"""Validation loop: per-task input synthesis, restoration through a
`Restorer`, metrics, reporting (counterpart of `grlir.engines.validate`).

Restored images and targets are quantized to the 1/255 grid, shaved by the
scale for any task containing "sr", scored per image on the device the
restorer runs on, and accumulated with their sample indices, so that a
repeated index counts once.  GT-free sets take the no-reference metric
(NIQE, on the host) only.  LPIPS reads its weights from $GRLIR_LPIPS_NPZ
(`grlir_torch.metrics.lpips`).
"""

from __future__ import annotations

import csv
import os
import os.path as osp
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from grlir_torch.data import degradations as D
from grlir_torch.metrics import basic as MB
from grlir_torch.metrics.collect import MetricAccumulator
from grlir_torch.utils.image import shave, tensor_round, to_uint8
from grlir_torch.utils.imageio import imwrite

METRIC_FNS: Dict[str, Callable] = {
    "psnr": MB.psnr,
    "psnr_y": MB.psnr_y,
    "ssim": MB.ssim,
    "ssim_y": MB.ssim_y,
    "psnrb": MB.psnrb,
    "psnrb_y": MB.psnrb_y,
}

# no-reference metrics: computable without a ground-truth image
GT_FREE_METRICS = ("niqe",)


def preprocess_val_batch(batch: dict, task: str,
                         blur_kernel: Optional[np.ndarray] = None, device="cpu"):
    """Per-task input synthesis on `device`: (lq, gt) as numpy arrays; dm
    demosaicks the packed mosaic, db blurs the target and adds the batch's
    noise; paired_dual stacks the two views along the channels."""
    if task == "paired_dual":
        lq = np.concatenate([batch["img_lq_l"], batch["img_lq_r"]], axis=-1)
        return lq, batch["img_gt"]
    lq = batch["img_lq"]
    gt = batch["img_gt"]

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    if task == "dm":
        lq = D.dm_matlab(dev(lq)).cpu().numpy()
    elif task == "db":
        lq, gt = D.db_forward(dev(lq), dev(gt), blur_kernel, training=False)
        lq, gt = lq.cpu().numpy(), gt.cpu().numpy()
    return lq, gt


def validate(
    restorer,
    loader,
    metric_names: Sequence[str] = ("psnr", "psnr_y", "ssim", "ssim_y"),
    task: str = "sr",
    scale: int = 1,
    blur_kernel: Optional[np.ndarray] = None,
    save_dir: Optional[str] = None,
    gather_across_hosts: bool = False,
    step: Optional[int] = None,
) -> Dict[str, float]:
    """Run a full validation pass with `restorer` (a `Restorer`, whose
    device the metrics run on); returns {metric: value}, and writes the
    per-image table (and images) to save_dir if given."""
    names = [n for n in metric_names if n not in GT_FREE_METRICS]
    gt_free_names = [n for n in metric_names if n in GT_FREE_METRICS]
    acc = MetricAccumulator(list(metric_names))
    device = restorer.device
    lpips_fn = None     # loaded at its first use

    for batch in loader:
        lq, gt = preprocess_val_batch(batch, task, blur_kernel, device)
        # GT-free sets (blind SR validation without GT) emit a (1,)-shaped
        # placeholder per sample; only no-reference metrics are computable
        gt_free = np.asarray(gt).ndim < 4
        if gt_free and names:
            raise ValueError(
                f"full-reference metrics {names} requested on a GT-free "
                f"validation set; use metric=restorer_niqe (reference: "
                f"config/experiment/bsr/grl.yaml val.with_gt=False)")
        restored = tensor_round(torch.from_numpy(restorer(np.asarray(lq))).to(device))
        target = None if gt_free else tensor_round(
            torch.as_tensor(np.asarray(gt, np.float32), device=device))

        if save_dir:
            _save_images(save_dir, task, batch["filenames"], lq,
                         restored.cpu().numpy(),
                         None if target is None else target.cpu().numpy())

        # shaved for any task containing "sr", synthetic blind SR included
        if "sr" in task and not gt_free:
            restored_m, target_m = shave(restored, scale), shave(target, scale)
        else:
            restored_m, target_m = restored, target

        values = {}
        for n in names:
            if n == "lpips":
                if lpips_fn is None:
                    from grlir_torch.metrics.lpips import lpips_metric_fn

                    lpips_fn = lpips_metric_fn(restored_m.device)
                values[n] = lpips_fn(restored_m, target_m)
                continue
            if n not in METRIC_FNS:
                raise ValueError(
                    f"unknown validation metric {n!r}; available: "
                    f"{sorted(METRIC_FNS)} + ['lpips'] + {list(GT_FREE_METRICS)}")
            values[n] = METRIC_FNS[n](restored_m, target_m).cpu().numpy()
        for n in gt_free_names:
            if n == "niqe":
                from grlir_torch.metrics.niqe import niqe_batch

                values[n] = niqe_batch(restored_m.cpu().numpy())
        acc.update(values, batch["indices"], batch["filenames"])

    if gather_across_hosts:
        acc.gather_across_hosts()
    results = acc.compute()
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        # step-stamped per-image tables, and a stable latest alias
        suffix = f"_{step}" if step is not None else ""
        with open(osp.join(save_dir, f"per_image_metrics{suffix}.txt"), "w") as f:
            f.write(acc.per_image_table())
        if suffix:
            with open(osp.join(save_dir, "per_image_metrics.txt"), "w") as f:
                f.write(acc.per_image_table())
    return results


def _save_images(save_dir, task, filenames, lq, restored, target):
    """LQ/HQ/GT dumps as PNG, one directory each."""
    for sub in ("LQ", "HQ", "GT"):
        os.makedirs(osp.join(save_dir, sub), exist_ok=True)
    for i, name in enumerate(filenames):
        base = osp.splitext(osp.basename(name))[0] + ".png"
        subs = [("LQ", lq[i]), ("HQ", restored[i])]
        if target is not None:  # GT-free sets have nothing to dump
            subs.append(("GT", target[i]))
        for sub, img in subs:
            imwrite(osp.join(save_dir, sub, base), to_uint8(img))


def write_results_csv(path: str, tag: str, val_set: str,
                      results: Dict[str, float], step: int):
    """Append one row per (val_set, step) to the final-validation CSV."""
    exists = osp.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(["tag", "val_set", "step"] + list(results.keys()))
        w.writerow([tag, val_set, step] + [f"{v:.4f}" for v in results.values()])
