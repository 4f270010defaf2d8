"""Training preprocessing on the device: task physics, MixUp and the
progressive re-crop (counterpart of `grlir.engines.preprocess`).

Each random draw is split from the arithmetic that uses it: `draw_crop`
and `draw_mixup` take an explicit numpy Generator (Beta(1.2, 1.2) has no
generator argument in torch.distributions), and `crop_pair` and `mixup`
are deterministic functions of the draws, so tests hold the arithmetic
equal to grlir's on injected draws.  Across processes every draw is made
for the global batch from the generator every process holds alike: the
crop is one for the batch, and MixUp mixes the gathered global batch.
"""

from __future__ import annotations

import bisect
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from grlir_torch.data import degradations as D


def draw_mixup(rng: np.random.Generator, batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, lam): a permutation of the batch and Beta(1.2, 1.2) weights."""
    return rng.permutation(batch), rng.beta(1.2, 1.2, batch).astype(np.float32)


def mixup(lq: torch.Tensor, gt: torch.Tensor, perm, lam):
    """Pairwise mixing of each sample with the perm-th: lam x + (1 - lam) x[perm]."""
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.long, device=gt.device)
    lam = torch.as_tensor(np.asarray(lam, np.float32), device=gt.device).reshape(-1, 1, 1, 1)
    gt = lam * gt + (1 - lam) * gt[perm]
    lq = lam * lq + (1 - lam) * lq[perm]
    return lq, gt


def _global_mixup(lq: torch.Tensor, gt: torch.Tensor, rng: np.random.Generator):
    """MixUp over the global batch, as grlir permutes its sharded global
    batch: across processes each gathers every process's rows, mixes them
    with draws every process makes alike, and keeps its own rows."""
    from grlir_torch.parallel.mesh import all_gather_rows, shard_rows

    lq_all, gt_all = all_gather_rows(lq), all_gather_rows(gt)
    lq_all, gt_all = mixup(lq_all, gt_all, *draw_mixup(rng, gt_all.shape[0]))
    rows = shard_rows(gt_all.shape[0])
    return lq_all[rows], gt_all[rows]


def draw_crop(rng: np.random.Generator, height: int, width: int,
              patch: int) -> Tuple[int, int]:
    """(x0, y0) of an aligned LR crop, one for the whole batch."""
    return (int(rng.integers(0, height - patch + 1)),
            int(rng.integers(0, width - patch + 1)))


def crop_pair(lq: torch.Tensor, gt: torch.Tensor, patch: int, scale: int,
              x0: int, y0: int):
    """The patch x patch LR crop at (x0, y0) and its scale-times GT crop."""
    lq = lq[:, x0:x0 + patch, y0:y0 + patch]
    gt = gt[:, x0 * scale:(x0 + patch) * scale, y0 * scale:(y0 + patch) * scale]
    return lq, gt


def make_train_preprocess(
    task: str,
    blur_kernel: Optional[np.ndarray] = None,
    use_mixup: bool = False,
    scale: int = 1,
    crop_patch: Optional[int] = None,
    use_usm_target: bool = False,
    mixup_start_step: int = 0,
):
    """Build preprocess(batch, rng, step) -> (lq, gt) on the batch's device.

    batch: dict of tensors on the device.  crop_patch: re-crop to this LR
    patch (progressive training).  use_usm_target: train against the
    batch's USM-sharpened GT when it has one.  mixup_start_step: MixUp only
    from this step on (the trainer passes six virtual epochs of steps).
    """

    def preprocess(batch, rng: np.random.Generator, step: Optional[int] = None):
        if task == "paired_dual":
            lq = torch.cat([batch["img_lq_l"], batch["img_lq_r"]], -1)
            gt = batch["img_gt"]
        else:
            lq, gt = batch["img_lq"], batch["img_gt"]
        if use_usm_target and "img_gt_usm" in batch:
            gt = batch["img_gt_usm"]

        if task == "dm":
            lq = D.dm_matlab(lq)
        elif task == "db":
            lq, gt = D.db_forward(lq, gt, blur_kernel, training=True)

        if crop_patch is not None and crop_patch < lq.shape[1]:
            x0, y0 = draw_crop(rng, lq.shape[1], lq.shape[2], crop_patch)
            lq, gt = crop_pair(lq, gt, crop_patch, scale, x0, y0)
        if use_mixup and (step is None or step >= mixup_start_step):
            lq, gt = _global_mixup(lq, gt, rng)
        return lq, gt

    return preprocess


def progressive_stage(step: int, steps: Sequence[int]) -> int:
    """Stage index for progressive batch/patch schedules."""
    return bisect.bisect_left(list(steps), step)
