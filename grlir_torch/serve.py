"""Batch inference CLI on PyTorch: restore a folder of images with a
reference torch checkpoint.

    python -m grlir_torch.serve --input lr_dir --output out_dir \
        --checkpoint sr_grl_small_c3x4.ckpt --model small --task sr --scale 4 \
        [--tile 640 --tile-overlap 32] [--shape-bucket 64] [--dtype bfloat16] \
        [--engine v3|fused|window|stripe] [--kernels auto|on|off] [--device cuda]

Loads reference .ckpt/.pth files (Lightning `model.`/`model_g.` prefixes or
a raw state_dict) with strict key matching.

`--engine` picks the attention engine (`GRLConfig.engine`) and `--kernels`
whether its CUDA kernels run.  The JAX CLI's `--pallas` choices map so:
auto -> --engine v3 --kernels auto; v3 -> --engine v3 --kernels on;
on -> --engine fused; window -> --engine window; stripe -> --engine stripe;
off -> --kernels off.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np
import torch

from grlir_torch.engines.inference import Restorer, reflect_pad_to
from grlir_torch.models import zoo
from grlir_torch.models.blocks import ENGINE_HALVES
from grlir_torch.models.grl import GRL
from grlir_torch.utils.convert import strip_prefix

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KERNELS = {"auto": "auto", "on": True, "off": False}


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference torch checkpoint into `model` (strict)."""
    ckpt = torch.load(osp.expanduser(path), map_location="cpu",
                      weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    errors = []
    for prefix in ("model.", "model_g.", ""):
        stripped = strip_prefix(sd, prefix)
        if not stripped:
            continue
        try:
            model.load_state_dict(stripped, strict=True)
            return
        except RuntimeError as e:
            errors.append(f"prefix {prefix!r}: {e}")
    raise KeyError(f"{path} does not match the model:\n" + "\n".join(errors))


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.uint8(np.round(np.clip(img, 0.0, 1.0) * 255.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True, help="input image file or dir")
    ap.add_argument("--output", required=True, help="output dir")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--model", default="small", choices=["tiny", "small", "base"])
    ap.add_argument("--task", default="sr")
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--tile-overlap", type=int, default=32)
    ap.add_argument("--shape-bucket", type=int, default=64,
                    help="whole-image mode: pad H/W up to multiples of this "
                         "so assorted sizes share shapes (0=off)")
    ap.add_argument("--batch", type=int, default=1,
                    help="restore up to N same-bucket images per call "
                         "(whole-image mode)")
    ap.add_argument("--dtype", default="float32", choices=list(DTYPES))
    ap.add_argument("--engine", default="v3", choices=list(ENGINE_HALVES),
                    help="attention engine: v3 = whole block-half kernels, "
                         "fused = kernels on projected q/k/v on both halves, "
                         "window/stripe = on that half only")
    ap.add_argument("--kernels", default="auto", choices=list(KERNELS),
                    help="CUDA attention kernels (auto = on for CUDA "
                         "inference; off = plain PyTorch attention)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import cv2

    cfg = zoo.make_config(args.model, task=args.task, upscale=args.scale,
                          dtype=DTYPES[args.dtype], engine=args.engine,
                          kernels=KERNELS[args.kernels])
    model = GRL(cfg)
    load_checkpoint(model, args.checkpoint)
    model.eval().to(args.device)
    scale = cfg.upscale
    restorer = Restorer(model, args.device, scale=scale, tile=args.tile,
                        tile_overlap=args.tile_overlap,
                        shape_bucket=args.shape_bucket)

    paths = ([args.input] if osp.isfile(args.input) else sorted(
        osp.join(args.input, f) for f in os.listdir(args.input)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))))
    os.makedirs(args.output, exist_ok=True)

    def bucket_key(shape):
        m = args.shape_bucket
        if not m or args.tile:
            return shape
        return (-(-shape[0] // m) * m, -(-shape[1] // m) * m)

    groups = {}
    for p in paths:
        img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        groups.setdefault(bucket_key(img.shape[:2]), []).append((p, img))

    step = max(args.batch, 1)
    for key, members in groups.items():
        for s in range(0, len(members), step):
            chunk = members[s:s + step]
            # pad each member straight to the group's shape in ONE reflect
            if args.shape_bucket and not args.tile:
                hmax, wmax = key
            else:
                hmax = max(im.shape[0] for _, im in chunk)
                wmax = max(im.shape[1] for _, im in chunk)
            batch = np.stack([
                reflect_pad_to(im.astype(np.float32) / 255.0, (hmax, wmax))
                for _, im in chunk])
            t0 = time.perf_counter()
            outs = restorer(batch)
            dt = time.perf_counter() - t0
            for i, (p, im) in enumerate(chunk):
                out = outs[i, :im.shape[0] * scale, :im.shape[1] * scale]
                dst = osp.join(args.output, osp.basename(p))
                cv2.imwrite(dst, cv2.cvtColor(to_uint8(out), cv2.COLOR_RGB2BGR))
                print(f"{osp.basename(p)}: {im.shape[1]}x{im.shape[0]} -> "
                      f"{out.shape[1]}x{out.shape[0]} in {dt / len(chunk):.2f}s"
                      f" -> {dst}")


if __name__ == "__main__":
    main()
