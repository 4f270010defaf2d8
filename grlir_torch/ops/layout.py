"""Layout transforms for NHWC feature maps (torch counterparts of
`grlir.ops.layout`).

Windows stay an explicit axis beside the batch, as in the JAX package.  Pixel
shuffle is `torch.nn.PixelShuffle` on NCHW at the model's tail, in the
reference's channel order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Size2 = Tuple[int, int]


def window_partition(x: torch.Tensor, window_size: Size2) -> torch.Tensor:
    """(B, H, W, C) -> (B, nWin, wh*ww, C) in row-major window order."""
    B, H, W, C = x.shape
    wh, ww = window_size
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // wh) * (W // ww), wh * ww, C)


def window_reverse(x: torch.Tensor, window_size: Size2,
                   x_size: Size2) -> torch.Tensor:
    """(B, nWin, wh*ww, C) -> (B, H, W, C)."""
    H, W = x_size
    wh, ww = window_size
    B, C = x.shape[0], x.shape[-1]
    x = x.reshape(B, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def nearest_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC nearest-neighbour upsampling (F.interpolate mode='nearest')."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def pad_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad H and W (bottom/right) of NHWC x up to the next multiple.

    Reflect padding, or zero padding when the image is smaller than the pad
    (the reference's try/except, grlir/ops/layout.py:125-137)."""
    _, H, W, _ = x.shape
    ph = (multiple - H % multiple) % multiple
    pw = (multiple - W % multiple) % multiple
    if ph == 0 and pw == 0:
        return x
    mode = "reflect" if (ph < H and pw < W) else "constant"
    y = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode)
    return y.permute(0, 2, 3, 1)
