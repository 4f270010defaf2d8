"""Imaging utilities on NHWC tensors (counterpart of `grlir.utils.image`).

The numerics are grlir's, so that the metrics agree with it digit for
digit: the 1/255 grid of `tensor_round`, and the MATLAB BT.601 RGB -> YCbCr
transform with its integer rounding.  `shave` and `tensor_round` work on
tensors, `modcrop` and `to_uint8` on numpy arrays, as in grlir.  `depthwise_conv`
is the filter of SSIM and of the deblurring synthesis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# MATLAB ITU-R BT.601 ycbcr matrix, grlir's `_YCBCR_ROT` and `_YCBCR_OFF`
YCBCR_ROT = np.array([[65.481, -37.797, 112.0],
                      [128.553, -74.203, -93.786],
                      [24.966, 112.0, -18.214]]) / 255.0
YCBCR_OFF = np.array([16.0, 128.0, 128.0])


def shave(img: torch.Tensor, border: int) -> torch.Tensor:
    """Crop `border` pixels from each spatial edge of an NHWC tensor."""
    if border > 0:
        img = img[..., border:-border, border:-border, :]
    return img


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H and W of an HWC or HW array to multiples of scale."""
    img = np.copy(img)
    H, W = img.shape[:2]
    return img[: H - H % scale, : W - W % scale, ...]


def tensor_round(img: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Quantize to the representable 1/255 grid."""
    img = torch.clamp(img, 0.0, 1.0 * data_range)
    img = torch.round(img * 255.0 / data_range)
    return img * data_range / 255.0


def to_uint8(img, data_range: float = 1.0) -> np.ndarray:
    img = np.clip(np.asarray(img), 0, data_range)
    return np.uint8(np.round(img * 255.0 / data_range))


def rgb2ycbcr(img: torch.Tensor, data_range: float = 1.0,
              only_y: bool = True) -> torch.Tensor:
    """MATLAB-compatible RGB -> YCbCr with integer rounding, NHWC float in
    [0, data_range] -> the same scale.  The round() is part of what PSNR-Y
    and SSIM-Y mean.  Each output channel sums its three products in the
    order of grlir's `x @ rot` (channel 0, 1, then 2) in x's type, so that
    no rounding flips against it."""
    x = img
    if data_range == 1.0:
        x = x * 255.0
    rot = torch.as_tensor(YCBCR_ROT, dtype=x.dtype, device=x.device)
    off = torch.as_tensor(YCBCR_OFF, dtype=x.dtype, device=x.device)
    cols = range(1) if only_y else range(3)
    x = torch.stack([x[..., 0] * rot[0, j] + x[..., 1] * rot[1, j] + x[..., 2] * rot[2, j]
                     + off[j] for j in cols], -1)
    x = torch.round(x)
    if data_range == 1.0:
        x = x / 255.0
    return x


def depthwise_conv(x: torch.Tensor, kernel: np.ndarray,
                   padding: tuple) -> torch.Tensor:
    """The same 2-D kernel over every channel of NHWC x, zero padding
    (ph, pw) on both sides of each axis, as a grouped F.conv2d in x's type
    with TF32 off; NHWC out."""
    C = x.shape[-1]
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    w = w[None, None].expand(C, 1, *kernel.shape)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=padding, groups=C)
    return y.permute(0, 2, 3, 1)
