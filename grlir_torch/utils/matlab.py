"""MATLAB-compatible bicubic resize (numpy), the port's copy of
`grlir.utils.matlab`.

Cubic kernel, antialiased downscaling, symmetric edge padding, fp32
accumulation, separable H-then-W passes.  SR validation's LR inputs and
NIQE's second scale go through it; the tests hold it bit-equal to grlir's.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def cubic(x: np.ndarray) -> np.ndarray:
    absx = np.abs(x)
    absx2 = absx**2
    absx3 = absx**3
    return (1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1) + (
        -0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2
    ) * ((absx > 1) & (absx <= 2))


def _weights_indices(
    in_length: int, out_length: int, scale: float, kernel_width: float,
    antialiasing: bool,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    # float32 like the reference (torch.linspace default dtype) for bit parity
    x = np.arange(1, out_length + 1, dtype=np.float32)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = math.ceil(kernel_width) + 2

    indices = left[:, None] + np.arange(p)[None, :]
    distance = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * cubic(distance * scale)
    else:
        weights = cubic(distance)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # drop all-zero boundary taps (first/last column), like the reference
    zero_cols = (weights == 0).sum(axis=0)
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        indices = indices[:, 1: p - 1]
        weights = weights[:, 1: p - 1]
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        indices = indices[:, 0: p - 2]
        weights = weights[:, 0: p - 2]

    sym_len_s = int(-indices.min() + 1)
    sym_len_e = int(indices.max() - in_length)
    indices = (indices + sym_len_s - 1).astype(np.int64)
    return weights.astype(np.float32), indices, sym_len_s, sym_len_e


def _resample_axis0(img: np.ndarray, weights, indices, sym_s: int, sym_e: int):
    """Resample along axis 0 with symmetric (reflect-no-repeat) padding."""
    top = img[:sym_s][::-1] if sym_s > 0 else img[:0]
    bottom = img[img.shape[0] - sym_e:][::-1] if sym_e > 0 else img[:0]
    aug = np.concatenate([top, img, bottom], axis=0)
    # gather (out, taps, ...) then contract taps
    gathered = aug[indices]  # (out, taps, W, C)
    return np.einsum("ot...,ot->o...", gathered, weights).astype(np.float32)


def imresize(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """MATLAB bicubic imresize on (H, W, C) or (H, W) float arrays in [0, 1]."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    img = img.astype(np.float32)
    in_h, in_w = img.shape[:2]
    out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)

    wh, ih, sh_s, sh_e = _weights_indices(in_h, out_h, scale, 4, antialiasing)
    ww, iw, sw_s, sw_e = _weights_indices(in_w, out_w, scale, 4, antialiasing)

    out = _resample_axis0(img, wh, ih, sh_s, sh_e)  # H pass
    out = out.transpose(1, 0, 2)
    out = _resample_axis0(out, ww, iw, sw_s, sw_e)  # W pass
    out = out.transpose(1, 0, 2)
    return out[:, :, 0] if squeeze else out
