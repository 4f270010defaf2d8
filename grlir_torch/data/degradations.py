"""The degradations validation synthesizes on the device: demosaicking (dm)
and kernel deblurring (db), the counterpart of the device side of
`grlir.data.degradations`.

  - `dm_matlab`: the MATLAB (Malvar) demosaicking init of a packed RGGB
    mosaic, one 5x5 conv of its four kernels, then the strided fills;
  - `apply_blur` and `db_forward`: blur(gt) + noise as a grouped conv with
    zero padding, the kernel's support cropped in training;
  - `get_blur_kernel`: the Gaussian (MATLAB fspecial) or one of Levin's
    real kernels (`grlir_torch/assets/Levin09.npy`, a byte copy of grlir's
    asset), flipped so that the correlation is a true convolution.

NHWC tensors in and out; the convolutions run in the input's type with
TF32 off.

The data pipeline's side, on numpy: training and validation noise (the
validation noise seeded by sha256 of the file's stem and drawn in CHW
order, as grlir draws it), the noise-level map, the RGGB mosaic, and the
JPEG-artifact data's compression (`jpeg_compress`, in integer numpy by
`grlir_torch.utils.jpeg`, bit-equal to grlir's cv2 round trip).
"""

from __future__ import annotations

import os
from hashlib import sha256
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from grlir_torch.utils.image import depthwise_conv

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "assets")


def _dm_kernels() -> np.ndarray:
    """The 4 Malvar demosaic kernels, (4, 5, 5)."""
    kgrb = np.array(
        [[0, 0, -1, 0, 0],
         [0, 0, 2, 0, 0],
         [-1, 2, 4, 2, -1],
         [0, 0, 2, 0, 0],
         [0, 0, -1, 0, 0]], np.float32) / 8
    krbg0 = np.array(
        [[0, 0, 0.5, 0, 0],
         [0, -1, 0, -1, 0],
         [-1, 4, 5, 4, -1],
         [0, -1, 0, -1, 0],
         [0, 0, 0.5, 0, 0]], np.float32) / 8
    krbg1 = krbg0.T
    krbbr = np.array(
        [[0, 0, -1.5, 0, 0],
         [0, 2, 0, 2, 0],
         [-1.5, 0, 6, 0, -1.5],
         [0, 2, 0, 2, 0],
         [0, 0, -1.5, 0, 0]], np.float32) / 8
    return np.stack([kgrb, krbg0, krbg1, krbbr])


def dm_matlab(cfa4: torch.Tensor) -> torch.Tensor:
    """MATLAB (Malvar) demosaicking init: (B, H/2, W/2, 4) packed RGGB ->
    (B, H, W, 3) RGB."""
    B, h2, w2, _ = cfa4.shape
    cfa = torch.zeros((B, 2 * h2, 2 * w2), dtype=cfa4.dtype, device=cfa4.device)
    cfa[:, 0::2, 0::2] = cfa4[..., 0]
    cfa[:, 0::2, 1::2] = cfa4[..., 1]
    cfa[:, 1::2, 0::2] = cfa4[..., 2]
    cfa[:, 1::2, 1::2] = cfa4[..., 3]

    pad = F.pad(cfa[:, None], (2, 2, 2, 2), mode="reflect")
    k = torch.as_tensor(_dm_kernels(), dtype=cfa.dtype, device=cfa.device)[:, None]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        conv = F.conv2d(pad, k)                          # (B, 4, H, W)

    # from the replicated CFA, fill the interpolated sites
    r, g, b = cfa.clone(), cfa.clone(), cfa.clone()
    g[:, 0::2, 0::2] = conv[:, 0, 0::2, 0::2]
    g[:, 1::2, 1::2] = conv[:, 0, 1::2, 1::2]
    r[:, 0::2, 1::2] = conv[:, 1, 0::2, 1::2]
    r[:, 1::2, 0::2] = conv[:, 2, 1::2, 0::2]
    r[:, 1::2, 1::2] = conv[:, 3, 1::2, 1::2]
    b[:, 0::2, 1::2] = conv[:, 2, 0::2, 1::2]
    b[:, 1::2, 0::2] = conv[:, 1, 1::2, 0::2]
    b[:, 0::2, 0::2] = conv[:, 3, 0::2, 0::2]
    return torch.stack([r, g, b], dim=-1)


def get_blur_kernel(kernel_type: str = "gaussian") -> np.ndarray:
    """(kh, kw) float32, flipped so that a correlation with it is a true
    convolution."""
    if kernel_type == "gaussian":
        k = _fspecial_gaussian(25, 1.6)
    elif "real" in kernel_type:
        path = os.path.join(ASSET_DIR, "Levin09.npy")
        with open(path, "rb") as f:
            k = np.load(f, allow_pickle=True)[0, int(kernel_type[-1]) - 1]
    else:
        raise ValueError(kernel_type)
    return np.flip(k.astype(np.float32)).copy()


def _fspecial_gaussian(hsize: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian')."""
    siz = (hsize - 1.0) / 2.0
    x, y = np.meshgrid(np.arange(-siz, siz + 1), np.arange(-siz, siz + 1))
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    s = h.sum()
    return h / s if s != 0 else h


def apply_blur(target: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """The kernel over every channel of NHWC target, zero padding k // 2."""
    kh, kw = kernel.shape
    return depthwise_conv(target, np.ascontiguousarray(kernel, np.float32),
                          (kh // 2, kw // 2))


def db_forward(noise: torch.Tensor, target: torch.Tensor, kernel: np.ndarray,
               training: bool):
    """Deblurring input synthesis: lq = blur(gt) + noise; training also
    crops the kernel's support from both."""
    bkh, bkw = kernel.shape[0] // 2, kernel.shape[1] // 2
    lq = noise + apply_blur(target, kernel)
    if training:
        lq = lq[:, bkh:-bkh, bkw:-bkw, :]
        target = target[:, bkh:-bkh, bkw:-bkw, :]
    return lq, target


# ---------------------------------------------------------------- host side

def train_noise(rng: np.random.Generator, shape_hwc, sigma: float = 0.0,
                sigma_range: Sequence[float] = ()) -> Tuple[np.ndarray, float]:
    """Fresh AWGN for a training sample; sigma in [0, 255] units (drawn
    from sigma_range when it is given)."""
    if len(sigma_range) > 0:
        sigma = rng.uniform(*sigma_range)
    s = sigma / 255.0
    return (rng.standard_normal(shape_hwc) * s).astype(np.float32), s


def val_noise(filename: str, shape_hwc, sigma: float) -> np.ndarray:
    """Deterministic validation noise: a RandomState seeded by sha256 of the
    file's stem (up to its first "_"), drawn in CHW order."""
    h, w, c = shape_hwc
    img_name = os.path.basename(filename).split("_")[0]
    seed = np.frombuffer(sha256(img_name.encode("utf-8")).digest(), dtype="uint32")
    rstate = np.random.RandomState(seed)
    noise = rstate.normal(0, sigma / 255.0, (c, h, w))
    return noise.transpose(1, 2, 0).astype(np.float32)


def noise_level_map(shape_hw, level: float) -> np.ndarray:
    """A constant noise-level channel, (H, W, 1)."""
    return np.full((*shape_hw, 1), level, np.float32)


def jpeg_compress(img_uint8: np.ndarray, quality_factor: int) -> np.ndarray:
    """The JPEG round trip of an RGB (H, W, 3) or grayscale (H, W, 1) uint8
    image at `quality_factor`, as grlir's cv2 encode and decode give it."""
    from grlir_torch.utils.jpeg import jpeg_roundtrip, jpeg_roundtrip_gray

    if img_uint8.ndim == 3 and img_uint8.shape[2] == 3:
        return jpeg_roundtrip(img_uint8, quality_factor)
    return jpeg_roundtrip_gray(img_uint8[..., 0], quality_factor)[..., np.newaxis]


def mosaic_cfa_bayer(rgb_uint8: np.ndarray):
    """RGGB mosaic of uint8 RGB: (CFA (H, W), CFA4 (H/2, W/2, 4) packed)."""
    H, W = rgb_uint8.shape[:2]
    mask = np.zeros((H, W, 3), bool)
    mask[0::2, 0::2, 0] = True  # R
    mask[0::2, 1::2, 1] = True  # G
    mask[1::2, 0::2, 1] = True  # G
    mask[1::2, 1::2, 2] = True  # B
    cfa = (mask * rgb_uint8).sum(2).astype(np.uint8)
    cfa4 = np.zeros((H // 2, W // 2, 4), np.uint8)
    cfa4[:, :, 0] = cfa[0::2, 0::2]
    cfa4[:, :, 1] = cfa[0::2, 1::2]
    cfa4[:, :, 2] = cfa[1::2, 0::2]
    cfa4[:, :, 3] = cfa[1::2, 1::2]
    return cfa, cfa4
