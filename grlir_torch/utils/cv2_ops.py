"""numpy/scipy copies of the OpenCV calls the BSR degradation pipeline
makes, on float32 (or float64) HWC or HW images, so that the port needs no
`cv2`:

- `gaussian_blur`: `cv2.GaussianBlur(img, (k, k), sigma)`, sigma 0 taking
  `cv2.getGaussianKernel`'s rule and its fixed tables for k <= 9;
- `filter2d`: `cv2.filter2D(img, -1, kernel)`, a correlation;
- `resize`: `cv2.resize(img, (w, h), interpolation)` for INTER_LINEAR (1),
  INTER_CUBIC (2, A = -0.75) and INTER_AREA (3, OpenCV's exact-area
  weights when both axes shrink, its bilinear emulation otherwise), and
  uint8 INTER_LINEAR in OpenCV's own fixed point, bit-equal (the SR
  dataset's enlargement of a small training image);
- `rgb_to_hsv` / `hsv_to_rgb`: `cv2.COLOR_RGB2HSV` / `COLOR_HSV2RGB` for
  float images, H in degrees;
- `copy_make_border_reflect101`: `cv2.copyMakeBorder(...,
  BORDER_REFLECT_101)`.

Every border is OpenCV's BORDER_REFLECT_101 (`gfedcb|abcdefgh|gfedcba`)
except the resizes', which replicate the edge.  Sums run in float64 over
OpenCV's float32 weights; results differ from OpenCV's float32 sums by
rounding only (tests/test_torch_bsr.py holds them within 1e-5).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage
from scipy.signal import fftconvolve

INTER_LINEAR, INTER_CUBIC, INTER_AREA = 1, 2, 3

# cv2.getGaussianKernel's fixed kernels for ksize <= 9 and sigma <= 0, in
# 256ths
_SMALL_GAUSSIAN = {
    1: [256],
    3: [64, 128, 64],
    5: [16, 64, 96, 64, 16],
    7: [8, 28, 56, 72, 56, 28, 8],
    9: [4, 13, 30, 51, 60, 51, 30, 13, 4],
}


def reflect101_index(p: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's borderInterpolate for BORDER_REFLECT_101: source index of
    position p (any integer) on an axis of length n."""
    p = np.asarray(p)
    if n == 1:
        return np.zeros_like(p)
    period = 2 * n - 2
    p = np.mod(p, period)
    return np.where(p >= n, period - p, p)


def _pad_reflect101(img: np.ndarray, top: int, bottom: int, left: int,
                    right: int) -> np.ndarray:
    h, w = img.shape[:2]
    rows = reflect101_index(np.arange(-top, h + bottom), h)
    cols = reflect101_index(np.arange(-left, w + right), w)
    return img[rows][:, cols]


def copy_make_border_reflect101(img: np.ndarray, top: int, bottom: int,
                                left: int, right: int) -> np.ndarray:
    """cv2.copyMakeBorder(img, top, bottom, left, right, BORDER_REFLECT_101)."""
    return np.ascontiguousarray(_pad_reflect101(img, top, bottom, left, right))


def get_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F) as float32 (ksize,)."""
    if ksize in _SMALL_GAUSSIAN and sigma <= 0:
        t = np.asarray(_SMALL_GAUSSIAN[ksize], np.float64) / 256
    else:
        s = sigma if sigma > 0 else ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
        x = np.arange(ksize) - (ksize - 1) * 0.5
        t = np.exp(-0.5 / (s * s) * x * x)
    k = t.astype(np.float32)
    return (k.astype(np.float64) * (1.0 / k.astype(np.float64).sum())).astype(np.float32)


def _correlate1d(img: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """Correlation along one axis with a reflect-101 border (scipy's
    "mirror"), centred tap len(k) // 2, in float64."""
    return ndimage.correlate1d(img.astype(np.float64), k.astype(np.float64),
                               axis=axis, mode="mirror")


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma), ksize odd."""
    if ksize % 2 != 1:
        raise ValueError(f"ksize {ksize}: odd sizes only")
    k = get_gaussian_kernel(ksize, sigma)
    out = _correlate1d(_correlate1d(img, k, 0), k, 1)
    return out.astype(img.dtype)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel, borderType=BORDER_REFLECT_101) for an
    odd-sized kernel (the kernel is taken in the image's precision, as
    OpenCV casts it)."""
    kh, kw = kernel.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"kernel {kernel.shape}: odd sizes only")
    k = np.asarray(kernel, np.float32 if img.dtype != np.float64 else np.float64)
    padded = _pad_reflect101(img.astype(np.float64), kh // 2, kh // 2, kw // 2, kw // 2)
    # correlation = convolution with the flipped kernel
    kk = k[::-1, ::-1].astype(np.float64)
    if img.ndim == 3:
        kk = kk[:, :, None]
    out = fftconvolve(padded, kk, mode="valid", axes=(0, 1))
    return out.astype(img.dtype)


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """OpenCV's interpolateCubic, A = -0.75: (n, 4) float32 weights."""
    a = -0.75
    x = x.astype(np.float64)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1).astype(np.float32)


def _interp_weights(ssize: int, dsize: int, interpolation: int,
                    area_mode: bool) -> np.ndarray:
    """(dsize, ssize) float64 matrix of one axis of OpenCV's generic
    (separable) resize, border replicated."""
    scale = ssize / dsize
    inv_scale = dsize / ssize
    d = np.arange(dsize)
    if area_mode:
        s0 = np.floor(d * scale).astype(np.int64)
        f = (d + 1) - (s0 + 1) * inv_scale
        f = np.where(f <= 0, 0.0, f - np.floor(f))
    else:
        f = (d + 0.5) * scale - 0.5
        s0 = np.floor(f).astype(np.int64)
        f = f - s0
    w = np.zeros((dsize, ssize), np.float64)
    if interpolation == INTER_CUBIC:
        coeffs = _cubic_coeffs(f)
        for j in range(4):
            idx = np.clip(s0 - 1 + j, 0, ssize - 1)
            np.add.at(w, (d, idx), coeffs[:, j].astype(np.float64))
        return w
    low = s0 < 0
    high = s0 >= ssize - 1
    f = np.where(low | high, 0.0, f).astype(np.float32)
    s0 = np.where(low, 0, np.where(high, ssize - 1, s0))
    np.add.at(w, (d, s0), (np.float32(1) - f).astype(np.float64))
    np.add.at(w, (d, np.minimum(s0 + 1, ssize - 1)), f.astype(np.float64))
    return w


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) float64 matrix of OpenCV's computeResizeAreaTab (a
    shrinking axis of INTER_AREA), the float32 weights it stores."""
    scale = ssize / dsize
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            w[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def _linear_u8_coeffs(ssize: int, dsize: int, clamp: bool):
    """OpenCV's INTER_LINEAR source indices and 11-bit fixed-point weights
    of one axis: fx in float32, weights rounded from (1 - fx, fx) * 2048.
    The x axis clamps fx to 0 at the borders; the y axis keeps its weights
    and only clamps the rows it reads."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int64)
    f = (f - s0.astype(np.float32)).astype(np.float32)
    if clamp:
        edge = (s0 < 0) | (s0 >= ssize - 1)
        f = np.where(edge, np.float32(0), f)
        s0 = np.clip(s0, 0, ssize - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return s0, w0, w1


def _resize_linear_u8(img: np.ndarray, w_out: int, h_out: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) of uint8 in OpenCV's fixed point: a
    horizontal pass of 11-bit weights into int32 rows, then the vertical
    pass as OpenCV's vector code computes it (VResizeLinearVec_32s8u): each
    row >> 4, times its 11-bit weight, high 16 bits kept, summed, then
    (sum + 2) >> 2 saturated to uint8."""
    h_in, w_in = img.shape[:2]
    x = img.reshape(h_in, w_in, -1).astype(np.int64)
    sx, ax0, ax1 = _linear_u8_coeffs(w_in, w_out, True)
    sy, by0, by1 = _linear_u8_coeffs(h_in, h_out, False)
    rows = (x[:, sx] * ax0[None, :, None]
            + x[:, np.minimum(sx + 1, w_in - 1)] * ax1[None, :, None])
    r0 = rows[np.clip(sy, 0, h_in - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, h_in - 1)] >> 4
    v = (((r0 * by0[:, None, None]) >> 16) + ((r1 * by1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape((h_out, w_out) + img.shape[2:])


def resize(img: np.ndarray, dsize, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """cv2.resize(img, dsize=(w, h), interpolation=...) for INTER_LINEAR,
    INTER_CUBIC and INTER_AREA; uint8 INTER_LINEAR in OpenCV's fixed point,
    bit-equal, everything else in float64 cast back to the input type."""
    w_out, h_out = int(dsize[0]), int(dsize[1])
    h_in, w_in = img.shape[:2]
    if (h_out, w_out) == (h_in, w_in):
        return img.copy()
    if interpolation not in (INTER_LINEAR, INTER_CUBIC, INTER_AREA):
        raise ValueError(f"interpolation {interpolation}: 1, 2 or 3")
    if interpolation == INTER_LINEAR and img.dtype == np.uint8:
        return _resize_linear_u8(img, w_out, h_out)
    if interpolation == INTER_AREA and w_in >= w_out and h_in >= h_out:
        wy, wx = _area_weights(h_in, h_out), _area_weights(w_in, w_out)
    else:
        area = interpolation == INTER_AREA
        kind = INTER_CUBIC if interpolation == INTER_CUBIC else INTER_LINEAR
        wy = _interp_weights(h_in, h_out, kind, area)
        wx = _interp_weights(w_in, w_out, kind, area)
    x = img.astype(np.float64)
    out = (wy @ x.reshape(h_in, -1)).reshape(h_out, *img.shape[1:])
    out = wx @ out if img.ndim == 3 else out @ wx.T
    return np.ascontiguousarray(out.astype(img.dtype))


_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) for float32 RGB in [0, 1]: H in
    [0, 360), S and V in [0, 1]."""
    img = img.astype(np.float32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _FLT_EPSILON)
    k = (np.float32(60.0) / (diff + _FLT_EPSILON)).astype(np.float32)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120),
                          (r - g) * k + np.float32(240))).astype(np.float32)
    h = np.where(h < 0, h + np.float32(360), h)
    return np.stack([h, s, v], -1).astype(np.float32)


# (b, g, r) picks from tab = [v, p, q, t] by sector (OpenCV's sector_data)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2RGB) for float32 HSV, H in degrees."""
    img = img.astype(np.float32)
    h, s, v = img[..., 0] * np.float32(6.0 / 360.0), img[..., 1], img[..., 2]
    h = np.mod(h, np.float32(6))
    sector = np.floor(h).astype(np.int64)
    h = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, np.float32(0), h).astype(np.float32)
    one = np.float32(1)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], -1)
    pick = _SECTORS[sector]                       # (..., 3): b, g, r
    bgr = np.take_along_axis(tab, pick, axis=-1)
    rgb = bgr[..., ::-1]
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.float32)
