"""numpy copies of the OpenCV calls the BSR degradation pipeline makes, so
that the port needs no `cv2`.  On float32 images each one computes what
cv2 computes, to the bit:

- `gaussian_blur`: `cv2.GaussianBlur(img, (k, k), sigma)`;
- `filter2d`: `cv2.filter2D(img, -1, kernel)` with BORDER_REFLECT_101, a
  correlation;
- `resize`: `cv2.resize(img, (w, h), interpolation)` for INTER_LINEAR (1),
  INTER_CUBIC (2) and INTER_AREA (3), and uint8 INTER_LINEAR in OpenCV's
  own fixed point (the SR dataset's enlargement of a small training image);
- `rgb_to_hsv` / `hsv_to_rgb`: `cv2.COLOR_RGB2HSV` / `COLOR_HSV2RGB` for
  float images, H in degrees;
- `copy_make_border_reflect101`: `cv2.copyMakeBorder(...,
  BORDER_REFLECT_101)`.

"To the bit" means the same float32 operations in the same order.  cv2
picks its code by CPU, so each model matches one dispatch: OpenCV 5.0.0 as
the opencv-python wheel builds it (SSE3 baseline, AVX2 code with FMA3
dispatched at run time) with IPP 2026.0.0 (ippIP AVX-512F/CD/BW/DQ/VL), on
an x86-64 CPU with avx2, avx512f and fma:

- filter2D, under 130 taps: OpenCV's direct loop.  Taps in row-major
  order of the correlation kernel, zero taps skipped; the first
  floor(W*cn/8)*8 values of a row are its 8-lane AVX2 body,
  s = fma(c, x, s) from s = c*x, the rest its scalar tail,
  s = s + c*x.  From 130 taps OpenCV correlates through its DFT in
  float64; here a float64 FFT, bit-equal at the BSR's sizes (the 400^2
  crop and its shrinks), not in general.  A float64 image under 50 taps
  (the ISP's demosaic) sums s = s + c*x in double.
- GaussianBlur: sepFilter2D with cv2.getGaussianKernel's float32 taps.
  Row filter (k >= 7): the first floor(W*cn/4)*4 values s = fma(x_j, k_j,
  s) over all taps; the scalar tail s = s + x_j*k_j for the first
  floor((k-1)/4)*4 taps after the first, FMA for the rest.  k = 3 and 5
  take OpenCV's symmetric small-kernel row filter.  Column filter: pairs
  p = x[+j] + x[-j], s = fma(p, k_j, s) on the 8-lane body, s = s + p*k_j
  on the tail.  A side of one pixel is not filtered along.
- resize INTER_LINEAR: IPP when both source sides exceed one pixel: a
  horizontal then a vertical pass, out = fma(f, x1 - x0, x0) with f the
  float32 of the float64 fraction; otherwise OpenCV's resizeGeneric
  (x0*a0 + x1*a1 per axis, float32 weights).
- resize INTER_CUBIC: IPP's cubic (B = 0, C = 0.75), see
  `_resize_cubic_ipp`; a source side under 4 pixels takes OpenCV's own
  resizeGeneric cubic (`_resize_cubic_opencv`).
- resize INTER_AREA: OpenCV's resizeAreaFast for integer factors,
  ResizeArea over computeResizeAreaTab's float32 weights for other
  shrinks, resizeGeneric's area-mode bilinear weights when a side grows.
- HSV: OpenCV's RGB2HSV_f row by row, its 8-lane body h = fma(d, 60/(diff
  + eps), offset) with 360 folded into the offset of negative red hues,
  its tail the same FMA, then + 360; HSV2RGB_f with v*fma(-s, h, 1) and
  v*fma(-s, 1 - h, 1).

Every fused multiply-add is `fma32`: one rounding of a*b + c, exact in
numpy (no `math.fma`).  Every border is OpenCV's BORDER_REFLECT_101
(`gfedcb|abcdefgh|gfedcba`) except the resizes', which replicate the edge.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
from scipy.signal import fftconvolve

INTER_LINEAR, INTER_CUBIC, INTER_AREA = 1, 2, 3

_F32 = np.float32
# a float64 holding a float32 midpoint has its 29 bits under the float32
# mantissa equal to 1 << 28
_LOW29 = np.uint64((1 << 29) - 1)
_HALF29 = np.uint64(1 << 28)
_EXP_BITS = np.uint64(0x7FF0000000000000)
_MIN_NORMAL32_BITS = np.float64(2.0 ** -126).view(np.uint64)


def fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: round32(a*b + c) with one rounding, for
    float32 operands (broadcast).  a*b is exact in float64; the float64 sum
    rounds once more, which differs from one rounding only when it lands
    on a float32 midpoint: there a TwoSum residual picks the side."""
    shape = np.broadcast_shapes(np.shape(a), np.shape(b), np.shape(c))
    p = np.atleast_1d(np.multiply(a, b, dtype=np.float64))
    t = np.atleast_1d(np.add(p, c, dtype=np.float64))
    out = t.astype(_F32)
    u = t.view(np.uint64)
    suspect = ((u & _LOW29) == _HALF29) | ((u & _EXP_BITS) < _MIN_NORMAL32_BITS)
    if suspect.any():
        i = np.nonzero(suspect)
        ps, ts = np.broadcast_to(p, t.shape)[i], t[i]
        cs = np.broadcast_to(np.asarray(c, np.float64), t.shape)[i]
        bv = ts - ps
        e = (ps - (ts - bv)) + (cs - bv)            # t + e == p + c exactly
        r = out[i]
        rd = r.astype(np.float64)
        side = np.where(rd < ts, np.nextafter(r, _F32(np.inf)), np.nextafter(r, _F32(-np.inf)))
        mid = (rd + side.astype(np.float64)) * 0.5    # side: the other float32 around t
        fix = (ts == mid) & (e != 0) & ((e > 0) == (side > r))
        out[i] = np.where(fix, side, r)
    return out.reshape(shape)


# values a row block of a filter holds: its float64 buffers stay in cache
_BLOCK = 1 << 15


class _FmaBuffers:
    """Work arrays of one row block for `_fma_into`."""

    def __init__(self, rows: int, cols: int):
        self.t = np.empty((rows, cols), np.float64)
        self.u = np.empty((rows, cols), np.uint64)
        self.tie = np.empty((rows, cols), bool)
        self.low = np.empty((rows, cols), bool)
        self.p = np.empty((rows, cols), _F32)

    def rows(self, n: int):
        return self.t[:n], self.u[:n], self.tie[:n], self.low[:n]


def _fma_into(s: np.ndarray, x: np.ndarray, c, bufs, tiny: bool = True,
              exact: bool = False) -> None:
    """s = fma(x, c, s) in place for a float32 block s and a float32
    scalar c, exactly as `fma32`, on preallocated work arrays.  tiny=False
    skips the test for sums under float32's normal range, for callers that
    know none can occur (`_no_tiny_sums`); exact=True adds x*c in float32,
    for callers that know every product is a float32 (`_exact_products`),
    where one rounding is the fused one."""
    t, u, tie, low = bufs
    if exact:
        p = u.view(np.float64)
        np.multiply(x, c, out=p, dtype=np.float64)
        np.add(s, p, out=s, casting="same_kind")
        return
    np.multiply(x, c, out=t, dtype=np.float64)
    np.add(t, s, out=t, dtype=np.float64)
    bits = t.view(np.uint64)
    np.bitwise_and(bits, _LOW29, out=u)
    np.equal(u, _HALF29, out=tie)
    if tiny:
        np.bitwise_and(bits, _EXP_BITS, out=u)
        np.less(u, _MIN_NORMAL32_BITS, out=low)
        np.logical_or(tie, low, out=tie)
    if tie.any():
        i = np.nonzero(tie)
        fixed = fma32(x[i], c, s[i])
        np.copyto(s, t, casting="same_kind")
        s[i] = fixed
    else:
        np.copyto(s, t, casting="same_kind")


def _no_tiny_sums(x: np.ndarray, taps) -> bool:
    """True when a chain of FMAs over values of x (the image a filter
    reads) and the taps cannot reach a nonzero sum under 2**-126: all of
    them non-negative, so that a sum is at least each of its nonzero
    products, and the least such product is in float32's normal range."""
    taps = np.asarray(taps, np.float64)
    if x.size == 0 or taps.min() < 0 or x.min() < 0:
        return False
    nonzero = x[x > 0]
    if nonzero.size == 0:
        return True
    return float(nonzero.min()) * float(taps[taps > 0].min()) >= 2.0 ** -126


def _exact_products(x: np.ndarray, taps) -> bool:
    """True when every product of a value of x and a tap is a float32: x
    holds only zeros and powers of two (a USM mask), and no product falls
    under float32's normal range."""
    bits = x.view(np.uint32) & np.uint32(0x7FFFFFFF)
    if np.any((bits & np.uint32(0x7FFFFF)) != 0):
        return False
    return _no_tiny_sums(np.abs(x), np.abs(np.asarray(taps, np.float64)))


def _blocks(rows: int, cols: int):
    """Row ranges of about _BLOCK values each, with their work arrays."""
    step = max(1, _BLOCK // max(cols, 1))
    bufs = _FmaBuffers(min(step, rows), cols)
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        yield r0, r1, bufs


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


# cv2.getGaussianKernel's fixed kernels for ksize <= 9 and sigma <= 0, in
# 256ths
_SMALL_GAUSSIAN = {
    1: [256],
    3: [64, 128, 64],
    5: [16, 64, 96, 64, 16],
    7: [8, 28, 56, 72, 56, 28, 8],
    9: [4, 13, 30, 51, 60, 51, 30, 13, 4],
}


def get_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F) as float32 (ksize,):
    OpenCV's getGaussianKernelBitExact in double (sigma 0.15*k + 0.35 with
    one rounding, the taps exp(-(x/2)^2 / (2 sigma^2)) for x = 2i - (k-1),
    normalised by one reciprocal of 1 + 2 * their sum), cast to float32."""
    if ksize in _SMALL_GAUSSIAN and sigma <= 0:
        return (np.asarray(_SMALL_GAUSSIAN[ksize], np.float64) / 256).astype(_F32)
    s = float(sigma) if sigma > 0 else float(Fraction(ksize) * Fraction(0.15) + Fraction(0.35))
    scale = -0.125 / (s * s)
    half = (ksize - 1) // 2
    vals = [math.exp(float(x * x) * scale) for x in range(1 - ksize, -1, 2)][:half]
    total = 0.0
    for v in vals:
        total += v
    total = total * 2.0 + 1.0
    if ksize % 2 == 0:
        total += 1.0
    mul = 1.0 / total
    k = np.empty(ksize, np.float64)
    for i, v in enumerate(vals):
        k[i] = k[ksize - 1 - i] = v * mul
    k[half] = mul
    if ksize % 2 == 0:
        k[half + 1] = mul
    return k.astype(_F32)


def _row_filter(pad: np.ndarray, k: np.ndarray, cn: int, n: int) -> np.ndarray:
    """OpenCV's float32 row filter of a symmetric kernel over rows padded by
    len(k)//2 pixels a side: (rows, n) with n = W*cn."""
    ks = len(k)
    x = [pad[:, j * cn: j * cn + n] for j in range(ks)]
    if ks <= 5:                                   # SymmRowSmallFilter
        r = ks // 2
        c, k0 = x[r], k[r]
        if ks == 3:
            return fma32(x[0] + x[2], k[0], c * k0)
        p1, p2 = x[1] + x[3], x[0] + x[4]
        out = fma32(p2, k[0], fma32(c, k0, p1 * k[1]))
        if n % 2:                                 # last value: its scalar code
            out[:, -1] = fma32(p1[:, -1], k[1], c[:, -1] * k0) + p2[:, -1] * k[0]
        return out
    quad = n // 4 * 4
    plain = (ks - 1) // 4 * 4
    out = np.empty((pad.shape[0], n), _F32)
    s = x[0][:, quad:] * k[0]                     # the scalar tail
    for j in range(1, ks):
        if j <= plain:
            s = s + x[j][:, quad:] * k[j]
        else:
            s = fma32(x[j][:, quad:], k[j], s)
    out[:, quad:] = s
    tiny, exact = not _no_tiny_sums(pad, k), _exact_products(pad, k)
    for r0, r1, bufs in _blocks(pad.shape[0], quad):
        acc = out[r0:r1, :quad]
        np.multiply(x[0][r0:r1, :quad], k[0], out=acc)
        for j in range(1, ks):
            _fma_into(acc, x[j][r0:r1, :quad], k[j], bufs.rows(r1 - r0), tiny, exact)
    return out


def _column_filter(rows: np.ndarray, k: np.ndarray, h: int, n: int) -> np.ndarray:
    """OpenCV's float32 symmetric column filter (SymmColumnFilter and its
    AVX2 body) of rows padded by len(k)//2 rows a side."""
    r = len(k) // 2
    body = n // 8 * 8
    out = np.empty((h, n), _F32)
    s = rows[r:r + h, body:] * k[r]
    for j in range(1, r + 1):
        s = s + (rows[r + j:r + j + h, body:] + rows[r - j:r - j + h, body:]) * k[r + j]
    out[:, body:] = s
    # a pair sum is at least its larger value: the rows' least nonzero value bounds it
    tiny = not _no_tiny_sums(rows, k)
    for r0, r1, bufs in _blocks(h, body):
        acc = out[r0:r1, :body]
        pair = bufs.p[:r1 - r0]
        np.multiply(rows[r + r0:r + r1, :body], k[r], out=acc)
        for j in range(1, r + 1):
            np.add(rows[r + j + r0:r + j + r1, :body], rows[r - j + r0:r - j + r1, :body], out=pair)
            _fma_into(acc, pair, k[r + j], bufs.rows(r1 - r0), tiny)
    return out


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) of float32, ksize odd."""
    if ksize % 2 != 1:
        raise ValueError(f"ksize {ksize}: odd sizes only")
    if img.dtype != np.float32:
        raise ValueError(f"{img.dtype}: float32 only")
    k = get_gaussian_kernel(ksize, sigma)
    h, w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    n = w * cn
    kx = k if w > 1 and ksize > 1 else np.ones(1, _F32)
    ky = k if h > 1 and ksize > 1 else np.ones(1, _F32)
    rx, ry = len(kx) // 2, len(ky) // 2
    pad = _pad_reflect101(img, ry, ry, rx, rx).reshape(h + 2 * ry, -1)
    rows = _row_filter(pad, kx, cn, n) if rx else pad
    out = _column_filter(rows, ky, h, n) if ry else rows
    return np.ascontiguousarray(out.reshape(img.shape))


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel, borderType=BORDER_REFLECT_101) for an
    odd-sized kernel (the kernel is taken in the image's precision, as
    OpenCV casts it)."""
    kh, kw = kernel.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"kernel {kernel.shape}: odd sizes only")
    double = img.dtype == np.float64
    k = np.asarray(kernel, np.float64 if double else _F32)
    if kh * kw < (50 if double else 130):
        return _filter2d_direct(img.astype(k.dtype, copy=False), k)
    padded = _pad_reflect101(img.astype(np.float64), kh // 2, kh // 2, kw // 2, kw // 2)
    # correlation = convolution with the flipped kernel
    kk = k[::-1, ::-1].astype(np.float64)
    if img.ndim == 3:
        kk = kk[:, :, None]
    out = fftconvolve(padded, kk, mode="valid", axes=(0, 1))
    return out.astype(img.dtype)


def _filter2d_direct(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """OpenCV's direct filter2D loop (see the module docstring)."""
    kh, kw = k.shape
    h, w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    n = w * cn
    pad = _pad_reflect101(img, kh // 2, kh // 2, kw // 2, kw // 2).reshape(h + kh - 1, -1)
    taps = [(i, j * cn, k[i, j]) for i in range(kh) for j in range(kw) if k[i, j] != 0]
    out = np.zeros((h, n), img.dtype)
    if not taps:
        return out.reshape(img.shape)
    body = n // 8 * 8 if img.dtype == np.float32 else 0
    (i0, j0, c0), rest = taps[0], taps[1:]
    s = pad[i0:i0 + h, j0 + body:j0 + n] * c0     # the scalar tail (all of float64)
    for i, j, c in rest:
        s = s + pad[i:i + h, j + body:j + n] * c
    out[:, body:] = s
    if body:
        cs = [c for _, _, c in taps]
        tiny, exact = not _no_tiny_sums(pad, cs), _exact_products(pad, cs)
        for r0, r1, bufs in _blocks(h, body):
            acc = out[r0:r1, :body]
            np.multiply(pad[r0 + i0:r1 + i0, j0:j0 + body], c0, out=acc)
            for i, j, c in rest:
                _fma_into(acc, pad[r0 + i:r1 + i, j:j + body], c, bufs.rows(r1 - r0), tiny,
                          exact)
    return out.reshape(img.shape)


def _linear_u8_coeffs(ssize: int, dsize: int, clamp: bool):
    """OpenCV's INTER_LINEAR source indices and 11-bit fixed-point weights
    of one axis: fx in float32, weights rounded from (1 - fx, fx) * 2048.
    The x axis clamps fx to 0 at the borders; the y axis keeps its weights
    and only clamps the rows it reads."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(_F32)
    s0 = np.floor(f).astype(np.int64)
    f = (f - s0.astype(_F32)).astype(_F32)
    if clamp:
        edge = (s0 < 0) | (s0 >= ssize - 1)
        f = np.where(edge, _F32(0), f)
        s0 = np.clip(s0, 0, ssize - 1)
    w0 = np.rint((_F32(1) - f) * _F32(2048)).astype(np.int64)
    w1 = np.rint(f * _F32(2048)).astype(np.int64)
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


def _on_axis(v: np.ndarray, axis: int, ndim: int) -> np.ndarray:
    """A per-position vector broadcast along image axis 0 or 1."""
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


def _ipp_linear_axis(x: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One pass of IPP's float32 bilinear resize: out = fma(f, x1 - x0, x0),
    f the float32 of the float64 fraction, 0 where the index clamps."""
    n_in = x.shape[axis]
    fx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s0 = np.floor(fx)
    f = fx - s0
    s0 = s0.astype(np.int64)
    edge = (s0 < 0) | (s0 >= n_in - 1)
    f = _on_axis(np.where(edge, 0.0, f).astype(_F32), axis, x.ndim)
    s0 = np.clip(s0, 0, n_in - 1)
    x0 = np.take(x, s0, axis)
    x1 = np.take(x, np.minimum(s0 + 1, n_in - 1), axis)
    return fma32(f, x1 - x0, x0)


def _generic_linear_table(n_in: int, n_out: int, area: bool):
    """resizeGeneric's source index and float32 fraction of one axis
    (INTER_LINEAR, or INTER_AREA's bilinear emulation)."""
    scale = 1.0 / (n_out / n_in)
    d = np.arange(n_out)
    if area:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * (n_out / n_in)).astype(_F32)
        f = np.where(f <= 0, _F32(0), f - np.floor(f)).astype(_F32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(_F32)
        s = np.floor(f)
        f = (f - s).astype(_F32)
        s = s.astype(np.int64)
    return s, f


def _resize_generic_linear(x: np.ndarray, w_out: int, h_out: int, area: bool) -> np.ndarray:
    """OpenCV's resizeGeneric bilinear on float32 (HResizeLinear, then
    VResizeLinear): x0*a0 + x1*a1 per axis; the horizontal weights clamp
    at the borders, the vertical ones only the rows they read."""
    h_in, w_in = x.shape[:2]
    sx, fx = _generic_linear_table(w_in, w_out, area)
    low, high = sx < 0, sx >= w_in - 1
    fx = np.where(low | high, _F32(0), fx)
    sx = np.where(low, 0, np.where(high, w_in - 1, sx))
    a0 = _on_axis((_F32(1) - fx).astype(_F32), 1, x.ndim)
    a1 = _on_axis(fx, 1, x.ndim)
    rows = x[:, sx] * a0 + x[:, np.minimum(sx + 1, w_in - 1)] * a1
    rows[:, high] = x[:, sx[high]]
    sy, fy = _generic_linear_table(h_in, h_out, area)
    b0 = _on_axis((_F32(1) - fy).astype(_F32), 0, x.ndim)
    b1 = _on_axis(fy, 0, x.ndim)
    return rows[np.clip(sy, 0, h_in - 1)] * b0 + rows[np.clip(sy + 1, 0, h_in - 1)] * b1


def _area_table(n_in: int, n_out: int, scale: float):
    """computeResizeAreaTab of one axis as (slot, n_out) arrays: source
    index, float32 weight and a mask, slots in OpenCV's order."""
    per = [[] for _ in range(n_out)]
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            per[dx].append((sx1 - 1, (sx1 - fsx1) / cell))
        for sx in range(sx1, sx2):
            per[dx].append((sx, 1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            per[dx].append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
    slots = max(len(p) for p in per)
    idx = np.zeros((slots, n_out), np.int64)
    alpha = np.zeros((slots, n_out), _F32)
    used = np.zeros((slots, n_out), bool)
    for dx, p in enumerate(per):
        for k, (sx, a) in enumerate(p):
            idx[k, dx], alpha[k, dx], used[k, dx] = sx, a, True
    return idx, alpha, used


def _resize_area(x: np.ndarray, w_out: int, h_out: int, sx: float, sy: float) -> np.ndarray:
    """OpenCV's ResizeArea on float32: each source row summed into its
    output columns in table order (buf += S*alpha), rows into the output
    the same way (sum += beta*buf)."""
    xi, xa, xu = _area_table(x.shape[1], w_out, sx)
    yi, ya, yu = _area_table(x.shape[0], h_out, sy)
    buf = np.zeros((x.shape[0], w_out) + x.shape[2:], _F32)
    for k in range(xi.shape[0]):
        term = x[:, xi[k]] * _on_axis(xa[k], 1, x.ndim)
        buf = np.where(_on_axis(xu[k], 1, x.ndim), buf + term, buf)
    out = np.zeros((h_out, w_out) + x.shape[2:], _F32)
    for k in range(yi.shape[0]):
        term = buf[yi[k]] * _on_axis(ya[k], 0, x.ndim)
        out = np.where(_on_axis(yu[k], 0, x.ndim), out + term, out)
    return out


def _resize_area_fast(x: np.ndarray, w_out: int, h_out: int, sx: int, sy: int) -> np.ndarray:
    """OpenCV's resizeAreaFast on float32 for integer factors: a cell's
    values summed four at a time, ((a + b) + c) + d, then times
    1/(sx*sy); one channel at factor 2 on its 4-lane SSE body as ((a + b) +
    (c + d)) * 0.25.  Cells cut by the image edge average what is left."""
    h_in, w_in = x.shape[:2]
    cn = x.shape[2] if x.ndim == 3 else 1
    xx = x.reshape(h_in, w_in, cn)
    full_h, full_w = min(h_out, h_in // sy), min(w_out, w_in // sx)
    cells = [xx[a:a + full_h * sy:sy, b:b + full_w * sx:sx]
             for a in range(sy) for b in range(sx)]
    area = sx * sy
    s = np.zeros((full_h, full_w, cn), _F32)
    k = 0
    while k <= area - 4:
        s = s + (((cells[k] + cells[k + 1]) + cells[k + 2]) + cells[k + 3])
        k += 4
    for c in cells[k:]:
        s = s + c
    out = np.zeros((h_out, w_out, cn), _F32)
    out[:full_h, :full_w] = s * _F32(1.0 / area)
    if cn == 1 and sx == sy == 2:
        vec = full_w // 4 * 4
        quad = (cells[0] + cells[1]) + (cells[2] + cells[3])
        out[:full_h, :vec] = quad[:, :vec] * _F32(0.25)
    edge = [(dy, dx) for dy in range(h_out) for dx in range(w_out)
            if dy >= full_h or dx >= full_w] if (full_h, full_w) != (h_out, w_out) else []
    for dy, dx in edge:
        part = xx[dy * sy:(dy + 1) * sy, dx * sx:(dx + 1) * sx].reshape(-1, cn)
        total = np.zeros(cn, _F32)
        for v in part:
            total = total + v
        out[dy, dx] = total / _F32(len(part)) if len(part) else 0
    return out.reshape((h_out, w_out) + x.shape[2:])


def _cubic_near(x: np.ndarray) -> np.ndarray:
    return 1.25 * x ** 3 - 2.25 * x ** 2 + 1


def _cubic_far(x: np.ndarray) -> np.ndarray:
    return -0.75 * x ** 3 + 3.75 * x ** 2 - 6 * x + 3


def _ipp_cubic_axis(n_in: int, n_out: int):
    """IPP's cubic taps of one axis: source indices (4, n_out), border
    replicated, float32 weights (4, n_out), the border mask and the first
    position past the left border / of the right border.  The weights are
    the cubic (B = 0, C = 0.75) in double at the float32 distances x0 =
    1 + t, x0 - 1, 2 - x0, 3 - x0, t the float32 of the float64 fraction."""
    fx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(fx)
    x0 = _F32(1) + (fx - s).astype(_F32)
    w = np.stack([_cubic_far(x0.astype(np.float64)),
                  _cubic_near((x0 - _F32(1)).astype(np.float64)),
                  _cubic_near((_F32(2) - x0).astype(np.float64)),
                  _cubic_far((_F32(3) - x0).astype(np.float64))]).astype(_F32)
    s = s.astype(np.int64)
    idx = np.clip(s[None] - 1 + np.arange(4)[:, None], 0, n_in - 1)
    low, high = s - 1 < 0, s + 2 > n_in - 1
    first = int(np.argmin(low)) if not low.all() else n_out
    last = int(np.argmax(high)) if high.any() else n_out
    return idx, w, low | high, first, last


def _sum4(x, w, order: str) -> np.ndarray:
    """One of IPP's four-tap sums of taps x[k] * w[k]."""
    p = [x[k] * w[k] for k in range(4)]
    if order == "01+23":
        return (p[0] + p[1]) + (p[2] + p[3])
    if order == "02+13":
        return (p[0] + p[2]) + (p[1] + p[3])
    if order == "f01+f23":
        return fma32(x[0], w[0], p[1]) + fma32(x[2], w[2], p[3])
    if order == "f10+f23":
        return fma32(x[1], w[1], p[0]) + fma32(x[2], w[2], p[3])
    if order == "f03+f12":
        return fma32(x[0], w[0], p[3]) + fma32(x[1], w[1], p[2])
    if order == "1023":
        return fma32(x[3], w[3], fma32(x[2], w[2], fma32(x[0], w[0], p[1])))
    if order == "0123":
        return fma32(x[3], w[3], fma32(x[2], w[2], fma32(x[1], w[1], p[0])))
    raise ValueError(order)


def _resize_cubic_ipp(x: np.ndarray, w_out: int, h_out: int) -> np.ndarray:
    """IPP's float32 cubic resize of a 1- or 3-channel image with both
    sides of at least 4 pixels, found by probing (impulses for the
    weights, random images for the order of the sums):

    - inside, a horizontal pass then a vertical one.  Horizontal, by
      output column from the first unclamped one in groups of four: one
      channel (t0 + t1) + (t2 + t3) with t_k = x_k * w_k, the columns
      left over after the last group (t0 + t2) + (t1 + t3); three
      channels fma(x0, w0, t3) + fma(x1, w1, t2).  Vertical, by element
      of the (W*cn)-float row from the first unclamped pixel in groups of
      four: fma(r0, w0, t1) + fma(r2, w2, t3), the elements left over
      fma(r1, w1, t0) + fma(r2, w2, t3);
    - where a tap clamps (either axis), per pixel: each of the four rows
      a chain of FMAs, taps 0, 1, 2, 3 for rows 0 and 3 and taps 1, 0, 2,
      3 for rows 1 and 2, then (t0 + t2) + (t1 + t3) down the rows."""
    x3 = x.reshape(x.shape[0], x.shape[1], -1)
    h_in, w_in, cn = x3.shape
    xi, xw, xb, left, right = _ipp_cubic_axis(w_in, w_out)
    yi, yw, yb, top, bottom = _ipp_cubic_axis(h_in, h_out)
    cols = [x3[:, xi[k]] for k in range(4)]                  # (h_in, w_out, cn)
    wx = [xw[k][None, :, None] for k in range(4)]
    wy = [yw[k][:, None, None] for k in range(4)]
    col = np.arange(w_out)[None, :, None]
    if cn == 1:
        spare = left + (right - left) // 4 * 4
        rows = np.where((col >= spare) & (col < right), _sum4(cols, wx, "02+13"),
                        _sum4(cols, wx, "01+23"))
    else:
        rows = _sum4(cols, wx, "f03+f12")
    taps = [rows[yi[k]] for k in range(4)]                   # (h_out, w_out, cn)
    elem = col * cn + np.arange(cn)[None, None, :]
    spare = left * cn + (right - left) * cn // 4 * 4
    out = np.where((elem >= spare) & (elem < right * cn), _sum4(taps, wy, "f10+f23"),
                   _sum4(taps, wy, "f01+f23"))
    edge = yb[:, None] | xb[None, :]
    if edge.any():
        chain = {"0123": _sum4(cols, wx, "0123"), "1023": _sum4(cols, wx, "1023")}
        taps = [chain["0123" if k in (0, 3) else "1023"][yi[k]] for k in range(4)]
        out = np.where(edge[..., None], _sum4(taps, wy, "02+13"), out)
    return out.reshape((h_out, w_out) + x.shape[2:])


def _opencv_cubic_axis(n_in: int, n_out: int):
    """resizeGeneric's cubic taps of one axis: source indices (4, n_out),
    border replicated, and interpolateCubic's float32 weights."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(_F32)
    s = np.floor(f)
    t = (f - s).astype(_F32)
    a, one = _F32(-0.75), _F32(1)
    w0 = ((a * (t + one) - _F32(5) * a) * (t + one) + _F32(8) * a) * (t + one) - _F32(4) * a
    w1 = ((a + _F32(2)) * t - (a + _F32(3))) * t * t + one
    w2 = ((a + _F32(2)) * (one - t) - (a + _F32(3))) * (one - t) * (one - t) + one
    w = np.stack([w0, w1, w2, one - w0 - w1 - w2]).astype(_F32)
    idx = np.clip(s.astype(np.int64)[None] - 1 + np.arange(4)[:, None], 0, n_in - 1)
    return idx, w


def _resize_cubic_opencv(x: np.ndarray, w_out: int, h_out: int) -> np.ndarray:
    """OpenCV's own float32 cubic (resizeGeneric: HResizeCubic, then
    VResizeCubic), taken where IPP declines (a side under 4 pixels):
    ((t0 + t1) + t2) + t3 along rows; down columns t0 + (t1 + (t2 + t3))
    on the 4-lane SSE body of a row, ((t0 + t1) + t2) + t3 after it."""
    x3 = x.reshape(x.shape[0], x.shape[1], -1)
    xi, xw = _opencv_cubic_axis(x3.shape[1], w_out)
    yi, yw = _opencv_cubic_axis(x3.shape[0], h_out)
    t = [x3[:, xi[k]] * xw[k][None, :, None] for k in range(4)]
    rows = ((t[0] + t[1]) + t[2]) + t[3]
    t = [rows[yi[k]] * yw[k][:, None, None] for k in range(4)]
    out = (((t[0] + t[1]) + t[2]) + t[3]).reshape(h_out, -1)
    body = out.shape[1] // 4 * 4
    out[:, :body] = (t[0] + (t[1] + (t[2] + t[3]))).reshape(h_out, -1)[:, :body]
    return out.reshape((h_out, w_out) + x.shape[2:])


def resize(img: np.ndarray, dsize, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """cv2.resize(img, dsize=(w, h), interpolation=...) for INTER_LINEAR,
    INTER_CUBIC and INTER_AREA of float32, and INTER_LINEAR of uint8."""
    w_out, h_out = int(dsize[0]), int(dsize[1])
    h_in, w_in = img.shape[:2]
    if interpolation not in (INTER_LINEAR, INTER_CUBIC, INTER_AREA):
        raise ValueError(f"interpolation {interpolation}: 1, 2 or 3")
    if not (img.dtype == np.float32 or (img.dtype == np.uint8 and interpolation == INTER_LINEAR)):
        raise ValueError(f"{img.dtype} with interpolation {interpolation}: float32, or uint8 "
                         "with INTER_LINEAR")
    if (h_out, w_out) == (h_in, w_in):
        return img.copy()
    if img.dtype == np.uint8:
        return _resize_linear_u8(img, w_out, h_out)
    cn = img.shape[2] if img.ndim == 3 else 1
    if interpolation == INTER_CUBIC:
        if min(h_in, w_in) < 4:
            out = _resize_cubic_opencv(img, w_out, h_out)
        elif cn in (1, 3):
            out = _resize_cubic_ipp(img, w_out, h_out)
        else:
            raise ValueError(f"INTER_CUBIC of {cn} channels: 1 or 3")
    elif interpolation == INTER_LINEAR and h_in > 1 and w_in > 1:
        out = _ipp_linear_axis(_ipp_linear_axis(img, w_out, 1), h_out, 0)
    elif interpolation == INTER_LINEAR or w_out > w_in or h_out > h_in:
        out = _resize_generic_linear(img, w_out, h_out, interpolation == INTER_AREA)
    else:
        sx, sy = 1.0 / (w_out / w_in), 1.0 / (h_out / h_in)
        ix, iy = int(round(sx)), int(round(sy))
        eps = np.finfo(np.float64).eps
        if abs(sx - ix) < eps and abs(sy - iy) < eps:
            out = _resize_area_fast(img, w_out, h_out, ix, iy)
        else:
            out = _resize_area(img, w_out, h_out, sx, sy)
    return np.ascontiguousarray(out, dtype=np.float32)


_FLT_EPSILON = _F32(np.finfo(np.float32).eps)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) for float32 RGB in [0, 1]: H in
    [0, 360), S and V in [0, 1]."""
    img = img.astype(_F32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    k = _F32(60.0) / (diff + _FLT_EPSILON)
    red, green = v == r, v == g
    num = np.where(red, g - b, np.where(green, b - r, r - g))
    offset = np.where(red, _F32(0), np.where(green, _F32(120), _F32(240)))
    h = fma32(num, k, offset)
    h = np.where(h < 0, h + _F32(360), h)
    # the 8-lane body of each row folds 360 into a negative red hue's offset
    body = (img.shape[-2] // 8 * 8) if img.ndim >= 2 else 0
    if body:
        fold = red[..., :body] & (g[..., :body] < b[..., :body])
        hv = fma32(num[..., :body], k[..., :body], np.where(fold, _F32(360), offset[..., :body]))
        h[..., :body] = hv
    return np.stack([h, s, v], -1).astype(_F32)


# (b, g, r) picks from tab = [v, p, q, t] by sector (OpenCV's sector_data)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2RGB) for float32 HSV, H in degrees."""
    img = img.astype(_F32)
    h, s, v = img[..., 0] * _F32(6.0 / 360.0), img[..., 1], img[..., 2]
    h = np.fmod(h, _F32(6))
    sector = np.floor(h).astype(np.int64)
    h = (h - sector).astype(_F32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, _F32(0), h).astype(_F32)
    one = _F32(1)
    tab = np.stack([v, v * (one - s), v * fma32(-s, h, one),
                    v * fma32(-s, one - h, one)], -1)
    pick = _SECTORS[sector]                       # (..., 3): b, g, r
    bgr = np.take_along_axis(tab, pick, axis=-1)
    return np.ascontiguousarray(bgr[..., ::-1], dtype=_F32)
