"""The JPEG round trip of the BSR degradation (encode at a quality, decode)
in integer numpy, as libjpeg-turbo computes it with OpenCV's settings:
baseline, 4:2:0 chroma, the islow DCT, standard tables scaled by
`jpeg_quality_scaling`, fancy upsampling.  Entropy coding is lossless and
is left out; everything that rounds is kept:

1. RGB -> YCbCr in 16-bit fixed point (jccolor.c);
2. 2x2 chroma averaging with the alternating 1, 2 bias (jcsample.c
   h2v2_downsample), the image's edges replicated to whole MCUs as
   jcprepct.c/jcsample.c replicate them;
3. islow forward DCT (jfdctint.c) and quantization by reciprocal
   multiplication (jcdctmgr.c, the 16-bit SIMD build's divisors);
4. dequantization and islow inverse DCT with its range limit
   (jidctint.c);
5. h2v2 fancy (triangle) upsampling with its +8/+7 biases and replicated
   context rows (jdsample.c, jdmainct.c), or plain 2x2 replication where
   the chroma is at most 2 samples wide;
6. YCbCr -> RGB in fixed point (jdcolor.c).

A one-component (grayscale) image takes steps 3 and 4 alone, with the
luminance table (`jpeg_roundtrip_gray`).  tests/test_torch_bsr.py holds
`jpeg_roundtrip` and tests/test_torch_jpeg.py `jpeg_roundtrip_gray`
bit-equal to `cv2.imdecode(cv2.imencode(".jpg", ...))`.
"""

from __future__ import annotations

import numpy as np

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix16(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


# jcparam.c's tables, natural order
_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
_STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int64).reshape(8, 8)


def quant_table(quality: int, chroma: bool) -> np.ndarray:
    """jpeg_set_quality(quality, force_baseline=TRUE): the (8, 8) table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    t = ((_STD_CHROMA if chroma else _STD_LUMA) * scale + 50) // 100
    return np.clip(t, 1, 255)


def _divisors(q: np.ndarray):
    """jcdctmgr.c compute_reciprocal for the islow divisors q * 8 with
    16-bit DCTELEMs: (reciprocal, correction, shift) tables with
    quantize(x) = sign(x) * (((|x| + corr) * recip) >> shift)."""
    recip = np.empty(64, np.int64)
    corr = np.empty(64, np.int64)
    shift = np.empty(64, np.int64)
    for i, d in enumerate((q.reshape(-1) * 8).tolist()):
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return recip.reshape(8, 8), corr.reshape(8, 8), shift.reshape(8, 8)


# jfdctint.c / jidctint.c constants, CONST_BITS 13
_CONST_BITS, _PASS1_BITS = 13, 2
F_0_298631336, F_0_390180644, F_0_541196100 = 2446, 3196, 4433
F_0_765366865, F_0_899976223, F_1_175875602 = 6270, 7373, 9633
F_1_501321110, F_1_847759065, F_1_961570560 = 12299, 15137, 16069
F_2_053119869, F_2_562915447, F_3_072711026 = 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, first: bool):
    """One pass of jpeg_fdct_islow along the last axis of int64 `d`."""
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    if first:
        out[..., 0] = (tmp10 + tmp11) << _PASS1_BITS
        out[..., 4] = (tmp10 - tmp11) << _PASS1_BITS
        n = _CONST_BITS - _PASS1_BITS
    else:
        out[..., 0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[..., 4] = _descale(tmp10 - tmp11, _PASS1_BITS)
        n = _CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * F_0_541196100
    out[..., 2] = _descale(z1 + tmp13 * F_0_765366865, n)
    out[..., 6] = _descale(z1 - tmp12 * F_1_847759065, n)

    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F_1_175875602
    tmp4, tmp5 = tmp4 * F_0_298631336, tmp5 * F_2_053119869
    tmp6, tmp7 = tmp6 * F_3_072711026, tmp7 * F_1_501321110
    z1, z2 = z1 * -F_0_899976223, z2 * -F_2_562915447
    z3, z4 = z3 * -F_1_961570560 + z5, z4 * -F_0_390180644 + z5
    out[..., 7] = _descale(tmp4 + z1 + z3, n)
    out[..., 5] = _descale(tmp5 + z2 + z4, n)
    out[..., 3] = _descale(tmp6 + z2 + z3, n)
    out[..., 1] = _descale(tmp7 + z1 + z4, n)
    return out


def _idct_1d(d, n: int):
    """One pass of jpeg_idct_islow along the last axis of int64 `d`,
    outputs descaled by n bits."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * F_0_541196100
    tmp2 = z1 - z3 * F_1_847759065
    tmp3 = z1 + z2 * F_0_765366865
    tmp0 = (d[..., 0] + d[..., 4]) << _CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * F_1_175875602
    tmp0, tmp1 = tmp0 * F_0_298631336, tmp1 * F_2_053119869
    tmp2, tmp3 = tmp2 * F_3_072711026, tmp3 * F_1_501321110
    z1, z2 = z1 * -F_0_899976223, z2 * -F_2_562915447
    z3, z4 = z3 * -F_1_961570560 + z5, z4 * -F_0_390180644 + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4

    out = np.empty_like(d)
    out[..., 0] = _descale(tmp10 + tmp3, n)
    out[..., 7] = _descale(tmp10 - tmp3, n)
    out[..., 1] = _descale(tmp11 + tmp2, n)
    out[..., 6] = _descale(tmp11 - tmp2, n)
    out[..., 2] = _descale(tmp12 + tmp1, n)
    out[..., 5] = _descale(tmp12 - tmp1, n)
    out[..., 3] = _descale(tmp13 + tmp0, n)
    out[..., 4] = _descale(tmp13 - tmp0, n)
    return out


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8a, 8b) -> (a, b, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _unblocks(blocks: np.ndarray) -> np.ndarray:
    a, b = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(a * 8, b * 8)


def _code_plane(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Samples (multiples of 8 on both axes) -> the decoded samples: level
    shift, fdct, quantize, dequantize, idct, range limit."""
    x = _blocks(plane) - 128
    coef = _fdct_1d(_fdct_1d(x, True).swapaxes(-1, -2), False).swapaxes(-1, -2)
    recip, corr, shift = _divisors(q)
    mag = ((np.abs(coef) + corr) * recip) >> shift
    quant = np.where(coef < 0, -mag, mag)
    deq = quant * q
    ws = _idct_1d(deq.swapaxes(-1, -2), _CONST_BITS - _PASS1_BITS).swapaxes(-1, -2)
    out = _idct_1d(ws, _CONST_BITS + _PASS1_BITS + 3)
    return np.clip(_unblocks(out) + 128, 0, 255)


def _replicate(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Extend a plane to (rows, cols) by repeating its last row and column."""
    h, w = plane.shape
    return plane[np.minimum(np.arange(rows), h - 1)][:, np.minimum(np.arange(cols), w - 1)]


def _fancy_upsample(c: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample of a (h, w) chroma plane, w >= 2, its
    context rows replicated at the top and bottom: (2h, 2w)."""
    h, w = c.shape
    up = c[np.maximum(np.arange(h) - 1, 0)]
    down = c[np.minimum(np.arange(h) + 1, h - 1)]
    out = np.empty((2 * h, 2 * w), np.int64)
    for v, near in ((0, up), (1, down)):
        s = 3 * c + near                          # column sums
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        even = (3 * s + left + 8) >> 4
        odd = (3 * s + right + 7) >> 4
        even[:, 0] = (4 * s[:, 0] + 8) >> 4
        odd[:, -1] = (4 * s[:, -1] + 7) >> 4
        out[v::2, 0::2] = even
        out[v::2, 1::2] = odd
    return out


def _h2v1_fancy_upsample(c: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample of a (h, w) plane, w >= 2: (h, 2w),
    each output 3/4 of its nearer and 1/4 of its further input sample."""
    left = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    even = (3 * c + left + 1) >> 2
    odd = (3 * c + right + 2) >> 2
    even[:, 0] = c[:, 0]
    odd[:, -1] = c[:, -1]
    out = np.empty((c.shape[0], 2 * c.shape[1]), np.int64)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _h1v2_fancy_upsample(c: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's h1v2_fancy_upsample of a (h, w) plane, its context
    rows replicated at the top and bottom: (2h, w)."""
    h = c.shape[0]
    up = c[np.maximum(np.arange(h) - 1, 0)]
    down = c[np.minimum(np.arange(h) + 1, h - 1)]
    out = np.empty((2 * h, c.shape[1]), np.int64)
    out[0::2] = (3 * c + up + 1) >> 2
    out[1::2] = (3 * c + down + 2) >> 2
    return out


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert of int planes (Cb, Cr centred on 128):
    (H, W, 3) uint8 RGB."""
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix16(1.40200) * cr + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_fix16(0.34414) * cb + _ONE_HALF - _fix16(0.71414) * cr) >> _SCALEBITS)
    b = y + ((_fix16(1.77200) * cb + _ONE_HALF) >> _SCALEBITS)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def rgb_to_y(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """jccolor.c's (and jdcolor.c rgb_gray_convert's) luma of int planes."""
    return (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b
            + _ONE_HALF) >> _SCALEBITS


def jpeg_roundtrip(rgb: np.ndarray, quality: int) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> the uint8 RGB image that a JPEG encode at
    `quality` and a decode give."""
    h, w = rgb.shape[:2]
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    y = rgb_to_y(r, g, b)
    center = (128 << _SCALEBITS) + _ONE_HALF - 1
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + center) >> _SCALEBITS
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + center) >> _SCALEBITS

    # luma: whole 8x8 blocks, edges replicated
    hl, wl = -(-h // 8) * 8, -(-w // 8) * 8
    y_dec = _code_plane(_replicate(y, hl, wl), quant_table(quality, False))[:h, :w]

    # chroma: rows to an even count and columns to whole chroma blocks,
    # 2x2 means with the alternating bias, then downsampled rows to whole
    # blocks, each step replicating the last row or column
    hc, wc = -(-h // 2), -(-w // 2)
    wcb = -(-w // 16) * 8
    bias = np.where(np.arange(wcb) % 2 == 0, 1, 2)
    qc = quant_table(quality, True)
    chroma = []
    for p in (cb, cr):
        p = _replicate(p, 2 * hc, 2 * wcb)
        d = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
        d = _replicate(d, -(-hc // 8) * 8, wcb)
        dec = _code_plane(d, qc)[:hc, :wc]
        if wc > 2:
            up = _fancy_upsample(dec)
        else:
            up = np.repeat(np.repeat(dec, 2, 0), 2, 1)
        chroma.append(up[:h, :w])
    return ycc_to_rgb(y_dec, *chroma)


def jpeg_roundtrip_gray(gray: np.ndarray, quality: int) -> np.ndarray:
    """(H, W) uint8 -> the uint8 image that a one-component (grayscale)
    JPEG encode at `quality` and a decode give: the luminance table, no
    colour transform and no subsampling, edges replicated to whole
    blocks."""
    h, w = gray.shape
    plane = _replicate(gray.astype(np.int64), -(-h // 8) * 8, -(-w // 8) * 8)
    return _code_plane(plane, quant_table(quality, False))[:h, :w].astype(np.uint8)


def jpeg_float(img: np.ndarray, quality: int) -> np.ndarray:
    """The BSR pipeline's JPEG step on a float RGB image in [0, 1]: rounded
    to 8 bits, round-tripped, back to float32 in [0, 1]."""
    u8 = np.uint8((np.clip(img, 0, 1) * 255.0).round())
    return jpeg_roundtrip(u8, quality).astype(np.float32) / 255.0
