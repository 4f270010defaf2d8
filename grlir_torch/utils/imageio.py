"""Image files with numpy, zlib and struct only: the port's replacement for
`cv2.imread` / `cv2.imwrite`, which the GPU machine does not have.

`imread` reads every format that grlir's datasets and server read through
`cv2.imread`, chosen by the file's first bytes as cv2 chooses, not by its
extension: PNG here, JPEG (`jpeg_decode`), BMP (`bmp`), TIFF (`tiff`) and
PGM/PPM (`pnm`) in sibling modules.  Each returns what
`grlir.data.base.imread` returns, bit for bit: cv2's IMREAD_COLOR read as
RGB, or its IMREAD_GRAYSCALE read, which each codec converts its own way
(libpng's weights here, libjpeg's Y plane for YCbCr JPEG, OpenCV's
fixed-point weights for BMP, TIFF and PNM).  Other formats raise
NotImplementedError.

PNG: every colour type (gray, RGB, palette, gray + alpha, RGBA) at bit
depths 8 and 16, non-interlaced or Adam7 (each pass unfiltered on its own),
all five row filters.  16-bit samples keep their high byte, alpha is
dropped, gray is repeated into three channels, and colour becomes gray by
libpng's fixed-point weights (9797, 19234, 3737) / 2^15, truncated for
8-bit samples and rounded at 16 bits before the high byte is kept.

`imwrite` writes uint8 gray, RGB or RGBA as PNG (filter 0, zlib level 6).
"""

from __future__ import annotations

import os.path as osp
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# libpng's png_set_rgb_to_gray(1, 0.299, 0.587) weights, in 1/2^15
GRAY_WEIGHTS = (9797, 19234, 3737)
# samples per pixel of each PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# (x0, y0, dx, dy) of the seven Adam7 passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unsupported(path: str, what: str):
    return NotImplementedError(
        f"{path}: {what} is not read by the port's imageio (PNG, JPEG, BMP, "
        "TIFF, PGM/PPM)")


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (height, stride) uint8 scanlines."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"image data holds {rows.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: a running sum per byte lane, mod 256
            pad = -stride % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:      # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            f, up = line.tolist(), prior.tolist()
            cur_l = [0] * stride
            for i in range(stride):
                left = cur_l[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_l[i] = (f[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {ftype}")
        out[y] = cur
        prior = cur
    return out


def _samples(scan: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """(H, stride) scanlines -> (H, W, channels) samples (uint8 or uint16)."""
    h = scan.shape[0]
    if depth == 16:
        s = scan.reshape(h, width * channels, 2)
        return ((s[..., 0].astype(np.uint16) << 8) | s[..., 1]).reshape(h, width, channels)
    return scan.reshape(h, width, channels)


def _decode_png(path: str, data: bytes) -> np.ndarray:
    """A PNG file's pixels as (H, W, C) RGB(A)/gray samples, uint8 or
    uint16, palette expanded."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise _unsupported(path, f"PNG colour type {ctype} at bit depth {depth}")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        px = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            n = ph * (pw * bpp + 1)
            scan = _unfilter(raw[pos:pos + n], ph, pw * bpp, bpp)
            px[y0::dy, x0::dx] = _samples(scan, pw, depth, channels)
            pos += n
    else:
        px = _samples(_unfilter(raw, height, width * bpp, bpp), width, depth, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[px[..., 0]]
    return px


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's rgb_to_gray as cv2 uses it (see the module docstring)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    wr, wg, wb = GRAY_WEIGHTS
    s = wr * r + wg * g + wb * b
    if rgb.dtype == np.uint16:
        return ((s + 16384) >> 15).astype(np.uint16)
    return (s >> 15).astype(np.uint8)


def _decoder(data: bytes):
    """The decode function of a non-PNG file by its magic bytes, as
    cv2's codec search by signature, or None."""
    if data[:3] == b"\xff\xd8\xff":
        from grlir_torch.utils.jpeg_decode import decode
    elif data[:2] == b"BM":
        from grlir_torch.utils.bmp import decode
    elif data[:4] in (b"II*\0", b"MM\0*"):
        from grlir_torch.utils.tiff import decode
    elif data[:1] == b"P" and data[1:2] in b"123456" and len(data) > 2 and data[2:3].isspace():
        from grlir_torch.utils.pnm import decode
    else:
        return None
    return decode


def imread(path: str, num_channels: int = 3, jpeg_gray_y: bool = False) -> np.ndarray:
    """An image file as uint8 HWC: RGB for num_channels 3, (H, W, 1) gray
    for 1 (the Y channel of the colour image when jpeg_gray_y, as
    `grlir.data.base.imread`)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        decoder = _decoder(data)
        if decoder is None:
            raise _unsupported(path, f"a file starting {data[:8]!r}")
        gray = num_channels == 1 and not jpeg_gray_y
        img = decoder(data, gray)
        if gray:
            return img[..., None]
        return rgb2ycbcr_y(img)[..., None] if num_channels == 1 else img
    px = _decode_png(path, data)
    color = px.shape[-1] >= 3
    if num_channels == 1 and not jpeg_gray_y:
        gray = _to_gray(px[..., :3]) if color else px[..., 0]
        if gray.dtype == np.uint16:
            gray = (gray >> 8).astype(np.uint8)
        return gray[..., None]
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    rgb = px[..., :3] if color else np.repeat(px[..., :1], 3, axis=-1)
    rgb = np.ascontiguousarray(rgb)
    if num_channels == 1:
        return rgb2ycbcr_y(rgb)[..., None]
    return rgb


def rgb2ycbcr_y(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> MATLAB BT.601 Y, uint8 (grlir.data.base.rgb2ycbcr_np)."""
    y = img.astype(np.float32) @ np.array([65.481, 128.553, 24.966], np.float32) / 255.0 + 16.0
    return np.round(y).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write uint8 (H, W), (H, W, 1), (H, W, 3) RGB or (H, W, 4) RGBA as a
    PNG file."""
    if not path.lower().endswith(".png"):
        raise NotImplementedError(f"{path}: the port's imwrite writes PNG only, "
                                  f"not {osp.splitext(path)[1]!r}")
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"imwrite takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4):
        raise ValueError(f"imwrite takes (H, W[, 1|3|4]), got {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], axis=1)
    ctype = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
