"""TIFF files decoded in numpy as `cv2.imread` decodes them: OpenCV reads
an 8-bit result through libtiff's RGBA interface (`TIFFReadRGBAStrip` /
`TIFFReadRGBATile`) and then drops alpha or converts to gray.

Read: the first image of a little- or big-endian classic TIFF, in strips
or tiles, uncompressed, LZW (with horizontal predictor 2), PackBits or
Deflate; 8 or 16 bits a sample; gray (min-is-black), RGB and RGB with an
alpha sample, interleaved.  JPEG-in-TIFF, other compressions, planar
(separate) samples, palettes and other photometric interpretations raise
NotImplementedError.

libtiff's 8-bit conversions (tif_getimage.c): a 16-bit gray sample keeps
its high byte (`put16bitbwtile`); a 16-bit colour or alpha sample becomes
(v + 128) // 257 (`BuildMapBitdepth16To8`); colour with unassociated alpha
is premultiplied, (c * a + 127) // 255 (`UaToAa`).  A gray read then
applies OpenCV's fixed-point weights to the RGB (`cv_gray`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from grlir_torch.utils.jpeg_decode import cv_gray

_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 16: 8}
NONE, LZW, OJPEG, JPEG, DEFLATE, PACKBITS, ADOBE_DEFLATE = 1, 5, 6, 7, 8, 32773, 32946


def _ifd(data: bytes, end: str) -> dict:
    """The first IFD's tags: {tag: tuple of values}."""
    off = struct.unpack(end + "I", data[4:8])[0]
    n = struct.unpack(end + "H", data[off:off + 2])[0]
    tags = {}
    for i in range(n):
        e = off + 2 + 12 * i
        tag, typ, count = struct.unpack(end + "HHI", data[e:e + 8])
        if typ not in _TYPES:
            continue
        size = _SIZES[typ] * count
        where = e + 8 if size <= 4 else struct.unpack(end + "I", data[e + 8:e + 12])[0]
        raw = data[where:where + size]
        if typ == 2:
            tags[tag] = (raw.rstrip(b"\0").decode("latin-1"),)
        else:
            fmt = _TYPES[typ]
            tags[tag] = struct.unpack(end + fmt * count, raw)
    return tags


def _lzw(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, clear 256, end 257, the
    code width growing one code early."""
    b = np.frombuffer(data + b"\0" * 8, np.uint8).astype(np.int64)
    win = (b[:-3] << 24 | b[1:-2] << 16 | b[2:-1] << 8 | b[3:]).tolist()
    total = len(data) * 8
    out = []
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, pos, prev = 9, 0, None
    while pos + nbits <= total:
        code = (win[pos >> 3] >> (32 - (pos & 7) - nbits)) & ((1 << nbits) - 1)
        pos += nbits
        if code == 256:
            del table[258:]
            nbits, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("TIFF: bad LZW code")
            if len(table) >= (1 << nbits) - 1 and nbits < 12:
                nbits += 1
        out.append(entry)
        prev = entry
    return b"".join(out)


def _packbits(data: bytes) -> bytes:
    out, i, n = [], 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out.append(data[i:i + h + 1])
            i += h + 1
        elif h > 128:
            out.append(data[i:i + 1] * (257 - h))
            i += 1
    return b"".join(out)


def _decompress(raw: bytes, comp: int) -> bytes:
    if comp == NONE:
        return raw
    if comp == LZW:
        return _lzw(raw)
    if comp == PACKBITS:
        return _packbits(raw)
    if comp in (DEFLATE, ADOBE_DEFLATE):
        return zlib.decompress(raw)
    if comp in (OJPEG, JPEG):
        raise NotImplementedError("TIFF: JPEG-compressed TIFF is not read")
    raise NotImplementedError(f"TIFF: compression {comp} is not read")


def _samples(buf: bytes, rows: int, cols: int, spp: int, dtype, predictor: int):
    """A strip's or tile's decompressed bytes as (rows, cols, spp) ints,
    horizontal differencing undone."""
    need = rows * cols * spp * dtype.itemsize
    if len(buf) < need:
        raise ValueError("TIFF: strip or tile shorter than its pixels")
    px = np.frombuffer(buf[:need], dtype).reshape(rows, cols, spp)
    if predictor == 2:
        px = np.cumsum(px, axis=1, dtype=dtype)
    elif predictor != 1:
        raise NotImplementedError(f"TIFF: predictor {predictor} is not read")
    return px


def decode(data: bytes, gray: bool = False) -> np.ndarray:
    """A TIFF file as cv2.imread reads it: (H, W, 3) uint8 RGB, or (H, W)
    uint8 for a gray read."""
    end = {b"II": "<", b"MM": ">"}.get(data[:2])
    if end is None or struct.unpack(end + "H", data[2:4])[0] != 42:
        raise NotImplementedError("not a classic TIFF file (BigTIFF is not read)")
    t = _ifd(data, end)
    width, height = t[256][0], t[257][0]
    spp = t.get(277, (1,))[0]
    bits = t.get(258, (1,) * spp)
    comp = t.get(259, (NONE,))[0]
    photo = t.get(262, (None,))[0]
    predictor = t.get(317, (1,))[0]
    if t.get(284, (1,))[0] != 1:
        raise NotImplementedError("TIFF: planar (separate) samples are not read")
    if t.get(274, (1,))[0] != 1:
        raise NotImplementedError("TIFF: an orientation other than top-left is not read")
    if any(v != 1 for v in t.get(339, (1,))):
        raise NotImplementedError("TIFF: samples that are not unsigned integers")
    if len(set(bits)) != 1 or bits[0] not in (8, 16):
        raise NotImplementedError(f"TIFF: {bits} bits a sample is not read")
    colour = {(1, 1): False, (2, 3): True, (2, 4): True}.get((photo, spp))
    if colour is None:
        raise NotImplementedError(
            f"TIFF: photometric {photo} with {spp} samples is not read")
    dtype = np.dtype(end + ("u1" if bits[0] == 8 else "u2"))
    img = np.zeros((height, width, spp), dtype)
    if 322 in t:                                    # tiles
        tw, tl = t[322][0], t[323][0]
        across = -(-width // tw)
        for i, (o, n) in enumerate(zip(t[324], t[325])):
            ty, tx = (i // across) * tl, (i % across) * tw
            if ty >= height:
                break
            tile = _samples(_decompress(data[o:o + n], comp), tl, tw, spp, dtype, predictor)
            h, w = min(tl, height - ty), min(tw, width - tx)
            img[ty:ty + h, tx:tx + w] = tile[:h, :w]
    else:                                           # strips
        rps = min(t.get(278, (height,))[0], height)
        for i, (o, n) in enumerate(zip(t[273], t[279])):
            y0 = i * rps
            if y0 >= height:
                break
            rows = min(rps, height - y0)
            img[y0:y0 + rows] = _samples(_decompress(data[o:o + n], comp),
                                         rows, width, spp, dtype, predictor)
    v = img.astype(np.int64)
    if not colour:
        g = v[..., 0] >> 8 if bits[0] == 16 else v[..., 0]
        g = g.astype(np.uint8)
        return g if gray else np.repeat(g[..., None], 3, axis=-1)
    if bits[0] == 16:
        v = (v + 128) // 257
    rgb = v[..., :3]
    extra = t.get(338, (0,))[0] if spp == 4 else None
    if extra == 2:                                  # unassociated alpha
        rgb = (rgb * v[..., 3:4] + 127) // 255
    rgb = rgb.astype(np.uint8)
    if gray:
        return cv_gray(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    return np.ascontiguousarray(rgb)
