"""BMP files decoded in numpy as `cv2.imread` decodes them (OpenCV's own
BMP codec, grfmt_bmp.cpp).

Read: the Windows info headers (40 bytes and the larger V2-V5 forms) and
the OS/2 12-byte header; 1, 4 and 8 bits through a palette, 16 bits (5-5-5,
or 5-6-5 by BI_BITFIELDS masks), 24 and 32 bits (BI_RGB, or BI_BITFIELDS,
which OpenCV reads as B, G, R, X bytes whatever the masks); RLE8 and RLE4
with OpenCV's handling of end-of-line, end-of-file and delta codes (skipped
pixels take palette entry 0); bottom-up and top-down rows.

A gray read converts by OpenCV's fixed-point weights (`cv_gray`): the
palette is converted first (`CvtPaletteToGray`), 16-bit pixels after their
5-bit fields are shifted into bytes without replication.
"""

from __future__ import annotations

import struct

import numpy as np

from grlir_torch.utils.jpeg_decode import cv_gray

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def _rle(data: bytes, pos: int, width: int, height: int, bits: int) -> np.ndarray:
    """OpenCV's RLE8 / RLE4 decoder on palette indices: (height, width) in
    file row order; pixels no code writes keep index 0, as OpenCV fills
    them with palette entry 0."""
    idx = np.zeros((height, width), np.int64)
    x = y = 0
    wrapped = 0          # OpenCV's line_end_flag: the last run ended a line
    n = len(data)
    while True:
        if pos + 2 > n:
            raise ValueError("BMP: RLE data ends without an end-of-bitmap code")
        count, code = data[pos], data[pos + 1]
        pos += 2
        if count:                                # encoded run
            if x + count > width:
                raise ValueError("BMP: RLE run crosses the end of a row")
            if bits == 8:
                idx[y, x:x + count] = code
            else:
                idx[y, x:x + count:2] = code >> 4
                idx[y, x + 1:x + count:2] = code & 15
            x += count
            if bits == 8 and x >= width:         # RLE8 wraps to the next row
                x, y, wrapped = 0, y + 1, 1
                if y >= height:
                    break
            else:
                wrapped = 0
        elif code > 2:                           # absolute run
            if x + code > width:
                raise ValueError("BMP: RLE run crosses the end of a row")
            if bits == 8:
                size = (code + 1) & ~1
                idx[y, x:x + code] = np.frombuffer(data[pos:pos + code], np.uint8)
            else:
                size = (((code + 1) >> 1) + 1) & ~1
                b = np.frombuffer(data[pos:pos + (code + 1) // 2], np.uint8)
                idx[y, x:x + code] = np.stack([b >> 4, b & 15], -1).reshape(-1)[:code]
            pos += size
            x += code
            wrapped = 0
        else:                                    # 0 end of row, 1 end, 2 delta
            skip, rows = width - x, height - y
            if bits == 4 or code or not wrapped or skip < width:
                if code == 2:
                    skip, rows = data[pos], data[pos + 1]
                    pos += 2
                if code != 0:
                    skip += rows * width
                if y >= height:
                    break
                while True:                      # FillUniColor: index 0
                    step = min(skip, width - x)
                    x += step
                    skip -= step
                    if x >= width:
                        x, y = 0, y + 1
                        if y >= height:
                            break
                    if skip <= 0:
                        break
            wrapped = 0
            if y >= height:
                break
    return idx


def decode(data: bytes, gray: bool = False) -> np.ndarray:
    """A BMP file as cv2.imread reads it: (H, W, 3) uint8 RGB, or (H, W)
    uint8 for a gray read."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset, size = struct.unpack("<I", data[10:14])[0], struct.unpack("<I", data[14:18])[0]
    palette = np.zeros((256, 3), np.uint8)          # B, G, R
    if size >= 36:
        width, height, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
        clrused = struct.unpack("<I", data[46:50])[0]
        after = 14 + size
        entry = 4
    elif size == 12:
        width, height, _, bits = struct.unpack("<HHHH", data[18:26])
        width, height = int(np.int16(width)), int(np.int16(height))
        comp, clrused, after, entry = BI_RGB, 0, 26, 3
    else:
        raise ValueError(f"BMP: info header of {size} bytes")
    top_down = height < 0
    height = abs(height)
    allowed = ((bits in (1, 4, 8, 24, 32) and comp == BI_RGB)
               or (bits in (16, 32) and comp in (BI_RGB, BI_BITFIELDS))
               or (bits == 4 and comp == BI_RLE4) or (bits == 8 and comp == BI_RLE8))
    if width <= 0 or height == 0 or not allowed:
        raise NotImplementedError(f"BMP: {bits} bits with compression {comp} is not read")
    if bits <= 8:
        count = clrused if clrused else 1 << bits
        if count > 256:
            raise ValueError("BMP: palette of more than 256 entries")
        raw = np.frombuffer(data[after:after + count * entry], np.uint8)
        palette[:len(raw) // entry] = raw.reshape(-1, entry)[:, :3]
    rgb565 = False
    if bits == 16 and comp == BI_BITFIELDS:
        red, green, blue = struct.unpack("<III", data[after:after + 12])
        if (red, green, blue) == (0xF800, 0x7E0, 0x1F):
            rgb565 = True
        elif (red, green, blue) != (0x7C00, 0x3E0, 0x1F):
            raise NotImplementedError("BMP: 16-bit masks other than 5-5-5 and 5-6-5")

    if comp in (BI_RLE8, BI_RLE4):
        rows = _rle(data, offset, width, height, bits)
        bgr = palette[rows]
    else:
        stride = (width * bits + 31) // 32 * 4
        raw = np.frombuffer(data[offset:offset + stride * height], np.uint8)
        if raw.size < stride * height:
            raise ValueError("BMP: truncated pixel data")
        raw = raw.reshape(height, stride)
        if bits <= 8:
            per = 8 // bits
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)[:per]
            ix = ((raw[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(height, -1)
            bgr = palette[ix[:, :width]]
        elif bits == 16:
            v = raw[:, :width * 2].view("<u2").astype(np.int64)
            if rgb565:
                b, g, r = (v << 3) & 0xF8, (v >> 3) & 0xFC, (v >> 8) & 0xF8
            else:
                b, g, r = (v << 3) & 0xF8, (v >> 2) & 0xF8, (v >> 7) & 0xF8
            bgr = np.stack([b, g, r], -1).astype(np.uint8)
        else:
            bgr = raw[:, :width * bits // 8].reshape(height, width, bits // 8)[..., :3]
    if not top_down:
        bgr = bgr[::-1]
    if gray:
        if bits <= 8:                             # CvtPaletteToGray, then look up
            gpal = cv_gray(palette[:, 2], palette[:, 1], palette[:, 0])
            ix = rows if comp in (BI_RLE8, BI_RLE4) else ix[:, :width]
            g = gpal[ix]
            return np.ascontiguousarray(g if top_down else g[::-1])
        return cv_gray(bgr[..., 2], bgr[..., 1], bgr[..., 0])
    return np.ascontiguousarray(bgr[..., ::-1])
