"""PGM and PPM files (P2, P3, P5, P6) decoded in numpy as `cv2.imread`
decodes them (OpenCV's PxM codec, grfmt_pxm.cpp).

OpenCV's conventions, held to cv2 in the tests: an ASCII sample above the
maximum is clipped to it; with a maximum below 256, ASCII samples are
rescaled, i * 255 // maxval, and binary bytes are kept as they are; with a
maximum above 255, samples are 16-bit big-endian and keep their high byte.
A gray read of a colour file applies OpenCV's fixed-point weights
(`cv_gray`); a colour read of a gray file repeats it.
"""

from __future__ import annotations

import re

import numpy as np

from grlir_torch.utils.jpeg_decode import cv_gray

_TOKEN = re.compile(rb"\s*(?:#[^\n]*\n\s*)*(\S+)")


def decode(data: bytes, gray: bool = False) -> np.ndarray:
    """A P2/P3/P5/P6 file as cv2.imread reads it: (H, W, 3) uint8 RGB, or
    (H, W) uint8 for a gray read."""
    kind = data[:2]
    if kind not in (b"P2", b"P3", b"P5", b"P6"):
        raise NotImplementedError(f"PNM: {kind!r} files are not read")
    pos, head = 2, []
    for _ in range(3):
        m = _TOKEN.match(data, pos)
        if m is None:
            raise ValueError("PNM: truncated header")
        head.append(int(m.group(1)))
        pos = m.end()
    width, height, maxval = head
    if not 0 < maxval < 65536:
        raise ValueError(f"PNM: maximum {maxval}")
    channels = 3 if kind in (b"P3", b"P6") else 1
    n = width * height * channels
    if kind in (b"P2", b"P3"):
        body = re.sub(rb"#[^\n]*", b" ", data[pos:])
        v = np.array(body.split()[:n], np.int64)
        if v.size < n:
            raise ValueError("PNM: truncated samples")
        v = np.minimum(v, maxval)
        v = v * 255 // maxval if maxval < 256 else v >> 8
    else:
        pos += 1                                   # the one whitespace byte
        dt = np.dtype(">u2") if maxval > 255 else np.dtype("u1")
        v = np.frombuffer(data[pos:pos + n * dt.itemsize], dt)
        if v.size < n:
            raise ValueError("PNM: truncated samples")
        v = v.astype(np.int64) >> 8 if maxval > 255 else v
    px = v.astype(np.uint8).reshape(height, width, channels)
    if channels == 1:
        return px[..., 0] if gray else np.repeat(px, 3, axis=-1)
    return cv_gray(px[..., 0], px[..., 1], px[..., 2]) if gray else px
