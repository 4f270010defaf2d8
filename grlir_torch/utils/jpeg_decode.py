"""JPEG files decoded in numpy as `cv2.imread` decodes them (libjpeg-turbo
with OpenCV's settings: islow IDCT, fancy upsampling, no block smoothing of
a complete progressive file).

Read: baseline (SOF0), extended sequential (SOF1) and progressive (SOF2)
frames with Huffman coding and 8-bit samples, restart intervals, one, three
or four components (gray, YCbCr or RGB, Adobe APP14 CMYK or YCCK) and any
integral sampling factors (h2v1, h1v2 and h2v2 through libjpeg-turbo's
fancy upsamplers, others by replication).  Arithmetic coding, 12-bit
samples and lossless frames raise NotImplementedError.

cv2's conventions: a colour read asks libjpeg for BGR and a gray read for
`JCS_GRAYSCALE`, which for YCbCr is the Y plane itself (not a gray of the
colour image); four components are read as CMYK and converted by OpenCV's
`icvCvt_CMYK2BGR_8u_C4C3R` / `icvCvt_CMYK2Gray_8u_C4C1R`; the EXIF
orientation tag is applied after decoding.

Entropy decoding is the slow part in Python: each Huffman table becomes a
65,536-entry lookup on a 16-bit peek (code length and symbol in one int),
and the bits are read from precomputed 32-bit windows of the unstuffed
scan data, so that a symbol costs a few list lookups.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from grlir_torch.utils.jpeg import (_CONST_BITS, _PASS1_BITS, _fancy_upsample,
                                    _h1v2_fancy_upsample, _h2v1_fancy_upsample,
                                    _idct_1d, rgb_to_y, ycc_to_rgb)

# jutils.c jpeg_natural_order: the natural index of the k-th zigzag
# coefficient, with libjpeg's 16 extra entries that absorb a corrupt run
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16

_SOF_READ = {0xC0: False, 0xC1: False, 0xC2: True}   # marker -> progressive
_SOF_REFUSED = {0xC3: "lossless (SOF3)", 0xC5: "differential sequential",
                0xC6: "differential progressive", 0xC7: "differential lossless",
                0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
                0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded",
                0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}

# OpenCV's fixed-point gray weights (utils.cpp: SCALE 14)
_CV_SCALE = 14
_CV_R = int(0.299 * (1 << _CV_SCALE) + 0.5)
_CV_G = int(0.587 * (1 << _CV_SCALE) + 0.5)
_CV_B = (1 << _CV_SCALE) - _CV_R - _CV_G


def cv_gray(r, g, b) -> np.ndarray:
    """OpenCV's codec gray (`icvCvt_BGR2Gray_8u_C3C1R`) of uint8 planes."""
    s = (b.astype(np.int64) * _CV_B + g.astype(np.int64) * _CV_G
         + r.astype(np.int64) * _CV_R)
    return ((s + (1 << (_CV_SCALE - 1))) >> _CV_SCALE).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _huffman_lut(counts: bytes, symbols: bytes) -> list:
    """A code-length/symbol table on a 16-bit peek: entry (length << 8) |
    symbol, 0 where no code starts (cached: files of one encoder share
    their tables)."""
    lut = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("JPEG: bad Huffman table")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.q = None          # natural-order table, latched at its first scan
        self.coef = None       # flat list, blocks_h * blocks_w * 64


def _unstuff(data: bytes, start: int):
    """The entropy-coded data from `start` to the next marker that is not
    a restart: (unstuffed bytes, byte offset of each restart segment, end)."""
    parts, seg_starts, n = [], [0], 0
    pos = seg = start
    end = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            break
        m = data[i + 1]
        if m == 0:
            pos = i + 2
        elif m == 0xFF:
            pos = i + 1
        elif 0xD0 <= m <= 0xD7:
            part = data[seg:i].replace(b"\xff\x00", b"\xff")
            parts.append(part)
            n += len(part)
            seg_starts.append(n)
            pos = seg = i + 2
        else:
            end = i
            break
    parts.append(data[seg:end].replace(b"\xff\x00", b"\xff"))
    return b"".join(parts), seg_starts, end


def _windows(buf: bytes) -> list:
    """32-bit big-endian windows starting at every byte (zero-padded)."""
    b = np.frombuffer(buf + b"\0" * 8, np.uint8).astype(np.int64)
    return (b[:-3] << 24 | b[1:-2] << 16 | b[2:-1] << 8 | b[3:]).tolist()


def _decode_scan(frame, comps, tables, ss, se, ah, al, win, seg_starts, restart):
    """Decode one scan's coefficients into each component's `coef` list."""
    progressive = frame["progressive"]
    hmax, vmax = frame["hmax"], frame["vmax"]
    width, height = frame["width"], frame["height"]
    mcus = []
    if len(comps) == 1:                          # non-interleaved: block order
        c = comps[0]
        bw = -(-(-(-width * c.h // hmax)) // 8)
        bh = -(-(-(-height * c.v // vmax)) // 8)
        for by in range(bh):
            for bx in range(bw):
                mcus.append(((0, (by * c.bw + bx) * 64),))
    else:
        mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        for y in range(my):
            for x in range(mx):
                mcus.append(tuple((i, ((y * c.v + v) * c.bw + x * c.h + h) * 64)
                                  for i, c in enumerate(comps)
                                  for v in range(c.v) for h in range(c.h)))
    coefs = [c.coef for c in comps]
    dcs = [tables[("dc", c.td)] if (ss == 0 and ah == 0) or not progressive else None
           for c in comps]
    acs = [tables[("ac", c.ta)] if se > 0 else None for c in comps]
    nat = NATURAL
    preds = [0] * len(comps)
    eobrun, seg = 0, 0
    pos = 0
    p1, m1 = 1 << al, -1 << al
    for m, blocks in enumerate(mcus):
        if restart and m and m % restart == 0:
            seg += 1
            if seg >= len(seg_starts):
                raise ValueError("JPEG: missing restart marker")
            pos = seg_starts[seg] * 8
            preds = [0] * len(comps)
            eobrun = 0
        for ci, base in blocks:
            co = coefs[ci]
            if not progressive:                  # sequential: a whole block
                e = dcs[ci][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                pos += e >> 8
                s = e & 255
                if s:
                    v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    preds[ci] += v
                co[base] = preds[ci]
                ac = acs[ci]
                k = 1
                while k < 64:
                    e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("JPEG: bad Huffman code")
                    pos += e >> 8
                    s = e & 15
                    r = (e >> 4) & 15
                    if s:
                        k += r
                        v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                        pos += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        co[base + nat[k]] = v
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
            elif ss == 0:                        # progressive DC
                if ah == 0:
                    e = dcs[ci][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("JPEG: bad Huffman code")
                    pos += e >> 8
                    s = e & 255
                    if s:
                        v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                        pos += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        preds[ci] += v
                    co[base] = preds[ci] << al
                else:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                        co[base] |= p1
                    pos += 1
            elif ah == 0:                        # progressive AC, first pass
                if eobrun:
                    eobrun -= 1
                    continue
                ac = acs[ci]
                k = ss
                while k <= se:
                    e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("JPEG: bad Huffman code")
                    pos += e >> 8
                    s = e & 15
                    r = (e >> 4) & 15
                    if s:
                        k += r
                        v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                        pos += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        co[base + nat[k]] = v << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                            pos += r
                        eobrun -= 1
                        break
                    k += 1
            else:                                # progressive AC, refinement
                ac = acs[ci]
                k = ss
                if not eobrun:
                    while k <= se:
                        e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError("JPEG: bad Huffman code")
                        pos += e >> 8
                        s = e & 15
                        r = (e >> 4) & 15
                        if s:
                            s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                            pos += 1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                                pos += r
                            break
                        while k <= se:
                            z = base + nat[k]
                            cur = co[z]
                            if cur:
                                if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not cur & p1:
                                    co[z] = cur + (p1 if cur >= 0 else m1)
                                pos += 1
                            else:
                                if r == 0:
                                    break
                                r -= 1
                            k += 1
                        if s:
                            co[base + nat[k]] = s
                        k += 1
                if eobrun:
                    while k <= se:
                        z = base + nat[k]
                        cur = co[z]
                        if cur:
                            if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not cur & p1:
                                co[z] = cur + (p1 if cur >= 0 else m1)
                            pos += 1
                        k += 1
                    eobrun -= 1


def _exif_orientation(body: bytes) -> int:
    """The orientation tag (0x0112) of an APP1 Exif body, 1 if absent."""
    if not body.startswith(b"Exif\0\0") or len(body) < 14:
        return 1
    t = body[6:]
    end = {b"II": "<", b"MM": ">"}.get(t[:2])
    if end is None:
        return 1
    ifd = struct.unpack(end + "I", t[4:8])[0]
    if ifd + 2 > len(t):
        return 1
    n = struct.unpack(end + "H", t[ifd:ifd + 2])[0]
    for i in range(n):
        e = ifd + 2 + 12 * i
        if e + 12 > len(t):
            break
        tag, typ = struct.unpack(end + "HH", t[e:e + 4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(end + "H", t[e + 8:e + 10])[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation (loadsave.cpp) for tags 1-8."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flip:
        img = np.flip(img, flip)
    return np.ascontiguousarray(img)


def _upsample(plane: np.ndarray, c: _Component, frame) -> np.ndarray:
    """jdsample.c's choice of upsampler for one component, to full size."""
    fh, fv = frame["hmax"] // c.h, frame["vmax"] // c.v
    if frame["hmax"] % c.h or frame["vmax"] % c.v:
        raise NotImplementedError("JPEG: non-integral sampling factors")
    w = plane.shape[1]
    if (fh, fv) == (1, 1):
        out = plane
    elif (fh, fv) == (2, 1) and w > 2:
        out = _h2v1_fancy_upsample(plane)
    elif (fh, fv) == (1, 2):
        out = _h1v2_fancy_upsample(plane)
    elif (fh, fv) == (2, 2) and w > 2:
        out = _fancy_upsample(plane)
    else:
        out = np.repeat(np.repeat(plane, fv, 0), fh, 1)
    return out[:frame["height"], :frame["width"]]


def _cmyk_to_cv(cmyk):
    """OpenCV's inverted-CMYK step: (c, m, y) -> k - ((255 - x) * k >> 8)."""
    k = cmyk[3]
    return [k - (((255 - x) * k) >> 8) for x in cmyk[:3]]


def decode(data: bytes, gray: bool = False) -> np.ndarray:
    """A JPEG file as cv2.imread reads it: (H, W, 3) uint8 RGB, or (H, W)
    uint8 for a gray read; the EXIF orientation applied."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI)")
    qtables, tables, frame, comps = {}, {}, None, []
    restart, orientation, jfif, adobe = 0, 1, False, None
    pos = 2
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            break
        marker = data[pos + 1]
        if marker == 0xFF or marker == 0x00:
            pos += 1
            continue
        if marker in (0x01,) or 0xD0 <= marker <= 0xD8:
            pos += 2
            continue
        if marker == 0xD9:
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:                       # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = struct.unpack(">64H", body[i + 1:i + 129])
                    i += 129
                else:
                    vals = tuple(body[i + 1:i + 65])
                    i += 65
                q = np.zeros(64, np.int64)
                q[NATURAL[:64]] = vals
                qtables[tq] = q.reshape(8, 8)
        elif marker == 0xC4:                     # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                n = sum(counts)
                symbols = body[i + 17:i + 17 + n]
                tables[("ac" if tc else "dc", th)] = _huffman_lut(counts, symbols)
                i += 17 + n
        elif marker == 0xDD:                     # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body.startswith(b"JFIF\0"):
            jfif = True
        elif marker == 0xE1 and orientation == 1:
            orientation = _exif_orientation(body)
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]
        elif marker in _SOF_REFUSED:
            raise NotImplementedError(
                f"JPEG: {_SOF_REFUSED[marker]} frames are not read")
        elif marker in _SOF_READ:
            precision, height, width, n = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"JPEG: {precision}-bit samples are not read")
            if height == 0:
                raise NotImplementedError("JPEG: a height set by DNL is not read")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                body[7 + 3 * i] & 15, body[8 + 3 * i]) for i in range(n)]
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.bw, c.bh = mx * c.h, my * c.v
                c.coef = [0] * (c.bw * c.bh * 64)
            frame = {"progressive": _SOF_READ[marker], "width": width,
                     "height": height, "hmax": hmax, "vmax": vmax}
        elif marker == 0xDA:                     # SOS
            if frame is None:
                raise ValueError("JPEG: scan before frame header")
            ns = body[0]
            scomps = []
            for i in range(ns):
                cid, t = body[1 + 2 * i], body[2 + 2 * i]
                c = next(c for c in comps if c.id == cid)
                c.td, c.ta = t >> 4, t & 15
                if c.q is None:
                    c.q = qtables[c.tq]
                scomps.append(c)
            ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            buf, seg_starts, pos = _unstuff(data, pos)
            try:
                _decode_scan(frame, scomps, tables, ss, se, a >> 4, a & 15,
                             _windows(buf), seg_starts, restart)
            except IndexError as e:
                raise ValueError("JPEG: corrupt entropy-coded data") from e
    if frame is None:
        raise ValueError("JPEG: no frame")

    def plane(i):
        c = comps[i]
        coef = np.asarray(c.coef, np.int64).reshape(c.bh, c.bw, 8, 8) * c.q
        ws = _idct_1d(coef.swapaxes(-1, -2), _CONST_BITS - _PASS1_BITS).swapaxes(-1, -2)
        out = np.clip(_idct_1d(ws, _CONST_BITS + _PASS1_BITS + 3) + 128, 0, 255)
        out = out.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        ch = -(-frame["height"] * c.v // frame["vmax"])
        cw = -(-frame["width"] * c.h // frame["hmax"])
        return _upsample(out[:ch, :cw], c, frame)

    n = len(comps)
    if n == 1:
        y = plane(0).astype(np.uint8)
        img = y if gray else np.repeat(y[..., None], 3, axis=-1)
    elif n == 3:
        ids = [c.id for c in comps]
        rgb_space = (not jfif and (adobe == 0 if adobe is not None
                                   else ids == [82, 71, 66]))
        if gray and not rgb_space:
            img = plane(0).astype(np.uint8)
        else:
            p = [plane(i) for i in range(3)]
            if rgb_space:
                img = (rgb_to_y(*p).astype(np.uint8) if gray
                       else np.stack(p, -1).astype(np.uint8))
            else:
                img = ycc_to_rgb(*p)
    elif n == 4:
        p = [plane(i) for i in range(4)]
        if adobe is not None and adobe != 0:     # YCCK -> CMYK (jdcolor.c)
            rgb = ycc_to_rgb(*p[:3]).astype(np.int64)
            p = [255 - rgb[..., 0], 255 - rgb[..., 1], 255 - rgb[..., 2], p[3]]
        c, m, yy = _cmyk_to_cv(p)
        img = (cv_gray(c, m, yy) if gray
               else np.stack([c, m, yy], -1).astype(np.uint8))
    else:
        raise NotImplementedError(f"JPEG: {n} components are not read")
    return apply_orientation(img, orientation)
