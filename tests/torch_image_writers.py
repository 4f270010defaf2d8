"""Writers of the image variants that cv2 and PIL do not write: BMP at 1,
4, 8, 16, 24 and 32 bits with palettes, bitfields, RLE8/RLE4 and either
row order; TIFF in strips or tiles, uncompressed, LZW, PackBits or
Deflate, with or without the horizontal predictor, in either byte order;
Adam7 PNG with every row filter.  cv2 is the oracle that decodes them
(tests/test_torch_imageio_formats.py)."""

import struct
import zlib

import numpy as np


def bmp(px, bits, palette=None, top_down=False, comp=0, masks=None, rle=None,
        header=40) -> bytes:
    """px: (H, W) palette indices for bits <= 8, (H, W) uint16 for 16 bits,
    (H, W, 3 or 4) B, G, R(, X) bytes for 24 and 32; rle: the RLE8/RLE4
    pixel data (comp 1 or 2) in place of the rows."""
    a = np.asarray(px)
    h, w = a.shape[:2]
    rows = a if top_down else a[::-1]
    stride = (w * bits + 31) // 32 * 4
    if rle is not None:
        body = rle
    elif bits <= 8:
        per = 8 // bits
        out = np.zeros((h, stride), np.uint8)
        for x in range(w):
            shift = 8 - bits - (x % per) * bits
            out[:, x // per] |= (rows[:, x].astype(np.uint8) << shift).astype(np.uint8)
        body = out.tobytes()
    else:
        out = np.zeros((h, stride), np.uint8)
        if bits == 16:
            out[:, :w * 2] = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            out[:, :w * bits // 8] = rows.reshape(h, -1)
        body = out.tobytes()
    pal = b"" if palette is None else b"".join(bytes([b, g, r, 0]) for b, g, r in palette)
    extra = b"" if masks is None else struct.pack("<III", *masks)
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, comp,
                       len(body), 2835, 2835, 0 if palette is None else len(palette), 0)
    info += b"\0" * (header - 40)
    off = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + extra + pal
            + body)


def _runs(row, longest):
    """(start, length) of the runs of equal values along a row."""
    i = 0
    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < longest:
            j += 1
        yield i, j - i
        i = j


def rle8(idx) -> bytes:
    """RLE8 pixel data of (H, W) indices (bottom row first): encoded runs of
    three or more, absolute runs of up to five, end of row, end of bitmap."""
    out = bytearray()
    for row in np.asarray(idx)[::-1].tolist():
        i = 0
        while i < len(row):
            _, n = next(_runs(row[i:], 255))
            if n >= 3 or len(row) - i < 3:
                out += bytes([n, row[i]])
                i += n
            else:
                seg = row[i:i + 5]
                out += bytes([0, len(seg)]) + bytes(seg) + b"\0" * (len(seg) % 2)
                i += len(seg)
        out += b"\0\0"
    return bytes(out + b"\0\1")


def rle4(idx) -> bytes:
    """RLE4 pixel data of (H, W) 4-bit indices (bottom row first): encoded
    runs of a repeated pair, absolute runs of up to seven, end of row, end
    of bitmap."""
    out = bytearray()
    for row in np.asarray(idx)[::-1].tolist():
        i = 0
        while i < len(row):
            if i + 4 <= len(row) and row[i:i + 2] == row[i + 2:i + 4]:
                j = i + 2
                while j + 2 <= len(row) and row[j:j + 2] == row[i:i + 2] and j - i < 250:
                    j += 2
                out += bytes([j - i, (row[i] << 4) | row[i + 1]])
                i = j
            elif len(row) - i >= 3:
                n = min(len(row) - i, 7)
                seg = row[i:i + n] + [0]
                b = bytes((seg[t] << 4) | (seg[t + 1] if t + 1 < n else 0)
                          for t in range(0, n, 2))
                out += bytes([0, n]) + b + b"\0" * (len(b) % 2)
                i += n
            else:
                n = len(row) - i
                out += bytes([n, (row[i] << 4) | (row[i + 1] if n > 1 else 0)])
                i += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def packbits(b: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(b):
        _, n = next(_runs(b[i:], 128))
        if n >= 2:
            out += bytes([257 - n]) + b[i:i + 1]
            i += n
        else:
            k = min(len(b), i + 128)
            out += bytes([k - i - 1]) + b[i:k]
            i = k
    return bytes(out)


def lzw(b: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, the width growing one
    code early, clear codes when the table fills."""
    table = {bytes([i]): i for i in range(256)}
    nxt, nbits, codes, w = 258, 9, [(256, 9)], b""
    for c in b:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], nbits))
        table[wc] = nxt
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
        if nxt >= 4093:
            codes.append((256, nbits))
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        w = bytes([c])
    if w:
        codes.append((table[w], nbits))
    codes.append((257, nbits))
    acc = n = 0
    out = bytearray()
    for code, nb in codes:
        acc = (acc << nb) | code
        n += nb
        while n >= 8:
            out.append((acc >> (n - 8)) & 255)
            n -= 8
    if n:
        out.append((acc << (8 - n)) & 255)
    return bytes(out)


def tiff(px, end="<", comp=1, predictor=1, tile=None, rps=None, extra=None) -> bytes:
    """A baseline TIFF of (H, W[, spp]) uint8 or uint16 samples: gray, RGB
    or RGB + an extra sample of type `extra`; strips of `rps` rows or
    (width, length) tiles; compression 1, 5 (LZW), 8 (Deflate) or 32773
    (PackBits)."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, spp = px.shape
    bits = 16 if px.dtype == np.uint16 else 8
    dt = np.dtype(end + ("u2" if bits == 16 else "u1"))

    def enc(block):
        a = block.astype(np.int64)
        if predictor == 2:
            a = np.concatenate([a[:, :1], np.diff(a, axis=1)], axis=1) % (1 << bits)
        raw = a.astype(dt).tobytes()
        return {1: lambda r: r, 5: lzw, 8: zlib.compress, 32773: packbits}[comp](raw)

    chunks = []
    if tile:
        tw, tl = tile
        for ty in range(0, h, tl):
            for tx in range(0, w, tw):
                blk = np.zeros((tl, tw, spp), px.dtype)
                part = px[ty:ty + tl, tx:tx + tw]
                blk[:part.shape[0], :part.shape[1]] = part
                chunks.append(enc(blk))
    else:
        rps = rps or h
        chunks = [enc(px[y:y + rps]) for y in range(0, h, rps)]
    data = bytearray(b"II*\0" if end == "<" else b"MM\0*") + b"\0\0\0\0"
    offs = []
    for c in chunks:
        offs.append(len(data))
        data += c + b"\0" * (len(c) % 2)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [comp]),
            (262, 3, [1 if spp == 1 else 2]), (277, 3, [spp]), (284, 3, [1])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if extra is not None:
        tags.append((338, 3, [extra]))
    if tile:
        tags += [(322, 4, [tile[0]]), (323, 4, [tile[1]]), (324, 4, offs),
                 (325, 4, [len(c) for c in chunks])]
    else:
        tags += [(273, 4, offs), (278, 4, [rps]), (279, 4, [len(c) for c in chunks])]
    tags.sort()
    ifd = len(data)
    ext, ext_base, ents = bytearray(), ifd + 2 + 12 * len(tags) + 4, b""
    for tag, typ, vals in tags:
        raw = struct.pack(end + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) <= 4:
            ents += struct.pack(end + "HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
        else:
            ents += struct.pack(end + "HHII", tag, typ, len(vals), ext_base + len(ext))
            ext += raw
    data[4:8] = struct.pack(end + "I", ifd)
    return bytes(data + struct.pack(end + "H", len(tags)) + ents + b"\0\0\0\0" + ext)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def png(px, interlace=True) -> bytes:
    """uint8 or uint16 (H, W[, C]) as PNG, Adam7 when interlace; row y of
    each pass takes filter y % 5."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    depth = 16 if px.dtype == np.uint16 else 8
    bpp = c * depth // 8

    def rows_of(img):
        out, prior = bytearray(), bytes(img.shape[1] * bpp)
        for y in range(img.shape[0]):
            raw = img[y].astype(">u2" if depth == 16 else "u1").tobytes()
            f, line = y % 5, bytearray()
            for i in range(len(raw)):
                a = raw[i - bpp] if i >= bpp else 0
                b, cc = prior[i], (prior[i - bpp] if i >= bpp else 0)
                pred = (0, a, b, (a + b) >> 1, _paeth(a, b, cc))[f]
                line.append((raw[i] - pred) & 255)
            out += bytes([f]) + line
            prior = raw
        return bytes(out)

    if interlace:
        raw = b"".join(rows_of(px[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7
                       if x0 < w and y0 < h)
    else:
        raw = rows_of(px)

    def chunk(k, b):
        return struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0,
                       int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))
