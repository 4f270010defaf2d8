"""A Zstandard frame decoder in Python and numpy (RFC 8878), so that the port
reads the zstd-compressed files of grlir's orbax checkpoints without the
zstandard package.

`decompress(data)` decodes every frame of `data` (skippable frames
skipped): raw, RLE and compressed blocks; raw, RLE, Huffman-compressed (one
or four streams) and treeless literals; FSE sequence tables given as
predefined, RLE, compressed or repeated; repeat offsets; matches reaching
into the window; and the optional XXH64 content checksum, verified.
Dictionaries raise NotImplementedError.

Bits are read from precomputed 64-bit windows of each bitstream, and each
Huffman or FSE table is a flat list, so a symbol costs a few list lookups.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0xFD2FB528
_M64 = (1 << 64) - 1

# RFC 8878 3.1.1.3.2.1.1: literal-length and match-length codes
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
                             1024, 2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = [c + 3 for c in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131,
                                        259, 515, 1027, 2051, 4099, 8195, 16387,
                                        32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# RFC 8878 3.1.1.3.2.2: the predefined distributions
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2,
               3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)


class ZstdError(ValueError):
    pass


class _Backward:
    """A bitstream read from its end (RFC 8878 4.1): 64-bit little-endian
    windows at every byte; bits past the start read as zeros."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bitstream without its final padding bit")
        b = np.frombuffer(bytes(data) + b"\0" * 8, np.uint8).astype(np.uint64)
        n = len(data)
        w = np.zeros(n, np.uint64)
        for i in range(8):
            w |= b[i:i + n] << np.uint64(8 * i)
        self.win = w.tolist()
        self.pos = 8 * (n - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        q = self.pos - n
        self.pos = q
        if q >= 0:
            return (self.win[q >> 3] >> (q & 7)) & ((1 << n) - 1)
        return (self.win[0] << -q) & ((1 << n) - 1)


def _read_ncount(data: bytes, pos: int, max_symbol: int, max_log: int):
    """An FSE table description (RFC 8878 4.1.1): (counts, accuracy log,
    position after it)."""
    bits = int.from_bytes(data[pos:pos + 520], "little")
    log = (bits & 15) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} > {max_log}")
    b = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts, previous0 = [], False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            n0 = len(counts)
            while (bits >> b) & 0xFFFF == 0xFFFF:
                n0 += 24
                b += 16
            while (bits >> b) & 3 == 3:
                n0 += 3
                b += 2
            n0 += (bits >> b) & 3
            b += 2
            counts += [0] * (n0 - len(counts))
            if len(counts) > max_symbol:
                break
        top = 2 * threshold - 1 - remaining
        v = (bits >> b) & (threshold - 1)
        if v < top:
            b += nbits - 1
        else:
            v = (bits >> b) & (2 * threshold - 1)
            if v >= threshold:
                v -= top
            b += nbits
        v -= 1
        remaining -= abs(v)
        counts.append(v)
        previous0 = v == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return counts, log, pos + (b + 7) // 8


def _fse_table(counts, log: int):
    """FSE decoding table: per state (symbol, bits to read, baseline)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("corrupt FSE distribution")
    nxt = [1 if c == -1 else c for c in counts]
    nb, base = [0] * size, [0] * size
    for u in range(size):
        s = sym[u]
        state = nxt[s]
        nxt[s] += 1
        nb[u] = log - (state.bit_length() - 1)
        base[u] = (state << nb[u]) - size
    return sym, nb, base, log


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


def _huffman_table(weights):
    """Weights of symbols 0..n-2 -> (table of (symbol | bits << 8) on a
    max_bits peek, max_bits); the last symbol's weight is implied."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights do not sum to a power of two")
    weights = list(weights) + [rest.bit_length()]
    if max_bits > 11:
        raise ZstdError(f"Huffman code of {max_bits} bits")
    table = [0] * (1 << max_bits)
    pos = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                span = 1 << (w - 1)
                table[pos:pos + span] = [s | ((max_bits + 1 - w) << 8)] * span
                pos += span
    return table, max_bits


def _huffman_weights(data: bytes, pos: int):
    """A Huffman tree description (RFC 8878 4.2.1): (weights, position
    after it)."""
    hb = data[pos]
    pos += 1
    if hb >= 128:
        n = hb - 127
        raw = data[pos:pos + (n + 1) // 2]
        weights = []
        for byte in raw:
            weights += [byte >> 4, byte & 15]
        return weights[:n], pos + (n + 1) // 2
    end = pos + hb
    counts, log, start = _read_ncount(data, pos, 255, 6)
    sym, nb, base, _ = _fse_table(counts, log)
    br = _Backward(data[start:end])
    s1, s2 = br.read(log), br.read(log)
    weights = []
    while True:
        weights.append(sym[s1])
        s1 = base[s1] + br.read(nb[s1])
        if br.pos < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + br.read(nb[s2])
        if br.pos < 0:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return weights, end


def _huffman_stream(data: bytes, n: int, table, max_bits: int) -> bytes:
    br = _Backward(data)
    win, mask = br.win, (1 << max_bits) - 1
    pos = br.pos
    out = bytearray(n)
    for i in range(n):
        q = pos - max_bits
        if q >= 0:
            e = table[(win[q >> 3] >> (q & 7)) & mask]
        else:
            e = table[(win[0] << -q) & mask]
        out[i] = e & 255
        pos -= e >> 8
    if pos != 0:
        raise ZstdError("Huffman stream not consumed exactly")
    return bytes(out)


class _Frame:
    """Tables and repeat offsets carried from block to block."""

    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data: bytes, pos: int, fr: _Frame):
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                       # raw, RLE
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if kind == 0:
            return data[pos:pos + size], pos + size
        return data[pos:pos + 1] * size, pos + 1
    if fmt in (0, 1):
        v = int.from_bytes(data[pos:pos + 3], "little")
        regen, comp, hsize = (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 3
    elif fmt == 2:
        v = int.from_bytes(data[pos:pos + 4], "little")
        regen, comp, hsize = (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4
    else:
        v = int.from_bytes(data[pos:pos + 5], "little")
        regen, comp, hsize = (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 5
    pos += hsize
    end = pos + comp
    if kind == 2:
        weights, pos = _huffman_weights(data, pos)
        fr.huffman = _huffman_table(weights)
    elif fr.huffman is None:
        raise ZstdError("treeless literals without a previous Huffman table")
    table, max_bits = fr.huffman
    if fmt == 0:
        return _huffman_stream(data[pos:end], regen, table, max_bits), end
    sizes = struct.unpack("<HHH", data[pos:pos + 6])
    pos += 6
    each = (regen + 3) // 4
    out = []
    for i in range(4):
        size = sizes[i] if i < 3 else end - pos
        n = each if i < 3 else regen - 3 * each
        out.append(_huffman_stream(data[pos:pos + size], n, table, max_bits))
        pos += size
    return b"".join(out), end


def _seq_table(data: bytes, pos: int, mode: int, name: str, default, max_symbol: int,
               max_log: int, fr: _Frame):
    if mode == 0:
        t = _fse_table(*default)
    elif mode == 1:
        t = _rle_table(data[pos])
        pos += 1
    elif mode == 2:
        counts, log, pos = _read_ncount(data, pos, max_symbol, max_log)
        t = _fse_table(counts, log)
    else:
        t = fr.tables[name]
        if t is None:
            raise ZstdError(f"repeat {name} table without a previous one")
    fr.tables[name] = t
    return t, pos


def _block(data: bytes, fr: _Frame, out: bytearray) -> None:
    """One compressed block appended to out."""
    lits, pos = _literals(data, 0, fr)
    b0 = data[pos]
    if b0 == 0:
        out += lits
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the compression modes")
    llt, pos = _seq_table(data, pos, modes >> 6, "ll", LL_DEFAULT, 35, 9, fr)
    oft, pos = _seq_table(data, pos, (modes >> 4) & 3, "of", OF_DEFAULT, 31, 8, fr)
    mlt, pos = _seq_table(data, pos, (modes >> 2) & 3, "ml", ML_DEFAULT, 52, 9, fr)
    br = _Backward(data[pos:])
    read = br.read
    ll_sym, ll_nb, ll_base, ll_log = llt
    of_sym, of_nb, of_base, of_log = oft
    ml_sym, ml_nb, ml_base, ml_log = mlt
    sl, so, sm = read(ll_log), read(of_log), read(ml_log)
    r1, r2, r3 = fr.reps
    lp = 0
    for i in range(nseq):
        oc, mc, lc = of_sym[so], ml_sym[sm], ll_sym[sl]
        ofv = (1 << oc) + read(oc)
        ml = ML_BASE[mc] + read(ML_BITS[mc])
        ll = LL_BASE[lc] + read(LL_BITS[lc])
        if ofv > 3:
            off = ofv - 3
            r1, r2, r3 = off, r1, r2
        else:
            idx = ofv + (ll == 0)
            if idx == 1:
                off = r1
            elif idx == 2:
                off = r2
                r1, r2 = r2, r1
            elif idx == 3:
                off = r3
                r1, r2, r3 = r3, r1, r2
            else:
                off = r1 - 1
                if off == 0:
                    raise ZstdError("repeat offset of 0")
                r1, r2, r3 = off, r1, r2
        if i < nseq - 1:
            sl = ll_base[sl] + read(ll_nb[sl])
            sm = ml_base[sm] + read(ml_nb[sm])
            so = of_base[so] + read(of_nb[so])
        if lp + ll > len(lits):
            raise ZstdError("sequence reads past the literals")
        out += lits[lp:lp + ll]
        lp += ll
        start = len(out) - off
        if start < 0:
            raise ZstdError("match offset beyond the decoded data")
        if off >= ml:
            out += out[start:start + ml]
        else:                                    # overlapping: repeat the period
            period = bytes(out[start:])
            out += (period * (ml // off + 1))[:ml]
    if br.pos != 0:
        raise ZstdError("sequence bitstream not consumed exactly")
    fr.reps = [r1, r2, r3]
    out += lits[lp:]


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of data (the content checksum's hash)."""
    p1, p2, p3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
    p4, p5 = 9650029242287828579, 2870177450012600261

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & _M64

    def rnd(acc, lane):
        return (rotl((acc + lane * p2) & _M64, 31) * p1) & _M64

    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + p1 + p2) & _M64, (seed + p2) & _M64, seed, (seed - p1) & _M64]
        lanes = np.frombuffer(data[:n - n % 32], "<u8").reshape(-1, 4).tolist()
        for row in lanes:
            v = [rnd(a, x) for a, x in zip(v, row)]
        i = n - n % 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & _M64
        for a in v:
            h = ((h ^ rnd(0, a)) * p1 + p4) & _M64
    else:
        h = (seed + p5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27) * p1 + p4) & _M64
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * p1 & _M64), 23) * p2
             + p3) & _M64
        i += 4
    while i < n:
        h = (rotl(h ^ (data[i] * p5 & _M64), 11) * p1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * p2) & _M64
    h ^= h >> 29
    h = (h * p3) & _M64
    return h ^ (h >> 32)


def _frame(data: bytes, pos: int):
    """Decode the frame at pos: (content, position after it)."""
    fhd = data[pos + 4]
    pos += 5
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    # the window descriptor bounds match offsets; the whole frame stays in
    # memory here, so any offset into it is read
    pos += 0 if single else 1
    did = (0, 1, 2, 4)[dict_flag]
    if did and int.from_bytes(data[pos:pos + did], "little"):
        raise NotImplementedError("zstd frames with a dictionary are not read")
    pos += did
    fsize = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = int.from_bytes(data[pos:pos + fsize], "little") if fsize else None
    if fsize == 2:
        content_size += 256
    pos += fsize
    fr, out = _Frame(), bytearray()
    while True:
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            out += data[pos:pos + 1] * size
            pos += 1
        elif kind == 2:
            _block(bytes(data[pos:pos + size]), fr, out)
            pos += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if content_size is not None and len(out) != content_size:
        raise ZstdError(f"frame decoded {len(out)} bytes, header says {content_size}")
    if checksum:
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return bytes(out), pos


def decompress(data: bytes) -> bytes:
    """Every frame of data, decoded and joined (skippable frames skipped)."""
    data = bytes(data)
    out, pos = [], 0
    while pos < len(data):
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic == MAGIC:
            content, pos = _frame(data, pos)
            out.append(content)
        elif magic & 0xFFFFFFF0 == 0x184D2A50:
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
        else:
            raise ZstdError(f"no zstd frame at byte {pos}")
    return b"".join(out)


def decompress_frame(data: bytes, pos: int = 0):
    """The zstd frame that starts at pos: (content, position after it);
    whatever follows the frame is left unread."""
    return _frame(bytes(data), pos)
