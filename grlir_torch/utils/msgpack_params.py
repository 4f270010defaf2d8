"""Read the `.msgpack` parameter files that flax writes
(`flax.serialization.to_bytes`, as `python -m grlir.utils.convert` uses it)
without the msgpack package.

The subset of MessagePack that flax writes for a parameter tree: maps,
str and bin, ints, floats, nil and bool, arrays, and its extension types 1
(an ndarray, packed as the msgpack array (shape, dtype name, C-order bytes))
and 3 (a numpy scalar, packed the same way); an array over flax's
MAX_CHUNK_SIZE is written as a map {"__msgpack_chunked_array__": True,
"shape": {"0": n0, ...}, "chunks": {"0": flat part, ...}} and read back as
one array.  bfloat16 buffers are read with torch.frombuffer (numpy has no
bfloat16) and returned as float32 arrays, which hold every bfloat16 value
exactly.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A cursor over MessagePack bytes."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (value,) = struct.unpack_from(fmt, self.take(struct.calcsize(fmt)))
        return value

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # marker: (length format, reader)
            0xC4: (">B", self.bin), 0xC5: (">H", self.bin), 0xC6: (">I", self.bin),
            0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
            0xDC: (">H", self.array), 0xDD: (">I", self.array),
            0xDE: (">H", self.map), 0xDF: (">I", self.map),
            0xC7: (">B", self.ext), 0xC8: (">H", self.ext), 0xC9: (">I", self.ext),
        }
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:   # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack marker {b:#04x} is outside what flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is outside what flax "
                             "writes for parameters")
        shape, dtype, buf = _Reader(payload).obj()
        arr = _ndarray(shape, dtype, buf)
        return arr if code == _EXT_NDARRAY else arr[()]


def _ndarray(shape, dtype, buf: bytes) -> np.ndarray:
    """An ndarray from flax's (shape, dtype name, C-order bytes)."""
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        flat = (torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).float().numpy()
                if buf else np.zeros(0, np.float32))
    else:
        flat = np.frombuffer(buf, dtype=np.dtype(dtype)).copy()
    return flat.reshape(shape)


def _unchunk(tree):
    """Chunked array leaves (flax's `_chunk`) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes):
    """The tree `flax.serialization.msgpack_restore` would give: nested
    dicts with numpy array leaves (bfloat16 as float32)."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)


def load(path: str):
    """`loads` of a file."""
    with open(path, "rb") as f:
        return loads(f.read())
