"""grlir's orbax checkpoints read with numpy and the standard library: no
orbax, tensorstore or zstandard.

What `grlir.utils.checkpoint.CheckpointManager.save` writes (orbax's
StandardSave on tensorstore's OCDBT key-value store with zarr v2 arrays):

- `<dir>/<step>/_CHECKPOINT_METADATA` (JSON) and `<step>/default/`, the
  saved tree: `_METADATA` (JSON, the tree's paths under "tree_metadata")
  and an OCDBT database (`manifest.ocdbt`, `d/<hash>` files, and a
  sub-database per writing process whose files the root refers to);
- every OCDBT file but the raw value files starts with a 14-byte header (a
  4-byte big-endian magic, `0cdb3a2a` for a manifest and `0cdb20de` for a
  B+tree node, an 8-byte little-endian file length, then version and
  compression as varints) and a zstd frame (compression 1), and ends with
  a CRC-32C;
- the manifest holds the database config (uuid, manifest kind, inline and
  node size limits, version-tree arity, compression) and its versions;
  the newest version's root node reference (file, offset, length) is the
  tree to read;
- a B+tree node holds its height, a table of the data files it refers to
  (paths prefix-compressed), and its entries' keys (prefix-compressed,
  below the common prefix of the node's subtree): in a leaf, each value's
  length and kind, inline values in the node and indirect ones as (file,
  offset) in a data file; in an interior node, each child's subtree
  common prefix, reference and statistics;
- each leaf of the saved tree is a zarr v2 array under the key of its
  path joined by ".": `<key>/.zarray` (JSON: shape, chunks, dtype, order,
  compressor zstd) and chunks `<key>/i.j` (zstd frames of C-order bytes).

`read_orbax(step_dir)` returns the tree as nested dicts of numpy arrays
(bfloat16 leaves as float32, which holds them exactly); `read_params`
returns what grlir's `restore_params_only` returns, the `params` or
`params_g` subtree; `latest_step_dir` finds the newest step of a
manager's directory.
"""

from __future__ import annotations

import ast
import json
import os
import os.path as osp
import struct

import numpy as np

from grlir_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE


def _varint(buf: bytes, pos: int):
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 128:
            return value, pos
        shift += 7


def _varints(buf: bytes, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _varint(buf, pos)
        out.append(v)
    return out, pos


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of an OCDBT manifest or node file: header checked, zstd
    frame decoded (compression 1) or the raw body taken (0)."""
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"{what}: not an OCDBT file of magic {magic:08x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"{what}: header length {length}, file {len(data)}")
    version, pos = _varint(data, 12)
    compression, pos = _varint(data, pos)
    if version != 0:
        raise NotImplementedError(f"{what}: OCDBT format version {version}")
    if compression == 0:
        return data[pos:-4]
    if compression == 1:
        return zstd.decompress_frame(data, pos)[0]
    raise NotImplementedError(f"{what}: OCDBT compression {compression}")


def _file_table(buf: bytes, pos: int):
    """A data file table: the paths of the files a node or manifest refers
    to, each relative to the database's directory."""
    n, pos = _varint(buf, pos)
    prefix, pos = _varints(buf, pos, max(n - 1, 0))
    suffix, pos = _varints(buf, pos, n)
    _, pos = _varints(buf, pos, n)          # base-path lengths: part of the path
    paths, prev = [], ""
    for i in range(n):
        path = (prev[:prefix[i - 1]] if i else "") + buf[pos:pos + suffix[i]].decode()
        pos += suffix[i]
        paths.append(path)
        prev = path
    return paths, pos


def _keys(buf: bytes, pos: int, n: int, interior: bool):
    prefix, pos = _varints(buf, pos, max(n - 1, 0))
    suffix, pos = _varints(buf, pos, n)
    common = None
    if interior:
        common, pos = _varints(buf, pos, n)
    keys, prev = [], b""
    for i in range(n):
        key = (prev[:prefix[i - 1]] if i else b"") + buf[pos:pos + suffix[i]]
        pos += suffix[i]
        keys.append(key)
        prev = key
    return keys, common, pos


class OcdbtReader:
    """The key-value pairs of one OCDBT database directory, as its newest
    version holds them."""

    def __init__(self, root: str):
        self.root = root
        self._files = {}
        body = _unframe(self._read("manifest.ocdbt"), MANIFEST_MAGIC,
                        osp.join(root, "manifest.ocdbt"))
        pos = 16                                    # uuid
        kind, pos = _varint(body, pos)
        if kind != 0:
            raise NotImplementedError("OCDBT: numbered manifests are not read")
        _, pos = _varints(body, pos, 2)             # inline and node size limits
        pos += 1                                    # version-tree arity (log2)
        compression, pos = _varint(body, pos)
        if compression == 1:
            pos += 4                                # zstd level, int32
        files, pos = _file_table(body, pos)
        n, pos = _varint(body, pos)
        if n == 0:
            self.root_ref = None
            return
        _, pos = _varints(body, pos, n)             # generation numbers
        heights = body[pos:pos + n]
        pos += n
        fid, pos = _varints(body, pos, n)
        off, pos = _varints(body, pos, n)
        length, pos = _varints(body, pos, n)
        # the newest version is the last of the manifest's own entries
        self.root_ref = (files[fid[-1]], off[-1], length[-1], heights[-1])

    def _read(self, rel: str) -> bytes:
        if rel not in self._files:
            with open(osp.join(self.root, rel), "rb") as f:
                self._files[rel] = f.read()
        return self._files[rel]

    def _node(self, path: str, offset: int, length: int, prefix: bytes, out: dict):
        body = _unframe(self._read(path)[offset:offset + length], NODE_MAGIC,
                        osp.join(self.root, path))
        height = body[0]
        files, pos = _file_table(body, 1)
        n, pos = _varint(body, pos)
        keys, common, pos = _keys(body, pos, n, height > 0)
        if height > 0:
            fid, pos = _varints(body, pos, n)
            off, pos = _varints(body, pos, n)
            size, pos = _varints(body, pos, n)
            for i in range(n):
                self._node(files[fid[i]], off[i], size[i],
                           prefix + keys[i][:common[i]], out)
            return
        lengths, pos = _varints(body, pos, n)
        kinds = body[pos:pos + n]
        pos += n
        indirect = [i for i in range(n) if kinds[i]]
        fid, pos = _varints(body, pos, len(indirect))
        off, pos = _varints(body, pos, len(indirect))
        where = dict(zip(indirect, zip(fid, off)))
        for i in range(n):
            if kinds[i] > 1:
                raise NotImplementedError(f"OCDBT: value kind {kinds[i]}")
            if i in where:
                f, o = where[i]
                out[prefix + keys[i]] = (files[f], o, lengths[i])
            else:
                out[prefix + keys[i]] = body[pos:pos + lengths[i]]
                pos += lengths[i]

    def items(self) -> dict:
        """{key: value bytes} of the newest version."""
        refs = {}
        if self.root_ref is not None:
            path, offset, length, _ = self.root_ref
            self._node(path, offset, length, b"", refs)
        out = {}
        for key, v in refs.items():
            if isinstance(v, tuple):
                path, o, n = v
                v = self._read(path)[o:o + n]
            out[key.decode()] = bytes(v)
        return out


def _zarr_array(meta: dict, chunks: dict) -> np.ndarray:
    """A zarr v2 array from its .zarray metadata and {chunk index: bytes}."""
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise NotImplementedError(f"zarr: {meta}")
    shape, cshape = tuple(meta["shape"]), tuple(meta["chunks"])
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    comp = (meta.get("compressor") or {}).get("id")
    if comp not in (None, "zstd"):
        raise NotImplementedError(f"zarr compressor {comp!r}")
    out = np.zeros(shape, dtype)
    sep = meta.get("dimension_separator", ".")
    for index, raw in chunks.items():
        idx = [int(i) for i in index.split(sep)] if shape else []
        data = zstd.decompress(raw) if comp == "zstd" else raw
        order = "F" if meta.get("order") == "F" else "C"
        chunk = np.frombuffer(data, dtype).reshape(cshape, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, cshape, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    if bf16:
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def read_orbax(step_dir: str, wanted=None) -> dict:
    """The tree orbax saved in `step_dir` (a `<step>` directory of a
    CheckpointManager, or its `default/` item): nested dicts of numpy arrays
    keyed as in the saved tree (list and tuple indices as strings), with
    None where orbax saved None.  `wanted(path)` (a tuple of keys) may skip
    leaves, as a params-only read does."""
    item = osp.join(step_dir, "default")
    if not osp.isdir(item):
        item = step_dir
    with open(osp.join(item, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise NotImplementedError(f"{item}: only OCDBT with zarr v2 is read")
    kv = OcdbtReader(item).items()
    tree: dict = {}
    for path_str, leaf in meta["tree_metadata"].items():
        path = tuple(str(k) for k in ast.literal_eval(path_str))
        if wanted is not None and not wanted(path):
            continue
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if leaf["value_metadata"].get("skip_deserialize"):
            node[path[-1]] = None
            continue
        key = ".".join(path)
        zmeta = json.loads(kv[f"{key}/.zarray"])
        chunks = {k[len(key) + 1:]: v for k, v in kv.items()
                  if k.startswith(key + "/") and not k.endswith("/.zarray")}
        node[path[-1]] = _zarr_array(zmeta, chunks)
    return tree


def is_orbax_step(path: str) -> bool:
    """A `<step>` directory of grlir's orbax checkpoints, or its item."""
    return (osp.isfile(osp.join(path, "default", "_METADATA"))
            or osp.isfile(osp.join(path, "_METADATA")))


def latest_step_dir(directory: str):
    """The newest `<step>` directory of a CheckpointManager's directory that
    holds a saved item, or None."""
    steps = [int(d) for d in os.listdir(directory)
             if d.isdigit() and is_orbax_step(osp.join(directory, d))]
    return osp.join(directory, str(max(steps))) if steps else None


def is_orbax_dir(path: str) -> bool:
    """A step directory of grlir's orbax checkpoints, or a manager's
    directory holding one."""
    return is_orbax_step(path) or (osp.isdir(path) and latest_step_dir(path) is not None)


def read_params(path: str) -> dict:
    """grlir's `CheckpointManager.restore_params_only` without a template:
    the `params` (a TrainState) or `params_g` (a GANTrainState) subtree of
    the newest step under a manager's directory, or of one step directory,
    or the whole tree where it has neither (bare params)."""
    step = path if is_orbax_step(path) else latest_step_dir(path)
    if step is None:
        raise FileNotFoundError(f"no orbax checkpoint in {path}")
    tree = read_orbax(step, wanted=lambda p: p[0] in ("params", "params_g"))
    for key in ("params", "params_g"):
        if key in tree:
            return tree[key]
    return read_orbax(step)
