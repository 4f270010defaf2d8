"""grlir's orbax checkpoints read by the port without orbax: the zstd
decoder bit-equal to the zstandard package, the OCDBT reader equal to
tensorstore's, `read_orbax` bit-equal to orbax's restore (a GRL-tiny
TrainState, a GAN state, a multi-chunk array, bf16 and scalar leaves), and
`serve.load_checkpoint` on an orbax directory equal to grlir's
`restore_params_only` converted; the committed fixture of the host_io
phase derived again."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from grlir.engines.gan import GANTrainState
from grlir.engines.train import create_state
from grlir.serve import load_any_checkpoint
from grlir.utils.checkpoint import CheckpointManager
from grlir_torch import host_io_cells as hc
from grlir_torch.models.grl import GRL
from grlir_torch.serve import load_checkpoint
from grlir_torch.utils import msgpack_params, orbax_read, zstd
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_host_fixtures import orbax_params


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "empty": b"",
        "random": rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(),
        "compressible": b"".join(rng.choice([b"abc", b"xyzzy", b"0123456789", b"\x00" * 7])
                                 for _ in range(6000)),
        "floats": rng.normal(size=6000).astype(np.float32).tobytes(),
        "zeros": bytes(70000),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_zstd_equals_zstandard(name, level, checksum):
    data = INPUTS[name]
    comp = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(comp) == zstandard.ZstdDecompressor().decompress(comp) == data


def test_zstd_frames_streams_and_checksum():
    data = INPUTS["compressible"] + INPUTS["floats"]
    two = b"".join(zstandard.ZstdCompressor(level=3).compress(d)
                   for d in (data[:30000], data[30000:]))
    skippable = b"\x50\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"hello"
    assert zstd.decompress(skippable + two) == data
    obj = zstandard.ZstdCompressor(level=3).compressobj()           # no content size
    assert zstd.decompress(obj.compress(data) + obj.flush()) == data
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(data))
    frame[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


def test_ocdbt_multilevel_tree_equals_tensorstore(tmp_path):
    """Small nodes give interior B+tree levels and indirect values."""
    root = str(tmp_path / "db")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 20}}).result()
    for i in range(40):
        kv.write(f"key{i:03d}/.zarray", (b"v%d" % i) * (1 + i % 15)).result()
    want = {k.decode(): bytes(kv.read(k).result().value) for k in kv.list().result()}
    reader = orbax_read.OcdbtReader(root)
    assert reader.root_ref[3] > 0
    assert reader.items() == want


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield path, tree


def _assert_restore_equal(step_dir, got):
    want = ocp.StandardCheckpointer().restore(osp.join(step_dir, "default"))
    want, got = dict(_flat(want)), dict(_flat(got))
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            w = w.astype(np.float32)         # the port's bf16 leaves, exactly
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def _save(directory, state, step=3):
    mgr = CheckpointManager(directory)
    mgr.save(step, state, {"val_psnr": 1.0})
    mgr.close()
    return osp.join(directory, str(step))


def test_read_orbax_train_state_equals_orbax(tmp_path):
    """A GRL-tiny TrainState (AdamW moments drawn from numpy, so they are
    not zero), with a bf16 leaf and scalars."""
    params = orbax_params()
    state = create_state(params, optax.adamw(1e-3))
    rng = np.random.default_rng(1)
    opt_state = jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.asarray(a).dtype), state.opt_state)
    params["params"]["bf16_leaf"] = jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 3
    state = state.replace(params=params, opt_state=opt_state, step=np.int32(1))
    step_dir = _save(str(tmp_path / "ckpt"), state)
    _assert_restore_equal(step_dir, orbax_read.read_orbax(step_dir))


def test_read_orbax_gan_state_and_multichunk(tmp_path):
    """A GAN state (params_g) whose leaves include an array sharded over
    four devices (four zarr chunks) and one over two on its last axis."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    big = jax.device_put(jnp.arange(8 * 6, dtype=jnp.float32).reshape(8, 6) / 7,
                         NamedSharding(mesh, P("x")))
    wide = jax.device_put(jnp.arange(4 * 12, dtype=jnp.float32).reshape(4, 12),
                          NamedSharding(Mesh(np.array(jax.devices()[:2]), ("y",)),
                                        P(None, "y")))
    params_g = {"params": {"conv": {"kernel": big, "bias": jnp.ones(6)}, "w": wide}}
    params_d = {"params": {"d": jnp.full((3,), 2.0)}}
    state = GANTrainState(step=jnp.int32(5), params_g=params_g, params_d=params_d,
                          spectral={"u": jnp.zeros((1, 3))},
                          opt_state_g=optax.adam(1e-4).init(params_g["params"]),
                          opt_state_d=optax.adam(1e-4).init(params_d["params"]))
    step_dir = _save(str(tmp_path / "gan"), state, step=7)
    kv = orbax_read.OcdbtReader(osp.join(step_dir, "default")).items()
    assert sum(k.startswith("params_g.params.conv.kernel/") for k in kv) == 5  # + .zarray
    _assert_restore_equal(step_dir, orbax_read.read_orbax(step_dir))
    got = orbax_read.read_params(str(tmp_path / "gan"))
    np.testing.assert_array_equal(got["params"]["conv"]["kernel"], np.asarray(big))
    np.testing.assert_array_equal(got["params"]["w"], np.asarray(wide))


def test_load_checkpoint_equals_restore_params_only(tmp_path):
    """serve.load_checkpoint on a manager's directory (newest step) and on
    one step directory equals grlir's restore_params_only, converted."""
    params = orbax_params()
    directory = str(tmp_path / "checkpoints")
    mgr = CheckpointManager(directory, save_top_k=3)
    for step, scale in ((1, 1.0), (2, 0.5)):
        scaled = jax.tree_util.tree_map(lambda a: a * scale, params)
        mgr.save(step, create_state(scaled, optax.adamw(1e-4)), {"val_psnr": float(step)})
    mgr.close()
    for path, which in ((directory, 0.5), (osp.join(directory, "1"), 1.0)):
        template = jax.tree_util.tree_map(np.zeros_like, params)
        if path == directory:
            want = load_any_checkpoint(path, template)
        else:
            m = CheckpointManager(directory)
            want = m.restore_params_only(template, step=1)
            m.close()
        model = GRL(hc.orbax_model_config())
        load_checkpoint(model, path)
        sd = model.state_dict()
        for k, v in jax_params_to_state_dict(want).items():
            assert torch.equal(sd[k], v), k
        expect = jax_params_to_state_dict(jax.tree_util.tree_map(lambda a: a * which, params))
        assert all(torch.equal(sd[k], v) for k, v in expect.items())


def test_committed_orbax_fixture_rederives():
    """The committed checkpoint holds grlir's model.init params and AdamW
    state as orbax restores them, and the .msgpack the same params."""
    step_dir = osp.join(hc.ASSETS, hc.ORBAX_DIR, str(hc.ORBAX_STEP))
    got = orbax_read.read_orbax(step_dir)
    _assert_restore_equal(step_dir, got)
    fresh = dict(_flat(orbax_params()))
    assert dict(_flat(got["params"])).keys() == fresh.keys()
    for k, v in _flat(got["params"]):
        np.testing.assert_array_equal(v, np.asarray(fresh[k]), err_msg=str(k))
    for k, v in _flat(msgpack_params.load(osp.join(hc.ASSETS, hc.ORBAX_MSGPACK))):
        np.testing.assert_array_equal(v, np.asarray(fresh[k]), err_msg=str(k))
    assert osp.getsize(osp.join(hc.ASSETS, hc.ORBAX_MSGPACK)) < 512 * 1024
