"""The port's reader of flax `.msgpack` parameter files
(`grlir_torch.utils.msgpack_params`) against `flax.serialization`, and
`grlir_torch.serve` on such a file, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from grlir.models import zoo as jzoo
from grlir.models.grl import GRL as JGRL
from grlir_torch import serve
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL
from grlir_torch.utils import msgpack_params
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import random_params


@pytest.fixture(scope="module")
def tiny_params():
    """GRL-tiny x4's parameter tree, random from a seed, with its biases
    and LayerNorm scales in bfloat16 and the rest in float32."""
    model = JGRL(jzoo.make_config("tiny"))
    params = random_params(model, np.random.default_rng(0),
                           jnp.zeros((1, 32, 32, 3), jnp.float32))

    def cast(path, leaf):
        name = path[-1].key
        return jnp.asarray(leaf, jnp.bfloat16) if name in ("bias", "scale") else leaf

    return jax.tree_util.tree_map_with_path(cast, params)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_tree_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reads_flax_bytes(tiny_params):
    dtypes = {str(v.dtype) for v in jax.tree_util.tree_leaves(tiny_params)}
    assert dtypes == {"float32", "bfloat16"}
    got = msgpack_params.loads(serialization.to_bytes(tiny_params))
    _assert_tree_equal(got, tiny_params)
    assert all(v.dtype == np.float32 for v in jax.tree_util.tree_leaves(got))


def test_reads_chunked_leaves(tiny_params, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    data = serialization.to_bytes(tiny_params)
    assert b"__msgpack_chunked_array__" in data
    _assert_tree_equal(msgpack_params.loads(data), tiny_params)


def test_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="after the msgpack object"):
        msgpack_params.loads(serialization.to_bytes({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="ends inside"):
        msgpack_params.loads(serialization.to_bytes({"a": np.zeros(4, np.float32)})[:-3])


def test_serve_msgpack_writes_the_state_dicts_pngs(tiny_params, tmp_path):
    """serve on the .msgpack writes the PNGs serve writes on the equivalent
    state dict, and refuses an orbax directory and another model's file."""
    cv2 = pytest.importorskip("cv2")
    msgpack_path = tmp_path / "grl_tiny.msgpack"
    msgpack_path.write_bytes(serialization.to_bytes(tiny_params))
    ckpt = tmp_path / "grl_tiny.ckpt"
    torch.save(jax_params_to_state_dict(tiny_params), ckpt)
    src = tmp_path / "lr"
    src.mkdir()
    rng = np.random.default_rng(4)
    for name, hw in (("a.png", (20, 28)), ("b.png", (24, 24))):
        cv2.imwrite(str(src / name), rng.integers(0, 256, (*hw, 3), np.uint8))
    for path, out in ((msgpack_path, "from_msgpack"), (ckpt, "from_ckpt")):
        serve.main(["--input", str(src), "--output", str(tmp_path / out), "--checkpoint",
                    str(path), "--model", "tiny", "--device", "cpu", "--shape-bucket", "16"])
    for name in ("a.png", "b.png"):
        got = cv2.imread(str(tmp_path / "from_msgpack" / name))
        want = cv2.imread(str(tmp_path / "from_ckpt" / name))
        assert got.shape == want.shape and got.shape[:2] != (0, 0)
        np.testing.assert_array_equal(got, want)

    model = GRL(zoo.make_config("tiny"))
    with pytest.raises(FileNotFoundError, match="neither"):
        serve.load_checkpoint(model, str(tmp_path))
    with pytest.raises(KeyError, match="does not match"):
        serve.load_checkpoint(GRL(zoo.make_config("tiny", upscale=2)), str(msgpack_path))
