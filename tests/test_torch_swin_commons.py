"""The port's Swin blocks (`grlir_torch.models.swin`) and EDSR commons
(`grlir_torch.models.commons`) against grlir's flax modules, fp32 on the
CPU: each module's random parameters, converted, give the same output on
the same numpy input (atol 3e-5, rtol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.models import commons as jc
from grlir.models import swin as js
from grlir_torch.models import commons as tc
from grlir_torch.models import swin as ts
from grlir_torch.ops.geometry import (get_relative_coords_table,
                                      get_relative_position_index)
from grlir_torch.utils.convert import (flax_path_to_torch_key,
                                       jax_params_to_state_dict,
                                       jax_variables_to_state_dict)
from torch_parity import one_torch_thread  # noqa: F401

TOL = dict(atol=3e-5, rtol=1e-4)


def _draw(module, rng, *inputs, **kw):
    """module's variables with every leaf drawn from rng: scales and
    variances 1 + |N(0, 0.1^2)|, logit scales log(10) + N(0, 0.5^2), the
    rest N(0, 0.1^2) (kernels scaled by 1/sqrt(fan in))."""
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, **kw))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("scale", "var"):
            a = 1 + np.abs(rng.normal(0, 0.1, shape))
        elif name == "logit_scale":
            a = np.log(10) + rng.normal(0, 0.5, shape)
        elif name == "kernel":
            a = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            a = rng.normal(0, 0.1, shape)
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _swin_state_dict(variables):
    """grlir's Swin parameters -> the port's names: the GRL mapping, plus
    the bias table under its own name."""
    params = dict(variables["params"])
    out = {}
    attn = dict(params.get("attn", {}))
    table = attn.pop("relative_position_bias_table", None)
    if table is not None:
        out["attn.relative_position_bias_table"] = torch.tensor(np.asarray(table))
        params["attn"] = attn
    out.update(jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return out


def _load(tmodule, sd, allowed_missing=()):
    missing, unexpected = tmodule.load_state_dict(sd, strict=False)
    assert not unexpected and all(m.endswith(allowed_missing) for m in missing), \
        (missing, unexpected)
    return tmodule


@pytest.mark.parametrize("shift", [False, True])
def test_swin_v1_block_matches_jax(shift):
    rng = np.random.default_rng(0)
    x = rng.random((2, 16, 24, 32)).astype(np.float32)
    jm = js.SwinTransformerBlockV1(32, (8, 8), 4, shift)
    v = _draw(jm, rng, jnp.asarray(x))
    tm = _load(ts.SwinTransformerBlockV1(32, (8, 8), 4, shift), _swin_state_dict(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("shift", [False, True])
def test_swin_v2_block_matches_jax(shift):
    rng = np.random.default_rng(1)
    x = rng.random((1, 16, 16, 32)).astype(np.float32)
    table = get_relative_coords_table((8, 8))
    index = get_relative_position_index((8, 8))
    jm = js.SwinTransformerBlockV2(32, (8, 8), 4, shift)
    args = (jnp.asarray(x), jnp.asarray(table), jnp.asarray(index))
    v = _draw(jm, rng, *args)
    tm = _load(ts.SwinTransformerBlockV2(32, (8, 8), 4, shift), _swin_state_dict(v))
    assert flax_path_to_torch_key(("attn", "attn_transform", "cpb_mlp", "fc1", "kernel")) \
        in tm.state_dict()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(table),
                 torch.from_numpy(index.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, *args)), **TOL)


@pytest.mark.parametrize("patch,norm", [(1, False), (2, True)])
def test_patch_embed_matches_jax(patch, norm):
    rng = np.random.default_rng(2)
    x = rng.random((1, 16, 16, 3)).astype(np.float32)
    jm = js.PatchEmbed(48, patch, norm)
    v = _draw(jm, rng, jnp.asarray(x))
    tm = _load(ts.PatchEmbed(3, 48, patch, norm), _swin_state_dict(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        assert torch.equal(ts.PatchUnEmbed()(torch.from_numpy(got)), torch.from_numpy(got))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


# ---- commons

def _commons_pair(jm, tm, x, seed, train=False, **kw):
    rng = np.random.default_rng(seed)
    call_kw = {"train": train} if train is not None else {}
    v = _draw(jm, rng, jnp.asarray(x), **call_kw, **kw)
    sd = jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, v))
    _load(tm, sd, ("num_batches_tracked",))
    if train:
        want, _ = jm.apply(v, jnp.asarray(x), **call_kw, mutable=["batch_stats"], **kw)
    else:
        want = jm.apply(v, jnp.asarray(x), **call_kw, **kw)
    tm.train(bool(train))
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy(), np.asarray(want)


def test_mean_shift_matches_jax():
    x = np.random.default_rng(3).random((1, 4, 4, 3)).astype(np.float32)
    for sign, std in ((-1, (1.0, 1.0, 1.0)), (1, (0.5, 1.0, 2.0))):
        got = tc.mean_shift(torch.from_numpy(x), 255.0, rgb_std=std, sign=sign)
        want = jc.mean_shift(jnp.asarray(x), 255.0, rgb_std=std, sign=sign)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shortcut", [True, False])
def test_resblock_matches_jax(shortcut):
    x = np.random.default_rng(4).random((2, 12, 10, 16)).astype(np.float32)
    got, want = _commons_pair(jc.ResBlock(16, 0.5, True, shortcut),
                              tc.ResBlock(16, 0.5, True, shortcut), x, 4, train=None)
    np.testing.assert_allclose(got, want, **TOL)


def test_resblock_wrapper_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.random((2, 12 * 10, 16)).astype(np.float32)
    jm = jc.ResBlockWrapper(16)
    v = _draw(jm, rng, jnp.asarray(x), (12, 10))
    tm = _load(tc.ResBlockWrapper(16), jax_variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), (12, 10)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x), (12, 10))), **TOL)


@pytest.mark.parametrize("stride,bn,act,train", [
    (1, True, "relu", False), (2, True, "prelu", True), (2, False, None, False),
    (1, False, "prelu", False),
])
def test_basic_block_matches_jax(stride, bn, act, train):
    x = np.random.default_rng(6).random((2, 11, 9, 8)).astype(np.float32)
    got, want = _commons_pair(jc.BasicBlock(12, 3, stride, True, bn, act),
                              tc.BasicBlock(8, 12, 3, stride, True, bn, act), x, 6,
                              train=train)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bn,esa", [(False, True), (True, False), (True, True)])
def test_edsr_resblock_matches_jax(bn, esa):
    x = np.random.default_rng(7).random((1, 40, 36, 16)).astype(np.float32)
    got, want = _commons_pair(jc.EDSRResBlock(16, bn=bn, esa_block=esa, res_scale=0.5),
                              tc.EDSRResBlock(16, bn=bn, esa_block=esa, res_scale=0.5),
                              x, 7)
    np.testing.assert_allclose(got, want, **TOL)


def test_esa_matches_jax():
    x = np.random.default_rng(8).random((2, 33, 29, 16)).astype(np.float32)
    got, want = _commons_pair(jc.ESA(8, 16), tc.ESA(8, 16), x, 8, train=None)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scale,act", [(2, None), (3, "relu"), (4, "prelu")])
def test_upsampler_matches_jax(scale, act):
    x = np.random.default_rng(9).random((1, 6, 5, 8)).astype(np.float32)
    got, want = _commons_pair(jc.Upsampler(scale, 8, True, act),
                              tc.Upsampler(scale, 8, True, act), x, 9, train=None)
    assert got.shape == (1, 6 * scale, 5 * scale, 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_lite_upsampler_matches_jax():
    x = np.random.default_rng(10).random((1, 6, 5, 8)).astype(np.float32)
    got, want = _commons_pair(jc.LiteUpsampler(3, 8, 3), tc.LiteUpsampler(3, 8, 3),
                              x, 10, train=None)
    np.testing.assert_allclose(got, want, **TOL)
