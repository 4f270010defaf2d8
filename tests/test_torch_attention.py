"""grlir_torch.ops.attention (B6, B7a, B7b and the auto dispatch) and the
plain `cosine_attention` of grlir_torch.models.blocks against their grlir
counterparts (Pallas in interpret mode, XLA for the plain path), fp32 on
the CPU, and the wrappers' dispatch.  The CUDA kernels are tested against
the plain versions in test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from grlir.models import blocks as jblocks
from grlir.ops.pallas import attention as jatt
from grlir_torch.models import blocks as tblocks
from grlir_torch.ops import attention as tatt
from grlir_torch.ops.geometry import (
    get_relative_coords_table,
    get_relative_position_index,
)
from torch_parity import random_params

ATOL, RTOL = 1e-5, 1e-4


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _scales(rng, h):
    """Per-head raw logit scales, as tests/test_pallas_attention.py draws
    them (at the clamp, a scale of 100 puts fp32's own noise near 1e-5 on
    the outputs; test_logit_scale_is_clamped covers the clamp)."""
    return rng.uniform(0, 3, (h, 1, 1)).astype(np.float32)


def _split_case(shape, with_mask, seed):
    """q (B, nW, h, N1, d), k, v (B, nW, h, N2, d), scales, bias, mask."""
    B, nW, h, N1, N2, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, nW, h, n, d)).astype(np.float32)
               for n in (N1, N2, N2))
    mask = None
    if with_mask:
        mask = np.where(rng.random((nW, N1, N2)) > 0.8, -100.0, 0.0).astype(np.float32)
    return (q, k, v, _scales(rng, h),
            rng.standard_normal((h, N1, N2)).astype(np.float32), mask)


# ------------------------------------------------------------------ B6

@pytest.mark.parametrize("with_bands", [False, True])
@pytest.mark.parametrize("heads,d", [(2, 16), (3, 10), (2, 64)])
def test_window_qkv_ref_matches_pallas(with_bands, heads, d):
    B, nW, N, C = 2, 4, 64, heads * d
    rng = np.random.default_rng(heads)
    qkv = rng.standard_normal((B, nW, 3 * C, N)).astype(np.float32)
    ls = _scales(rng, heads)
    bias = rng.standard_normal((heads, N, N)).astype(np.float32)
    bands = rng.integers(0, 9, (nW, N)).astype(np.int32) if with_bands else None
    want = np.asarray(jatt.fused_window_attention_qkv(
        jnp.asarray(qkv), jnp.asarray(ls), jnp.asarray(bias), heads, _j(bands),
        interpret=True, channel_major=True))
    got = tatt.fused_window_attention_qkv_ref(_t(qkv), _t(ls), _t(bias), heads,
                                              _t(bands))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ B7a and B7b

# (B, nW, h, N1, N2, d): a2w (few queries, many keys), w2a, GRL-S's 8x32
# stripes at 128^2 (N1 = 256) at GRL-base's head dim 30, and head dim 64
@pytest.mark.parametrize("shape", [(2, 3, 2, 16, 64, 16), (2, 3, 2, 64, 16, 16),
                                   (1, 2, 3, 256, 16, 30), (1, 2, 2, 64, 128, 64)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_cosine_ref_matches_pallas(shape, with_mask):
    args = _split_case(shape, with_mask, 0)
    want = np.asarray(jatt.fused_cosine_attention(*map(_j, args), interpret=True))
    got = tatt.fused_cosine_attention_ref(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("with_mask", [False, True])
def test_packed_ref_matches_pallas(pack, with_mask):
    """B7b packed as the TPU packs it, and the same function as B7a."""
    _check_packed((2, 4, 2, 64, 64, 16), pack, with_mask)


@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("with_mask", [False, True])
def test_packed_ref_matches_pallas_at_head_dim_64(pack, with_mask):
    """B7b at head dim 64, the widest the port's kernel takes."""
    _check_packed((1, 4, 2, 64, 64, 64), pack, with_mask)


def _check_packed(shape, pack, with_mask):
    args = _split_case(shape, with_mask, 1)
    want = np.asarray(jatt.fused_cosine_attention_packed(
        *map(_j, args), pack=pack, interpret=True))
    got = tatt.fused_cosine_attention_packed_ref(*map(_t, args), pack=pack)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, tatt.fused_cosine_attention_ref(*map(_t, args)),
                               atol=ATOL, rtol=RTOL)


# square windows of <= 128 tokens go packed when B * nW allows a pack of 2
# or 4; one window (B * nW = 1) and rectangular shapes go unpacked
@pytest.mark.parametrize("shape,packed", [
    ((1, 6, 2, 32, 32, 8), True), ((1, 1, 2, 32, 32, 8), False),
    ((2, 2, 2, 16, 48, 8), False)])
def test_auto_dispatch_matches_pallas(shape, packed, monkeypatch):
    args = _split_case(shape, True, 2)
    want = np.asarray(jatt.fused_cosine_attention_auto(*map(_j, args),
                                                       interpret=True))
    taken = []

    def spy(name):
        fn = getattr(tatt, name)

        def call(*a, **kw):
            taken.append(name)
            return fn(*a, **kw)
        return call

    for name in ("fused_cosine_attention", "fused_cosine_attention_packed"):
        monkeypatch.setattr(tatt, name, spy(name))
    got = tatt.fused_cosine_attention_auto(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert taken == ["fused_cosine_attention_packed" if packed
                     else "fused_cosine_attention"]


def test_logit_scale_is_clamped():
    """A raw scale of 5.0 gives the output of log(100), in each plain
    version: the scale clamps at 100."""
    q, k, v, _, bias, mask = map(_t, _split_case((1, 4, 2, 16, 16, 8), True, 6))
    qkv = torch.cat([t.transpose(-1, -2).reshape(1, 4, 16, 16) for t in (q, k, v)], 2)
    hi, cl = torch.full((2, 1, 1), 5.0), torch.full((2, 1, 1), np.log(100.0))
    for fn, a in ((tatt.fused_cosine_attention_ref, (q, k, v)),
                  (tatt.fused_cosine_attention_packed_ref, (q, k, v)),
                  (tatt.fused_window_attention_qkv_ref, (qkv,))):
        extra = (2,) if fn is tatt.fused_window_attention_qkv_ref else (mask,)
        assert torch.equal(fn(*a, hi, bias, *extra), fn(*a, cl, bias, *extra))


def test_wrappers_on_cpu_take_the_plain_path():
    """kernels=True on CPU tensors runs each plain version and launches
    nothing; an input that needs grad raises."""
    args = tuple(map(_t, _split_case((2, 2, 2, 16, 16, 8), True, 3)))
    before = [k.launches for k in tatt.KERNELS]
    for fn, ref in ((tatt.fused_cosine_attention, tatt.fused_cosine_attention_ref),
                    (tatt.fused_cosine_attention_packed,
                     tatt.fused_cosine_attention_packed_ref)):
        assert torch.equal(fn(*args), ref(*args))
        assert torch.equal(fn(*args, kernels=False), ref(*args))
    rng = np.random.default_rng(4)
    qkv = _t(rng.standard_normal((1, 2, 48, 16)).astype(np.float32))
    bias = _t(rng.standard_normal((2, 16, 16)).astype(np.float32))
    assert torch.equal(tatt.fused_window_attention_qkv(qkv, args[3], bias, 2),
                       tatt.fused_window_attention_qkv_ref(qkv, args[3], bias, 2))
    assert [k.launches for k in tatt.KERNELS] == before
    with pytest.raises(RuntimeError, match="no backward"):
        tatt.fused_cosine_attention(args[0].clone().requires_grad_(True), *args[1:])


# ---------------------------------------------------- cosine_attention

class _JCos(fnn.Module):
    """grlir's cosine_attention with its own AffineTransform."""

    heads: int
    use_pallas: bool

    @fnn.compact
    def __call__(self, q, k, v, table, index, mask):
        t = jblocks.AffineTransform(self.heads, name="t")
        return jblocks.cosine_attention(q, k, v, t, table, index, mask,
                                        use_pallas=self.use_pallas, d_major=True)


def _transform_from(params, heads):
    """The port's AffineTransform carrying the JAX module's parameters."""
    p = params["params"]["t"]
    t = tblocks.AffineTransform(heads)
    with torch.no_grad():
        t.logit_scale.copy_(_t(p["logit_scale"]))
        t.cpb_mlp[0].weight.copy_(_t(p["cpb_mlp"]["fc1"]["kernel"]).t())
        t.cpb_mlp[0].bias.copy_(_t(p["cpb_mlp"]["fc1"]["bias"]))
        t.cpb_mlp[2].weight.copy_(_t(p["cpb_mlp"]["fc2"]["kernel"]).t())
    return t


# the a2w step of an 8x16 stripe at anchor df 4 (2x4 anchors against 128
# stripe tokens) and the w2a step back, d-major, with and without the shift
# mask; fused=True runs the B7 path of the stripe engine
@pytest.mark.parametrize("step", ["a2w", "w2a"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_cosine_attention_matches_jax(step, with_mask, fused):
    B, nW, h, d = 2, 3, 2, 8
    stripe, df = (8, 16), 4
    a2w = step == "a2w"
    N1, N2 = (8, 128) if a2w else (128, 8)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, nW, h, d, n)).astype(np.float32)
               for n in (N1, N2, N2))
    table = get_relative_coords_table(stripe, (0, 0), df)
    index = get_relative_position_index(stripe, df, not a2w).astype(np.int32)
    assert index.shape == (N1, N2)
    mask = None
    if with_mask:
        mask = np.where(rng.random((nW, N1, N2)) > 0.8, -100.0, 0.0).astype(np.float32)
    jmod = _JCos(h, fused)
    jargs = tuple(map(_j, (q, k, v, table, index, mask)))
    params = random_params(jmod, rng, *jargs)
    want = np.asarray(jmod.apply(params, *jargs))
    with torch.no_grad():
        got = tblocks.cosine_attention(*map(_t, (q, k, v)), _transform_from(params, h),
                                       _t(table), _t(index).long(), _t(mask), fused)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
