"""grlir_torch.ops.block_attn: the plain PyTorch block halves vs the Pallas
kernels they port (interpret mode), and the dispatch rules of the wrappers.
The CUDA kernels themselves are tested in test_torch_cuda_kernels.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.ops.pallas import block_attn as jba
from grlir_torch.ops import block_attn as tba

# the sizes of tests/test_block_attn.py
B, H, W, C = 2, 32, 32, 64
CW, HEADS = 32, 2
WIN = (8, 8)
N = WIN[0] * WIN[1]
DF = 4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {
        "x": rng.standard_normal((B, H, W, C)).astype(np.float32),
        "wqkv": (rng.standard_normal((C, 3 * CW)) * 0.05).astype(np.float32),
        "bqkv": (rng.standard_normal(3 * CW) * 0.05).astype(np.float32),
        # one head above the log(100) clamp
        "ls": np.array([math.log(10.0), 5.0], np.float32).reshape(HEADS, 1, 1),
        "ls2": np.array([math.log(12.0), 4.0], np.float32).reshape(HEADS, 1, 1),
    }


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _window_args(d, shifted, seed=1):
    rng = np.random.default_rng(seed)
    bias = (rng.standard_normal((HEADS, N, N)) * 0.5).astype(np.float32)
    bands = None
    if shifted:
        bands = rng.integers(0, 3, ((H // WIN[0]) * (W // WIN[1]), N)).astype(np.int32)
    return (d["x"], d["wqkv"], d["bqkv"], d["ls"], bias), bands


def _stripe_args(d, stripe, shifted, seed=2):
    rng = np.random.default_rng(seed)
    sh, sw = stripe
    N1, N2 = sh * sw, (sh // DF) * (sw // DF)
    anchor = rng.standard_normal((B, H // DF, W // DF, CW)).astype(np.float32)
    b1 = (rng.standard_normal((HEADS, N2, N1)) * 0.5).astype(np.float32)
    b2 = (rng.standard_normal((HEADS, N1, N2)) * 0.5).astype(np.float32)
    bands = bands_a = None
    if shifted:
        nW = (H // sh) * (W // sw)
        bands = rng.integers(0, 3, (nW, N1)).astype(np.int32)
        bands_a = rng.integers(0, 3, (nW, N2)).astype(np.int32)
    args = (d["x"], anchor, d["wqkv"], d["bqkv"], d["ls"], d["ls2"], b1, b2)
    return args, bands, bands_a


@pytest.mark.parametrize("shifted", [False, True])
def test_window_half_ref_matches_pallas(data, shifted):
    args, bands = _window_args(data, shifted)
    shift = WIN[0] // 2 if shifted else 0
    want = np.asarray(jba.fused_window_half(
        *map(_j, args), WIN, bands=_j(bands), shift=shift, interpret=True))
    got = tba.window_half_ref(*map(_t, args), WIN, bands=_t(bands), shift=shift)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


# (8, 16) is a horizontal stripe, (16, 8) a vertical one; shifted stripes
# roll x by half a stripe in each axis (the anchor arrives rolled)
@pytest.mark.parametrize("stripe", [(8, 16), (16, 8)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_half_ref_matches_pallas(data, stripe, shifted):
    args, bands, bands_a = _stripe_args(data, stripe, shifted)
    shift = (stripe[0] // 2, stripe[1] // 2) if shifted else (0, 0)
    want = np.asarray(jba.fused_stripe_half(
        *map(_j, args), stripe, DF, bands=_j(bands), bands_a=_j(bands_a),
        shift=shift, interpret=True))
    got = tba.stripe_half_ref(*map(_t, args), stripe, DF, bands=_t(bands),
                              bands_a=_t(bands_a), shift=shift)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


def test_cpu_tensors_take_the_plain_path(data):
    """kernels=True on CPU tensors runs the plain version and launches no
    kernel."""
    args, bands = _window_args(data, True)
    targs = tuple(map(_t, args))
    before = (tba.window_half.launches, tba.stripe_half.launches)
    got = tba.window_half(*targs, WIN, bands=_t(bands), shift=4)
    want = tba.window_half_ref(*targs, WIN, bands=_t(bands), shift=4)
    assert torch.equal(got, want)
    sargs, sb, sba = _stripe_args(data, (8, 16), True)
    st = tuple(map(_t, sargs))
    got = tba.stripe_half(*st, (8, 16), DF, bands=_t(sb), bands_a=_t(sba),
                          shift=(4, 8))
    want = tba.stripe_half_ref(*st, (8, 16), DF, bands=_t(sb),
                               bands_a=_t(sba), shift=(4, 8))
    assert torch.equal(got, want)
    assert (tba.window_half.launches, tba.stripe_half.launches) == before


def test_grad_requiring_input_raises(data):
    args, _ = _window_args(data, False)
    x, *rest = map(_t, args)
    x = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tba.window_half(x, *rest, WIN)
    sargs, _, _ = _stripe_args(data, (8, 16), False)
    sx, *srest = map(_t, sargs)
    with pytest.raises(RuntimeError, match="no backward"):
        tba.stripe_half(sx.clone().requires_grad_(True), *srest, (8, 16), DF)
    # under no_grad the same call runs; kernels=False keeps autograd
    with torch.no_grad():
        tba.window_half(x, *rest, WIN)
    tba.window_half(x, *rest, WIN, kernels=False).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("size", [(256, 256), (32, 48), (250, 250), (64, 1024)])
@pytest.mark.parametrize("window,heads", [((8, 8), 2), ((8, 8), 3),
                                          ((16, 16), 2), ((32, 32), 2),
                                          ((32, 32), 6)])
def test_window_guard_restates_pallas(size, window, heads):
    """The port takes what the small-window Pallas branch takes (N <= 512);
    larger windows belong to the q-tiled branch (B3)."""
    want = (jba.window_half_supported(size, window, heads)
            and window[0] * window[1] <= jba._LARGE_N)
    assert tba.window_half_supported(size, window, heads) == want


@pytest.mark.parametrize("size", [(256, 256), (32, 48), (1024, 1024)])
@pytest.mark.parametrize("stripe,df,heads", [
    ((8, 64), 4, 2), ((64, 8), 4, 3), ((8, 256), 4, 3), ((64, 64), 2, 3),
    ((8, 12), 4, 2)])
def test_stripe_guard_restates_pallas(size, stripe, df, heads):
    want = (jba.stripe_half_supported(size, stripe, df, heads)
            and jba._stripe_resident_supported(stripe, df, heads))
    assert tba.stripe_half_supported(size, stripe, df, heads) == want
