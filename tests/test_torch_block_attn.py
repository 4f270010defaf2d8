"""grlir_torch.ops.block_attn: the plain PyTorch block halves vs the Pallas
kernels they port (interpret mode), and the dispatch rules of the wrappers.
The CUDA kernels themselves are tested in test_torch_cuda_kernels.py."""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from grlir.ops.pallas import block_attn as jba
from grlir_torch.models.grl import GRL
from grlir_torch.ops import block_attn as tba
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import model_pair

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
    """Under grad, B1-B4's wrappers no longer raise: with kernels=True they
    return gradients (on a CPU tensor those of the plain version, on the
    card the kernel forward with the plain version's backward), equal to
    kernels=False's; only B5-B7, which have no backward in the JAX package
    either, still raise (tests/test_torch_attention.py,
    tests/test_torch_flash_attention.py)."""
    args, _ = _window_args(data, False)
    x, *rest = map(_t, args)
    grads = []
    for kernels in (True, False):
        xg = x.clone().requires_grad_(True)
        tba.window_half(xg, *rest, WIN, kernels=kernels).sum().backward()
        grads.append(xg.grad)
    assert torch.isfinite(grads[0]).all()
    torch.testing.assert_close(grads[0], grads[1], atol=0, rtol=0)
    sargs, _, _ = _stripe_args(data, (8, 16), False)
    sx, *srest = map(_t, sargs)
    sx = sx.clone().requires_grad_(True)
    tba.stripe_half(sx, *srest, (8, 16), DF).sum().backward()
    assert sx.grad is not None and torch.isfinite(sx.grad).all()
    from grlir_torch.ops import attention as tatt
    q = torch.zeros((1, 1, 1, 16, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tatt.fused_cosine_attention(q, q, q, torch.zeros((1, 1, 1)),
                                    torch.zeros((1, 16, 16)))


def _grads(torch_fn, jax_fn, args, diff, cot):
    """d sum(y * cot) / d args[i] for i in diff: (the port's autograd, grlir's
    jax.grad), args numpy arrays (None or int where not differentiated)."""
    targs = [_t(a) for a in args]
    for i in diff:
        targs[i] = targs[i].clone().requires_grad_(True)
    (torch_fn(*targs) * _t(cot)).sum().backward()
    got = [targs[i].grad.numpy() for i in diff]

    def loss(*dargs):
        jargs = [_j(a) for a in args]
        for i, v in zip(diff, dargs):
            jargs[i] = v
        return jnp.sum(jax_fn(*jargs) * _j(cot))

    want = jax.grad(loss, argnums=tuple(range(len(diff))))(
        *[_j(args[i]) for i in diff])
    return got, [np.asarray(w) for w in want]


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0)


# kernels=True on CPU tensors that require grad: the wrappers run their
# plain version with autograd; grlir differentiates its Pallas kernels
# (interpret mode) through their custom VJPs, which recompute the XLA twins.
# Every float operand's gradient, fp32, within 1e-4 of its largest
# magnitude: w's and b's gradients sum over every token and reach a few
# hundred, where fp32's own spacing is ~3e-5; the two frameworks' sums in
# other orders land ~6e-6 of that largest magnitude apart.
@pytest.mark.parametrize("shifted", [False, True])
def test_window_half_grads_match_jax(data, shifted):
    args, bands = _window_args(data, shifted)
    shift = WIN[0] // 2 if shifted else 0
    cot = np.random.default_rng(11).standard_normal((B, H, W, CW)).astype(np.float32)
    got, want = _grads(
        lambda *a: tba.window_half(*a[:5], WIN, bands=a[5], shift=shift, kernels=True),
        lambda *a: jba.fused_window_half(*a[:5], WIN, bands=a[5], shift=shift,
                                         interpret=True),
        (*args, bands), range(5), cot)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("stripe", [(8, 16), (16, 8)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_half_grads_match_jax(data, stripe, shifted):
    args, bands, bands_a = _stripe_args(data, stripe, shifted)
    shift = (stripe[0] // 2, stripe[1] // 2) if shifted else (0, 0)
    cot = np.random.default_rng(12).standard_normal((B, H, W, CW)).astype(np.float32)
    kw = dict(shift=shift)
    got, want = _grads(
        lambda *a: tba.stripe_half(*a[:8], stripe, DF, bands=a[8], bands_a=a[9],
                                   kernels=True, **kw),
        lambda *a: jba.fused_stripe_half(*a[:8], stripe, DF, bands=a[8], bands_a=a[9],
                                         interpret=True, **kw),
        (*args, bands, bands_a), range(8), cot)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("size", [(256, 256), (32, 48), (250, 250), (64, 1024)])
@pytest.mark.parametrize("window,heads", [((8, 8), 2), ((8, 8), 3),
                                          ((16, 16), 2), ((32, 32), 2),
                                          ((32, 32), 6)])
def test_window_guard_restates_pallas(size, window, heads):
    """The port takes what the Pallas window kernel takes, small windows
    (N <= 512) on B1's route and larger ones on B3's."""
    route = tba.window_route(size, window, heads)
    assert (route is not None) == jba.window_half_supported(size, window, heads)
    if route is not None:
        large = window[0] * window[1] > jba._LARGE_N
        assert route == ("large" if large else "small")


@pytest.mark.parametrize("size", [(256, 256), (32, 48), (1024, 1024)])
@pytest.mark.parametrize("stripe,df,heads", [
    ((8, 64), 4, 2), ((64, 8), 4, 3), ((8, 256), 4, 3), ((64, 64), 2, 3),
    ((8, 12), 4, 2), ((64, 128), 2, 3), ((128, 64), 2, 3), ((256, 256), 2, 6)])
def test_stripe_guard_restates_pallas(size, stripe, df, heads):
    """The port takes what the Pallas stripe kernels take: resident biases
    on B2's route, streamed ones on B4's."""
    route = tba.stripe_route(size, stripe, df, heads)
    assert (route is not None) == jba.stripe_half_supported(size, stripe, df, heads)
    if route is not None:
        resident = jba._stripe_resident_supported(stripe, df, heads)
        assert route == ("resident" if resident else "large")
        if not resident:
            assert (tba._stripe_large_tiles(stripe, df, heads)
                    == jba._stripe_large_tiles(stripe, df, heads))


def test_unrouted_geometries_raise(data, monkeypatch):
    """A geometry that no TPU kernel takes (here every half of TRUNK at
    32x32, once the TPU's budgets are cut in both packages) runs the plain
    cosine attention in engine v3, as grlir runs its XLA path there
    (grlir/models/blocks.py:557-562,717-721): the port with kernels on
    (CPU) and off equals grlir's v3 (interpret) and False, and counts every
    half in unrouted_halves.  The kernel wrappers themselves still raise on
    such a geometry, as on one that is not a multiple of the window."""
    for mod in (jba, tba):
        monkeypatch.setattr(mod, "_BIAS_VMEM_BUDGET", 1000)
        monkeypatch.setattr(mod, "_STRIPE_ATTN_BUDGET", 1000)
    assert tba.window_route((32, 32), (8, 8), 2) is None
    assert tba.stripe_route((32, 32), (8, 8), 4, 2) is None
    x = np.random.default_rng(21).random((1, 32, 32, 3)).astype(np.float32)
    for kernels, jax_mode in ((True, "v3"), (False, False)):
        jmodel, params, tmodel, _ = model_pair("pixelshuffle", 2, 4, jax_mode)
        tmodel = GRL(replace(tmodel.cfg, kernels=kernels)).eval()
        tmodel.load_state_dict(jax_params_to_state_dict(params))
        want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
        tba.reset_launches()
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
        assert tba.unrouted_halves == 2 * 4      # both halves of 4 blocks
    args, _ = _window_args(data, False)
    x, *rest = map(_t, args)
    with pytest.raises(NotImplementedError, match="no TPU window kernel"):
        tba.window_half(x, *rest, WIN)
    for kernels in (True, False):
        with pytest.raises(NotImplementedError, match="no TPU window kernel"):
            tba.window_half(x[:, :20], *rest, WIN, kernels=kernels)
    sargs, _, _ = _stripe_args(data, (8, 16), False)
    sx, sa, *srest = map(_t, sargs)
    with pytest.raises(NotImplementedError, match="no TPU stripe kernel"):
        tba.stripe_half(sx[:, :, :24], sa[:, :, :6], *srest, (8, 16), DF)


# B3: one 32x32 window (N = 1024 > _LARGE_N), the q-tiled Pallas branch
LW = (32, 32)
LN = LW[0] * LW[1]


@pytest.mark.parametrize("shifted", [False, True])
def test_window_half_large_ref_matches_pallas(data, shifted):
    """window_half_large_ref against the q-tiled branch of the Pallas window
    kernel (interpret mode) at 32x32, shifted and unshifted; the bias is
    pre-rounded to bf16, the type the large branch stores it in."""
    assert tba.window_route((H, W), LW, HEADS) == "large"
    rng = np.random.default_rng(11)
    bias = torch.from_numpy(
        (rng.standard_normal((HEADS, LN, LN)) * 0.5).astype(np.float32)
    ).to(torch.bfloat16).float().numpy()
    bands = rng.integers(0, 3, (1, LN)).astype(np.int32) if shifted else None
    shift = LW[0] // 2 if shifted else 0
    args = (data["x"], data["wqkv"], data["bqkv"], data["ls"], bias)
    want = np.asarray(jba.fused_window_half(
        *map(_j, args), LW, bands=_j(bands), shift=shift, interpret=True))
    got = tba.window_half_large_ref(*map(_t, args), LW, bands=_t(bands),
                                    shift=shift)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)
    # the router takes the same function on CPU tensors
    routed = tba.window_half(*map(_t, args), LW, bands=_t(bands), shift=shift)
    assert torch.equal(routed, got)


def _large_stripe_case(stripe, df, shifted, size, seed):
    rng = np.random.default_rng(seed)
    sh, sw = stripe
    Hs, Ws = size
    N1, N2 = sh * sw, (sh // df) * (sw // df)
    x = rng.standard_normal((B, Hs, Ws, C)).astype(np.float32)
    anchor = rng.standard_normal((B, Hs // df, Ws // df, CW)).astype(np.float32)
    b1 = (rng.standard_normal((HEADS, N2, N1)) * 0.5).astype(np.float32)
    b2 = (rng.standard_normal((HEADS, N1, N2)) * 0.5).astype(np.float32)
    bands = bands_a = None
    if shifted:
        nW = (Hs // sh) * (Ws // sw)
        bands = rng.integers(0, 3, (nW, N1)).astype(np.int32)
        bands_a = rng.integers(0, 3, (nW, N2)).astype(np.int32)
    return (x, anchor, data_w(rng), *data_b(rng), b1, b2), bands, bands_a


def data_w(rng):
    return (rng.standard_normal((C, 3 * CW)) * 0.05).astype(np.float32)


def data_b(rng):
    return ((rng.standard_normal(3 * CW) * 0.05).astype(np.float32),
            np.array([math.log(8.0), 5.0], np.float32).reshape(HEADS, 1, 1),
            np.array([math.log(12.0), 4.0], np.float32).reshape(HEADS, 1, 1))


# (16, 16) and (16, 8) at df 2 route to the streamed-bias kernels only with
# both sides' budgets cut (as tests/test_block_attn.py does, with a resident
# budget low enough for the vertical stripe too); (64, 64)/df 2, GRL-base's
# eval stripe, takes that route at the real budgets
@pytest.mark.parametrize("stripe,size,patch", [
    ((16, 16), (32, 32), True), ((16, 8), (32, 32), True),
    ((64, 64), (64, 64), False)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_half_large_ref_matches_pallas(stripe, size, patch, shifted,
                                              monkeypatch):
    df = 2
    if patch:
        for mod in (jba, tba):
            monkeypatch.setattr(mod, "_BIAS_VMEM_BUDGET", 50_000)
            monkeypatch.setattr(mod, "_STRIPE_ATTN_BUDGET", 64 * 1024)
    assert tba.stripe_route(size, stripe, df, HEADS) == "large"
    assert not jba._stripe_resident_supported(stripe, df, HEADS)
    args, bands, bands_a = _large_stripe_case(stripe, df, shifted, size, 12)
    shift = (stripe[0] // 2, stripe[1] // 2) if shifted else (0, 0)
    if shifted:   # the anchor arrives rolled, as the block passes it
        args = (args[0], np.roll(args[1], (-shift[0] // df, -shift[1] // df),
                                 axis=(1, 2)), *args[2:])
    want = np.asarray(jba.fused_stripe_half(
        *map(_j, args), stripe, df, bands=_j(bands), bands_a=_j(bands_a),
        shift=shift, interpret=True))
    got = tba.stripe_half_large_ref(*map(_t, args), stripe, df,
                                    bands=_t(bands), bands_a=_t(bands_a),
                                    shift=shift)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)
    routed = tba.stripe_half(*map(_t, args), stripe, df, bands=_t(bands),
                             bands_a=_t(bands_a), shift=shift)
    assert torch.equal(routed, got)


# bf16 x and anchor, as the served GRL-base path runs B4: the plain version
# rounds where the TPU kernels round (bias in bf16, the scale after the
# product, the softmax normalised before rounding, x1 in bf16), which the
# tensor-core kernels keep.  Tolerance: interpret mode and PyTorch on the CPU
# may flip a bf16 rounding of a projection, a probability or x1, which moves
# y by about one bf16 ulp; 8e-3 is two ulps at |y| in [0.5, 1) and one at
# [1, 2), where the largest outputs lie (|y| <= 1.8 here).
@pytest.mark.parametrize("stripe", [(16, 16), (16, 8)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_half_large_ref_matches_pallas_bf16(stripe, shifted,
                                                   monkeypatch):
    df, size = 2, (32, 32)
    for mod in (jba, tba):
        monkeypatch.setattr(mod, "_BIAS_VMEM_BUDGET", 50_000)
        monkeypatch.setattr(mod, "_STRIPE_ATTN_BUDGET", 64 * 1024)
    assert tba.stripe_route(size, stripe, df, HEADS) == "large"
    args, bands, bands_a = _large_stripe_case(stripe, df, shifted, size, 12)
    shift = (stripe[0] // 2, stripe[1] // 2) if shifted else (0, 0)
    if shifted:
        args = (args[0], np.roll(args[1], (-shift[0] // df, -shift[1] // df),
                                 axis=(1, 2)), *args[2:])
    x, anchor = (torch.from_numpy(a).bfloat16() for a in args[:2])
    want = jba.fused_stripe_half(
        _j(x.float().numpy()).astype(jnp.bfloat16),
        _j(anchor.float().numpy()).astype(jnp.bfloat16), *map(_j, args[2:]),
        stripe, df, bands=_j(bands), bands_a=_j(bands_a), shift=shift,
        interpret=True)
    assert want.dtype == jnp.bfloat16
    got = tba.stripe_half_large_ref(x, anchor, *map(_t, args[2:]), stripe,
                                    df, bands=_t(bands), bands_a=_t(bands_a),
                                    shift=shift)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=8e-3, rtol=8e-3)
    routed = tba.stripe_half(x, anchor, *map(_t, args[2:]), stripe, df,
                             bands=_t(bands), bands_a=_t(bands_a), shift=shift)
    assert torch.equal(routed, got)


def test_pack_w_is_the_projection():
    """The tensor-core routes' layout of w: row p*Cs + head*d + e of the
    packed parts p0..p0+n holds column e of that head's part p0+p in its
    first C values, rows 16-byte aligned; x times those values plus the
    parts' b is x @ w + b."""
    rng = np.random.default_rng(14)
    C, h, d = 70, 3, 10
    w = torch.from_numpy(rng.standard_normal((C, 3 * h * d)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(3 * h * d).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, C)).astype(np.float32)).bfloat16()
    full = (x.float() @ w.bfloat16().float() + b).reshape(5, 3, h, d)
    for p0, n in ((0, 1), (1, 2), (0, 3)):
        wt = tba._pack_w(w, p0, n)
        assert wt.dtype == torch.bfloat16 and tuple(wt.shape) == (n * h * d, 80)
        assert wt.stride() == (80, 1)
        got = x.float() @ wt[:, :C].float().t() + b[p0 * h * d:(p0 + n) * h * d]
        torch.testing.assert_close(got.reshape(5, n, h, d), full[:, p0:p0 + n],
                                   atol=1e-5, rtol=1e-5)


def test_large_routes_round_as_their_tpu_kernels():
    """The large-window route differs from the small one exactly where the
    TPU kernels do: B3 rounds its bias to bf16 even for fp32 x."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((1, 32, 32, C)).astype(np.float32))
    w = torch.from_numpy(data_w(rng))
    bq, ls1, ls2 = map(torch.from_numpy, data_b(rng))
    bias = torch.from_numpy(rng.standard_normal((HEADS, LN, LN)).astype(np.float32))
    large = tba.window_half_large_ref(x, w, bq, ls1, bias, LW)
    small = tba.window_half_ref(x, w, bq, ls1, bias, LW)
    rounded = tba.window_half_ref(x, w, bq, ls1, bias.bfloat16().float(), LW)
    assert not torch.equal(large, small) and torch.equal(large, rounded)


# bf16 x (and anchor), as the served paths run B2 and B3 on tensor cores:
# the plain versions round where the TPU kernels round (the logit scale
# folded into q, and k for a2w, before rounding; exp(s - max) rounded, the
# 1/sum applied after the product; B3's bias in bf16, B2's fp32; B2's x1 in
# bf16).  Tolerance: interpret mode and PyTorch on the CPU may flip a bf16
# rounding of a projection, an exp or x1, which moves y by about one bf16
# ulp; 8e-3 is two ulps at |y| in [0.5, 1) and one at [1, 2), where the
# largest outputs lie (|y| < 2 here).
def _bf16_pair(a):
    """A float32 array as bf16 for both packages: (torch, jax)."""
    t = torch.from_numpy(a).bfloat16()
    return t, _j(t.float().numpy()).astype(jnp.bfloat16)


def _assert_bf16_close(got, want):
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=8e-3, rtol=8e-3)


@pytest.mark.parametrize("shifted", [False, True])
def test_window_half_large_ref_matches_pallas_bf16(data, shifted):
    """B3's plain version in bf16 against the q-tiled branch of the Pallas
    window kernel (interpret mode): window 32, with band ids when shifted."""
    rng = np.random.default_rng(15)
    bias = torch.from_numpy(
        (rng.standard_normal((HEADS, LN, LN)) * 0.5).astype(np.float32)
    ).to(torch.bfloat16).float().numpy()
    bands = rng.integers(0, 3, (1, LN)).astype(np.int32) if shifted else None
    shift = LW[0] // 2 if shifted else 0
    xt, xj = _bf16_pair(data["x"])
    rest = (data["wqkv"], data["bqkv"], data["ls"], bias)
    want = jba.fused_window_half(xj, *map(_j, rest), LW, bands=_j(bands),
                                 shift=shift, interpret=True)
    got = tba.window_half_large_ref(xt, *map(_t, rest), LW, bands=_t(bands),
                                    shift=shift)
    _assert_bf16_close(got, want)
    routed = tba.window_half(xt, *map(_t, rest), LW, bands=_t(bands),
                             shift=shift)
    assert torch.equal(routed, got)


@pytest.mark.parametrize("stripe", [(8, 16), (16, 8)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_half_ref_matches_pallas_bf16(data, stripe, shifted):
    """B2's plain version in bf16 against the resident-bias Pallas stripe
    kernel (interpret mode), horizontal and vertical stripes.  The logit
    scales are the init's (log 10 and log 12, below the clamp): B2 runs two
    attentions in a row, and at the fixture's clamped scale of 100 one
    flipped bf16 rounding of q or k moves a whole token's output by several
    ulps, between grlir's Pallas kernel and its own XLA twin of it
    (`fused_stripe_half(..., ref=True)`) too; the fp32 test above covers
    the clamp."""
    scales = {"ls": np.full((HEADS, 1, 1), math.log(10.0), np.float32),
              "ls2": np.full((HEADS, 1, 1), math.log(12.0), np.float32)}
    args, bands, bands_a = _stripe_args({**data, **scales}, stripe, shifted,
                                        seed=16)
    assert tba.stripe_route((H, W), stripe, DF, HEADS) == "resident"
    shift = (stripe[0] // 2, stripe[1] // 2) if shifted else (0, 0)
    (xt, xj), (at, aj) = _bf16_pair(args[0]), _bf16_pair(args[1])
    want = jba.fused_stripe_half(
        xj, aj, *map(_j, args[2:]), stripe, DF, bands=_j(bands),
        bands_a=_j(bands_a), shift=shift, interpret=True)
    got = tba.stripe_half_ref(xt, at, *map(_t, args[2:]), stripe, DF,
                              bands=_t(bands), bands_a=_t(bands_a), shift=shift)
    _assert_bf16_close(got, want)
    routed = tba.stripe_half(xt, at, *map(_t, args[2:]), stripe, DF,
                             bands=_t(bands), bands_a=_t(bands_a), shift=shift)
    assert torch.equal(routed, got)


# (C, h, d): GRL-base's width, and GRL-S's, where nothing is padded
@pytest.mark.parametrize("C,h,d", [(180, 3, 30), (128, 2, 32)])
def test_pack_w_with_scales_is_the_scaled_projection(C, h, d):
    """The tensor-core projection on the packed w, as the kernel computes
    it (B3: the logit scale on q; B2: s2 on q, s1 on k): each head's d
    columns zero-padded to 32, x times them plus b, unit-normed over the 32
    for q and k, times the scale of part 0 or 1, rounded to bf16, is
    bf16(unit(x w + b) s) per head, as the plain versions compute it; v is
    the unscaled projection.  Tolerance: one bf16 ulp, for the two
    summation orders of the products."""
    rng = np.random.default_rng(17)
    w = torch.from_numpy(rng.standard_normal((C, 3 * h * d)).astype(np.float32) * 0.05)
    b = torch.from_numpy(rng.standard_normal(3 * h * d).astype(np.float32) * 0.05)
    x = torch.from_numpy(rng.standard_normal((9, C)).astype(np.float32)).bfloat16()
    s1, s2 = (tba._scale(torch.from_numpy(rng.uniform(1, 5, (h, 1, 1)).astype(np.float32)))
              for _ in range(2))
    q, k, v = (x.float() @ w.bfloat16().float() + b).reshape(9, 3, h, d).unbind(1)
    wt = tba._pack_w(w, 0, 3)
    assert wt.stride() == (wt.shape[1], 1) and wt.shape[1] % 16 == 0
    rows = F.pad(wt[:, :C].float().reshape(3, h, d, C), (0, 0, 0, 32 - d))
    bp = F.pad(b.reshape(3, h, d), (0, 32 - d))
    proj = torch.einsum("tc,phec->tphe", x.float(), rows) + bp
    ones = torch.ones(h)
    for (scale0, scale1), want in (((s1, ones), (tba._unit(q) * s1[:, None], tba._unit(k), v)),
                                   ((s2, s1), (tba._unit(q) * s2[:, None],
                                               tba._unit(k) * s1[:, None], v))):
        got = torch.stack([tba._unit(proj[:, 0]) * scale0[:, None],
                           tba._unit(proj[:, 1]) * scale1[:, None], proj[:, 2]], 1)
        for p in range(3):
            torch.testing.assert_close(got[:, p, :, :d].bfloat16().float(),
                                       want[p].bfloat16().float(), atol=0,
                                       rtol=2 ** -7)
        assert not got[..., d:].any()


def test_pack_w_reads_the_weights_of_each_call():
    """The tensor-core routes pack w from the operand of each call, the
    model's view of its qkv weight (`MixedAttention`: weight.t() split per
    half), so a write to the parameter is seen whatever path it takes,
    `.data` (which bumps no version counter) included."""
    C, Cs = 48, 32
    lin = torch.nn.Linear(C, 6 * Cs)
    half = 3 * Cs
    for p0, n in ((0, 3), (1, 2), (0, 1)):
        rows = lin.weight[half + p0 * Cs:half + (p0 + n) * Cs]
        wt = tba._pack_w(lin.weight.t()[:, half:], p0, n)
        assert torch.equal(wt[:, :C], rows.bfloat16())
    before = tba._pack_w(lin.weight.t()[:, half:], 0, 3)
    lin.weight.data.mul_(2)
    after = tba._pack_w(lin.weight.t()[:, half:], 0, 3)
    assert torch.equal(after[:, :C], lin.weight[half:].bfloat16())
    assert torch.equal(after[:, :C], 2 * before[:, :C])


def test_reset_launches_clears_the_routes():
    """reset_launches sets the counts by route of B2, B3 and B4 to 0, as
    chip_smoke.py reads them just after a run."""
    assert tba.window_half_large in tba.ROUTED and tba.stripe_half in tba.ROUTED
    for k in tba.ROUTED:
        k.route_launches["tensor_core"] += 3
        k.route_launches["cuda_core"] += 1
    tba.reset_launches()
    assert all(k.route_launches == {"tensor_core": 0, "cuda_core": 0}
               for k in tba.ROUTED)


def test_reset_launches_clears_the_attend_rows():
    """reset_launches sets the counts by rows a block of B3, B4's two steps
    and B5 (the tensor-core attention's 64- and 128-row blocks) to 0."""
    from grlir_torch.ops import flash_attention as tfa

    fns = (tba.window_half_large, tba.stripe_a2w_large, tba.stripe_w2a_large,
           tfa.flash_rect_attention)
    for k in fns:
        k.attend_rows[64] += 2
        k.attend_rows[128] += 1
    tba.reset_launches()
    assert all(k.attend_rows == {64: 0, 128: 0} for k in fns)


def test_reset_launches_clears_every_kernel():
    """One call resets all nine counters: B1-B4 and their routes, B5 and
    its routes, B6/B7, and unrouted_halves."""
    from grlir_torch.ops import attention as tatt
    from grlir_torch.ops import flash_attention as tfa

    kernels = tba.KERNELS + tfa.KERNELS + tatt.KERNELS
    assert len(kernels) == 9 and set(kernels) == set(tba.COUNTED)
    for k in kernels:
        k.launches += 2
    tfa.flash_rect_attention.route_launches["tensor_core"] += 1
    tba.unrouted_halves += 1
    tba.reset_launches()
    assert [k.launches for k in kernels] == [0] * 9
    assert tfa.flash_rect_attention.route_launches == {"tensor_core": 0, "cuda_core": 0}
    assert tba.unrouted_halves == 0
