"""The CUDA block-half kernels vs their plain PyTorch versions, on a card.

Needs an NVIDIA Hopper GPU and nvcc; skips without a CUDA device.  The file
imports no JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py configures JAX.)  The geometries go beyond
GRL-S's: small and large windows, ragged stripe tiles (N1 not a multiple of
64), N2 not a multiple of 32, vertical stripes, batch 2, and GRL-base's
three heads of d = 30 on every route: the small-window (B1) and
resident-stripe (B2) kernels at its deployed window 8 / df 4, the
large-window (B3) and streamed-bias stripe (B4) kernels at its eval
geometry (window 32, stripes 64x64 and 64x128, df 2), B3 and B4 also at
GRL-base's width (C = 180), B4 on the ragged V stripes of the 1080p repair
and on an odd geometry, B2 at GRL-S's and GRL-base's widths in both stripe
directions and at C = 90 (x rows not 8-byte aligned); B2, B3 and B4 count
each launch on its route (bf16 on tensor cores, fp32 on CUDA cores); B1-B5
also at head dims up to 64.  B3's bf16 route is held to the stage gates of
`grlir_torch.b3_spread` (its attention against the plain attention on its
own q, k, v; its q, k, v bf16 flips against the plain path's, both counted
against a float64-summed projection; the share of outputs off by more
than 1e-2 end to end), also over the twelve input draws of `b3_spread`;
B5's bf16 route is held to the same gates over the twelve draws of
`b5_spread` at GRL-base's three steps (ROADMAP C5), and B1's bf16 route
to them over the twelve draws of `b1_spread` at GRL-base-bsr's window 16
(ROADMAP C9); B3 also at the JPEG experiment's window 36 on 288^2.
The fused engines' kernels run at GRL-S's and GRL-base's
shapes and at ragged ones: B5 (`flash_rect_attention`, bf16 on tensor
cores, fp32 on CUDA cores, counted by route), B6
(`fused_window_attention_qkv`), B7a (`fused_cosine_attention`, token-major
and d-major operands) and B7b (`fused_cosine_attention_packed`, the same
function as B7a).  The one-pass tensor-core attention under B3, B4 and B5
takes 64 or 128 query rows a block by the grid's size: both are counted
(`attend_rows`), at ragged shapes, with a running max that rises in the
last key chunk and with rows whose keys are all band-masked.
"""

import math

import numpy as np
import pytest
import torch

from grlir_torch import b1_spread, b3_spread, b5_spread
from grlir_torch.ops import attention as tatt
from grlir_torch.ops import block_attn as tba
from grlir_torch.ops import flash_attention as tfa

B, C, CW, HEADS, DF = 2, 64, 32, 2, 4
BF16_MAX_ERR = 1e-2   # outputs |y| < 1: a few bf16 ulps
FP32_TOL = 1e-4       # summation order only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _weights(rng, dev):
    return (_rand(rng, C, 3 * CW, std=0.05).to(dev),
            _rand(rng, 3 * CW, std=0.05).to(dev),
            torch.tensor([math.log(10.0), 5.0]).reshape(HEADS, 1, 1).to(dev),
            torch.tensor([math.log(12.0), 4.0]).reshape(HEADS, 1, 1).to(dev))


def _bands(rng, nw, n, dev):
    return torch.from_numpy(rng.integers(0, 3, (nw, n)).astype(np.int32)).to(dev)


def _bf16_ulp(v: float) -> float:
    """The bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (math.frexp(abs(v))[1] - 8)


def _assert_close(got, want, dtype, ulp_gate=False):
    """fp32: atol/rtol FP32_TOL.  bf16: max|diff| <= BF16_MAX_ERR, or with
    ulp_gate (B4) <= max(BF16_MAX_ERR, 2 bf16 ulps of max|want|): B4's
    tensor-core sums of the projection round k, q and v to bf16 in another
    order than the plain path, and the clamped head's logit scale of 100
    turns a one-ulp flip of k or q into about a percent of a probability,
    so y moves by a fraction of the values it averages, whose scale is that
    of the largest outputs (PERF.md, section 6)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
        return
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    gate = max(BF16_MAX_ERR, 2 * _bf16_ulp(top)) if ulp_gate else BF16_MAX_ERR
    assert err <= gate, f"max|diff| {err:.3e} > {gate:.3e} (max|want| {top:.4f})"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,shift", [((8, 8), 0), ((8, 8), 4), ((4, 4), 2),
                                          ((16, 16), 8), ((6, 6), 3)])
def test_window_kernel_matches_plain(cuda, dtype, window, shift):
    rng = np.random.default_rng(3)
    H, W = 48, 48
    n = window[0] * window[1]
    x = _rand(rng, B, H, W, C).to(cuda, dtype)
    w, b, ls, _ = _weights(rng, cuda)
    bias = _rand(rng, HEADS, n, n).to(cuda)
    bands = _bands(rng, (H // window[0]) * (W // window[1]), n, cuda) if shift else None
    before, routes = tba.window_half.launches, _routes([tba.window_half])
    with torch.no_grad():
        got = tba.window_half(x, w, b, ls, bias, window, bands, shift)
        want = tba.window_half(x, w, b, ls, bias, window, bands, shift, kernels=False)
        moved = tba.window_half(x, w * 1.001, b, ls, bias, window, bands, shift)
    torch.cuda.synchronize()
    # the kernel ran (its count and its route's), wrote storage of its own,
    # and reads w: its output moves with w
    assert tba.window_half.launches == before + 2
    routes[0]["tensor_core" if dtype == torch.bfloat16 else "cuda_core"] += 2
    assert _routes([tba.window_half]) == routes
    assert got.data_ptr() != want.data_ptr()
    assert (moved.float() - got.float()).abs().max().item() > 0
    _assert_close(got, want, dtype, ulp_gate=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stripe,shift", [((8, 16), (0, 0)), ((8, 16), (4, 8)),
                                          ((16, 8), (8, 4)), ((8, 12), (4, 6)),
                                          ((16, 48), (8, 24))])
def test_stripe_kernel_matches_plain(cuda, dtype, stripe, shift):
    rng = np.random.default_rng(4)
    sh, sw = stripe
    H, W = 32, 48
    n1, n2 = sh * sw, (sh // DF) * (sw // DF)
    w, b, ls1, ls2 = _weights(rng, cuda)
    args = [_rand(rng, B, H, W, C).to(cuda, dtype),
            _rand(rng, B, H // DF, W // DF, CW).to(cuda, dtype), w, b, ls1, ls2,
            _rand(rng, HEADS, n2, n1).to(cuda), _rand(rng, HEADS, n1, n2).to(cuda)]
    nw = (H // sh) * (W // sw)
    shifted = shift != (0, 0)
    kw = dict(bands=_bands(rng, nw, n1, cuda) if shifted else None,
              bands_a=_bands(rng, nw, n2, cuda) if shifted else None, shift=shift)
    before = tba.stripe_half.launches
    with torch.no_grad():
        got = tba.stripe_half(*args, stripe, DF, **kw)
        want = tba.stripe_half(*args, stripe, DF, kernels=False, **kw)
    torch.cuda.synchronize()
    assert tba.stripe_half.launches == before + 1
    _assert_close(got, want, dtype)


# GRL-base: 3 heads of d = 30 per half
BC, BH, BD = 64, 3, 30
BCH = BH * BD


def _base_weights(rng, dev, c=BC, heads=BH, d=BD):
    # w at std 0.05 * sqrt(64 / C): projections at the scale of C = 64's for
    # any width, so |y| < 1, where BF16_MAX_ERR is a few bf16 ulps
    return (_rand(rng, c, 3 * heads * d, std=0.05 * math.sqrt(BC / c)).to(dev),
            _rand(rng, 3 * heads * d, std=0.05).to(dev),
            torch.tensor([math.log(10.0), 5.0, 3.0][:heads]).reshape(heads, 1, 1).to(dev),
            torch.tensor([math.log(12.0), 4.0, 2.5][:heads]).reshape(heads, 1, 1).to(dev))


def _routes(fns):
    """The launches by route of the kernels among fns that have two routes
    (B1-B5)."""
    return [dict(f.route_launches) for f in fns if f in tba.ROUTED + tfa.KERNELS]


def _expect_routes(fns, routes, dtype):
    """routes with one more launch of each routed kernel on dtype's route:
    tensor cores for bf16, CUDA cores for fp32."""
    for r in routes:
        r["tensor_core" if dtype == torch.bfloat16 else "cuda_core"] += 1
    assert _routes(fns) == routes


def _run_window(dev, dtype, window, shift, H, W, launches_of, c=BC, heads=BH, d=BD,
                batch=B):
    rng = np.random.default_rng(6)
    n = window[0] * window[1]
    x = _rand(rng, batch, H, W, c).to(dev, dtype)
    w, b, ls, _ = _base_weights(rng, dev, c, heads, d)
    bias = 16 * torch.sigmoid(_rand(rng, heads, n, n)).to(dev)
    bands = _bands(rng, (H // window[0]) * (W // window[1]), n, dev) if shift else None
    before, routes = launches_of.launches, _routes([launches_of])
    with torch.no_grad():
        got = tba.window_half(x, w, b, ls, bias, window, bands, shift)
        want = tba.window_half(x, w, b, ls, bias, window, bands, shift, kernels=False)
    torch.cuda.synchronize()
    assert launches_of.launches == before + 1
    _expect_routes([launches_of], routes, dtype)
    if launches_of is tba.window_half_large and dtype == torch.bfloat16:
        _assert_b3_stages(x, w, b, ls, bias, bands, shift, heads, got, want, window)
        return
    _assert_close(got, want, dtype, ulp_gate=launches_of is tba.window_half)


def _assert_b3_stages(x, w, b, ls, bias, bands, shift, heads, got, want,
                      window=b3_spread.WINDOW):
    """B3's bf16 route against its stage gates (`b3_spread.stage_failures`)
    in place of a flat end-to-end bound: at logit scale 100 a one-ulp flip
    of a large q or k value in a near-tied row moves y by several ulps
    (ROADMAP C4).  The gated y is the wrapper's, and the stage split's
    plain y is the plain version's."""
    st = b3_spread.b3_stage_check(x, w, b, ls, bias, bands, shift, heads, window)
    assert torch.equal(st["y"], got.float())
    assert torch.equal(st["y_plain"], want.float())
    assert not b3_spread.stage_failures(st), b3_spread.stage_line(st)


def _run_stripe(dev, dtype, stripe, df, shift, H, W, launch_fns, c=BC, batch=B,
                direct=False, heads=BH, d=BD):
    """The stripe half (or, direct, B4's two steps called one after the
    other, whatever the route) against its plain version; every B2 or B4
    launch must take the route of dtype: tensor cores for bf16, CUDA cores
    for fp32."""
    rng = np.random.default_rng(7)
    sh, sw = stripe
    n1, n2 = sh * sw, (sh // df) * (sw // df)
    w, b, ls1, ls2 = _base_weights(rng, dev, c, heads, d)
    args = [_rand(rng, batch, H, W, c).to(dev, dtype),
            _rand(rng, batch, H // df, W // df, heads * d).to(dev, dtype), w, b, ls1, ls2,
            16 * torch.sigmoid(_rand(rng, heads, n2, n1)).to(dev),
            16 * torch.sigmoid(_rand(rng, heads, n1, n2)).to(dev)]
    nw = (H // sh) * (W // sw)
    shifted = shift != (0, 0)
    kw = dict(bands=_bands(rng, nw, n1, dev) if shifted else None,
              bands_a=_bands(rng, nw, n2, dev) if shifted else None, shift=shift)
    before, routes = [f.launches for f in launch_fns], _routes(launch_fns)

    def half(kernels):
        if not direct:
            return tba.stripe_half(*args, stripe, df, kernels=kernels, **kw)
        x, a, w_, b_, s1, s2, b1, b2 = args
        x1 = tba.stripe_a2w_large(x, a, w_, b_, s1, b1, stripe, df, kernels=kernels, **kw)
        return tba.stripe_w2a_large(x, a, x1, w_, b_, s2, b2, stripe, df, kernels=kernels,
                                    **kw)

    with torch.no_grad():
        got, want = half(True), half(False)
    torch.cuda.synchronize()
    assert [f.launches for f in launch_fns] == [n + 1 for n in before]
    _expect_routes(launch_fns, routes, dtype)
    _assert_close(got, want, dtype, ulp_gate=tba.stripe_a2w_large in launch_fns)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 4])
def test_small_kernels_at_base_heads(cuda, dtype, shift):
    """B1 and B2 at three heads of d = 30 (GRL-base's deployed zoo
    geometry: window 8, stripes 8 x W/4, df 4)."""
    _run_window(cuda, dtype, (8, 8), shift, 32, 64, tba.window_half)
    _run_stripe(cuda, dtype, (8, 16), 4, (shift, 2 * shift), 32, 64,
                [tba.stripe_half])


# (heads, d, C): GRL-base's window half (3 heads of d = 30, C = 180), two
# heads of d = 64 (C = 256: w of both heads does not fit a block's shared
# memory beside the rest, so the bf16 kernel holds one head's at a time),
# and one head of d = 64 at C = 64
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d,c", [(3, 30, 180), (2, 64, 256), (1, 64, 64)])
@pytest.mark.parametrize("window,shift", [((8, 8), 0), ((8, 8), 4), ((12, 12), 6)])
def test_window_kernel_at_head_dims(cuda, dtype, heads, d, c, window, shift):
    """B1 on both routes at head dims 30 and 64 (the bf16 tensor-core route
    takes up to 64), windows 8 and 12 (N = 144: three key chunks)."""
    _run_window(cuda, dtype, window, shift, 24, 48, tba.window_half, c=c, heads=heads, d=d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 16])
def test_window_large_kernel_matches_plain(cuda, dtype, shift):
    """B3: window 32 (N = 1024), shifted and unshifted."""
    assert tba.window_route((64, 96), (32, 32), BH) == "large"
    _run_window(cuda, dtype, (32, 32), shift, 64, 96, tba.window_half_large)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 16])
def test_window_large_kernel_at_base_width(cuda, dtype, shift):
    """B3 at GRL-base's width (C = 180, 3 heads of d = 30: x rows of 360 B,
    packed w rows padded to 192), window 32, batch 2, shifted with band ids
    and unshifted."""
    _run_window(cuda, dtype, (32, 32), shift, 64, 64, tba.window_half_large, c=180)


# (heads, d, C): GRL-S's stripe half (C = 128), GRL-base's (C = 180), and
# GRL-base's heads at C = 90, whose x rows (180 B) take the projection's
# element loads
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d,c", [(2, 32, 128), (3, 30, 180), (3, 30, 90)])
@pytest.mark.parametrize("stripe", [(8, 64), (64, 8)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_resident_kernel_at_model_widths(cuda, dtype, heads, d, c, stripe, shifted):
    """B2 at GRL-S's stripes (8x64 and 64x8 at df 4: N1 = 512, N2 = 32) on
    128 x 128, shifted by half a stripe and unshifted."""
    assert tba.stripe_route((128, 128), stripe, 4, heads) == "resident"
    shift = (stripe[0] // 2, stripe[1] // 2) if shifted else (0, 0)
    _run_stripe(cuda, dtype, stripe, 4, shift, 128, 128, [tba.stripe_half], c=c,
                heads=heads, d=d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stripe", [(64, 64), (64, 128), (128, 64)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_large_kernels_match_plain(cuda, dtype, stripe, shifted):
    """B4 (a2w then w2a): stripes 64x64 and 64x128 in both orientations at
    df 2, shifted by half a stripe and unshifted."""
    H = W = 128
    assert tba.stripe_route((H, W), stripe, 2, BH) == "large"
    shift = (stripe[0] // 2, stripe[1] // 2) if shifted else (0, 0)
    _run_stripe(cuda, dtype, stripe, 2, shift, H, W,
                [tba.stripe_a2w_large, tba.stripe_w2a_large])


# GRL-base's own width: C = 180 input channels (x rows of 360 B, 8-byte
# aligned), Cs = 90
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stripe", [(64, 64), (64, 128)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_large_kernels_at_base_width(cuda, dtype, stripe, shifted):
    H = W = 128
    assert tba.stripe_route((H, W), stripe, 2, BH) == "large"
    shift = (stripe[0] // 2, stripe[1] // 2) if shifted else (0, 0)
    _run_stripe(cuda, dtype, stripe, 2, shift, H, W,
                [tba.stripe_a2w_large, tba.stripe_w2a_large], c=180, batch=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_large_kernels_ragged_repair_geometry(cuda, dtype, shifted):
    """The V stripes of the 1080p repair (GRL-base dn, 1088 x 1920): (272, 8)
    at df 4, N1 = 2176, N2 = 136, neither a multiple of 64, on 272 x 16."""
    H, W, stripe = 272, 16, (272, 8)
    assert tba.stripe_route((H, W), stripe, 4, BH) == "large"
    shift = (136, 4) if shifted else (0, 0)
    _run_stripe(cuda, dtype, stripe, 4, shift, H, W,
                [tba.stripe_a2w_large, tba.stripe_w2a_large], c=180, batch=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stripe_large_kernels_odd_geometry(cuda, dtype):
    """B4's steps called directly on a geometry no route sends them: C = 90
    (x rows not 8-byte aligned), 6 x 6 stripes at df 2 (N1 = 36, N2 = 9:
    bias rows not 16-byte aligned), which take the kernels' element loads."""
    _run_stripe(cuda, dtype, (6, 6), 2, (3, 3), 12, 18,
                [tba.stripe_a2w_large, tba.stripe_w2a_large], c=90, direct=True)


@pytest.mark.cuda
def test_kernels_refuse_large_geometries(cuda):
    """Geometries that no TPU kernel takes, or whose head dim is beyond the
    kernels' 64 columns, raise; nothing falls back."""
    rng = np.random.default_rng(5)
    w, b, ls, _ = _weights(rng, cuda)
    x = torch.zeros((1, 256, 256, C), device=cuda)
    dummy = torch.zeros(1, device=cuda)   # the route is refused before use
    # a 64x64 window's bf16 bias (2 x 4096^2 x 2 B) exceeds the 8 MB budget
    with torch.no_grad(), pytest.raises(NotImplementedError, match="no TPU window"):
        tba.window_half(x, w, b, ls, dummy, (64, 64))
    # a 256x256 stripe has no streamed tiling within the 4 MB budget
    anchor = torch.zeros((1, 128, 128, CW), device=cuda)
    assert tba.stripe_route((256, 256), (256, 256), 2, HEADS) is None
    with torch.no_grad(), pytest.raises(NotImplementedError, match="no TPU stripe"):
        tba.stripe_half(x, anchor, w, b, ls, ls, dummy, dummy, (256, 256), 2)
    # one head of d = 96 is beyond the large-window kernel's 64 columns
    w1 = torch.zeros((C, 3 * 96), device=cuda)
    ls1 = torch.zeros((1, 1, 1), device=cuda)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="head dim"):
        tba.window_half(x[:, :64, :64], w1, None, ls1,
                        torch.zeros((1, 1024, 1024), device=cuda), (32, 32))
    # and beyond the resident stripe kernel's on its bf16 route (GRL-S's
    # 64x8 stripes at df 4); its fp32 route takes it
    assert tba.stripe_route((64, 64), (64, 8), 4, 1) == "resident"
    with torch.no_grad(), pytest.raises(NotImplementedError, match="head dim"):
        tba.stripe_half(x[:, :64, :64].bfloat16(),
                        torch.zeros((1, 16, 16, 96), device=cuda, dtype=torch.bfloat16),
                        w1, None, ls1, ls1, torch.zeros((1, 32, 512), device=cuda),
                        torch.zeros((1, 512, 32), device=cuda), (64, 8), 4)


@pytest.mark.cuda
def test_stripe_resident_fp32_takes_head_dim_64(cuda):
    """B2's CUDA-core route (fp32) at one head of d = 64, the widest its
    shared memory holds."""
    _run_stripe(cuda, torch.float32, (8, 16), 4, (4, 8), 32, 64, [tba.stripe_half],
                c=64, heads=1, d=64)


# Two heads of d = 64 at C = 128 (the tensor-core routes' rows of 64
# columns), and one head of d = 40 (rows of 64, zeros past d)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(2, 64), (1, 40)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_resident_kernel_at_head_dim_64(cuda, dtype, heads, d, shifted):
    """B2 on both routes at GRL-S's 8 x 64 stripes (N1 = 512, N2 = 32) and
    at 8 x 16 (N2 = 8)."""
    for stripe, H, W in (((8, 64), 32, 128), ((8, 16), 32, 64)):
        shift = (stripe[0] // 2, stripe[1] // 2) if shifted else (0, 0)
        _run_stripe(cuda, dtype, stripe, 4, shift, H, W, [tba.stripe_half], c=128,
                    batch=1, heads=heads, d=d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(2, 64), (1, 40)])
@pytest.mark.parametrize("shift", [0, 16])
def test_window_large_kernel_at_head_dim_64(cuda, dtype, heads, d, shift):
    """B3 on both routes at window 32 (N = 1024), heads of d = 64 and
    40."""
    _run_window(cuda, dtype, (32, 32), shift, 64, 64, tba.window_half_large, c=128,
                heads=heads, d=d)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,d", b3_spread.SHAPES)
@pytest.mark.parametrize("shift", b3_spread.SHIFTS)
@pytest.mark.parametrize("seed", b3_spread.SEEDS)
def test_window_large_bf16_stage_gates(cuda, seed, shift, c, heads, d):
    """B3's bf16 route on the twelve input draws of `b3_spread` (three seeds,
    shifted and not, GRL-base's 3 heads of d = 30 and 2 heads of d = 64 at
    window 32 on 2 x 64^2): every draw within the three stage gates.  Seed
    6 draws the inputs of `_run_window`."""
    x, w, b, ls, bias, bands = b3_spread.draw(seed, shift, c, heads, d, cuda)
    routes = _routes([tba.window_half_large])
    with torch.no_grad():
        got = tba.window_half(x, w, b, ls, bias, b3_spread.WINDOW, bands, shift)
        want = tba.window_half(x, w, b, ls, bias, b3_spread.WINDOW, bands, shift,
                               kernels=False)
    torch.cuda.synchronize()
    _expect_routes([tba.window_half_large], routes, torch.bfloat16)
    _assert_b3_stages(x, w, b, ls, bias, bands, shift, heads, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", b1_spread.SHIFTS)
@pytest.mark.parametrize("seed", b1_spread.SEEDS)
def test_window16_bf16_stage_gates(cuda, seed, shift):
    """B1's bf16 route on the twelve input draws of `b1_spread` (six seeds,
    shifted by 8 and not, GRL-base-bsr's window half at 256^2: window 16,
    3 heads of d = 30, C = 180): every draw within the three stage gates of
    `b3_spread` (ROADMAP C9).  The gated y is the wrapper's, and the stage
    split's plain y is the plain version's."""
    x, w, b, ls, bias, bands = b1_spread.draw(seed, shift, cuda)
    routes = _routes([tba.window_half])
    with torch.no_grad():
        got = tba.window_half(x, w, b, ls, bias, b1_spread.WINDOW, bands, shift)
        want = tba.window_half(x, w, b, ls, bias, b1_spread.WINDOW, bands, shift,
                               kernels=False)
    torch.cuda.synchronize()
    _expect_routes([tba.window_half], routes, torch.bfloat16)
    st = b1_spread.b1_stage_check(x, w, b, ls, bias, bands, shift, b1_spread.HEADS)
    assert torch.equal(st["y"], got.float())
    assert torch.equal(st["y_plain"], want.float())
    assert not b3_spread.stage_failures(st), b3_spread.stage_line(st)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 18])
def test_window_large_kernel_at_jpeg_geometry(cuda, dtype, shift):
    """B3 at the JPEG experiment's window half (jpeg/grl_p288: GRL-S width,
    window 36, N = 1296, whose last q tile of 64 is ragged at 16 rows; 2
    heads of d = 32, C = 128, one 288^2 patch), shifted by 18 and not; bf16
    on the stage gates."""
    assert tba.window_route((288, 288), (36, 36), 2) == "large"
    _run_window(cuda, dtype, (36, 36), shift, 288, 288, tba.window_half_large, c=128,
                heads=2, d=32, batch=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(2, 64), (1, 40)])
@pytest.mark.parametrize("shifted", [False, True])
def test_stripe_large_kernels_at_head_dim_64(cuda, dtype, heads, d, shifted):
    """B4's two steps on both routes at GRL-base's 64 x 64 stripes, df 2
    (N1 = 4096, N2 = 1024), heads of d = 64 and 40."""
    shift = (32, 32) if shifted else (0, 0)
    _run_stripe(cuda, dtype, (64, 64), 2, shift, 128, 64,
                [tba.stripe_a2w_large, tba.stripe_w2a_large], c=128, batch=1,
                heads=heads, d=d)


@pytest.mark.cuda
def test_tensor_core_routes_see_weight_writes(cuda):
    """B3 and B2 on their bf16 route read w on every call: after a write
    through `.data`, which bumps no version counter, the next call matches
    the plain version of the new weights."""
    rng = np.random.default_rng(8)
    w, b, ls1, ls2 = _base_weights(rng, cuda)
    x = _rand(rng, 1, 32, 64, BC).to(cuda, torch.bfloat16)
    anchor = _rand(rng, 1, 8, 16, BCH).to(cuda, torch.bfloat16)
    bias = 16 * torch.sigmoid(_rand(rng, BH, 1024, 1024)).to(cuda)
    b1 = 16 * torch.sigmoid(_rand(rng, BH, 8, 128)).to(cuda)
    b2 = 16 * torch.sigmoid(_rand(rng, BH, 128, 8)).to(cuda)
    calls = [lambda k: tba.window_half(x, w, b, ls1, bias, (32, 32), kernels=k),
             lambda k: tba.stripe_half(x, anchor, w, b, ls1, ls2, b1, b2, (8, 16), 4,
                                       kernels=k)]
    new_w = _rand(rng, BC, 3 * BCH, std=0.05).to(cuda)
    with torch.no_grad():
        first = [call(True) for call in calls]
        w.data.copy_(new_w)
        for call, y0 in zip(calls, first):
            y = call(True)
            assert not torch.equal(y, y0)
            _assert_close(y, call(False), torch.bfloat16)


# ------------------------------------------------- fused engines (B5-B7)

def _scales(h, dev):
    return torch.tensor([math.log(10.0), 5.0, 3.0][:h]).reshape(h, 1, 1).to(dev)


def _assert_fp32_close(got, want):
    """B6/B7's gate in either input type: |got - want| <= FP32_TOL (1 +
    |want|), plus, for bf16 outputs, one bf16 ulp of |want|: both sides
    compute in fp32 and round only y, so a rounding boundary between two
    values that agree to 1e-4 moves one of them by an ulp."""
    ulp = 0.0
    if want.dtype == torch.bfloat16:
        a = want.float().abs().clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    err = (got.float() - want.float()).abs()
    gate = FP32_TOL * (1 + want.float().abs()) + ulp
    assert bool((err <= gate).all()), (
        f"max|diff| {err.max().item():.3e} beyond the gate (max excess "
        f"{(err - gate).max().item():.3e})")


def _launched(fn, call):
    """Run call() under no_grad; assert it launched fn once; return y."""
    before = fn.launches
    with torch.no_grad():
        y = call()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return y


# (B, nW, h, d, N1, N2): GRL-S's 8x64 stripes at 256^2 (w2a, a2w),
# GRL-base's window 32 and its 64x64-stripe a2w step at df 2, a ragged
# shape (N1 not a multiple of 32, N2 not a multiple of 128), and head dims
# 64 and 40 (rows of 64 columns)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,with_bands", [
    ((2, 4, 2, 32, 512, 32), True), ((2, 4, 2, 32, 32, 512), True),
    ((1, 2, 3, 30, 1024, 1024), True), ((1, 2, 3, 30, 1024, 4096), False),
    ((1, 3, 2, 16, 100, 70), True), ((2, 4, 2, 64, 512, 32), True),
    ((1, 2, 2, 64, 1024, 1024), False), ((1, 3, 1, 40, 100, 300), True)])
def test_flash_kernel_matches_plain(cuda, dtype, shape, with_bands):
    B, nW, h, d, N1, N2 = shape
    rng = np.random.default_rng(8)
    # values at std 0.25 keep |y| < 1, where BF16_MAX_ERR is a few ulps
    q, k, v = (_rand(rng, B, nW, h, d, n, std=sd).to(cuda, dtype)
               for n, sd in ((N1, 1.0), (N2, 1.0), (N2, 0.25)))
    bias = 16 * torch.sigmoid(_rand(rng, h, N1, N2)).to(cuda)
    bands = [_bands(rng, nW, n, cuda) if with_bands else None for n in (N1, N2)]
    args = (q, k, v, _scales(h, cuda), bias, *bands)
    routes = _routes([tfa.flash_rect_attention])
    got = _launched(tfa.flash_rect_attention, lambda: tfa.flash_rect_attention(*args))
    # bf16 on tensor cores, fp32 on CUDA cores
    _expect_routes([tfa.flash_rect_attention], routes, dtype)
    with torch.no_grad():
        want = tfa.flash_rect_attention(*args, kernels=False)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", b5_spread.SEEDS)
def test_flash_grlbase_bf16_draws(cuda, seed):
    """B5's bf16 route at GRL-base x4 256^2's three steps (window 32 shifted
    by 16, the 64x64 stripes' a2w and w2a at df 2), on the twelve input
    draws of `b5_spread`: every step within the stage gates (ROADMAP C5;
    a flat end-to-end bound fails on half the draws, as B3's did in C4).
    The gated y is the wrapper's."""
    for step, args in b5_spread.draw(seed, cuda).items():
        routes = _routes([tfa.flash_rect_attention])
        got = _launched(tfa.flash_rect_attention, lambda: tfa.flash_rect_attention(*args))
        _expect_routes([tfa.flash_rect_attention], routes, torch.bfloat16)
        with torch.no_grad():
            want = tfa.flash_rect_attention(*args, kernels=False)
        st = b5_spread.b5_stage_check(*args)
        assert torch.equal(st["y"], got.float()), step
        assert torch.equal(st["y_plain"], want.float()), step
        assert not b3_spread.stage_failures(st), (step, b3_spread.stage_line(st))


# ------------------------------------- the one-pass attention kernel's rows

def _rows_moved(fn, before):
    """The launches of the tensor-core attention kernel by rows a block
    that fn counted since `before` (a copy of its attend_rows)."""
    return {r: n - before[r] for r, n in fn.attend_rows.items()}


@pytest.mark.cuda
def test_attend_rows_both_variants(cuda):
    """The tensor-core attention takes 128 query rows a block where the grid
    fills the card and stays at 64 where it would not, by the one rule the
    launch and the counter share (`block_attn.attend_rows`).  128: B3 at
    GRL-base x4 SR 256^2 (64 windows x 8 row tiles x 3 heads = 1536 blocks
    of 128), on the stage gates; 64: B5 on 3 regions of 100 query rows at
    one head (3 blocks)."""
    x = torch.zeros(1, device=cuda, dtype=torch.bfloat16)
    assert tba.attend_rows(x, 1024, 64, BH, BD) == 128
    assert tba.attend_rows(x, 100, 3, 1, 40) == 64
    before = dict(tba.window_half_large.attend_rows)
    _run_window(cuda, torch.bfloat16, (32, 32), 16, 256, 256, tba.window_half_large, c=180,
                batch=1)
    assert _rows_moved(tba.window_half_large, before) == {64: 0, 128: 1}
    rng = np.random.default_rng(10)
    q, k, v = (_rand(rng, 1, 3, 1, 40, n, std=sd).to(cuda, torch.bfloat16)
               for n, sd in ((100, 1.0), (300, 1.0), (300, 0.25)))
    args = (q, k, v, _scales(1, cuda), 16 * torch.sigmoid(_rand(rng, 1, 100, 300)).to(cuda))
    before = dict(tfa.flash_rect_attention.attend_rows)
    got = _launched(tfa.flash_rect_attention, lambda: tfa.flash_rect_attention(*args))
    assert _rows_moved(tfa.flash_rect_attention, before) == {64: 1, 128: 0}
    with torch.no_grad():
        _assert_close(got, tfa.flash_rect_attention(*args, kernels=False), torch.bfloat16)


# (B, nW, h, d, N1, N2, case): the JPEG window's 1296 tokens (a ragged last
# row tile and a last key chunk of 16) at 2 heads of d = 32 on 16 windows
# (128 rows a block) and on 2 (64); 300 keys (a last chunk of 44) with the
# largest logits of odd rows in the last chunk and those of even rows
# rising in every chunk, so that o and l are rescaled (64 rows a block at
# d = 30, 128 at d = 64); and rows whose keys are all band-masked
@pytest.mark.cuda
@pytest.mark.parametrize("shape,case", [
    ((1, 16, 2, 32, 1296, 1296), "ragged"), ((1, 2, 2, 32, 1296, 1296), "ragged"),
    ((2, 3, 3, 30, 256, 300), "late_max"), ((4, 16, 2, 64, 512, 300), "late_max"),
    ((2, 3, 3, 30, 256, 300), "all_masked"), ((1, 16, 2, 32, 1296, 1296), "all_masked")])
def test_attend_kernel_edges(cuda, shape, case):
    """The one-pass tensor-core attention (B5's bf16 route) against the
    plain version at ragged shapes, with its running max rising in the last
    key chunk, and with rows whose every key is band-masked (-100 on every
    logit leaves their softmax as it was); each launch counted on the rows
    `block_attn.attend_rows` gives."""
    B, nW, h, d, N1, N2 = shape
    rng = np.random.default_rng(11)
    q, k, v = (_rand(rng, B, nW, h, d, n, std=sd).to(cuda, torch.bfloat16)
               for n, sd in ((N1, 1.0), (N2, 1.0), (N2, 0.25)))
    bias = 16 * torch.sigmoid(_rand(rng, h, N1, N2))
    bands = [_bands(rng, nW, n, cuda) for n in (N1, N2)]
    if case == "late_max":
        # odd rows: a step of 30 on the last chunk's keys; even rows: a ramp
        # that raises the max in every chunk
        last = (N2 - 1) // 64 * 64
        bias[:, 1::2, last:] += 30.0
        bias[:, 0::2] += torch.linspace(0.0, 24.0, N2)
    if case == "all_masked":
        bands[0][:, ::3] = 7   # keys' band ids are 0-2
    bias = bias.to(cuda)
    args = (q, k, v, _scales(h, cuda), bias, *bands)
    rows = tba.attend_rows(q, N1, B * nW, h, d)
    before = dict(tfa.flash_rect_attention.attend_rows)
    got = _launched(tfa.flash_rect_attention, lambda: tfa.flash_rect_attention(*args))
    assert _rows_moved(tfa.flash_rect_attention, before) == {r: int(r == rows)
                                                             for r in (64, 128)}
    with torch.no_grad():
        want = tfa.flash_rect_attention(*args, kernels=False)
    _assert_close(got, want, torch.bfloat16)


# (N, heads, d): GRL-S's windows (8x8, 2 heads of 32), 16x16 windows at
# GRL-base's heads, and ragged window sizes
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,heads,d", [(64, 2, 32), (256, 3, 30), (36, 2, 16),
                                       (144, 3, 10), (64, 2, 64)])
@pytest.mark.parametrize("with_bands", [False, True])
def test_window_qkv_kernel_matches_plain(cuda, dtype, N, heads, d, with_bands):
    rng = np.random.default_rng(9)
    nW = 5
    qkv = _rand(rng, 2, nW, 3 * heads * d, N, std=0.25).to(cuda, dtype)
    bias = 16 * torch.sigmoid(_rand(rng, heads, N, N)).to(cuda)
    bands = _bands(rng, nW, N, cuda) if with_bands else None
    args = (qkv, _scales(heads, cuda), bias, heads, bands)
    got = _launched(tatt.fused_window_attention_qkv,
                    lambda: tatt.fused_window_attention_qkv(*args))
    with torch.no_grad():
        want = tatt.fused_window_attention_qkv(*args, kernels=False)
    _assert_fp32_close(got, want)


def _split(rng, shape, with_mask, dev, dtype):
    B, nW, h, N1, N2, d = shape
    q, k, v = (_rand(rng, B, nW, h, n, d, std=sd).to(dev, dtype)
               for n, sd in ((N1, 1.0), (N2, 1.0), (N2, 0.25)))
    mask = None
    if with_mask:
        mask = torch.where(torch.from_numpy(rng.random((nW, N1, N2))) > 0.8,
                           -100.0, 0.0).to(dev, dtype)
    bias = 16 * torch.sigmoid(_rand(rng, h, N1, N2)).to(dev)
    return q, k, v, _scales(h, dev), bias, mask


# (B, nW, h, N1, N2, d): GRL-S's 8x32 stripes at 128^2 (a2w, w2a), a ragged
# shape at GRL-base's heads, 600 keys (the most the CUDA-core kernel held),
# head dim 64, and 700 keys at head dim 40 (ten key chunks)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 2, 16, 256, 32), (1, 8, 2, 256, 16, 32),
                                   (2, 3, 3, 100, 37, 30), (1, 2, 2, 600, 600, 8),
                                   (1, 4, 2, 64, 64, 64), (1, 2, 2, 70, 700, 40)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_cosine_kernel_matches_plain(cuda, dtype, shape, with_mask):
    args = _split(np.random.default_rng(10), shape, with_mask, cuda, dtype)
    got = _launched(tatt.fused_cosine_attention,
                    lambda: tatt.fused_cosine_attention(*args))
    with torch.no_grad():
        want = tatt.fused_cosine_attention(*args, kernels=False)
    _assert_fp32_close(got, want)
    # d-major views in, as the stripe engine passes them: same values, and
    # y comes back as a d-major view
    dm = [t.transpose(-1, -2).contiguous().transpose(-1, -2) for t in args[:3]]
    y = _launched(tatt.fused_cosine_attention,
                  lambda: tatt.fused_cosine_attention(*dm, *args[3:]))
    assert y.stride(-2) == 1
    assert torch.equal(y, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_packed_kernel_matches_plain(cuda, dtype, pack, with_mask, d):
    """B7b at GRL-S's window shapes (and head dim 64) against its
    block-diagonally packed plain version, and equal to B7a's kernel."""
    args = _split(np.random.default_rng(11), (1, 16, 2, 64, 64, d), with_mask,
                  cuda, dtype)
    got = _launched(tatt.fused_cosine_attention_packed,
                    lambda: tatt.fused_cosine_attention_packed(*args, pack=pack))
    with torch.no_grad():
        want = tatt.fused_cosine_attention_packed(*args, pack=pack, kernels=False)
        split = tatt.fused_cosine_attention(*args)
    _assert_fp32_close(got, want)
    assert torch.equal(got, split)


@pytest.mark.cuda
def test_fused_kernels_refuse_beyond_their_limits(cuda):
    """Head dims beyond a kernel's tiles raise NotImplementedError before any
    launch: 64 for B5 and B6/B7 (whose keys stream in chunks, any number of
    them)."""
    z = lambda *s: torch.zeros(s, device=cuda)   # noqa: E731
    ls = z(1, 1, 1)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="head dim"):
            tfa.flash_rect_attention(z(1, 1, 1, 72, 32), z(1, 1, 1, 72, 32),
                                     z(1, 1, 1, 72, 32), ls, z(1, 32, 32))
        with pytest.raises(NotImplementedError, match="head dim"):
            tatt.fused_cosine_attention(z(1, 1, 1, 16, 72), z(1, 1, 1, 16, 72),
                                        z(1, 1, 1, 16, 72), ls, z(1, 16, 16))
        with pytest.raises(NotImplementedError, match="head dim"):
            tatt.fused_window_attention_qkv(z(1, 1, 3 * 72, 64), ls, z(1, 64, 64), 1)
        y = tatt.fused_cosine_attention(z(1, 1, 1, 16, 8), z(1, 1, 1, 700, 8),
                                        z(1, 1, 1, 700, 8), ls, z(1, 16, 700))
    assert tuple(y.shape) == (1, 1, 1, 16, 8)


# ------------------------------------------- wide heads and gradients

def _block(dev, dtype, engine, window, stripe, groups, df, dim=256, heads=2, seed=0):
    """One GRL block (positions 0: window shift, H stripes) with `heads`
    heads a half of d = dim / (2 heads), random weights from a seed, in
    dtype, with kernels on and a twin with kernels off."""
    from grlir_torch.models.blocks import EfficientMixAttnTransformerBlock
    from grlir_torch.models.grl import init_weights

    def make():
        return EfficientMixAttnTransformerBlock(
            dim, heads, heads, window, True, stripe, groups, "H", True, 2.0, df,
            engine=engine).eval().to(dev)

    blk = init_weights(make(), torch.Generator().manual_seed(seed))
    return blk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("engine", ["v3", "fused"])
@pytest.mark.parametrize("geometry", ["grl_s", "base_eval"])
def test_head_dim_64_block_kernels_vs_plain(cuda, dtype, engine, geometry):
    """A block of 2 + 2 heads of d = 64 (dim 256) runs on its kernels.  At
    GRL-S's geometry (window 8, 8 x 16 stripes at df 4) B1 or B6 takes the
    window half and B2 (v3) or B7a twice (fused) the stripe half; at
    GRL-base's eval geometry (window 32, 64 x 64 stripes at df 2) B3 and
    B4's two steps (v3) or B5 three times (fused).  Kernels on against off:
    fp32 within 5e-4, bf16 by rel L2 (the block's output is a residual sum
    ~N(0, 1))."""
    from grlir_torch.models.grl import geometry_tensors
    from grlir_torch.ops.geometry import GeometryConfig

    if geometry == "grl_s":
        window, stripe, groups, df, size = 8, (8, None), (None, 4), 4, (64, 64)
    else:
        window, stripe, groups, df, size = 32, (64, 64), (None, None), 2, (64, 64)
    blk = _block(cuda, dtype, engine, window, stripe, groups, df)
    geom = geometry_tensors(GeometryConfig((window, window), stripe, groups, df), size,
                            cuda)
    x = _rand(np.random.default_rng(13), 1, *size, 256).to(cuda)
    tba.reset_launches()
    for k in tatt.KERNELS + tfa.KERNELS:
        k.launches = 0
    routes = _routes(tfa.KERNELS)
    with torch.no_grad():
        got = blk(x.to(dtype), geom, dtype, kernels=True)
        launched = {k.__name__: k.launches
                    for k in tba.KERNELS + tatt.KERNELS + tfa.KERNELS if k.launches}
        want = blk(x.to(dtype), geom, dtype, kernels=False)
    # every B5 launch on dtype's route: tensor cores for bf16, CUDA cores
    # for fp32
    for r in routes:
        r["tensor_core" if dtype == torch.bfloat16 else "cuda_core"] += launched.get(
            "flash_rect_attention", 0)
    assert _routes(tfa.KERNELS) == routes
    torch.cuda.synchronize()
    assert tba.unrouted_halves == 0
    expect = {("grl_s", "v3"): {"window_half": 1, "stripe_half": 1},
              ("grl_s", "fused"): {"fused_window_attention_qkv": 1,
                                   "fused_cosine_attention": 2},
              ("base_eval", "v3"): {"window_half_large": 1, "stripe_a2w_large": 1,
                                    "stripe_w2a_large": 1},
              ("base_eval", "fused"): {"flash_rect_attention": 3}}
    assert launched == expect[geometry, engine]
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - want.float())
    if dtype == torch.float32:
        assert diff.abs().max().item() <= 5e-4
    else:
        assert (diff.norm() / want.float().norm()).item() <= 1e-2


def _grad_case(dev, kind, dtype=torch.float32):
    """Operands of one block half at small shapes: x and every float operand
    require grad.  kind: "window" (B1, 8 x 8), "window_large" (B3, 32 x
    32), "stripe" (B2, 8 x 16 at df 4), "stripe_large" (B4, 64 x 64 at df
    2)."""
    rng = np.random.default_rng(14)
    w, b, ls1, ls2 = _base_weights(rng, dev)
    if kind.startswith("window"):
        window = (8, 8) if kind == "window" else (32, 32)
        H, W = (32, 32) if kind == "window" else (64, 64)
        n = window[0] * window[1]
        shift = window[0] // 2
        args = [_rand(rng, 1, H, W, BC).to(dev, dtype), w, b, ls1,
                16 * torch.sigmoid(_rand(rng, BH, n, n)).to(dev)]
        bands = _bands(rng, (H // window[0]) * (W // window[1]), n, dev)
        return args, lambda a, k: tba.window_half(*a, window, bands, shift, kernels=k)
    stripe, df = ((8, 16), 4) if kind == "stripe" else ((64, 64), 2)
    H, W = (32, 64) if kind == "stripe" else (128, 128)
    n1, n2 = stripe[0] * stripe[1], (stripe[0] // df) * (stripe[1] // df)
    nw = (H // stripe[0]) * (W // stripe[1])
    args = [_rand(rng, 1, H, W, BC).to(dev, dtype),
            _rand(rng, 1, H // df, W // df, BCH).to(dev, dtype), w, b, ls1, ls2,
            16 * torch.sigmoid(_rand(rng, BH, n2, n1)).to(dev),
            16 * torch.sigmoid(_rand(rng, BH, n1, n2)).to(dev)]
    kw = dict(bands=_bands(rng, nw, n1, dev), bands_a=_bands(rng, nw, n2, dev),
              shift=(stripe[0] // 2, stripe[1] // 2))
    return args, lambda a, k: tba.stripe_half(*a, stripe, df, kernels=k, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["window", "window_large", "stripe", "stripe_large"])
def test_kernel_grads_match_plain(cuda, kind):
    """B1-B4 under grad with kernels on: the kernel runs forward (its launch
    counts, and y equals its no-grad output to the bit and the plain
    version's to FP32_TOL), the backward is the plain version's, so every
    gradient equals kernels=False's (the backward is the same code on the
    same inputs; torch's fp32 tolerances)."""
    args, call = _grad_case(cuda, kind)
    with torch.no_grad():
        y_kernel, y_plain = call(args, True), call(args, False)
    cot = _rand(np.random.default_rng(15), *y_plain.shape).to(cuda)
    grads = []
    launched = tba.KERNELS
    for kernels in (True, False):
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        before = sum(k.launches for k in launched)
        y = call(leaves, kernels)
        (y * cot).sum().backward()
        assert sum(k.launches for k in launched) - before == (
            0 if not kernels else 2 if kind == "stripe_large" else 1)
        # the forward under grad is the kernel's (bit-equal to its no-grad
        # output), or the plain version's
        assert torch.equal(y.detach(), y_kernel if kernels else y_plain)
        grads.append([t.grad for t in leaves])
    _assert_close(y_kernel, y_plain, torch.float32)
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w)
