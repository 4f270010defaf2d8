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
geometry (window 32, stripes 64x64 and 64x128, df 2).
"""

import math

import numpy as np
import pytest
import torch

from grlir_torch.ops import block_attn as tba

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


def _assert_close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    else:
        assert (got - want).abs().max().item() <= BF16_MAX_ERR


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
    before = tba.window_half.launches
    with torch.no_grad():
        got = tba.window_half(x, w, b, ls, bias, window, bands, shift)
        want = tba.window_half(x, w, b, ls, bias, window, bands, shift, kernels=False)
    torch.cuda.synchronize()
    assert tba.window_half.launches == before + 1
    _assert_close(got, want, dtype)


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


def _base_weights(rng, dev):
    return (_rand(rng, BC, 3 * BCH, std=0.05).to(dev),
            _rand(rng, 3 * BCH, std=0.05).to(dev),
            torch.tensor([math.log(10.0), 5.0, 3.0]).reshape(BH, 1, 1).to(dev),
            torch.tensor([math.log(12.0), 4.0, 2.5]).reshape(BH, 1, 1).to(dev))


def _run_window(dev, dtype, window, shift, H, W, launches_of):
    rng = np.random.default_rng(6)
    n = window[0] * window[1]
    x = _rand(rng, B, H, W, BC).to(dev, dtype)
    w, b, ls, _ = _base_weights(rng, dev)
    bias = 16 * torch.sigmoid(_rand(rng, BH, n, n)).to(dev)
    bands = _bands(rng, (H // window[0]) * (W // window[1]), n, dev) if shift else None
    before = launches_of.launches
    with torch.no_grad():
        got = tba.window_half(x, w, b, ls, bias, window, bands, shift)
        want = tba.window_half(x, w, b, ls, bias, window, bands, shift, kernels=False)
    torch.cuda.synchronize()
    assert launches_of.launches == before + 1
    _assert_close(got, want, dtype)


def _run_stripe(dev, dtype, stripe, df, shift, H, W, launch_fns):
    rng = np.random.default_rng(7)
    sh, sw = stripe
    n1, n2 = sh * sw, (sh // df) * (sw // df)
    w, b, ls1, ls2 = _base_weights(rng, dev)
    args = [_rand(rng, B, H, W, BC).to(dev, dtype),
            _rand(rng, B, H // df, W // df, BCH).to(dev, dtype), w, b, ls1, ls2,
            16 * torch.sigmoid(_rand(rng, BH, n2, n1)).to(dev),
            16 * torch.sigmoid(_rand(rng, BH, n1, n2)).to(dev)]
    nw = (H // sh) * (W // sw)
    shifted = shift != (0, 0)
    kw = dict(bands=_bands(rng, nw, n1, dev) if shifted else None,
              bands_a=_bands(rng, nw, n2, dev) if shifted else None, shift=shift)
    before = [f.launches for f in launch_fns]
    with torch.no_grad():
        got = tba.stripe_half(*args, stripe, df, **kw)
        want = tba.stripe_half(*args, stripe, df, kernels=False, **kw)
    torch.cuda.synchronize()
    assert [f.launches for f in launch_fns] == [n + 1 for n in before]
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 4])
def test_small_kernels_at_base_heads(cuda, dtype, shift):
    """B1 and B2 at three heads of d = 30 (GRL-base's deployed zoo
    geometry: window 8, stripes 8 x W/4, df 4)."""
    _run_window(cuda, dtype, (8, 8), shift, 32, 64, tba.window_half)
    _run_stripe(cuda, dtype, (8, 16), 4, (shift, 2 * shift), 32, 64,
                [tba.stripe_half])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 16])
def test_window_large_kernel_matches_plain(cuda, dtype, shift):
    """B3: window 32 (N = 1024), shifted and unshifted."""
    assert tba.window_route((64, 96), (32, 32), BH) == "large"
    _run_window(cuda, dtype, (32, 32), shift, 64, 96, tba.window_half_large)


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


@pytest.mark.cuda
def test_kernels_refuse_large_geometries(cuda):
    """Geometries that no TPU kernel takes, or whose head dim is beyond the
    large kernels' 32 columns, raise; nothing falls back."""
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
    # one head of d = 64 is beyond the large kernels' 32 columns
    w1 = torch.zeros((C, 3 * 64), device=cuda)
    ls1 = torch.zeros((1, 1, 1), device=cuda)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="head dim"):
        tba.window_half(x[:, :64, :64], w1, None, ls1,
                        torch.zeros((1, 1024, 1024), device=cuda), (32, 32))
