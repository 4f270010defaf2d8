"""The CUDA block-half kernels vs their plain PyTorch versions, on a card.

Needs an NVIDIA Hopper GPU and nvcc; skips without a CUDA device.  The file
imports no JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py configures JAX.)  The geometries go beyond
GRL-S's: small and large windows, ragged stripe tiles (N1 not a multiple of
64), N2 not a multiple of 32, vertical stripes, batch 2.
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


@pytest.mark.cuda
def test_kernels_refuse_large_geometries(cuda):
    rng = np.random.default_rng(5)
    w, b, ls, _ = _weights(rng, cuda)
    x = torch.zeros((1, 64, 64, C), device=cuda)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="B3"):
        tba.window_half(x, w, b, ls, torch.zeros((HEADS, 1024, 1024), device=cuda),
                        (32, 32))
    anchor = torch.zeros((1, 32, 32, CW), device=cuda)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="B4"):
        tba.stripe_half(x, anchor, w, b, ls, ls,
                        torch.zeros((HEADS, 1024, 4096), device=cuda),
                        torch.zeros((HEADS, 4096, 1024), device=cuda), (64, 64), 2)
