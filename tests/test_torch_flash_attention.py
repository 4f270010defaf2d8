"""grlir_torch.ops.flash_attention (B5): the plain PyTorch version against
grlir's `flash_rect_attention` (Pallas, interpret mode), fp32 on the CPU,
and the wrapper's dispatch.  The CUDA kernel is tested against the plain
version in test_torch_cuda_kernels.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.ops.pallas.flash_attention import flash_rect_attention as jflash
from grlir_torch.ops import flash_attention as tfa


def _case(shape, with_bands, seed=0):
    """q, k, v channel-major; one head's logit scale (5.0) above the clamp
    at log(100)."""
    B, nW, h, d, N1, N2 = shape
    rng = np.random.default_rng(seed)
    ls = rng.uniform(0, 3, (h, 1, 1)).astype(np.float32)
    ls[0] = 5.0
    args = [rng.standard_normal((B, nW, h, d, N1)).astype(np.float32),
            rng.standard_normal((B, nW, h, d, N2)).astype(np.float32),
            rng.standard_normal((B, nW, h, d, N2)).astype(np.float32),
            ls, rng.standard_normal((h, N1, N2)).astype(np.float32)]
    bands = [None, None]
    if with_bands:
        bands = [rng.integers(0, 9, (nW, n)).astype(np.int32) for n in (N1, N2)]
    return args, bands


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (B, nW, h, d, N1, N2): more queries than keys (w2a), fewer (a2w), and an
# N1 of 192 that halves the q-tile to 64 at GRL-base's head dim 30
@pytest.mark.parametrize("shape", [(1, 2, 2, 32, 256, 64),
                                   (1, 2, 2, 32, 64, 256),
                                   (2, 2, 3, 30, 192, 48)])
@pytest.mark.parametrize("with_bands", [False, True])
def test_flash_ref_matches_pallas(shape, with_bands):
    args, bands = _case(shape, with_bands)
    want = np.asarray(jflash(*map(_j, args), bands_q=_j(bands[0]),
                             bands_k=_j(bands[1]), interpret=True))
    got = tfa.flash_rect_attention_ref(*map(_t, args), *map(_t, bands))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_flash_logit_scale_is_clamped():
    """A head's scale of exp(5) and one of exp(log 100) give the same
    output: both clamp at 100."""
    args, _ = _case((1, 1, 2, 8, 32, 16), False, seed=1)
    q, k, v, ls, bias = map(_t, args)
    ls_hi = torch.tensor([5.0, 5.0]).reshape(2, 1, 1)
    ls_cl = torch.full((2, 1, 1), math.log(100.0))
    torch.testing.assert_close(tfa.flash_rect_attention_ref(q, k, v, ls_hi, bias),
                               tfa.flash_rect_attention_ref(q, k, v, ls_cl, bias),
                               atol=0, rtol=0)


def test_flash_dispatch_on_cpu():
    """kernels=True on CPU tensors runs the plain version and launches
    nothing on either route; bands come in pairs; an input that needs grad
    raises."""
    args, bands = _case((1, 2, 2, 16, 64, 32), True, seed=2)
    targs, tb = list(map(_t, args)), list(map(_t, bands))
    before = tfa.flash_rect_attention.launches
    routes = dict(tfa.flash_rect_attention.route_launches)
    got = tfa.flash_rect_attention(*targs, *tb)
    assert torch.equal(got, tfa.flash_rect_attention_ref(*targs, *tb))
    assert torch.equal(got, tfa.flash_rect_attention(*targs, *tb, kernels=False))
    bf = [t.bfloat16() for t in targs[:3]]
    assert torch.equal(tfa.flash_rect_attention(*bf, *targs[3:], *tb),
                       tfa.flash_rect_attention_ref(*bf, *targs[3:], *tb))
    assert tfa.flash_rect_attention.launches == before
    assert tfa.flash_rect_attention.route_launches == routes
    with pytest.raises(ValueError, match="both"):
        tfa.flash_rect_attention(*targs, tb[0], None)
    q = targs[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_rect_attention(q, *targs[1:])


@pytest.mark.parametrize("shape", [(1, 2, 2, 32, 256, 64), (1, 2, 3, 30, 100, 300)])
def test_cpu_dispatch_counts_no_attend_rows(shape):
    """bf16 CPU tensors take the plain version: B5 counts no block of the
    tensor-core attention kernel by its rows."""
    args, bands = _case(shape, True, seed=3)
    targs, tb = list(map(_t, args)), list(map(_t, bands))
    bf = [t.bfloat16() for t in targs[:3]]
    before = dict(tfa.flash_rect_attention.attend_rows)
    got = tfa.flash_rect_attention(*bf, *targs[3:], *tb)
    assert torch.equal(got, tfa.flash_rect_attention_ref(*bf, *targs[3:], *tb))
    assert tfa.flash_rect_attention.attend_rows == before
