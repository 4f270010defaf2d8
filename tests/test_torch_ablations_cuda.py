"""GRL's ablation switches, classification training and the remat
policies on a card: each switch's model with the CUDA kernels against
kernels=False on the engine where it reaches a kernel (grlir's legacy
route launches B6 and B7a on qkv projected beforehand), the
classification step's fp32 gate, and each remat policy's gradients
against full recompute with the kernels running in the recompute.

Needs an NVIDIA Hopper GPU and nvcc; skips without a CUDA device.  The file
imports no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ablations_cuda.py

Variants and gates: `grlir_torch.ablation_cells` (GRL-S x4, here cut to
one stage of four blocks at 128^2).
"""

import pytest
import torch

from grlir_torch import ablation_cells as ac
from grlir_torch import train_cells as tc
from grlir_torch.ops import block_attn as tba

DEPTH = dict(depths=(4,), num_heads_window=(2,), num_heads_stripe=(2,))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ac.VARIANTS))
def test_variant_kernels_vs_plain(cuda, name):
    """Four blocks: the variant's launches a block as predicted, bf16 PSNR
    >= 60 dB and fp32 max|diff| <= 5e-4 against kernels=False."""
    g = torch.Generator().manual_seed(1)
    x = torch.rand(1, 128, 128, 3, generator=g).to(cuda)
    x32 = torch.rand(1, 64, 64, 3, generator=g).to(cuda)
    r = ac.run_variant(name, cuda, x, x32, timed=False, **DEPTH)
    want = {k: n // ac.N_BLOCKS * 4 for k, n in ac.expected(name).items()}
    assert r["launches"] == want and r["unrouted"] == 0, r["launches"]
    assert r["psnr"] >= ac.MODEL_MIN_PSNR, r["psnr"]
    assert r["err32"] <= ac.MODEL_FP32_MAX_ERR, r["err32"]


@pytest.mark.cuda
def test_classification_step_kernels_vs_plain(cuda):
    tba.reset_launches()
    rel, worst, where = ac.cls_gate_fp32(cuda)
    assert tba.window_half_large.launches > 0 and tba.stripe_a2w_large.launches > 0
    assert rel <= tc.FP32_LOSS_REL, rel
    assert worst <= 1.0, (worst, where)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ac.REMAT_POLICIES[1:])
def test_remat_policy_gradients(cuda, policy):
    """Cell b fp32 under remat, kernels on: the policy's loss and gradients
    against None's; B1 and B2 launch in the forward and in the recompute."""
    l0, g0 = ac.remat_grads(None, cuda)
    tba.reset_launches()
    l1, g1 = ac.remat_grads(policy, cuda)
    n = ac.N_BLOCKS
    assert (tba.window_half.launches, tba.stripe_half.launches) == (2 * n, 2 * n)
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    worst, where = ac._worst(g1, g0, ac.REMAT_GRAD_REL, ac.REMAT_GRAD_FLOOR)
    assert worst <= 1.0, (worst, where)


@pytest.mark.cuda
def test_legacy_route_at_grl_s_256(cuda):
    """The separable-conv qkv on the fused engine at 256^2: B7a on GRL-S's
    512-token stripes against 32 anchors, in d-major views."""
    g = torch.Generator().manual_seed(2)
    x = torch.rand(1, 256, 256, 3, generator=g).to(cuda)
    x32 = torch.rand(1, 64, 64, 3, generator=g).to(cuda)
    r = ac.run_variant("separable_qkv", cuda, x, x32, timed=False, **DEPTH)
    assert r["launches"]["fused_cosine_attention"] == 8, r["launches"]
    assert r["psnr"] >= ac.MODEL_MIN_PSNR, r["psnr"]
