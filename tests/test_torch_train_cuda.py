"""The training path on a card: the train step with the CUDA kernels on
(B1-B4 forward under grad, the plain backward) against kernels off, and a
Restorer's CUDA-graph replay after optimizer steps against an eager
forward.

Needs an NVIDIA Hopper GPU and nvcc; skips without a CUDA device.  The file
imports no JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_cuda.py

Cells and gates: `grlir_torch.train_cells` (GRL-S width x4, bs8, LR 64^2;
cell a the SR recipe's window 32 / stripes 64x64, cell b zoo.GRL_SMALL).
"""

import math

import pytest
import torch

from grlir_torch import train_cells as tc
from grlir_torch.ops import block_attn as tba


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_fp32_step_kernels_vs_plain(cuda):
    """Cell a, fp32, drop path 0, one step: loss within 1e-5 relative and
    every gradient within 1e-3 max|g| + 1e-7 of kernels off; the step ran
    B3 and B4 (both steps) under grad."""
    tba.reset_launches()
    rel, worst, where = tc.gate_fp32(cuda)
    launched = {k.__name__: k.launches for k in tba.KERNELS}
    assert all(launched[k] > 0 for k in ("window_half_large", "stripe_a2w_large",
                                         "stripe_w2a_large")), launched
    assert rel <= tc.FP32_LOSS_REL, rel
    assert worst <= 1.0, (worst, where)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["a", "b"])
def test_bf16_steps_kernels_vs_plain(cuda, cell):
    """Ten bf16 steps, kernels on and off: finite losses within 2e-2 of
    each other at every step, falling in both modes."""
    losses, rel = tc.gate_bf16(cell, cuda)
    assert all(math.isfinite(v) for ls in losses.values() for v in ls), losses
    assert max(rel) <= tc.BF16_LOSS_REL, rel
    assert tc.bf16_gate_ok(losses, rel), losses


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["a", "b"])
def test_replay_after_steps_equals_eager(cuda, cell):
    err, graphs = tc.replay_after_steps(cell, cuda)
    assert graphs == 1
    assert err == 0.0, err
