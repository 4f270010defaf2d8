"""The stage split of B5's bf16 route (`grlir_torch.b5_spread`) on the CPU,
no kernel: the plain attention it applies to the kernel's rows is the
plain version's attention, and its float64-normed reference rows differ
from the plain fp32 rows by a few bf16 flips only.

The card tests and `chip_smoke.py` hold B5's bf16 route to the stage gates
of `b3_spread` through `b5_stage_check` (ROADMAP C5).
"""

import numpy as np
import pytest
import torch

from grlir_torch import b5_spread
from grlir_torch.ops import flash_attention as tfa


def _operands(seed, n1, n2, with_bands):
    rng = np.random.default_rng(seed)

    def rnd(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    q, k = rnd(1, 2, 3, 30, n1).bfloat16(), rnd(1, 2, 3, 30, n2).bfloat16()
    v = rnd(1, 2, 3, 30, n2, std=0.25).bfloat16()
    ls = torch.tensor([2.3, 5.0, 3.0]).reshape(3, 1, 1)
    bias = 16 * torch.sigmoid(rnd(3, n1, n2))
    bands = ([torch.from_numpy(rng.integers(0, 3, (2, n)).astype(np.int32)) for n in (n1, n2)]
             if with_bands else [None, None])
    return q, k, v, ls, bias, *bands


@pytest.mark.parametrize("n1,n2,with_bands", [(128, 64, True), (64, 256, False)])
def test_attend_on_plain_rows_is_the_plain_version(n1, n2, with_bands):
    q, k, v, ls, bias, bq, bk = _operands(3, n1, n2, with_bands)
    rows = [b5_spread._rows(q, "fp32"), b5_spread._rows(k, "fp32"),
            b5_spread._rows(v, "none")]
    got = b5_spread._attend(*rows, ls, bias, bq, bk)
    want = tfa.flash_rect_attention_ref(q, k, v, ls, bias, bq, bk).float()
    assert got.shape == want.shape
    # the same rounding points; the two products may sum in other orders
    assert (got - want).abs().max().item() <= 2 ** -7


def test_float64_rows_differ_by_few_flips():
    q = _operands(4, 256, 64, False)[0]
    r32, r64 = b5_spread._rows(q, "fp32"), b5_spread._rows(q, "fp64")
    flips = int((r32 != r64).sum())
    assert flips <= 1e-3 * q.numel()
    # unit rows over the head dim
    assert torch.allclose(r64.square().sum(-1), torch.ones(1), atol=2e-2)
