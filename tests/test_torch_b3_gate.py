"""The stage gates of B3's bf16 route (`grlir_torch.b3_spread`) on synthetic
tensors, no kernel: each gate fails what it is there to catch, and a
faithful reordering of the same sums passes all three.

The card tests and `chip_smoke.py` hold B3's bf16 route to these gates
(`b3_stage_check`); here their pure-tensor part (`stage_stats`,
`stage_failures`) is shown not to be vacuous.
"""

import numpy as np
import pytest
import torch

from grlir_torch import b3_spread
from grlir_torch.ops.block_attn import _unit

BF16 = torch.bfloat16


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).float()


def _nudge(t: torch.Tensor, count: int, rng) -> torch.Tensor:
    """t (bf16 values as fp32) with `count` of its values moved to their
    next bf16 neighbour away from zero: one-ulp flips."""
    flat = t.flatten().clone()
    idx = torch.from_numpy(rng.choice(flat.numel(), count, replace=False))
    bits = flat[idx].to(BF16).view(torch.int16)
    flat[idx] = (bits + 1).view(BF16).float()
    return flat.reshape(t.shape)


def _attention(q, k, v, dtype=torch.float32):
    """softmax(q k^T) v summed in dtype: (B, nW, h, N, d) -> same."""
    q, k, v = (t.to(dtype) for t in (q, k, v))
    return (torch.softmax(q @ k.transpose(-1, -2), -1) @ v).float()


def _project(x, w, order):
    """x @ w in fp32 three ways: "float64" (summed in float64, then
    rounded), "plain" (one fp32 product) or "reversed" (fp32, the channels
    summed in the other order); split into unit-normed q, k and v of 2
    heads, rounded to bf16."""
    if order == "float64":
        t = (x.double() @ w.double()).float()
    elif order == "plain":
        t = x @ w
    else:
        t = x.flip(-1) @ w.flip(0)
    B, N, C3 = t.shape
    q, k, v = t.reshape(B, 1, N, 3, 2, C3 // 6).permute(3, 0, 1, 4, 2, 5).unbind(0)
    return [_bf16(_unit(q)), _bf16(_unit(k)), _bf16(v)]


def _case(kind):
    """The six tensors of `stage_stats` for one kind of input."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((2, 256, 96)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((96, 3 * 2 * 32)) * 0.1).astype(np.float32))
    p64, plain = _project(x, w, "float64"), _project(x, w, "plain")
    if kind == "reordered":
        # the kernel's sums in another order: projection and attention
        kern = _project(x, w, "reversed")
        y_on_k = _attention(*kern)
        return kern, plain, p64, _attention(*kern, torch.float64), y_on_k, _attention(*plain)
    if kind == "many_flips":
        # a handful of flips in the plain path, 20x as many in the kernel's
        plain = [_nudge(t, 8, rng) for t in p64]
        kern = [_nudge(t, 160, rng) for t in p64]
        y = _attention(*kern)
        return kern, plain, p64, y, y, _attention(*plain)
    y_plain = _attention(*plain)
    y_on_k = y_plain.clone()
    y_k = y_on_k.clone()
    if kind == "attention_off":
        # the kernel's attention misses the plain attention on its own q,
        # k, v by 2e-2 at one output (of 32768)
        y_k.view(-1)[12345] += 2e-2
    else:  # "e2e_off": 1% of the outputs off end to end, stages faithful
        y_k.view(-1)[::100] += 2e-2
        y_on_k = y_k
    return plain, plain, p64, y_k, y_on_k, y_plain


@pytest.mark.parametrize("kind,failing", [
    ("many_flips", {"projection"}), ("attention_off", {"attention"}),
    ("e2e_off", {"end to end"}), ("reordered", set())])
def test_b3_stage_gates(kind, failing):
    st = b3_spread.stage_stats(*_case(kind))
    fails = b3_spread.stage_failures(st)
    got = {g for g in ("projection", "attention", "end to end")
           if any(f.startswith(g) for f in fails)}
    assert got == failing, (fails, st)
    assert len(fails) == len(got) + 2 * (kind == "many_flips")   # q, k and v each
    if kind == "reordered":
        # a reordering rounds some values to the other neighbour, as the
        # plain path does against float64
        assert sum(st["flips_kernel"]) > 0 and st["attn_err"] > 0
