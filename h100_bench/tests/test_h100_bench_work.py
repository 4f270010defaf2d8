"""The counts of operations and bytes against a brute-force count at tiny
sizes: the reference forward, and each attention half, under
torch.utils.flop_counter, and the bytes of each half's tensors."""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import work
from h100_bench.reference import grl as ref
from h100_bench.tests.tiny import tiny_cell
from h100_bench.weights import cell_weights

CASES = [("grl_s_x4.sr_256", (64, 128)), ("grl_base_x4.sr_256", (32, 48)),
         ("grl_base_x4.train_sr_p64", (32, 32))]


@pytest.mark.parametrize("workload,hw", CASES)
def test_model_flops_match_a_count_of_the_forward(workload, hw):
    cell = tiny_cell(workload)
    m, P = cell.model(), cell_weights(cell, 11, "cpu")
    x = torch.rand(2, *hw, 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(P, m, x)
    assert fc.get_total_flops() == work.model_flops(m, *hw, batch=2)


def cpb_ops(entries, heads):
    """The position-bias MLP's products over a table: the model's work,
    outside the half the kernels compute."""
    return 2 * entries * (2 * 512 + 512 * heads)


@pytest.mark.parametrize("workload,hw", CASES)
def test_attention_halves_match_a_count_of_each_half(workload, hw):
    cell = tiny_cell(workload)
    m, P = cell.model(), cell_weights(cell, 12, "cpu")
    (H, W), B, C = hw, 2, m["embed_dim"]
    df, win = m["anchor_window_down_factor"], m["window_size"]
    x = torch.rand(B, H, W, C)
    ops, geo = ref.Ops(P, None), ref.Geometry(m, (H, W), "cpu")
    halves = iter(work.attention_halves(m, H, W, B, "bfloat16"))
    half = 3 * C // 2
    for s, b in ref.blocks(m):
        p = f"layers.{s}.blocks.{b}.attn"
        hw, hs = m["num_heads_window"][s], m["num_heads_stripe"][s]
        w, bias = P[f"{p}.qkv.body.weight"], P[f"{p}.qkv.body.bias"]
        pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), df).permute(0, 2, 3, 1)
        anchor = ops.linear(f"{p}.anchor.body.0.reduction", pooled)

        with FlopCounterMode(display=False) as fc, torch.no_grad():
            y = ref.window_half(ops, f"{p}.window_attn.attn_transform",
                                x @ w[:half].t() + bias[:half], hw, win,
                                win // 2 if b % 2 == 0 else 0, geo)
        n_ops, n_bytes = next(halves)
        assert fc.get_total_flops() - cpb_ops((2 * win - 1) ** 2, hw) == n_ops
        elems = x.numel() + w[:half].numel() + half + hw * win ** 4 + y.numel()
        assert n_bytes == 2 * elems

        vertical = b % 2 == 1
        size, groups = m["stripe_size"], m["stripe_groups"]
        if vertical:
            size, groups = size[::-1], groups[::-1]
        st, _ = ref.G.stripe_info(size, groups, False, (H, W))
        n1, n2 = st[0] * st[1], st[0] * st[1] // df ** 2
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            y = ref.stripe_half(ops, f"{p}.stripe_attn.attn_transform",
                                x @ w[half:].t() + bias[half:], anchor, hs, m,
                                vertical, b % 4 in (2, 3), geo)
        n_ops, n_bytes = next(halves)
        table = (st[0] + st[0] // df - 1) * (st[1] + st[1] // df - 1)
        assert fc.get_total_flops() - 2 * cpb_ops(table, hs) == n_ops
        elems = (x.numel() + anchor.numel() + w[half:].numel() + half
                 + 2 * hs * n1 * n2 + y.numel())
        assert n_bytes == 2 * elems
    assert next(halves, None) is None


def test_least_seconds_takes_the_longer_bound_a_call():
    peak, bw = work.PEAKS["bfloat16_flops"], work.PEAKS["hbm_bytes_s"]
    calls = [(peak, 0.0), (0.0, 2 * bw)]
    assert work.least_seconds(calls, "bfloat16") == pytest.approx(3.0)
