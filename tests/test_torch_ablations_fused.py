"""GRL's ablation switches through the whole GRL on the port's fused
engine against grlir's use_pallas_attention=True (Pallas in interpret
mode), fp32 on the CPU, with the kernels each switch routes to (their
plain versions here).  The switches and the v3 engine's cases are in
tests/test_torch_ablations.py."""

import numpy as np
import pytest

from test_torch_ablations import ABLATIONS, count_calls, run_pair
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_fused_matches_jax(name, monkeypatch):
    """Four blocks, 8x8 windows (N = 64) and 8x8 stripes at 32^2: B6 once
    a block on the window half whichever route the switch takes (grlir's
    legacy route calls the same kernel on qkv projected beforehand), B7
    twice a block on an anchored stripe half (N1 = 64, N2 = 64 / df^2);
    double_window's second window half and df 1's stripe half are plain,
    and the Euclidean logits never reach a kernel."""
    calls = count_calls(monkeypatch, ["fused_window_attention_qkv",
                                      "fused_cosine_attention_auto",
                                      "flash_rect_attention"])
    got, want = run_pair(ABLATIONS[name], True, "fused")
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    options = ABLATIONS[name]
    cosine = not options.get("euclidean_dist", False)
    anchored = (options.get("anchor_window_down_factor", 4) > 1
                and not options.get("double_window", False))
    assert calls == {"fused_window_attention_qkv": 4 * cosine,
                     "fused_cosine_attention_auto": 8 * (cosine and anchored),
                     "flash_rect_attention": 0}
