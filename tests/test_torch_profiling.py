"""The port's profiling hooks (`grlir_torch/utils/profiling.py`) against
`grlir.utils.profiling`: the four cases of tests/test_profiling.py, a
matmul's FLOPs equal to XLA's count, and each kernel's reported work equal
to what torch's FLOP counter counts on its plain version inside a small GRL
of each engine."""

import inspect
import json
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from grlir.utils import profiling as jprof
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL
from grlir_torch.ops import attention as tatt
from grlir_torch.ops import block_attn as ba
from grlir_torch.ops import flash_attention as tfa
from grlir_torch.utils import profiling as tprof
from grlir_torch.utils.profiling import MetricsLogger, cost_analysis, device_memory_stats


def test_cost_analysis_flops_scale_with_size():
    def f(a, b):
        return a @ b

    small = cost_analysis(f, torch.ones(64, 64), torch.ones(64, 64))
    big = cost_analysis(f, torch.ones(128, 128), torch.ones(128, 128))
    assert small["flops"] > 0
    assert 4 < big["flops"] / small["flops"] <= 16
    assert big["bytes_accessed"] > small["bytes_accessed"]
    assert big["arithmetic_intensity"] > 0


def test_metrics_logger_jsonl(tmp_path):
    path = str(tmp_path / "log.jsonl")
    lg = MetricsLogger(path)
    lg.log(1, loss=0.5, psnr=np.float32(30.25))
    lg.log(2, loss=0.25)
    lg.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["step"] == 1 and lines[0]["psnr"] == 30.25
    assert lines[1]["loss"] == 0.25


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    for v in stats.values():
        assert set(v) == {"bytes_in_use_mb", "peak_bytes_mb"}
    if not torch.cuda.is_available():
        assert stats == {} and jprof.device_memory_stats() == {}


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (48, 80, 32)])
def test_matmul_cost_equals_xla(m, k, n):
    """A Linear's FLOPs are 2·M·N·K, XLA's count of the same product, and
    its bytes are the operands read and the result written once."""
    rng = np.random.default_rng(0)
    a, b = rng.random((m, k), np.float32), rng.random((k, n), np.float32)
    got = cost_analysis(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    want = jprof.cost_analysis(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    assert got["flops"] == 2 * m * n * k == want["flops"]
    assert got["bytes_accessed"] == 4 * (m * k + k * n + m * n) == want["bytes_accessed"]
    lin = torch.nn.Linear(k, n, bias=False)
    assert cost_analysis(lin, torch.from_numpy(a))["flops"] == 2 * m * n * k


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tb")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    events = json.load(open(tmp_path / "tb" / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


# each plain kernel version, where its module calls it, and the work its
# kernel reports, from the plain call's arguments and output
WORK = {
    "window_half_ref": (ba, lambda a, y: ba._window_work(
        a["x"], a["wqkv"], a["bqkv"], a["logit_scale"], a["bias"], a["window"], a["bands"])),
    "window_half_large_ref": (ba, lambda a, y: ba._window_work(
        a["x"], a["wqkv"], a["bqkv"], a["logit_scale"], a["bias"], a["window"], a["bands"])),
    "stripe_half_ref": (ba, lambda a, y: ba._stripe_work(
        3, 2, y, a["x"], a["anchor"], a["wqkv"], a["bqkv"],
        (a["logit_scale1"], a["logit_scale2"]), (a["bias_a2w"], a["bias_w2a"]),
        a["stripe"], a["df"], a["bands"], a["bands_a"])),
    "stripe_a2w_large_ref": (ba, lambda a, y: ba._stripe_work(
        2, 1, y, a["x"], a["anchor"], a["wqkv"], a["bqkv"], (a["logit_scale1"],),
        (a["bias_a2w"],), a["stripe"], a["df"], a["bands"], a["bands_a"])),
    "stripe_w2a_large_ref": (ba, lambda a, y: ba._stripe_work(
        1, 1, y, a["x"], a["anchor"], a["wqkv"], a["bqkv"], (a["logit_scale2"],),
        (a["bias_w2a"],), a["stripe"], a["df"], a["bands"], a["bands_a"], a["x1"])),
    "fused_window_attention_qkv_ref": (tatt, lambda a, y: tatt._qkv_work(
        a["qkv"], a["logit_scale"], a["bias"], a["bands"])),
    "fused_cosine_attention_ref": (tatt, lambda a, y: tatt._cosine_work(
        a["q"], a["k"], a["v"], a["logit_scale"], a["bias"], a["mask"])),
    "flash_rect_attention_ref": (tfa, lambda a, y: tfa._flash_work(
        a["q"], a["k"], a["v"], a["logit_scale"], a["bias"], a["bands_q"], a["bands_k"])),
}

# small GRLs whose halves take every kernel of the model paths: GRL-S's
# geometry on v3 (B1, B2) and fused (B6, B7a, and B5 at threshold 0), and
# GRL-base's window 32 / 64x64 stripes / df 2 on v3 (B3, B4a, B4b)
SMALL = replace(zoo.GRL_TINY, embed_dim=32, depths=(2,), num_heads_window=(2,),
                num_heads_stripe=(2,), upscale=2)
BASE = replace(SMALL, window_size=32, stripe_size=(64, 64), stripe_groups=(None, None),
               anchor_window_down_factor=2)
CASES = {
    "v3 small": (SMALL, "v3", 32, {"window_half_ref", "stripe_half_ref"}),
    # B3's plain version calls B1's
    "v3 base": (BASE, "v3", 64, {"window_half_large_ref", "window_half_ref",
                                 "stripe_a2w_large_ref", "stripe_w2a_large_ref"}),
    "fused": (SMALL, "fused", 32, {"fused_window_attention_qkv_ref",
                                   "fused_cosine_attention_ref"}),
    "fused flash": (SMALL, "fused", 32, {"flash_rect_attention_ref"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_work_equals_plain_flops(case, monkeypatch):
    """Each kernel reports the FLOPs that torch's counter counts on its
    plain version at the model's own calls, so a forward counts the same
    FLOPs with the kernels on (the card) or off; and a small GRL's
    cost_analysis runs on the plain path, its FLOPs above the attention's
    alone."""
    from grlir_torch.models import blocks as tblocks

    cfg, engine, hw, expected = CASES[case]
    if case == "fused flash":
        monkeypatch.setattr(tblocks, "_FLASH_MIN_TOKENS", 0)
    seen, counting = {}, [True]
    for name, (module, work) in WORK.items():
        plain = getattr(module, name)

        def spy(*args, _name=name, _plain=plain, _work=work, **kwargs):
            if not counting[0]:
                return _plain(*args, **kwargs)
            bound = inspect.signature(_plain).bind(*args, **kwargs)
            bound.apply_defaults()
            with FlopCounterMode(display=False) as counter:
                y = _plain(*args, **kwargs)
            flops, nbytes = _work(bound.arguments, y)
            seen.setdefault(_name, []).append((counter.get_total_flops(), flops))
            assert nbytes > y.numel() * y.element_size()
            return y

        monkeypatch.setattr(module, name, spy)
    torch.manual_seed(0)
    model = GRL(replace(cfg, engine=engine)).eval()
    x = torch.rand(1, hw, hw, 3)
    with torch.no_grad():
        model(x)
        counting[0] = False
        cost = cost_analysis(model, x)
        counted = sum(got for got, _ in seen[min(seen)])
    assert set(seen) == expected, sorted(seen)
    for name, pairs in seen.items():
        assert all(got == want for got, want in pairs), (name, pairs)
    assert cost["flops"] > counted > 0
    assert cost["bytes_accessed"] > 0
