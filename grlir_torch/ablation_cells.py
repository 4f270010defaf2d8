"""GRL's model surface beyond the recipes on the card: the ablation
switches, classification training and the remat policies.  `chip_smoke.py`
runs the three phases (`ablation_phase`, `classification_phase`,
`remat_phase`); each prints its numbers beside the card's name and power
limit, raises through `check` when a gate fails, and returns the launches
of its main path by kernel.

Ablation: zoo.GRL_SMALL (GRL-S x4, 16 blocks) with one switch at a time,
256^2 LR, batch 1, bf16, on the engine where the switch reaches a kernel:
the fused engine for the branches that project qkv first (grlir's legacy
route: B6 on the window half, B7a twice on an anchored stripe half), v3
for the rest (B1 and B2).  Gates: kernels against kernels=False on the
same weights, PSNR >= 60 dB in bf16 at 256^2 and max|diff| <= 5e-4 in fp32
at 64^2; the launches of one forward equal to the variant's prediction.

Classification: the PSNR CLI of chip_smoke's train phase (the SR recipe
at GRL-S width, bs8, LR 64^2, bf16, v3 with the kernels under grad) with
loss=l1_ce on gray data (grlir's head adds the RGB mean to its C*256
channels, so a classification head trains single-channel images): 3
steps, validation on the formed image, a resume to 6; one step's launches,
time and peak memory; one fp32 step kernels on against off at the train
cells' gates.

Remat: train cell b (zoo.GRL_SMALL's geometry, B1 and B2) under remat with
policies None, "dots" and "dots_no_batch": the fp32 gradients of each
policy against None's; each policy's bf16 step launches, time and peak
memory.
"""

from __future__ import annotations

import math
import os
import statistics
import tempfile
import time
from dataclasses import replace
from typing import Callable, Dict, List

import torch

from grlir_torch.engines.train import TrainState, make_train_step
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL, GRLConfig, init_weights
from grlir_torch.ops import block_attn as ba
from grlir_torch.optim import build_optimizer
from grlir_torch import train_cells as tc

HW = 256                       # the ablation forwards' LR size
FP32_HW = 64                   # the fp32 gate's LR size
MODEL_MIN_PSNR = 60.0          # bf16, kernels against kernels=False
MODEL_FP32_MAX_ERR = 5e-4      # fp32, kernels against kernels=False
FORWARD_WARMUP, FORWARD_RUNS = 2, 10
STEP_WARMUP, STEP_RUNS = 2, 6
REMAT_GRAD_REL, REMAT_GRAD_FLOOR = 1e-5, 1e-9   # x max|g| of each tensor, + floor
N_BLOCKS = sum(zoo.GRL_SMALL.depths)

V3 = {"window_half": 1, "stripe_half": 1}
B6 = {"fused_window_attention_qkv": 1}
# name: (fields over zoo.GRL_SMALL, engine, launches a block by kernel)
VARIANTS = {
    "separable_qkv": ({"qkv_proj_type": "separable_conv"}, "fused",
                      {"fused_window_attention_qkv": 1, "fused_cosine_attention": 2}),
    "anchor_maxpool": ({"anchor_proj_type": "maxpool"}, "v3", V3),
    "anchor_conv2d": ({"anchor_proj_type": "conv2d"}, "v3", V3),
    "anchor_separable_conv": ({"anchor_proj_type": "separable_conv"}, "v3", V3),
    # one patch merging halves the map: at df 4 it takes two stages
    "anchor_patchmerging_2stage": ({"anchor_proj_type": "patchmerging",
                                    "anchor_one_stage": False}, "v3", V3),
    "anchor_conv2d_2stage": ({"anchor_proj_type": "conv2d", "anchor_one_stage": False},
                             "v3", V3),
    "out_proj_conv2d": ({"out_proj_type": "conv2d"}, "v3", V3),
    "conv_type_3conv": ({"conv_type": "3conv"}, "v3", V3),
    "conv_type_1conv1x1": ({"conv_type": "1conv1x1"}, "v3", V3),
    "conv_type_linear": ({"conv_type": "linear"}, "v3", V3),
    "df1": ({"anchor_window_down_factor": 1}, "fused", B6),
    # stripe_square reads the stripe geometry's table: grlir takes it only
    # where the stripes are the window's squares (8x8 here)
    "stripe_square": ({"anchor_window_down_factor": 1, "stripe_square": True,
                       "stripe_size": (8, 8), "stripe_groups": (None, None)}, "fused", B6),
    "double_window": ({"double_window": True}, "fused", B6),
    "euclidean_dist": ({"euclidean_dist": True}, "fused", {}),
}


def counts() -> Dict[str, int]:
    """Launches of every kernel wrapper since the last reset."""
    return {k.__name__: k.launches for k in ba.COUNTED}


def expected(name: str) -> Dict[str, int]:
    """A forward's predicted launches of the variant, every kernel listed."""
    per_block = VARIANTS[name][2]
    return {k: per_block.get(k, 0) * N_BLOCKS for k in counts()}


def variant_config(name: str, dtype=torch.bfloat16, kernels=True) -> GRLConfig:
    options, engine, _ = VARIANTS[name]
    return replace(zoo.GRL_SMALL, engine=engine, kernels=kernels, dtype=dtype, **options)


def _model(cfg: GRLConfig, device, seed: int = 0, train: bool = False) -> GRL:
    """A seeded GRL built on the host and moved (see train_cells.make_state)."""
    m = init_weights(GRL(cfg), torch.Generator().manual_seed(seed)).to(device)
    return m.train(train)


def _twin(m: GRL, device, **kw) -> GRL:
    t = GRL(replace(m.cfg, **kw)).to(device).train(m.training)
    t.load_state_dict(m.state_dict())
    return t


def time_ms(fn: Callable, runs: int, warmup: int) -> List[float]:
    """CUDA-event times of fn() after warm-up."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def spread(ts: List[float]) -> str:
    return f"{statistics.median(ts):.3f} ms (min {min(ts):.3f}, max {max(ts):.3f})"


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.float() - b.float()) ** 2).item()
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def _nonzero(d: Dict[str, int]) -> Dict[str, int]:
    return {k: n for k, n in d.items() if n}


def peak_gib(fn: Callable) -> str:
    """fn()'s peak device memory above what was allocated before it (the
    earlier phases' models stay resident), and that base, in GiB."""
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    peak = torch.cuda.max_memory_allocated()
    return f"peak {(peak - base) / 2**30:.2f} GiB above {base / 2**30:.2f} GiB held"


def run_variant(name: str, device, x: torch.Tensor, x32: torch.Tensor, seed: int = 0,
                timed: bool = True, **fields) -> dict:
    """One variant (GRLConfig `fields` over it, e.g. a cut depth) on bf16
    x and fp32 x32: the launches of one kernels-on forward (counts set to 0
    just before, read just after), unrouted halves, the output, PSNR
    against kernels=False, the fp32 max|diff| and, when timed, the
    forward's times and peak GiB."""
    m = _model(replace(variant_config(name), **fields), device, seed=seed)
    plain = _twin(m, device, kernels=False)
    out = {}
    with torch.no_grad():
        ba.reset_launches()
        y = m(x)
        torch.cuda.synchronize()
        out.update(launches=counts(), unrouted=ba.unrouted_halves, y=y)
        out["psnr"] = _psnr(y, plain(x))
        if timed:
            out["peak"] = peak_gib(lambda: out.update(
                times=time_ms(lambda: m(x), FORWARD_RUNS, FORWARD_WARMUP)))
        m32, p32 = (_twin(m, device, dtype=torch.float32, kernels=k) for k in (True, False))
        out["err32"] = (m32(x32) - p32(x32)).abs().max().item()
    return out


def ablation_phase(device, smi: str, check: Callable) -> Dict[str, Dict[str, int]]:
    """Every variant at full depth: its forward's launches, the gates, the
    forward timed.  Returns {variant: {kernel: launches a forward}}."""
    g = torch.Generator().manual_seed(12)
    x = torch.rand(1, HW, HW, 3, generator=g).to(device)
    x32 = torch.rand(1, FP32_HW, FP32_HW, 3, generator=g).to(device)
    launched = {}
    for name, (options, engine, _) in VARIANTS.items():
        r = run_variant(name, device, x, x32, seed=len(launched))
        got, times, y, p = r["launches"], r["times"], r["y"], r["psnr"]
        launched[name] = got
        print(f"[ablation] GRL-S x4 {name} {options} engine {engine} bf16 {HW}^2: out "
              f"{tuple(y.shape)}, launches a forward {_nonzero(got)} (predicted "
              f"{_nonzero(expected(name))}), unrouted halves {r['unrouted']}; kernels vs "
              f"kernels=False PSNR {p:.2f} dB (min {MODEL_MIN_PSNR}), fp32 {FP32_HW}^2 "
              f"max|diff| {r['err32']:.3e} (max {MODEL_FP32_MAX_ERR}); forward {spread(times)} "
              f"over {FORWARD_RUNS} after {FORWARD_WARMUP}, "
              f"{HW * HW / 1e6 / (statistics.median(times) / 1e3):.4f} MP/s, "
              f"{r['peak']} [{smi}]")
        check(got == expected(name) and r["unrouted"] == 0, f"ablation {name}: launches {got}")
        check(tuple(y.shape) == (1, 4 * HW, 4 * HW, 3) and bool(torch.isfinite(y).all()),
              f"ablation {name}: output")
        check(p >= MODEL_MIN_PSNR, f"ablation {name}: PSNR {p:.2f} dB")
        check(r["err32"] <= MODEL_FP32_MAX_ERR,
              f"ablation {name}: fp32 max|diff| {r['err32']:.3e}")
        del r, y
    return launched


# ---- classification

CLS_ARGS = ["loss=l1_ce", "data_module.num_channels=1", "metric=classifier"]


def cls_config(dtype=torch.bfloat16, kernels=True, **kw) -> GRLConfig:
    """Train cell a (the SR recipe's geometry at GRL-S width) on gray
    images with a 256-class head."""
    return tc.cell_config("a", dtype, kernels, in_channels=1, out_channels=256, **kw)


def cls_batches(n: int, device, seed: int = 0):
    """The train cells' batches in gray (the channel mean)."""
    return [{k: v.mean(-1, keepdim=True) for k, v in b.items()}
            for b in tc.batches(n, device, seed)]


def cls_gate_fp32(device, seed: int = 0):
    """One fp32 classification step (l1 + cross entropy) at drop path 0,
    kernels on against off: (loss rel diff, worst max|dg| / (1e-3 max|g| +
    1e-7), its parameter) at the train cells' gates."""
    data = cls_batches(1, device, seed)
    step = make_train_step({"l1": 1.0, "cross_entropy": 1.0}, classification=True)
    losses, grads = [], []
    for kernels in (True, False):
        model = _model(cls_config(torch.float32, kernels, drop_path_rate=0.0), device,
                       seed, train=True)
        opt, sched = build_optimizer(model.parameters(), "sgd", learning_rate=0.0)
        losses.append(float(step(TrainState(model, opt, sched), data[0])["loss"]))
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
    return (abs(losses[0] - losses[1]) / abs(losses[1]),) + _worst(grads[0], grads[1],
                                                                   tc.FP32_GRAD_REL,
                                                                   tc.FP32_GRAD_FLOOR)


def _worst(got, want, rel, floor):
    worst, where = 0.0, ""
    for n, g in want.items():
        r = ((got[n] - g).abs().max() / (rel * g.abs().max() + floor)).item()
        if r >= worst:
            worst, where = r, n
    return worst, where


def classification_phase(device, smi: str, check: Callable,
                         write_root: Callable[[str], str], cli_args: List[str]
                         ) -> Dict[str, int]:
    """The CLI with loss=l1_ce: 3 steps and a resume to 6 on a synthetic
    root written by write_root, launches counted over both runs; then one
    step timed and the fp32 gate.  Returns the CLI run's launches."""
    from grlir_torch.train import main as train_main

    tmp = tempfile.TemporaryDirectory()
    saved = {k: os.environ.get(k) for k in ("GRLIR_DATA_ROOT", "GRLIR_CACHE_DIR")}
    os.environ["GRLIR_DATA_ROOT"] = os.path.join(tmp.name, "data")
    os.environ["GRLIR_CACHE_DIR"] = os.path.join(tmp.name, "cache")
    try:
        write_root(os.environ["GRLIR_DATA_ROOT"])
        out = os.path.join(tmp.name, "out")
        args = cli_args + CLS_ARGS + [f"io.base_output_path={out}", "tag=chip_cls"]
        ba.reset_launches()
        t0 = time.perf_counter()
        train_main(args + ["trainer.max_steps=3"])
        t1 = time.perf_counter()
        train_main(args + ["trainer.max_steps=6"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cli = counts()
        run = os.path.join(out, "chip_cls", "version_0")
        with open(os.path.join(run, "results.csv")) as f:
            rows = [r.split(",") for r in f.read().splitlines()]
        head = rows[0]
        steps = [r[head.index("step")] for r in rows[1:]] if "step" in head else \
            [r[2] for r in rows[1:]]
        psnrs = [float(r[head.index("psnr")]) for r in rows[1:]] if "psnr" in head else []
        ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()
    print(f"[classification] CLI {' '.join(cli_args + CLS_ARGS)}: 3 steps in {t1 - t0:.1f} s, "
          f"resumed to 6 in {t2 - t1:.1f} s; results.csv steps {steps}, formed-image PSNR "
          f"{psnrs}; checkpoints {ckpts}; launches {_nonzero(cli)}, unrouted halves "
          f"{ba.unrouted_halves}")
    check(steps == ["3", "6"] and all(math.isfinite(v) for v in psnrs) and len(psnrs) == 2,
          f"classification CLI: results {steps} {psnrs}")
    check(ckpts and all(cli[k] > 0 for k in tc.admitted(cls_config())),
          f"classification CLI: launches {cli}")

    # one step: launches, time, peak memory
    state = tc.make_state(cls_config(), device, seed=0)
    data = cls_batches(4, device, seed=3)
    step = make_train_step({"l1": 1.0, "cross_entropy": 1.0}, classification=True)
    for i in range(STEP_WARMUP):
        step(state, data[i % 4])
    torch.cuda.synchronize()
    ba.reset_launches()
    step(state, data[0])
    torch.cuda.synchronize()
    one = counts()
    it, times = iter(data * STEP_RUNS), []
    peak = peak_gib(lambda: times.extend(time_ms(lambda: step(state, next(it)), STEP_RUNS, 0)))
    print(f"[time] classification step cell a gray 256 classes bf16 bs{tc.BATCH} LR "
          f"{tc.LR_HW}^2: {spread(times)} over {STEP_RUNS} after {STEP_WARMUP + 1}, "
          f"{peak}; launches a step {_nonzero(one)} [{smi}]")
    check(_nonzero(one) == {k: N_BLOCKS for k in tc.admitted(cls_config())},
          f"classification step launches {one}")
    del state, data
    rel, worst, where = cls_gate_fp32(device)
    print(f"[classification] gate fp32, one step, kernels on vs off: loss rel diff {rel:.3e} "
          f"(max {tc.FP32_LOSS_REL}); worst gradient max|diff| / (1e-3 max|g| + 1e-7) "
          f"{worst:.3e} at {where} (max 1)")
    check(rel <= tc.FP32_LOSS_REL and worst <= 1.0, "classification gate fp32")
    return cli


# ---- remat

REMAT_POLICIES = (None, "dots", "dots_no_batch")


def remat_grads(policy, device, seed: int = 0):
    """One fp32 step of train cell b under remat with `policy`, kernels on,
    drop path on with fixed masks: (loss, {name: grad})."""
    cfg = tc.cell_config("b", torch.float32, True, remat=True, remat_policy=policy)
    model = _model(cfg, device, seed, train=True)
    batch = tc.batches(1, device, seed)[0]
    masks = model.draw_drop_masks(tc.BATCH, torch.Generator().manual_seed(seed + 1), device)
    pred = model(batch["img_lq"], drop_masks=masks)
    loss = torch.mean(torch.abs(pred - batch["img_gt"]))
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def remat_phase(device, smi: str, check: Callable) -> Dict[str, Dict[str, int]]:
    """The gradient gate of each policy against None's (fp32; None run
    twice for the run-to-run floor), then each policy's bf16 step timed.
    Returns {policy: launches a step}."""
    l0, g0 = remat_grads(None, device)
    l0b, g0b = remat_grads(None, device)
    floor, _ = _worst(g0b, g0, 1.0, 0.0)
    print(f"[remat] fp32 cell b, None twice: loss {l0:.8f} / {l0b:.8f}, worst gradient "
          f"max|diff| / max|g| {floor:.3e}")
    for policy in REMAT_POLICIES[1:]:
        l1, g1 = remat_grads(policy, device)
        worst, where = _worst(g1, g0, REMAT_GRAD_REL, REMAT_GRAD_FLOOR)
        equal = sum(torch.equal(g1[n], g0[n]) for n in g0)
        print(f"[remat] fp32 cell b, policy {policy} vs None: loss {l1:.8f} vs {l0:.8f}; worst "
              f"gradient max|diff| / ({REMAT_GRAD_REL} max|g| + {REMAT_GRAD_FLOOR}) {worst:.3e} "
              f"at {where} (max 1); {equal} of {len(g0)} gradients equal to the bit")
        check(abs(l1 - l0) <= 1e-6 * abs(l0) and worst <= 1.0, f"remat {policy} gradients")
    launched = {}
    for policy in REMAT_POLICIES:
        state = tc.make_state(tc.cell_config("b", remat=True, remat_policy=policy), device)
        data = tc.batches(4, device, seed=3)
        step = make_train_step(tc.LOSS)
        for i in range(STEP_WARMUP):
            step(state, data[i % 4])
        torch.cuda.synchronize()
        ba.reset_launches()
        step(state, data[0])
        torch.cuda.synchronize()
        one = counts()
        it, times = iter(data * STEP_RUNS), []
        peak = peak_gib(lambda: times.extend(time_ms(lambda: step(state, next(it)),
                                                     STEP_RUNS, 0)))
        launched[str(policy)] = one
        print(f"[time] remat step cell b bf16 bs{tc.BATCH} LR {tc.LR_HW}^2 policy {policy}: "
              f"{spread(times)} over {STEP_RUNS} after {STEP_WARMUP + 1}, {peak}; "
              f"launches a step {_nonzero(one)} (the forward's and the recompute's) [{smi}]")
        check(_nonzero(one) == {"window_half": 2 * N_BLOCKS, "stripe_half": 2 * N_BLOCKS},
              f"remat {policy}: launches {one}")
        del state, data
    return launched
