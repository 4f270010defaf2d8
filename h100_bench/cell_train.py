"""A training cell: the port's training step (`engines.train.make_train_step`
with the recipe's loss, AdamW and LR schedule) driven for the window's
seconds on batches of the pool.

Set-up makes the weights and a pool of (LR, GT) pairs on the device from
the seed (GT: structured images; LR: their 4x4 means), builds one
`TrainState`, and drives it through its first `checked_steps` steps, on
rows that all differ, then `warmup_steps` more: the same object goes on
into the window.  The check follows those first steps with the
reference once the window has closed and the program is freed.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench import check, inputs, program, traffic
from h100_bench import trace as tr
from h100_bench.cell_serve import free
from h100_bench.reference import train as ref_train
from h100_bench.weights import cell_weights

# the numbers the check compares (`check.train_numbers`)
NUMBERS = ("loss_gap", "grad_gap", "delta_gap", "delta_gap_median")


def pool(mix: dict, seed: int, device):
    """(LR, GT) NHWC pairs of the pool."""
    n, p, s = mix["pool"], mix["lr_patch"], mix["scale"]
    if n % mix["batch"]:
        raise ValueError("the pool must hold a whole number of batches")
    gt = inputs.structured(n, p * s, p * s, inputs.sub_seed(seed, 2), device)
    lq = F.avg_pool2d(gt.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1).contiguous()
    return lq, gt


def batch(mix: dict, data, step: int) -> Dict[str, torch.Tensor]:
    rows = traffic.step_rows(mix, step)
    return {"img_lq": data[0][rows], "img_gt": data[1][rows]}


def build(cell, P, seed: int, device):
    """(TrainState, step) of the port, as its train CLI builds them."""
    from grlir_torch.engines.preprocess import make_train_preprocess
    from grlir_torch.engines.train import TrainState, make_train_step
    from grlir_torch.optim import build_optimizer
    from grlir_torch.optim.schedules import SCHEDULES

    mix = cell.traffic
    model = program.grl(cell, P, device)
    o, sch = mix["optimizer"], dict(mix["lr_scheduler"])
    schedule = SCHEDULES[sch.pop("name")](o["lr"], **sch)
    opt, sched = build_optimizer(model.parameters(), o["name"], schedule=schedule,
                                 betas=tuple(o["betas"]), eps=o["eps"],
                                 weight_decay=o["weight_decay"])
    state = TrainState(model, opt, sched,
                       generator=torch.Generator().manual_seed(mask_seed(seed)),
                       rng=np.random.default_rng(inputs.sub_seed(seed, 6)))
    step = make_train_step(mix["loss"], preprocess=make_train_preprocess(
        "sr", None, False, mix["scale"]))
    return state, step


def mask_seed(seed: int) -> int:
    return inputs.sub_seed(seed, 5)


def first_steps(state, step, mix, data, P0) -> dict:
    """The checked steps: each loss, the first gradient as AdamW holds it
    (its first moment over 1 - beta1 after one step) and the change of
    each parameter after the last."""
    b1 = mix["optimizer"]["betas"][0]
    named = dict(state.model.named_parameters())
    losses, grads = [], None
    for k in range(mix["checked_steps"]):
        losses.append(step(state, batch(mix, data, k))["loss"])
        if grads is None:
            # a parameter the optimizer holds no moment of has no gradient
            moment = {n: state.optimizer.state.get(p, {}).get("exp_avg") for n, p in named.items()}
            grads = ref_train.leaf_norms({n: torch.zeros_like(named[n]) if v is None
                                          else v / (1 - b1) for n, v in moment.items()})
    return {"losses": [float(v) for v in losses], "grad_norms": grads,
            "delta_norms": ref_train.leaf_norms(
                {n: p.detach() - P0[n] for n, p in named.items()})}


def reference(cell, seed: int, data, device, prec=None) -> dict:
    """The reference's checked steps from the same weights and rows."""
    mix, m, net = cell.traffic, cell.model(), cell.reference
    P = cell_weights(cell, seed, device)
    steps = mix["checked_steps"]
    batches = [(b["img_lq"], b["img_gt"]) for b in
               (batch(mix, data, k) for k in range(steps))]
    masks = ref_train.drop_masks(net, m, mix["batch"], steps, mask_seed(seed))
    return ref_train.run(net, P, m, batches, masks, mix["optimizer"], mix["lr_scheduler"],
                         prec)


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    device = torch.device(device)
    mix = cell.traffic
    data = pool(mix, seed, device)
    P0 = cell_weights(cell, seed, device)
    state, step = build(cell, P0, seed, device)
    built = time.perf_counter()
    before = program.unrouted_halves()
    got = first_steps(state, step, mix, data, P0)
    checked = time.perf_counter()
    del P0
    k = mix["checked_steps"]
    for _ in range(mix["warmup_steps"]):
        step(state, batch(mix, data, k))
        k += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    unrouted = program.unrouted_halves() - before
    setup_s = time.perf_counter() - t0

    window = min(seconds, mix["trace_seconds"]) if traced else seconds
    prof = tr.profiler(device) if traced else None
    marks = tr.Marks()
    losses, k0 = [], k
    if prof is not None:
        prof.start()
    marks.start(tr.WINDOW)
    w0 = time.perf_counter()
    end = w0 + window
    while time.perf_counter() < end:
        with marks.span("step"):
            losses.append(step(state, batch(mix, data, k))["loss"])
        k += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - w0
    marks.stop(tr.WINDOW)
    timeline = None
    if prof is not None:
        prof.stop()
        timeline = tr.reduce(prof, marks)
    steps = k - k0
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, step
    free(device)
    numbers = check.train_numbers(got, reference(cell, seed, data, device))
    return {
        "attempted": steps,
        "failed": failed,
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "end_to_end": {"train_samples_s": steps * mix["batch"] / window_s,
                       "setup_s": setup_s},
        "log": (f"step_ms mean {window_s / max(steps, 1) * 1e3!r} n {steps}; "
                f"window_s {window_s!r}; memory_peak_bytes {peak}; "
                f"unrouted_halves {unrouted}; losses {got['losses']!r}; set-up to the "
                f"built step {built - t0!r} s, checked steps {checked - built!r} s"),
        "timeline": timeline,
        "spans": ["step"],
        "context": {"steps": steps, "unrouted_halves": unrouted},
    }


def worst(got: dict, want: dict, n: int = 4) -> dict:
    """The look behind a training reading: each step's loss gap, the
    parameters with the largest gradient and change gaps (gap, reference
    norm, program norm), the median parameter's gaps and the parameters
    left out as round-off."""
    g, d = want["grad_norms"], want["delta_norms"]
    keys = check.compared(want)
    out = {"step_loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])],
           "left_out": sorted(set(g) - set(keys))}
    for name, gaps, norms, mine in (
            ("grad", check.leaf_gaps(got["grad_norms"], g, g), g, got["grad_norms"]),
            ("delta", check.leaf_gaps(got["delta_norms"], d, keys), d, got["delta_norms"])):
        top = sorted(gaps, key=gaps.get, reverse=True)[:n]
        out[f"{name}_worst"] = [[k, gaps[k], norms[k], mine[k]] for k in top]
        out[f"{name}_median_gap"] = float(sorted(gaps.values())[len(gaps) // 2])
    return out


def readings(cell, seeds, control_seeds, seconds, device):
    """Each seed's checked steps against the reference, with the look; on
    the control seeds also the reference with fp8 products in the
    program's place, and the program's step on half of each batch, the
    mean taken over the rest.  Training needs no window: `seconds` is
    not read."""
    mix = cell.traffic
    half = mix["batch"] // 2
    for seed in seeds:
        t = time.perf_counter()
        data = pool(mix, seed, device)
        want = reference(cell, seed, data, device)
        P0 = cell_weights(cell, seed, device)
        state, step = build(cell, P0, seed, device)
        got = first_steps(state, step, mix, data, P0)
        yield {"kind": "program", "seed": seed, "numbers": check.train_numbers(got, want),
               "look": worst(got, want), "seconds": time.perf_counter() - t}
        del state, step
        if seed in control_seeds:
            fp8 = reference(cell, seed, data, device, prec="fp8")
            yield {"kind": "control", "seed": seed, "numbers": check.train_numbers(fp8, want),
                   "look": worst(fp8, want)}
            state, step = build(cell, P0, seed, device)

            def half_step(st, b):
                return step(st, {k: v[:half] for k, v in b.items()})

            bad = first_steps(state, half_step, mix, data, P0)
            yield {"kind": "fault_half_batch", "seed": seed,
                   "numbers": check.train_numbers(bad, want), "look": worst(bad, want)}
            del state, step
        del P0, data
        free(device)


def tiny_traffic(mix: dict) -> dict:
    """Batches of two 16x16 LR patches from a pool of four, one warm-up step."""
    return {**mix, "batch": 2, "lr_patch": 16, "pool": 4, "warmup_steps": 1}
