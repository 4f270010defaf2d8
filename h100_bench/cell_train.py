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
from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                   register_optimizer_step_pre_hook)

from h100_bench import check, inputs, program, traffic
from h100_bench import trace as tr
from h100_bench.cell_serve import free
from h100_bench.reference import train as ref_train
from h100_bench.weights import make_weights


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
    mix, m = cell.traffic, cell.model()
    P = make_weights(m, seed, device)
    steps = mix["checked_steps"]
    batches = [(b["img_lq"], b["img_gt"]) for b in
               (batch(mix, data, k) for k in range(steps))]
    masks = ref_train.drop_masks(m, mix["batch"], steps, mask_seed(seed))
    return ref_train.run(P, m, batches, masks, mix["optimizer"], mix["lr_scheduler"], prec)


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    device = torch.device(device)
    mix, m = cell.traffic, cell.model()
    data = pool(mix, seed, device)
    P0 = make_weights(m, seed, device)
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
    hooks = [register_optimizer_step_pre_hook(lambda *a: marks.start("optimizer")),
             register_optimizer_step_post_hook(lambda *a: marks.stop("optimizer"))]
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
    for h in hooks:
        h.remove()
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
