"""LR schedules as plain functions of the optimizer step (counterpart of
`grlir.optim.schedules`): multi-step with linear warmup, cosine annealing
with restarts, gradual-warmup cosine, timm-style warmup cosine and step
decay.  `schedule(k)` is the LR of update k (0-based)."""

from __future__ import annotations

import bisect
import math
from typing import Sequence, Union


def parse_milestones(milestones: Union[str, Sequence[int]]) -> list:
    """'100000+150000+175000' -> [100000, 150000, 175000]."""
    if isinstance(milestones, str):
        return list(map(int, milestones.split("+")))
    return list(milestones)


def multi_step_warmup(base_lr: float, milestones, gamma: float = 0.1,
                      warmup_iter: int = -1, warmup_init_lr: float = 0.0):
    """Linear warmup for warmup_iter steps, then gamma at each milestone."""
    ms = sorted(parse_milestones(milestones))

    def schedule(step):
        if warmup_iter > 0 and step < warmup_iter:
            return warmup_init_lr + (base_lr - warmup_init_lr) / warmup_iter * step
        return base_lr * gamma ** bisect.bisect_right(ms, step)

    return schedule


def cosine_annealing_restart_cyclic(base_lr: float, periods: Sequence[int],
                                    restart_weights: Sequence[float] = (1,),
                                    eta_mins: Sequence[float] = (0,)):
    """Cosine annealing restarted at the end of each period, each cycle
    with its own weight and floor."""
    if not len(periods) == len(restart_weights) == len(eta_mins):
        raise ValueError("periods, restart_weights and eta_mins differ in length")
    cum = [sum(periods[:i + 1]) for i in range(len(periods))]

    def schedule(step):
        idx = min(sum(step > c for c in cum), len(periods) - 1)
        nearest_restart = 0 if idx == 0 else cum[idx - 1]
        eta_min = eta_mins[idx]
        return eta_min + restart_weights[idx] * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * ((step - nearest_restart) / periods[idx])))

    return schedule


def gradual_warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int,
                          eta_min: float = 1e-6, multiplier: float = 1.0):
    """Gradual warmup to base_lr * multiplier, then cosine annealing."""

    def schedule(step):
        if step < warmup_steps:
            if multiplier > 1.0:
                return base_lr * ((multiplier - 1.0) * step / warmup_steps + 1.0)
            return base_lr * step / warmup_steps
        t = min(max(step - warmup_steps, 0), total_steps - warmup_steps)
        return eta_min + (base_lr * multiplier - eta_min) * 0.5 * (
            1 + math.cos(math.pi * t / (total_steps - warmup_steps)))

    return schedule


def warmup_cosine(base_lr: float, t_initial: int, lr_min: float = 1e-5,
                  warmup_lr_init: float = 1e-5, warmup_t: int = 0):
    """timm CosineLRScheduler subset (config/lr_scheduler/cosinelr.yaml)."""

    def schedule(step):
        if step < warmup_t:
            return warmup_lr_init + (base_lr - warmup_lr_init) * step / max(warmup_t, 1)
        t = min(max(step - warmup_t, 0), t_initial - warmup_t)
        return lr_min + (base_lr - lr_min) * 0.5 * (
            1 + math.cos(math.pi * t / max(t_initial - warmup_t, 1)))

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float = 0.5):
    """torch StepLR."""

    def schedule(step):
        return base_lr * gamma ** (step // step_size)

    return schedule


SCHEDULES = {
    "multi_steplr": multi_step_warmup,
    "cosine_restart": cosine_annealing_restart_cyclic,
    "warmup_cosine": gradual_warmup_cosine,
    "cosinelr": warmup_cosine,
    "steplr": step_lr,
}
