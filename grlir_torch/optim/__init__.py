"""Optimizers and LR schedules (counterpart of `grlir.optim`).

`build_optimizer` returns a torch optimizer over one parameter group (as
optax transforms every leaf, weight decay included) and a `LambdaLR` that
gives update k the LR schedule(k), as `optax.inject_hyperparams` does: the
trainer steps the scheduler once after each `optimizer.step()`.  Adam and
AdamW add eps after the square root, as optax does.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

from grlir_torch.optim.schedules import (
    SCHEDULES,
    cosine_annealing_restart_cyclic,
    gradual_warmup_cosine,
    multi_step_warmup,
    parse_milestones,
    step_lr,
    warmup_cosine,
)


def build_optimizer(
    params: Iterable[torch.nn.Parameter],
    name: str = "adamw",
    schedule: Optional[Callable[[int], float]] = None,
    learning_rate: float = 2e-4,
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler); without a schedule the LR is constant."""
    params = list(params)
    lr = schedule(0) if schedule is not None else learning_rate
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                                weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr)
    else:
        raise ValueError(f"unknown optimizer {name}")
    # LambdaLR multiplies the group's initial LR: set it to 1 so that the
    # lambda's value is the LR itself
    for group in opt.param_groups:
        group["lr"] = 1.0
    fn = schedule if schedule is not None else (lambda step: learning_rate)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=fn)
    return opt, sched


def current_lr(optimizer: torch.optim.Optimizer) -> float:
    """The LR the next update uses."""
    return float(optimizer.param_groups[0]["lr"])


__all__ = [
    "build_optimizer", "current_lr", "SCHEDULES", "parse_milestones",
    "multi_step_warmup", "cosine_annealing_restart_cyclic",
    "gradual_warmup_cosine", "warmup_cosine", "step_lr",
]
