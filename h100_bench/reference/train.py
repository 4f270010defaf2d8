"""The SR recipe's first training steps in plain PyTorch, float32: L1 loss
on GRL's reference forward, its gradient by autograd, AdamW with decoupled
weight decay and the multi-step LR schedule, written out here.

AdamW (Loshchilov and Hutter, ICLR 2019) as the recipe runs it: m and v
from zero, bias-corrected, eps added after the square root, the decay
p <- p * (1 - lr * wd) before the update, every parameter in one group.
"""

from __future__ import annotations

import bisect
from types import ModuleType
from typing import Dict, List, Optional, Sequence

import torch


def multi_step_lr(opt: dict, sched: dict, step: int) -> float:
    """LR of update `step` (0-based): linear warm-up, then gamma at each
    milestone."""
    base, warm = opt["lr"], sched["warmup_iter"]
    if warm > 0 and step < warm:
        return sched["warmup_init_lr"] + (base - sched["warmup_init_lr"]) / warm * step
    return base * sched["gamma"] ** bisect.bisect_right(sorted(sched["milestones"]), step)


def drop_masks(net: ModuleType, m: dict, batch: int, steps: int,
               seed: int) -> List[torch.Tensor]:
    """(blocks, 2, batch) stochastic-depth masks of each step: block i keeps
    a branch with probability 1 - its rate, from uniform float64 draws of a
    CPU generator seeded with the run's mask seed, one (blocks, 2, batch)
    draw a step.  `net`: the reference module of the forward (its
    `drop_rates`)."""
    rates = torch.tensor(net.drop_rates(m), dtype=torch.float64)
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((len(rates), 2, batch), generator=g, dtype=torch.float64)
            < (1.0 - rates)[:, None, None] for _ in range(steps)]


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def run(net: ModuleType, P0: Dict[str, torch.Tensor], m: dict, batches: Sequence, masks: Sequence,
        opt: dict, sched: dict, prec: Optional[str] = None) -> dict:
    """len(batches) steps from P0 of the forward of the reference module
    `net` (its `forward` and `exact_fp32`): (lq, gt) NHWC batches, masks
    from `drop_masks`.  Returns each step's loss, the first step's gradient
    norm a parameter, and the norm of each parameter's change after the
    last step."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    b1, b2 = opt["betas"]
    eps, wd = opt["eps"], opt["weight_decay"]
    mom = {k: torch.zeros_like(v) for k, v in P.items()}
    var = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, first = [], None
    with net.exact_fp32():
        for t, ((lq, gt), keep) in enumerate(zip(batches, masks), start=1):
            pred = net.forward(P, m, lq, keep=keep.to(lq.device), prec=prec, recompute=True)
            loss = torch.mean(torch.abs(pred - gt))
            grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = leaf_norms(grads)
            lr = multi_step_lr(opt, sched, t - 1)
            with torch.no_grad():
                for k, p in P.items():
                    g = grads[k]
                    mom[k].mul_(b1).add_(g, alpha=1 - b1)
                    var[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.mul_(1 - lr * wd)
                    denom = (var[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                    p.addcdiv_(mom[k], denom, value=-lr / (1 - b1 ** t))
    delta = leaf_norms({k: P[k].detach() - P0[k] for k in P})
    return {"losses": losses, "grad_norms": first, "delta_norms": delta}
