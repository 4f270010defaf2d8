"""PSNR-engine training step (counterpart of `grlir.engines.train`):
preprocess, forward in train() mode, weighted loss, backward, optimizer
step and LR-scheduler step, on the model's device.

`TrainState` holds what a step changes: the model, its optimizer and LR
scheduler, the step count, and the run's two generators (a torch one for
the stochastic-depth masks, a numpy one for the preprocessing draws).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from grlir_torch.losses import LOSS_FNS, weighted_loss


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    generator: torch.Generator = field(default_factory=torch.Generator)
    rng: np.random.Generator = field(default_factory=np.random.default_rng)

    def state_dicts(self) -> dict:
        """What a checkpoint keeps: the model, optimizer and scheduler."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}


def build_loss(loss_cfg: Mapping[str, float]):
    """{loss_name: weight} -> {name: (weight, fn)}."""
    return {name: (w, LOSS_FNS[name]) for name, w in loss_cfg.items()}


def make_train_step(
    loss_cfg: Mapping[str, float],
    preprocess: Optional[Callable] = None,
    classification: bool = False,
):
    """Build step(state, batch) -> metrics.

    batch: dict of tensors on the model's device.  The step updates the
    state in place and returns {"loss", "loss_<name>"} as detached 0-d
    tensors: reading them (float()) waits for the device, so the caller
    reads them only on the steps it logs.
    """
    if classification:
        raise NotImplementedError(
            "classification training (per-pixel class losses) is not ported "
            "yet (ROADMAP A10)")
    losses = build_loss(loss_cfg)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        if preprocess is not None:
            lq, gt = preprocess(batch, state.rng, state.step)
        else:
            lq, gt = batch["img_lq"], batch["img_gt"]
        model = state.model
        model.train()
        pred = model(lq, generator=state.generator)
        total, parts = weighted_loss(losses, pred, gt)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {"loss": total.detach(),
                **{f"loss_{k}": v.detach() for k, v in parts.items()}}

    return step_fn


def make_eval_step(model: torch.nn.Module):
    """eval(lq) -> the model's output in eval mode without grad."""

    def eval_fn(lq: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return model(lq)

    return eval_fn
