"""PSNR-engine training step (counterpart of `grlir.engines.train`):
preprocess, forward in train() mode, weighted loss, backward, optimizer
step and LR-scheduler step, on the model's device.

Across processes (`grlir_torch.parallel`) each holds its rows of the
global batch and the step averages the gradients over the world before
the update (`reduce_step`).

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


def reduce_step(model: torch.nn.Module, metrics: Dict[str, torch.Tensor]) -> None:
    """Across processes: the model's gradients and the step's metrics, in
    place, become their means over the world (one all-reduce), so every
    process takes the update of the global batch's mean loss, as grlir's
    sharded step does.  An explicit reduce, not DistributedDataParallel:
    remat's recompute, the GAN step's two generator forwards and its frozen
    discriminator each break DDP's one-forward-a-backward reducer."""
    from grlir_torch.parallel.mesh import all_reduce_mean_

    grads = [p.grad for p in model.parameters() if p.grad is not None]
    all_reduce_mean_(grads + list(metrics.values()))


def drop_masks(model: torch.nn.Module, rows: int, generator: torch.Generator,
               device) -> Optional[torch.Tensor]:
    """A GRL's stochastic-depth masks for a step on this process's `rows`:
    drawn for the global batch from the generator every process holds
    alike and cut to this process's rows (`shard_rows`), so the processes
    together draw what one process draws on the global batch; None where
    no block drops."""
    from grlir_torch.parallel.mesh import shard_rows, world

    if model.cfg.drop_path_rate <= 0.0:
        return None
    n = rows * world()[1]
    return model.draw_drop_masks(n, generator, device, rows=shard_rows(n))


def build_loss(loss_cfg: Mapping[str, float]):
    """{loss_name: weight} -> {name: (weight, fn)}."""
    return {name: (w, LOSS_FNS[name]) for name, w in loss_cfg.items()}


def make_train_step(
    loss_cfg: Mapping[str, float],
    preprocess: Optional[Callable] = None,
    classification: bool = False,
    one_hot_label: bool = True,
):
    """Build step(state, batch) -> metrics.

    batch: dict of tensors on the model's device.  The step updates the
    state in place and returns {"loss", "loss_<name>"} as detached 0-d
    tensors: reading them (float()) waits for the device, so the caller
    reads them only on the steps it logs.

    classification: the model's head gives 256 class logits a channel; the
    pixel losses apply to the expected image under their softmax and
    cross_entropy to the distribution, against the target's one-hot class
    or, one_hot_label False, its smoothed distribution
    (`losses.classification.build_classification_loss`).
    """
    if classification:
        from grlir_torch.losses.classification import build_classification_loss

        cls_loss = build_classification_loss(loss_cfg, LOSS_FNS,
                                             one_hot_label=one_hot_label)
    else:
        losses = build_loss(loss_cfg)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        if preprocess is not None:
            lq, gt = preprocess(batch, state.rng, state.step)
        else:
            lq, gt = batch["img_lq"], batch["img_gt"]
        model = state.model
        model.train()
        pred = model(lq, drop_masks=drop_masks(model, lq.shape[0], state.generator, lq.device))
        if classification:
            total, parts = cls_loss(pred, gt)
        else:
            total, parts = weighted_loss(losses, pred, gt)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        metrics = {"loss": total.detach(),
                   **{f"loss_{k}": v.detach() for k, v in parts.items()}}
        reduce_step(model, metrics)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return metrics

    return step_fn


def make_eval_step(model: torch.nn.Module):
    """eval(lq) -> the model's output in eval mode without grad."""

    def eval_fn(lq: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return model(lq)

    return eval_fn
