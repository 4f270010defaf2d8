"""Pixel losses on NHWC tensors (counterpart of `grlir.losses.pixel`); the
trainer combines them as a weighted sum over the config's {name: weight}."""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-3) -> torch.Tensor:
    """mean(sqrt(diff^2 + eps^2)), eps 1e-3."""
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps * eps))


def tv_loss(pred: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total variation of an NHWC batch."""
    h_tv = torch.mean((pred[:, 1:, :, :] - pred[:, :-1, :, :]) ** 2)
    w_tv = torch.mean((pred[:, :, 1:, :] - pred[:, :, :-1, :]) ** 2)
    return weight * 2.0 * (h_tv + w_tv)


LOSS_FNS: Dict[str, Callable] = {
    "l1": l1_loss,
    "mse": mse_loss,
    "l2": mse_loss,
    "charbonnier": charbonnier_loss,
    "tv": lambda pred, target: tv_loss(pred),
}


def weighted_loss(losses: Mapping[str, Tuple[float, Callable]], pred, target):
    """{name: (weight, fn)} -> (total, {name: value})."""
    values = {}
    total = 0.0
    for name, (weight, fn) in losses.items():
        v = fn(pred, target)
        values[name] = v
        total = total + weight * v
    return total, values
