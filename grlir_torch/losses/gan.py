"""GAN losses on discriminator logits (counterpart of `grlir.losses.gan`):
vanilla, lsgan, wgan, wgan_softplus and hinge."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Stable BCE-with-logits, max(x, 0) - x z + log(1 + exp(-|x|)), as
    grlir writes it."""
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def gan_loss(logits: torch.Tensor, target_is_real: bool,
             gan_type: str = "vanilla", is_disc: bool = False,
             real_label: float = 1.0, fake_label: float = 0.0,
             loss_weight: float = 1.0) -> torch.Tensor:
    """One side's GAN loss: the generator's is scaled by loss_weight, the
    discriminator's never is."""
    if gan_type == "vanilla":
        label = real_label if target_is_real else fake_label
        loss = _bce_with_logits(logits, torch.full_like(logits, label))
    elif gan_type == "lsgan":
        label = real_label if target_is_real else fake_label
        loss = torch.mean((logits - label) ** 2)
    elif gan_type == "wgan":
        loss = -torch.mean(logits) if target_is_real else torch.mean(logits)
    elif gan_type == "wgan_softplus":
        loss = torch.mean(F.softplus(-logits if target_is_real else logits))
    elif gan_type == "hinge":
        if is_disc:
            sign = -1.0 if target_is_real else 1.0
            loss = torch.mean(F.relu(1.0 + sign * logits))
        else:
            loss = -torch.mean(logits)
    else:
        raise ValueError(f"unknown gan_type {gan_type}")
    return loss if is_disc else loss * loss_weight
