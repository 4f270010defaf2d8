"""Classification-mode training losses (counterparts of
`grlir.losses.classification`).

The model's head emits (B, H, W, C*256) logits, reshaped to
(B, H, W, C, 256) with the classes on the last axis.  Pixel losses apply to
the image formed from the softmax distribution, and cross entropy to the
distribution itself.  The softmax runs in the logits' type, as grlir's
does.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from grlir_torch.utils.classification import (
    cross_entropy_pixel_loss,
    img_from_prob_argmax,
    img_from_prob_weighted,
    img_to_prob,
)

FORMS = {"argmax": img_from_prob_argmax, "weighted_sum": img_from_prob_weighted}


def _classes(logits: torch.Tensor) -> torch.Tensor:
    B, H, W, CK = logits.shape
    if CK % 256:
        raise ValueError(f"classification head needs C*256 channels, got {CK}")
    return logits.reshape(B, H, W, CK // 256, 256)


def logits_to_class_dist(logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C*256) -> (B, H, W, C, 256) softmax distribution."""
    return torch.softmax(_classes(logits), -1)


def soft_cross_entropy_pixel_loss(logits: torch.Tensor, target_img: torch.Tensor,
                                  data_range: float = 1.0) -> torch.Tensor:
    """Cross entropy against the Gaussian-smoothed target distribution
    (`img_to_prob`), the `one_hot_label: false` loss."""
    target = img_to_prob(target_img, data_range=data_range)
    return -(target * torch.log_softmax(logits, -1)).sum(-1).mean()


def build_classification_loss(loss_cfg: Mapping[str, float],
                              pixel_losses: Mapping[str, Callable],
                              one_hot_label: bool = True,
                              prob_to_image: str = "weighted_sum") -> Callable:
    """(logits, target_img) -> (total, {name: loss}): each pixel loss of
    loss_cfg on the image formed by prob_to_image, cross_entropy on the
    distribution (against the one-hot or the smoothed target), weighted and
    summed."""
    form = FORMS[prob_to_image]

    def loss_fn(logits, target_img):
        raw = _classes(logits)
        dist = torch.softmax(raw, -1)
        total = 0.0
        parts: Dict[str, torch.Tensor] = {}
        for name, weight in loss_cfg.items():
            if name == "cross_entropy":
                v = (cross_entropy_pixel_loss(raw, target_img) if one_hot_label
                     else soft_cross_entropy_pixel_loss(raw, target_img))
            elif name in pixel_losses:
                v = pixel_losses[name](form(dist), target_img)
            else:
                raise NotImplementedError(
                    f"loss {name!r} is not a classification-mode loss")
            parts[name] = v
            total = total + weight * v
        return total, parts

    return loss_fn


class FormedImage(torch.nn.Module):
    """A classification model whose output is the image formed from its
    class distribution: what validation and the Restorer run."""

    def __init__(self, model: torch.nn.Module, prob_to_image: str = "weighted_sum"):
        super().__init__()
        self.model = model
        self.form = FORMS[prob_to_image]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.form(logits_to_class_dist(self.model(x)))
