"""Classification-mode image <-> probability converters (counterparts of
`grlir.utils.classification`).

Each 8-bit pixel value is one of 256 classes.  NHWC: probability tensors
are (B, H, W, C, 256), classes on the last axis.  Every function computes
in its input's type, as grlir's do.
"""

from __future__ import annotations

import math

import torch


def img_to_prob(image: torch.Tensor, sigma: float = 5.0,
                data_range: float = 1.0) -> torch.Tensor:
    """(B, H, W, C) in [0, 1] -> (B, H, W, C, 256): a Gaussian of width
    sigma around the 8-bit value, normalised over the classes."""
    if data_range == 1:
        image = image * 255.0
    classes = torch.arange(256, dtype=image.dtype, device=image.device)
    diff = classes - image[..., None]
    prob = (1.0 / math.sqrt(2 * math.pi) / sigma
            * torch.exp(-0.5 * (diff / sigma) ** 2))
    return prob / prob.sum(-1, keepdim=True)


def img_to_class(image: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """(B, H, W, C) -> int64 class indices, truncated toward zero."""
    if data_range == 1:
        image = image * 255.0
    return image.to(torch.int32).long()


def img_from_prob_argmax(class_dist: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C, 256) -> (B, H, W, C): the most likely class / 255, fp32."""
    return class_dist.argmax(-1).float() / 255.0


def img_from_prob_weighted(class_dist: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C, 256) -> (B, H, W, C): the expected class / 255."""
    value = torch.arange(256, dtype=class_dist.dtype, device=class_dist.device) / 255.0
    return (class_dist * value).sum(-1)


def cross_entropy_pixel_loss(logits: torch.Tensor, target_img: torch.Tensor,
                             data_range: float = 1.0) -> torch.Tensor:
    """Mean cross entropy of (..., 256) logits against the target's 8-bit
    classes."""
    labels = img_to_class(target_img, data_range)
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(-1, labels[..., None]).mean()
