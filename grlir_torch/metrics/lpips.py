"""LPIPS distance on a VGG16 backbone (counterpart of `grlir.metrics.lpips`):
unit-normalize each of five taps, squared difference, a learned
non-negative 1x1 calibration, spatial mean, sum over taps (Zhang et al.
2018).

The weights come from the official release (the LPIPS `.pth` and
torchvision's vgg16) through `convert_lpips_torch_weights`, or from the
`.npz` file that `save_lpips_params` writes, which grlir reads too: one
file, named by `$GRLIR_LPIPS_NPZ`, serves both packages.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from grlir_torch.models.vgg import vgg_convs

VGG16_NAMES = [
    "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1",
    "conv2_1", "relu2_1", "conv2_2", "relu2_2", "pool2",
    "conv3_1", "relu3_1", "conv3_2", "relu3_2", "conv3_3", "relu3_3", "pool3",
    "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3", "relu4_3", "pool4",
    "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3", "relu5_3", "pool5",
]
LPIPS_TAPS = ["relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3"]
LPIPS_TAP_CH = [64, 128, 256, 512, 512]

# the official input scaling (lpips' ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


class LPIPSVgg(nn.Module):
    """forward(x, y): NHWC images in [0, 1] -> (B,) LPIPS distances."""

    def __init__(self):
        super().__init__()
        self.names = VGG16_NAMES[: VGG16_NAMES.index(LPIPS_TAPS[-1]) + 1]
        for name, conv in vgg_convs(self.names).items():
            self.add_module(name, conv)
        for i, ch in enumerate(LPIPS_TAP_CH):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(ch)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h = torch.cat([x, y], dim=0).permute(0, 3, 1, 2)
        h = ((2.0 * h - 1.0) - self.shift) / self.scale
        total = 0.0
        tap = 0
        for name in self.names:
            if name.startswith("conv"):
                h = getattr(self, name)(h)
            elif name.startswith("relu"):
                h = F.relu(h)
            else:
                h = F.max_pool2d(h, 2, 2)
            if name == LPIPS_TAPS[tap]:
                d = (_unit_normalize(h[:b]) - _unit_normalize(h[b:])) ** 2
                w = torch.clamp(getattr(self, f"lin{tap}"), min=0.0)
                d = torch.sum(d * w[:, None, None], dim=1)
                total = total + d.mean(dim=(1, 2))
                tap += 1
        return total


def lpips_batch(model: LPIPSVgg, pred, target) -> np.ndarray:
    """Per-image LPIPS of NHWC batches in [0, 1] (numpy arrays or tensors)
    on the model's device."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        d = model(torch.as_tensor(pred, dtype=torch.float32, device=dev),
                  torch.as_tensor(target, dtype=torch.float32, device=dev))
    return d.cpu().numpy()


def save_lpips_params(params: Dict, path: str):
    """Write a nested parameter dict (grlir's flax tree) as an npz with
    '/'-joined keys."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    rec("", params)
    np.savez(path, **flat)


def load_lpips_params(path: str) -> Dict:
    """Inverse of save_lpips_params: the nested dict of numpy arrays."""
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def load_lpips_model(path: str, device="cuda") -> LPIPSVgg:
    """An LPIPSVgg in eval mode on `device` (the card unless the caller
    asks for the CPU) with the weights of an npz file of
    save_lpips_params."""
    from grlir_torch.utils.convert import jax_variables_to_state_dict

    model = LPIPSVgg()
    model.load_state_dict(jax_variables_to_state_dict(load_lpips_params(path)),
                          strict=True)
    return model.eval().to(device)


def lpips_metric_fn(device="cuda") -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """(B,H,W,3) x2 -> (B,) LPIPS with the weights of $GRLIR_LPIPS_NPZ, on
    `device` (the card unless the caller asks for the CPU); raises when the
    variable names no file."""
    path = os.path.expanduser(os.environ.get("GRLIR_LPIPS_NPZ", ""))
    if not path or not os.path.exists(path):
        raise RuntimeError(
            "LPIPS requested but $GRLIR_LPIPS_NPZ is not set or missing: "
            "convert the official weights with convert_lpips_torch_weights "
            "and write them with save_lpips_params")
    model = load_lpips_model(path, device)
    return lambda pred, target: lpips_batch(model, pred, target)
