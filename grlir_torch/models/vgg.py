"""VGG19 feature extractor and the perceptual loss on NHWC tensors
(counterparts of `grlir.models.vgg`).

Truncated VGG19 with a {layer_name: features} output and ImageNet input
normalization.  torchvision's `vgg19` weights load through
`grlir_torch.utils.convert.convert_vgg_torch_weights` (a file the user
supplies: the repository carries none).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# layer-name sequence of torchvision's vgg19 `features`
VGG19_NAMES = [
    "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1",
    "conv2_1", "relu2_1", "conv2_2", "relu2_2", "pool2",
    "conv3_1", "relu3_1", "conv3_2", "relu3_2", "conv3_3", "relu3_3",
    "conv3_4", "relu3_4", "pool3",
    "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3", "relu4_3",
    "conv4_4", "relu4_4", "pool4",
    "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3", "relu5_3",
    "conv5_4", "relu5_4", "pool5",
]

VGG_CHANNELS = {"conv1": 64, "conv2": 128, "conv3": 256, "conv4": 512,
                "conv5": 512}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_convs(names: Sequence[str], in_ch: int = 3) -> Dict[str, nn.Conv2d]:
    """The 3x3 SAME convolutions of a VGG layer-name sequence, by name."""
    convs = {}
    for name in names:
        if name.startswith("conv"):
            out = VGG_CHANNELS[name.split("_")[0]]
            convs[name] = nn.Conv2d(in_ch, out, 3, 1, 1)
            in_ch = out
    return convs


class VGGFeatureExtractor(nn.Module):
    """VGG19 cut after the deepest requested layer; NHWC in, {name: NHWC
    features} out."""

    def __init__(self, layer_name_list: Sequence[str], use_input_norm: bool = True,
                 range_norm: bool = False, remove_pooling: bool = False,
                 pooling_stride: int = 2):
        super().__init__()
        self.layer_name_list = tuple(layer_name_list)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        self.remove_pooling = remove_pooling
        self.pooling_stride = pooling_stride
        max_idx = max(VGG19_NAMES.index(v) for v in self.layer_name_list)
        self.names = VGG19_NAMES[: max_idx + 1]
        for name, conv in vgg_convs(self.names).items():
            self.add_module(name, conv)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        out = {}
        for name in self.names:
            if name.startswith("conv"):
                x = getattr(self, name)(x)
            elif name.startswith("relu"):
                x = F.relu(x)
            elif not self.remove_pooling:
                x = F.max_pool2d(x, 2, self.pooling_stride)
            if name in self.layer_name_list:
                out[name] = x.permute(0, 2, 3, 1)
        return out


def perceptual_loss(vgg: Callable[[torch.Tensor], Mapping[str, torch.Tensor]],
                    pred: torch.Tensor, target: torch.Tensor,
                    layer_weights: Mapping[str, float], criterion: str = "l1",
                    perceptual_weight: float = 1.0, style_weight: float = 0.0):
    """Layer-weighted VGG feature loss and the Gram-matrix style loss:
    (percep, style), each 0.0 when its weight is 0.  The target's features
    carry no gradient."""
    feats_p = vgg(pred)
    with torch.no_grad():
        feats_t = vgg(target)

    def crit(a, b):
        if criterion == "l1":
            return torch.mean(torch.abs(a - b))
        if criterion in ("l2", "mse"):
            return torch.mean((a - b) ** 2)
        if criterion == "fro":
            return torch.linalg.vector_norm(a - b)
        raise ValueError(criterion)

    percep = 0.0
    if perceptual_weight > 0:
        for k, w in layer_weights.items():
            percep = percep + w * crit(feats_p[k], feats_t[k])
        percep = percep * perceptual_weight

    style = 0.0
    if style_weight > 0:
        def gram(f):
            b, h, w, c = f.shape
            m = f.reshape(b, h * w, c)
            return torch.einsum("bnc,bnd->bcd", m, m) / (h * w * c)

        for k, w in layer_weights.items():
            style = style + w * crit(gram(feats_p[k]), gram(feats_t[k]))
        style = style * style_weight
    return percep, style
