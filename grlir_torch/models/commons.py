"""EDSR-lineage common blocks on NHWC tensors (counterparts of
`grlir.models.commons`): MeanShift as a function, the plain ResBlock and
its token-format wrapper, BasicBlock, ESA, the EDSR ResBlock, and the
pixel-shuffle upsamplers.  Support layers the GRL path does not use.
Parameter names follow grlir's flax modules (conv1, body_conv0, bn, esa,
act ...); convolutions pad as flax's "SAME" and "VALID" do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def mean_shift(x: torch.Tensor, rgb_range: float, rgb_mean=_RGB_MEAN,
               rgb_std=(1.0, 1.0, 1.0), sign: int = -1) -> torch.Tensor:
    """EDSR's MeanShift: x / std + sign * rgb_range * mean / std."""
    std = torch.as_tensor(rgb_std, dtype=x.dtype, device=x.device)
    mean = torch.as_tensor(rgb_mean, dtype=x.dtype, device=x.device)
    return x / std + sign * rgb_range * mean / std


class Conv(nn.Conv2d):
    """A conv of NHWC tensors with flax's padding: "SAME" pads
    max((ceil(H/s) - 1) s + k - H, 0) split low-first, "VALID" none."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: str = "SAME", groups: int = 1, bias: bool = True,
                 device=None):
        super().__init__(cin, cout, kernel, stride, groups=groups, bias=bias,
                         device=device)
        self.same = padding == "SAME"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.same:
            pads = []
            for size, k, s in zip(x.shape[:1:-1], self.kernel_size[::-1],
                                  self.stride[::-1]):
                total = max((-(-size // s) - 1) * s + k - size, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
        return super().forward(x).permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """PReLU with one slope (flax's nn.PReLU: parameter negative_slope,
    initial 0.01)."""

    def __init__(self, device=None):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


def _pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    """conv3x3 - ReLU - conv3x3, scaled by res_scale, plus the input when
    shortcut."""

    def __init__(self, num_feats: int = 64, res_scale: float = 1.0,
                 use_bias: bool = True, shortcut: bool = True, device=None):
        super().__init__()
        self.res_scale = res_scale
        self.shortcut = shortcut
        self.conv1 = Conv(num_feats, num_feats, 3, bias=use_bias, device=device)
        self.conv2 = Conv(num_feats, num_feats, 3, bias=use_bias, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(torch.relu(self.conv1(x))) * self.res_scale
        return x + out if self.shortcut else out


class ResBlockWrapper(ResBlock):
    """ResBlock on (B, L, C) tokens of an image of x_size."""

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        B, L, C = x.shape
        return super().forward(x.reshape(B, *x_size, C)).reshape(B, L, C)


class BasicBlock(nn.Module):
    """Conv, optional BatchNorm (batch statistics in train), optional ReLU
    or PReLU."""

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int = 1,
                 use_bias: bool = False, bn: bool = True,
                 act: Optional[str] = "relu", device=None):
        super().__init__()
        self.conv = Conv(cin, features, kernel_size, stride, bias=use_bias,
                         device=device)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.01,
                                 device=device) if bn else None
        self.act_name = act
        self.act = PReLU(device=device) if act == "prelu" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.act_name == "relu":
            return torch.relu(x)
        return self.act(x) if self.act is not None else x


class ESA(nn.Module):
    """Enhanced spatial attention: 1x1, a stride-2 3x3 (VALID), a 7x7
    max pool of stride 3 (VALID), 3x3, bilinear back to x's size, plus the
    1x1 of the first conv, 1x1 to n_feats, sigmoid gate."""

    def __init__(self, esa_channels: int, n_feats: int, device=None):
        super().__init__()
        f = esa_channels
        self.conv1 = Conv(n_feats, f, 1, device=device)
        self.conv2 = Conv(f, f, 3, 2, padding="VALID", device=device)
        self.conv3 = Conv(f, f, 3, device=device)
        self.conv_f = Conv(f, f, 1, device=device)
        self.conv4 = Conv(f, n_feats, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = self.conv1(x)
        c1 = self.conv2(c1_)
        v_max = F.max_pool2d(c1.permute(0, 3, 1, 2), 7, 3)
        c3 = self.conv3(v_max.permute(0, 2, 3, 1))
        c3 = F.interpolate(c3.permute(0, 3, 1, 2), size=x.shape[1:3],
                           mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        c4 = self.conv4(c3 + self.conv_f(c1_))
        return x * torch.sigmoid(c4)


class EDSRResBlock(nn.Module):
    """EDSR ResBlock (conv, [BN], ReLU, conv, [BN]; x + res * res_scale)
    with an optional depthwise conv and ESA tail."""

    def __init__(self, n_feats: int, kernel_size: int = 3, use_bias: bool = True,
                 bn: bool = False, res_scale: float = 1.0, esa_block: bool = True,
                 depth_wise_kernel: int = 7, device=None):
        super().__init__()
        self.res_scale = res_scale
        self.body_conv0 = Conv(n_feats, n_feats, kernel_size, bias=use_bias,
                               device=device)
        self.body_conv1 = Conv(n_feats, n_feats, kernel_size, bias=use_bias,
                               device=device)
        self.body_bn0 = self.body_bn1 = None
        if bn:
            self.body_bn0 = nn.BatchNorm2d(n_feats, momentum=0.01, device=device)
            self.body_bn1 = nn.BatchNorm2d(n_feats, momentum=0.01, device=device)
        self.c5 = self.esa = None
        if esa_block:
            self.c5 = Conv(n_feats, n_feats, depth_wise_kernel, groups=n_feats,
                           device=device)
            self.esa = ESA(16, n_feats, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for i, (conv, bn) in enumerate(((self.body_conv0, self.body_bn0),
                                        (self.body_conv1, self.body_bn1))):
            res = conv(res)
            if bn is not None:
                res = bn(res.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            if i == 0:
                res = torch.relu(res)
        res = x + res * self.res_scale
        if self.esa is not None:
            res = self.esa(self.c5(res))
        return res


class Upsampler(nn.Module):
    """conv3x3 to r^2 n_feats then a pixel shuffle of r, per step of 2
    (scale 2^n) or one of 3, each optionally followed by ReLU or PReLU."""

    def __init__(self, scale: int, n_feats: int, use_bias: bool = True,
                 act: Optional[str] = None, device=None):
        super().__init__()
        if scale & (scale - 1) == 0:
            steps = [2] * (scale.bit_length() - 1)
        elif scale == 3:
            steps = [3]
        else:
            raise NotImplementedError(f"Upsampler scale {scale}")
        self.steps = steps
        self.act_name = act
        for i, r in enumerate(steps):
            self.add_module(f"conv{i}", Conv(n_feats, r * r * n_feats, 3,
                                             bias=use_bias, device=device))
            if act == "prelu":
                self.add_module(f"act{i}", PReLU(device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, r in enumerate(self.steps):
            x = _pixel_shuffle(getattr(self, f"conv{i}")(x), r)
            if self.act_name == "relu":
                x = torch.relu(x)
            elif self.act_name == "prelu":
                x = getattr(self, f"act{i}")(x)
        return x


class LiteUpsampler(nn.Module):
    """One conv3x3 to n_out scale^2 channels, one pixel shuffle."""

    def __init__(self, scale: int, n_feats: int, n_out: int = 3,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.scale = scale
        self.conv0 = Conv(n_feats, n_out * scale * scale, 3, bias=use_bias,
                          device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pixel_shuffle(self.conv0(x), self.scale)
