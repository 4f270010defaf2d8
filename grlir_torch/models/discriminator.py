"""Discriminators for GAN training on NHWC tensors (counterparts of
`grlir.models.discriminator`): UNetDiscriminatorSN, the one the real-world
SR recipe trains, PatchGANDiscriminator and VGGStyleDiscriminator.

Spectral norm is grlir's: one power-iteration step per training forward
over the (O, I*kh*kw) matricization, with the vector `u` an explicit
buffer of shape (O,).  `torch.nn.utils.spectral_norm` is not used: it
keeps `weight_orig`/`weight_u`/`weight_v`, iterates on every forward in
train mode whatever the caller asks, and differs in eval mode.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Size2 = Tuple[int, int]


def _l2n(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class SNConv(nn.Module):
    """Conv2d (padding 1) with its kernel divided by a spectral-norm
    estimate.

    forward(x, update): with update, one power-iteration step
    v = l2n(W^T u), u = l2n(W v) runs and the new u is stored; without,
    v = l2n(W^T u) from the stored u.  sigma = u . (W v) with u and v
    constants, so dsigma/dW = u v^T, as grlir's stop-gradients give it.
    """

    def __init__(self, in_ch: int, features: int, kernel_size: Size2 = (3, 3),
                 stride: Size2 = (1, 1), use_bias: bool = True):
        super().__init__()
        kh, kw = kernel_size
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(features, in_ch, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.register_buffer("u", _l2n(torch.randn(features)))

    def forward(self, x: torch.Tensor, update: bool = True) -> torch.Tensor:
        """x: NCHW."""
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        with torch.no_grad():
            u = self.u.clone()
            v = _l2n(w_mat.T @ u)
            if update:
                u = _l2n(w_mat @ v)
                self.u.copy_(u)
        sigma = torch.dot(u, w_mat @ v)
        return F.conv2d(x, self.weight / sigma, self.bias, self.stride, 1)


def _bilinear_up2(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsampling of NCHW, half-pixel centres, edges clamped."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class UNetDiscriminatorSN(nn.Module):
    """U-Net discriminator with spectral norm; NHWC in, (B, H, W, 1) logits
    out.  forward(x, update_sn) advances every SNConv's u when update_sn."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 skip_connection: bool = True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv1 = SNConv(nf, nf * 2, (4, 4), (2, 2), False)
        self.conv2 = SNConv(nf * 2, nf * 4, (4, 4), (2, 2), False)
        self.conv3 = SNConv(nf * 4, nf * 8, (4, 4), (2, 2), False)
        self.conv4 = SNConv(nf * 8, nf * 4, use_bias=False)
        self.conv5 = SNConv(nf * 4, nf * 2, use_bias=False)
        self.conv6 = SNConv(nf * 2, nf, use_bias=False)
        self.conv7 = SNConv(nf, nf, use_bias=False)
        self.conv8 = SNConv(nf, nf, use_bias=False)
        self.conv9 = nn.Conv2d(nf, 1, 3, 1, 1)

    def forward(self, x: torch.Tensor, update_sn: bool = True) -> torch.Tensor:
        up = update_sn
        x0 = _lrelu(self.conv0(_nchw(x)))
        x1 = _lrelu(self.conv1(x0, up))
        x2 = _lrelu(self.conv2(x1, up))
        x3 = _lrelu(self.conv3(x2, up))
        x4 = _lrelu(self.conv4(_bilinear_up2(x3), up))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = _lrelu(self.conv5(_bilinear_up2(x4), up))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = _lrelu(self.conv6(_bilinear_up2(x5), up))
        if self.skip_connection:
            x6 = x6 + x0
        out = _lrelu(self.conv7(x6, up))
        out = _lrelu(self.conv8(out, up))
        return _nhwc(self.conv9(out))


class BatchNorm(nn.Module):
    """flax's BatchNorm (momentum 0.9, eps 1e-5) on NCHW: batch statistics
    in train mode, with the biased variance both for normalizing and for
    the running average (torch's BatchNorm2d keeps the unbiased one)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class PatchGANDiscriminator(nn.Module):
    """PatchGAN discriminator: VALID 3x3 convolutions; NHWC in and out."""

    def __init__(self, num_in_ch: int = 3, ndf: int = 64, n_layers: int = 35):
        super().__init__()
        self.n_layers = n_layers
        self.conv_in = nn.Conv2d(num_in_ch, ndf, 3)
        for i in range(n_layers):
            self.add_module(f"conv_{i}", nn.Conv2d(ndf, ndf, 3, bias=False))
            self.add_module(f"bn_{i}", BatchNorm(ndf))
        self.conv_out = nn.Conv2d(ndf, 1, 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _lrelu(self.conv_in(_nchw(x)))
        for i in range(self.n_layers):
            y = _lrelu(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(y)))
        return _nhwc(self.conv_out(y))


class VGGStyleDiscriminator(nn.Module):
    """VGG-style discriminator for 128^2 or 256^2 inputs; NHWC in, (B, 1)
    logits out."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 input_size: int = 128):
        super().__init__()
        if input_size not in (128, 256):
            raise ValueError(f"input_size {input_size}: 128 or 256")
        self.input_size = input_size
        nf = num_feat
        widths = [nf, nf * 2, nf * 4, nf * 8, nf * 8]
        if input_size == 256:
            widths.append(nf * 8)
        self.n_blocks = len(widths)
        cin = num_in_ch
        for i, cout in enumerate(widths):
            self.add_module(f"conv{i}_0", nn.Conv2d(cin, cout, 3, 1, 1, bias=i == 0))
            if i:
                self.add_module(f"bn{i}_0", BatchNorm(cout))
            self.add_module(f"conv{i}_1", nn.Conv2d(cout, cout, 4, 2, 1, bias=False))
            self.add_module(f"bn{i}_1", BatchNorm(cout))
            cin = cout
        self.linear1 = nn.Linear(cin * 4 * 4, 100)
        self.linear2 = nn.Linear(100, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.input_size:
            raise ValueError(f"input {tuple(x.shape)}: expected "
                             f"{self.input_size}^2")
        feat = _nchw(x)
        for i in range(self.n_blocks):
            feat = getattr(self, f"conv{i}_0")(feat)
            if i:
                feat = getattr(self, f"bn{i}_0")(feat)
            feat = _lrelu(feat)
            feat = _lrelu(getattr(self, f"bn{i}_1")(getattr(self, f"conv{i}_1")(feat)))
        # flatten in grlir's NHWC order
        feat = _nhwc(feat).reshape(feat.shape[0], -1)
        return self.linear2(_lrelu(self.linear1(feat)))
