"""GRL building blocks as torch modules on NHWC tensors (counterparts of the
main-path classes of `grlir.models.blocks`).

Parameter names follow the reference's state_dict, so that
`grlir_torch.utils.convert.flax_path_to_torch_key` maps every JAX parameter
to its key here and released reference checkpoints load with `strict=True`.
Parameters stay fp32; convolutions and linear layers run in the compute
dtype `dt`, LayerNorm and the position-bias MLP in fp32, GELU exact in fp32
and tanh-approximate in bf16 (grlir/models/blocks.py:156-194).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from grlir_torch.ops.block_attn import stripe_half, window_half
from grlir_torch.ops.geometry import get_stripe_info

Size2 = Tuple[int, int]


def linear(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    b = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), b)


def conv_nhwc(layer: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """SAME conv of an NHWC tensor in dtype dt (the conv reads and writes
    channels-last memory, so the permutes are free)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), layer.weight.to(dt),
                 layer.bias.to(dt), padding=layer.padding)
    return y.permute(0, 2, 3, 1)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32, cast back to x's dtype."""
    y = F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                     layer.bias, layer.eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    approx = "tanh" if x.dtype == torch.bfloat16 else "none"
    return F.gelu(x, approximate=approx)


class Mlp(nn.Module):
    """Per-pixel 2-layer MLP."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x, dt):
        return linear(self.fc2, gelu(linear(self.fc1, x, dt)), dt)


class CPBMlp(nn.Sequential):
    """Continuous position bias MLP 2 -> 512 -> heads (keys cpb_mlp.0/.2)."""

    def __init__(self, heads: int, hidden: int = 512, device=None):
        super().__init__(nn.Linear(2, hidden, device=device), nn.ReLU(),
                         nn.Linear(hidden, heads, bias=False, device=device))


class AffineTransform(nn.Module):
    """Logit scale and continuous position bias of one attention map."""

    def __init__(self, heads: int, device=None):
        super().__init__()
        self.logit_scale = nn.Parameter(
            torch.full((heads, 1, 1), math.log(10.0), device=device))
        self.cpb_mlp = CPBMlp(heads, device=device)

    def bias(self, table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """(heads, N1, N2) fp32 bias 16*sigmoid(cpb_mlp(table)) gathered by
        the (N1, N2) table index."""
        t = self.cpb_mlp(table.float())               # (1, Th, Tw, heads)
        t = 16.0 * torch.sigmoid(t.reshape(-1, t.shape[-1]).t())
        return t[:, index]


class WindowAttention(nn.Module):
    """Window half with optional half-window cyclic shift."""

    def __init__(self, window: int, heads: int, shift: bool, device=None):
        super().__init__()
        self.window = (window, window)
        self.shift = window // 2 if shift else 0
        self.attn_transform = AffineTransform(heads, device=device)

    def forward(self, x, wqkv, bqkv, tim, kernels: bool):
        t = self.attn_transform
        y = window_half(x, wqkv, bqkv, t.logit_scale,
                        t.bias(tim["table_w"], tim["index_w"]), self.window,
                        bands=tim["bands_w"] if self.shift else None,
                        shift=self.shift, kernels=kernels)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        return y


class AnchorLinear(nn.Module):
    """df x df average pool then a linear reduction to dim/2 (key reduction)."""

    def __init__(self, dim: int, df: int, device=None):
        super().__init__()
        self.df = df
        self.reduction = nn.Linear(dim, dim // 2, device=device)

    def forward(self, x, dt):
        p = F.avg_pool2d(x.permute(0, 3, 1, 2), self.df, self.df)
        return linear(self.reduction, p.permute(0, 2, 3, 1), dt)


class AnchorProjection(nn.Module):
    """One-stage avgpool anchor projection (keys anchor.body.0.reduction)."""

    def __init__(self, dim: int, df: int, device=None):
        super().__init__()
        self.body = nn.ModuleList([AnchorLinear(dim, df, device=device)])

    def forward(self, x, dt):
        return self.body[0](x, dt)


class AnchorStripeAttention(nn.Module):
    """Anchored stripe half: stripe tokens attend through the df x
    down-sampled anchor (a2w, then w2a)."""

    def __init__(self, stripe_size, stripe_groups, shift: bool, heads: int,
                 df: int, device=None):
        super().__init__()
        self.stripe_size = tuple(stripe_size)
        self.stripe_groups = tuple(stripe_groups)
        self.shift = shift
        self.df = df
        self.attn_transform1 = AffineTransform(heads, device=device)
        self.attn_transform2 = AffineTransform(heads, device=device)

    def forward(self, x, anchor, wqkv, bqkv, tim, kernels: bool):
        _, H, W, _ = x.shape
        df = self.df
        stripe, shift = get_stripe_info(self.stripe_size, self.stripe_groups,
                                        self.shift, (H, W))
        if self.shift:
            # the anchor is rolled here; x's roll happens inside stripe_half
            anchor = torch.roll(anchor, (-(shift[0] // df), -(shift[1] // df)),
                                dims=(1, 2))
        t1, t2 = self.attn_transform1, self.attn_transform2
        y = stripe_half(
            x, anchor, wqkv, bqkv, t1.logit_scale, t2.logit_scale,
            t1.bias(tim["table_s"], tim["index_a2w"]),
            t2.bias(tim["table_s"], tim["index_w2a"]), stripe, df,
            bands=tim["bands_s"] if self.shift else None,
            bands_a=tim["bands_s_a"] if self.shift else None,
            shift=shift if self.shift else (0, 0), kernels=kernels)
        if self.shift:
            y = torch.roll(y, shift, dims=(1, 2))
        return y


def _pointwise(layer: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """1x1 conv of an NHWC tensor as grlir rounds it in dt: the product is
    rounded to dt, then the bias (in dt) is added."""
    w = layer.weight.reshape(layer.out_channels, layer.in_channels)
    return F.linear(x.to(dt), w.to(dt)) + layer.bias.to(dt)


class ChannelAttention(nn.Module):
    """Squeeze-excite gate: channel means, 1x1 conv to dim/reduction, ReLU,
    1x1 conv back, sigmoid (keys attention.1 and attention.3)."""

    def __init__(self, dim: int, reduction: int, device=None):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(dim, dim // reduction, 1, device=device), nn.ReLU(),
            nn.Conv2d(dim // reduction, dim, 1, device=device), nn.Sigmoid())

    def forward(self, x, dt):
        # the mean is taken in fp32 and rounded to dt, as jnp.mean does
        m = x.float().mean((1, 2), keepdim=True).to(dt)
        y = torch.relu(_pointwise(self.attention[1], m, dt))
        return x * torch.sigmoid(_pointwise(self.attention[3], y, dt))


class CAB(nn.Module):
    """Local convolution branch of GRL-base: 3x3 conv to dim/4, GELU, 3x3
    conv back to dim, channel attention (keys cab.0, cab.2, cab.3)."""

    def __init__(self, dim: int, compress_ratio: int = 4, reduction: int = 18,
                 device=None):
        super().__init__()
        mid = dim // compress_ratio
        self.cab = nn.Sequential(
            nn.Conv2d(dim, mid, 3, padding=1, device=device), nn.GELU(),
            nn.Conv2d(mid, dim, 3, padding=1, device=device),
            ChannelAttention(dim, reduction, device=device))

    def forward(self, x, dt):
        y = gelu(conv_nhwc(self.cab[0], x, dt))
        return self.cab[3](conv_nhwc(self.cab[2], y, dt), dt)


class QKVProjection(nn.Module):
    """Shared qkv projection (key qkv.body); its weight is split per half."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.body = nn.Linear(dim, 3 * dim, device=device)


class MixedAttention(nn.Module):
    """Shared-qkv window + anchored-stripe attention: the first half of the
    qkv channels feeds the window half, the second the stripe half; the
    outputs concatenate before the output projection."""

    def __init__(self, dim: int, heads_w: int, heads_s: int, window: int,
                 window_shift: bool, stripe_size, stripe_groups,
                 stripe_shift: bool, df: int, device=None):
        super().__init__()
        self.dim = dim
        self.qkv = QKVProjection(dim, device=device)
        self.window_attn = WindowAttention(window, heads_w, window_shift,
                                           device=device)
        self.anchor = AnchorProjection(dim, df, device=device)
        self.stripe_attn = AnchorStripeAttention(
            stripe_size, stripe_groups, stripe_shift, heads_s, df,
            device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x, tim, dt, kernels: bool):
        wqkv = self.qkv.body.weight.t()               # (C, 3C), JAX layout
        bqkv = self.qkv.body.bias
        half = 3 * self.dim // 2
        x_win = self.window_attn(x, wqkv[:, :half], bqkv[:half], tim, kernels)
        anchor = self.anchor(x, dt)
        x_str = self.stripe_attn(x, anchor, wqkv[:, half:], bqkv[half:], tim,
                                 kernels)
        return linear(self.proj, torch.cat([x_win, x_str], dim=-1), dt)


class EfficientMixAttnTransformerBlock(nn.Module):
    """GRL block: mixed attention and MLP with post-norm residuals, plus the
    CAB local branch beside the attention when local_connection is set
    (key conv).  stripe_type "W" (vertical stripes) reverses the stripe size
    and groups and reads the `sv` geometry."""

    def __init__(self, dim: int, heads_w: int, heads_s: int, window: int,
                 window_shift: bool, stripe_size, stripe_groups,
                 stripe_type: str, stripe_shift: bool, mlp_ratio: float,
                 df: int, local_connection: bool = False, device=None):
        super().__init__()
        self.geometry_key = "sv" if stripe_type == "W" else "sh"
        if stripe_type == "W":
            stripe_size, stripe_groups = stripe_size[::-1], stripe_groups[::-1]
        self.attn = MixedAttention(dim, heads_w, heads_s, window, window_shift,
                                   stripe_size, stripe_groups, stripe_shift,
                                   df, device=device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.conv = CAB(dim, device=device) if local_connection else None

    def select_geometry(self, g: Dict[str, torch.Tensor]):
        s = self.geometry_key
        return {
            "table_w": g["table_w"], "index_w": g["index_w"],
            "bands_w": g["bands_w"], "table_s": g[f"table_{s}"],
            "index_a2w": g[f"index_{s}_a2w"], "index_w2a": g[f"index_{s}_w2a"],
            "bands_s": g[f"bands_{s}"], "bands_s_a": g[f"bands_{s}_a"],
        }

    def forward(self, x, geometry, dt, kernels: bool):
        tim = self.select_geometry(geometry)
        branch = layer_norm(self.norm1, self.attn(x, tim, dt, kernels))
        if self.conv is not None:
            branch = branch + self.conv(x, dt)
        x = x + branch
        return x + layer_norm(self.norm2, self.mlp(x, dt))
