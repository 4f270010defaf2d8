"""Swin v1 and v2 window-attention blocks and the patch embedding, on NHWC
tensors (counterparts of `grlir.models.swin`).

Support layers kept beside GRL for completeness; the GRL path does not use
them.  v1: pre-norm, a learned relative-position bias table, scaled
dot-product attention.  v2: post-norm, cosine attention with the
continuous position bias of `blocks.AffineTransform`.  Parameter names
follow grlir's flax modules (attn.qkv, attn.relative_position_bias_table,
attn.attn_transform, attn.proj, norm1, mlp.fc1, norm2 ...), fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from grlir_torch.models.blocks import AffineTransform, Mlp, layer_norm, linear
from grlir_torch.ops.geometry import fill_window, get_relative_position_index
from grlir_torch.ops.layout import window_partition, window_reverse

Size2 = Tuple[int, int]


def shift_mask(x_size: Size2, window: Size2, shift: Size2,
               device=None) -> torch.Tensor:
    """(nW, N, N) additive {0, -100} mask of shifted windows: -100 where
    the band ids of query and key differ (grlir.ops.geometry.calculate_mask)."""
    m = torch.as_tensor(fill_window(x_size, window, shift), device=device)
    return torch.where(m[:, None, :] != m[:, :, None], -100.0, 0.0)


def _split_heads(qkv: torch.Tensor, heads: int):
    """(B, nW, N, 3C) -> q, k, v of (B, nW, heads, N, d), channels in
    [3, heads, d] order."""
    B, nW, N, C3 = qkv.shape
    x = qkv.reshape(B, nW, N, 3, heads, C3 // (3 * heads)).permute(3, 0, 1, 4, 2, 5)
    return x[0], x[1], x[2]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, nW, heads, N, d) -> (B, nW, N, heads * d)."""
    B, nW, h, N, d = x.shape
    return x.transpose(2, 3).reshape(B, nW, N, h * d)


class WindowAttentionV1(nn.Module):
    """Swin v1 window attention: q scaled by d^-1/2, a learned bias table
    gathered by the relative position index.  x: (B, nW, N, C)."""

    def __init__(self, dim: int, window: Size2, heads: int, qkv_bias: bool = True,
                 device=None):
        super().__init__()
        self.window = tuple(window)
        self.heads = heads
        wh, ww = self.window
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(((2 * wh - 1) * (2 * ww - 1), heads), device=device))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("index", torch.as_tensor(
            get_relative_position_index(self.window).astype("int64"),
            device=device), persistent=False)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        N, C = x.shape[2], x.shape[3]
        q, k, v = _split_heads(linear(self.qkv, x, x.dtype), self.heads)
        attn = (q * (C // self.heads) ** -0.5) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[self.index.reshape(-1)]
        attn = attn + bias.reshape(N, N, self.heads).permute(2, 0, 1)
        if mask is not None:
            attn = attn + mask[:, None]
        out = torch.softmax(attn, -1) @ v
        return linear(self.proj, _merge_heads(out), x.dtype)


class SwinTransformerBlockV1(nn.Module):
    """Pre-norm Swin v1 block with optional half-window shift, on NHWC x."""

    def __init__(self, dim: int, window: Size2, heads: int, shift: bool = False,
                 mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.window = tuple(window)
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn = WindowAttentionV1(dim, self.window, heads, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + _windowed(self.attn, layer_norm(self.norm1, x), self.window,
                          self.shift)
        return x + self.mlp(layer_norm(self.norm2, x), x.dtype)


def _windowed(attn, x, window: Size2, shift: bool, *args):
    """attn on the (shifted) windows of NHWC x, with the shift mask."""
    _, H, W, _ = x.shape
    s = (window[0] // 2, window[1] // 2) if shift else (0, 0)
    if shift:
        x = torch.roll(x, (-s[0], -s[1]), dims=(1, 2))
    mask = shift_mask((H, W), window, s, x.device) if shift else None
    y = window_reverse(attn(window_partition(x, window), *args, mask=mask),
                       window, (H, W))
    return torch.roll(y, s, dims=(1, 2)) if shift else y


class WindowAttentionV2(nn.Module):
    """Swin v2 window attention: cosine logits, the logit scale and the
    continuous position bias of AffineTransform.  x: (B, nW, N, C); table
    and index as the GRL geometry gives them."""

    def __init__(self, dim: int, window: Size2, heads: int, qkv_bias: bool = True,
                 device=None):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.attn_transform = AffineTransform(heads, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x, table, index, mask: Optional[torch.Tensor] = None):
        q, k, v = _split_heads(linear(self.qkv, x, x.dtype), self.heads)

        def unit(t):
            return t / torch.clamp(t.norm(dim=-1, keepdim=True), min=1e-12)

        t = self.attn_transform
        attn = unit(q) @ unit(k).transpose(-1, -2)
        attn = attn * torch.exp(torch.clamp(t.logit_scale, max=math.log(100.0)))
        attn = attn + t.bias(table, index)
        if mask is not None:
            attn = attn + mask[:, None]
        out = torch.softmax(attn, -1) @ v
        return linear(self.proj, _merge_heads(out), x.dtype)


class SwinTransformerBlockV2(nn.Module):
    """Post-norm Swin v2 block, on NHWC x."""

    def __init__(self, dim: int, window: Size2, heads: int, shift: bool = False,
                 mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.window = tuple(window)
        self.shift = shift
        self.attn = WindowAttentionV2(dim, self.window, heads, device=device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, x, table, index):
        y = _windowed(self.attn, x, self.window, self.shift, table, index)
        x = x + layer_norm(self.norm1, y)
        return x + layer_norm(self.norm2, self.mlp(x, x.dtype))


class PatchEmbed(nn.Module):
    """p x p patches of NHWC x to embed_dim tokens, staying spatial, with
    an optional LayerNorm."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 1,
                 use_norm: bool = False, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Linear(patch_size * patch_size * in_chans, embed_dim,
                              device=device)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5, device=device) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        if p > 1:
            B, H, W, C = x.shape
            x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(B, H // p, W // p, p * p * C)
        x = linear(self.proj, x, x.dtype)
        return x if self.norm is None else layer_norm(self.norm, x)


class PatchUnEmbed(nn.Module):
    """Tokens back to an image: the identity on NHWC tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
