"""GRL building blocks as torch modules on NHWC tensors (counterparts of the
classes of `grlir.models.blocks`, the ablation branches included).

Parameter names follow the reference's state_dict, so that
`grlir_torch.utils.convert.flax_path_to_torch_key` maps every JAX parameter
to its key here and released reference checkpoints load with `strict=True`.
Parameters stay fp32; convolutions and linear layers run in the compute
dtype `dt`, LayerNorm and the position-bias MLP in fp32, GELU exact in fp32
and tanh-approximate in bf16 (grlir/models/blocks.py:156-194).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from grlir_torch.ops import block_attn
from grlir_torch.ops.attention import (
    fused_cosine_attention_auto,
    fused_window_attention_qkv,
)
from grlir_torch.ops.block_attn import (
    stripe_half,
    stripe_route,
    window_half,
    window_route,
)
from grlir_torch.ops.flash_attention import flash_rect_attention
from grlir_torch.ops.geometry import get_stripe_info
from grlir_torch.ops.layout import window_partition_cm, window_reverse_cm

Size2 = Tuple[int, int]

# token count above which the fused engines take the flash-tiled kernel (B5)
# instead of the whole-window ones (B6, B7) (grlir/models/blocks.py:329-331)
_FLASH_MIN_TOKENS = 256

# each engine's attention for the (window, stripe) halves: "v3" the whole
# block-half kernels (B1-B4), "fused" the kernels on q, k, v projected
# beforehand (B5-B7), "plain" cosine_attention; the JAX package's per-half
# choice (grlir/models/blocks.py:1084-1090)
ENGINE_HALVES = {"v3": ("v3", "v3"), "fused": ("fused", "fused"),
                 "window": ("fused", "plain"), "stripe": ("plain", "fused")}


def linear(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    b = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), b)


def conv_nhwc(layer: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The conv of an NHWC tensor in dtype dt, with the layer's stride,
    padding and groups (the conv reads and writes channels-last memory, so
    the permutes are free)."""
    b = None if layer.bias is None else layer.bias.to(dt)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), layer.weight.to(dt), b,
                 stride=layer.stride, padding=layer.padding, groups=layer.groups)
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

    def bias(self, table: torch.Tensor, index: torch.Tensor,
             out_dtype=None) -> torch.Tensor:
        """(heads, N1, N2) bias 16*sigmoid(cpb_mlp(table)) gathered by the
        (N1, N2) table index: fp32, or cast to out_dtype before the gather
        (grlir/models/blocks.py:313-316)."""
        t = self.cpb_mlp(table.float())               # (1, Th, Tw, heads)
        t = 16.0 * torch.sigmoid(t.reshape(-1, t.shape[-1]).t())
        if out_dtype is not None:
            t = t.to(out_dtype)
        return t[:, index]


def _inflate_mask(bands_q: torch.Tensor, bands_k: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """(nW, N1) x (nW, N2) band ids -> (nW, N1, N2) additive {0, -100} mask
    in dtype (grlir/models/grl.py:176-182), built where it is used."""
    return block_attn._band_mask(bands_q, bands_k)[:, 0].to(dtype)


def _l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12):
    """x / max(||x||, eps) over dim (torch F.normalize)."""
    n = torch.sqrt((x * x).sum(dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def cosine_attention(q, k, v, transform: AffineTransform, table, index, mask,
                     fused: bool = False, kernels: bool = True,
                     euclidean: bool = False) -> torch.Tensor:
    """Cosine attention of grlir's `cosine_attention` in its d-major layout:
    q (B, nW, h, d, N1); k, v (B, nW, h, d, N2); mask (nW, N1, N2) additive
    or None.  Returns (B, nW, h, d, N1).

    fused=False is grlir's plain path (use_pallas=False,
    grlir/models/blocks.py:379-413) with its rounding: unit norms as
    x / max(||x||, 1e-12), logits in the compute type, the scale, bias and
    mask in the logits' type, an fp32 softmax rounded back, the product
    with v in the compute type.  fused=True runs the B7 kernels through
    `fused_cosine_attention_auto` on token-major views (use_pallas=True,
    :370-378).  euclidean=True takes the logits as the Euclidean distances
    ||q_n - k_m|| of the raw q and k (grlir's euclidean_dist, :379-392);
    it never reaches a kernel, whatever `fused` says, as in grlir."""
    if fused and not euclidean:
        y = fused_cosine_attention_auto(
            q.transpose(-1, -2), k.transpose(-1, -2), v.transpose(-1, -2),
            transform.logit_scale, transform.bias(table, index), mask, kernels)
        return y.transpose(-1, -2)
    if euclidean:
        attn = torch.linalg.vector_norm(q[..., :, None] - k[..., None, :], dim=-3)
    else:
        attn = torch.einsum("...dn,...dm->...nm", _l2_normalize(q, -2),
                            _l2_normalize(k, -2))
    scale = torch.exp(torch.clamp(transform.logit_scale, max=math.log(100.0)))
    attn = attn * scale.to(attn.dtype)
    attn = attn + transform.bias(table, index, attn.dtype)
    if mask is not None:
        attn = attn + mask.to(attn.dtype)[:, None]
    attn = torch.softmax(attn.float(), -1).to(q.dtype)
    return torch.einsum("...nm,...dm->...dn", attn, v).to(v.dtype)


def _qkv_cm(xw, wqkv, bqkv, dt: torch.dtype) -> torch.Tensor:
    """Channel-major qkv projection of partitioned windows in dt: xw
    (B, nW, C, N), wqkv (C, 3Ch) -> (B, nW, 3Ch, N)
    (grlir/models/blocks.py:856-867)."""
    out = torch.matmul(wqkv.t().to(dt), xw.to(dt))
    if bqkv is not None:
        out = out + bqkv.to(dt)[:, None]
    return out


def _split_qkv_cm(qkv: torch.Tensor, heads: int):
    """(B, nW, 3C, N) channel-major qkv -> q, k, v of (B, nW, heads, d, N)
    each, channels in [3, heads, d] order."""
    B, nW, C3, N = qkv.shape
    C = C3 // 3
    return tuple(qkv[:, :, i * C:(i + 1) * C].reshape(B, nW, heads, C // heads, N)
                 for i in range(3))


def _qkv_cm_heads(xw, wqkv, bqkv, dt: torch.dtype, heads: int):
    """The projection split into q, k, v of (B, nW, heads, d, N) each (the
    "fused" form of grlir/models/blocks.py:883-898)."""
    return _split_qkv_cm(_qkv_cm(xw, wqkv, bqkv, dt), heads)


class WindowAttention(nn.Module):
    """Window half with optional half-window cyclic shift.  mode "v3" runs
    the block-half kernels where a TPU route takes the geometry and the
    plain path where none does (grlir/models/blocks.py:557-562); "fused"
    runs B6, or B5 above _FLASH_MIN_TOKENS tokens; "plain" runs
    cosine_attention.  `forward` takes the block input and this half's
    slice of the qkv weights; `forward_projected` takes qkv projected
    beforehand (grlir's legacy route, :484-522)."""

    def __init__(self, window: int, heads: int, shift: bool, mode: str = "v3",
                 euclidean: bool = False, device=None):
        super().__init__()
        self.window = (window, window)
        self.heads = heads
        self.shift = window // 2 if shift else 0
        self.mode = mode
        self.euclidean = euclidean
        self.attn_transform = AffineTransform(heads, device=device)

    def forward(self, x, wqkv, bqkv, tim, dt, kernels: bool):
        t = self.attn_transform
        _, H, W, _ = x.shape
        h, shift = self.heads, self.shift
        table, index = tim["table_w"], tim["index_w"]
        bands = tim["bands_w"] if shift else None
        if self.mode == "v3":
            if window_route((H, W), self.window, h) is not None:
                y = window_half(x, wqkv, bqkv, t.logit_scale, t.bias(table, index),
                                self.window, bands=bands, shift=shift,
                                kernels=kernels)
                return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y
            block_attn.unrouted_halves += 1
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = window_partition_cm(x, self.window)              # (B, nW, C, N)
        N = xw.shape[-1]
        if self.mode == "fused" and N > _FLASH_MIN_TOKENS:
            q, k, v = _qkv_cm_heads(xw, wqkv, bqkv, dt, h)
            y = flash_rect_attention(q, k, v, t.logit_scale,
                                     t.bias(table, index, q.dtype), bands, bands,
                                     kernels)
        elif self.mode == "fused":
            y = fused_window_attention_qkv(_qkv_cm(xw, wqkv, bqkv, dt),
                                           t.logit_scale, t.bias(table, index),
                                           h, bands, kernels)
        else:
            q, k, v = _qkv_cm_heads(xw, wqkv, bqkv, dt, h)
            mask = _inflate_mask(bands, bands, dt) if shift else None
            y = cosine_attention(q, k, v, t, table, index, mask)
        y = window_reverse_cm(y.reshape(*xw.shape[:2], -1, N), self.window,
                              (H, W))
        return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y

    def forward_projected(self, qkv, tim, dt, kernels: bool):
        """qkv: (B, H, W, 3Cw) projected beforehand.  mode "fused" runs B6
        on the channel-major windows of qkv, whatever their token count (the
        legacy route has no flash branch); any other mode, and the
        Euclidean logits, the plain cosine_attention."""
        t = self.attn_transform
        _, H, W, _ = qkv.shape
        h, shift = self.heads, self.shift
        table, index = tim["table_w"], tim["index_w"]
        bands = tim["bands_w"] if shift else None
        if shift:
            qkv = torch.roll(qkv, (-shift, -shift), dims=(1, 2))
        qw = window_partition_cm(qkv, self.window)            # (B, nW, 3Cw, N)
        if self.mode == "fused" and not self.euclidean:
            y = fused_window_attention_qkv(qw, t.logit_scale, t.bias(table, index),
                                           h, bands, kernels)
        else:
            q, k, v = _split_qkv_cm(qw, h)
            mask = _inflate_mask(bands, bands, dt) if shift else None
            y = cosine_attention(q, k, v, t, table, index, mask,
                                 euclidean=self.euclidean)
        B, nW, _, N = qw.shape
        y = window_reverse_cm(y.reshape(B, nW, -1, N), self.window, (H, W))
        return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y


class SeparableConv(nn.Sequential):
    """Depthwise k x k conv (stride s, a group a channel), GELU when act,
    then a 1x1 pointwise conv (keys 0 and 2; grlir/models/blocks.py:803-823)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = True, act: bool = True, device=None):
        super().__init__(
            nn.Conv2d(cin, cin, kernel, stride, padding=kernel // 2, groups=cin,
                      bias=bias, device=device),
            nn.GELU() if act else nn.Identity(),
            nn.Conv2d(cin, cout, 1, bias=bias, device=device))
        self.act = act

    def forward(self, x, dt):
        y = conv_nhwc(self[0], x, dt)
        return conv_nhwc(self[2], gelu(y) if self.act else y, dt)


class PatchMerging(nn.Module):
    """2 x 2 space-to-depth, then a linear reduction without bias (key
    reduction; grlir/models/blocks.py:920-933)."""

    def __init__(self, dim: int, out_dim: int, device=None):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False, device=device)

    def forward(self, x, dt):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return linear(self.reduction, x, dt)


class AnchorLinear(nn.Module):
    """df x df average (or max) pool then a linear reduction to dim/2 (key
    reduction)."""

    def __init__(self, dim: int, df: int, pool: str = "avgpool", device=None):
        super().__init__()
        self.df = df
        self.pool = F.avg_pool2d if pool == "avgpool" else F.max_pool2d
        self.reduction = nn.Linear(dim, dim // 2, device=device)

    def forward(self, x, dt):
        p = self.pool(x.permute(0, 3, 1, 2), self.df, self.df)
        return linear(self.reduction, p.permute(0, 2, 3, 1), dt)


class AnchorProjection(nn.Module):
    """The block input down-sampled df x to the anchor map at dim/2
    channels (grlir/models/blocks.py:935-977; keys anchor.body.<i>).  One
    stage: avgpool or maxpool + linear, a (df+1)^2 conv of stride df, its
    separable form, or one patch merging; two stages (one_stage False):
    log2(df) steps of a 3x3 conv of stride 2, its separable form, or patch
    merging.  Where grlir gives a layer no compute type (patch merging, the
    two-stage steps) it runs in fp32, and the anchor is rounded to dt."""

    def __init__(self, dim: int, df: int, proj_type: str = "avgpool",
                 one_stage: bool = True, act: bool = True, device=None):
        super().__init__()
        out = dim // 2
        self.fp32 = proj_type == "patchmerging" or not one_stage
        if one_stage:
            if proj_type in ("avgpool", "maxpool"):
                body = AnchorLinear(dim, df, proj_type, device=device)
            elif proj_type == "conv2d":
                body = nn.Conv2d(dim, out, df + 1, df, padding=(df + 1) // 2,
                                 device=device)
            elif proj_type == "separable_conv":
                body = SeparableConv(dim, out, df + 1, df, True, act, device=device)
            elif proj_type == "patchmerging":
                body = PatchMerging(dim, out, device=device)
            else:
                raise ValueError(f"anchor_proj_type {proj_type!r}")
            self.body = nn.ModuleList([body])
            return
        steps = []
        for i in range(int(math.log2(df))):
            cin = dim if i == 0 else out
            if proj_type == "conv2d":
                steps.append(nn.Conv2d(cin, out, 3, 2, padding=1, device=device))
            elif proj_type == "separable_conv":
                steps.append(SeparableConv(cin, out, 3, 2, True, act, device=device))
            elif proj_type == "patchmerging":
                steps.append(PatchMerging(cin, out, device=device))
            else:
                raise ValueError(f"two-stage anchor_proj_type {proj_type!r}")
        self.body = nn.ModuleList(steps)

    def forward(self, x, dt):
        cdt = torch.float32 if self.fp32 else dt
        for step in self.body:
            x = conv_nhwc(step, x, cdt) if isinstance(step, nn.Conv2d) else step(x, cdt)
        return x.to(dt)


class AnchorStripeAttention(nn.Module):
    """Anchored stripe half: stripe tokens attend through the df x
    down-sampled anchor (a2w, then w2a).  mode as in WindowAttention: "v3"
    the block-half kernels where a TPU route takes the geometry, else the
    plain path; "fused" B5 twice above _FLASH_MIN_TOKENS tokens, else B7
    twice; "plain" cosine_attention twice.  `forward_projected` takes qkv
    projected beforehand (grlir's legacy route, :646-672): "fused" runs B7
    twice at any token count, every other mode the plain path."""

    def __init__(self, stripe_size, stripe_groups, shift: bool, heads: int,
                 df: int, mode: str = "v3", euclidean: bool = False, device=None):
        super().__init__()
        self.stripe_size = tuple(stripe_size)
        self.stripe_groups = tuple(stripe_groups)
        self.shift = shift
        self.heads = heads
        self.df = df
        self.mode = mode
        self.euclidean = euclidean
        self.attn_transform1 = AffineTransform(heads, device=device)
        self.attn_transform2 = AffineTransform(heads, device=device)

    def _geometry(self, x_size, anchor, tim):
        """(stripe, shift, anchor rolled by the anchor's shift, bands,
        anchor bands); the shift and bands are zero and None unshifted."""
        df = self.df
        stripe, shift = get_stripe_info(self.stripe_size, self.stripe_groups,
                                        self.shift, x_size)
        if not self.shift:
            return stripe, (0, 0), anchor, None, None
        anchor = torch.roll(anchor, (-(shift[0] // df), -(shift[1] // df)),
                            dims=(1, 2))
        return stripe, shift, anchor, tim["bands_s"], tim["bands_s_a"]

    def forward(self, x, anchor, wqkv, bqkv, tim, dt, kernels: bool):
        _, H, W, _ = x.shape
        df, h = self.df, self.heads
        # the anchor is rolled here; x's roll happens inside stripe_half or
        # below
        stripe, shift, anchor, bands, bands_a = self._geometry((H, W), anchor, tim)
        t1, t2 = self.attn_transform1, self.attn_transform2
        table, i1, i2 = tim["table_s"], tim["index_a2w"], tim["index_w2a"]
        if self.mode == "v3":
            if stripe_route((H, W), stripe, df, h) is not None:
                y = stripe_half(
                    x, anchor, wqkv, bqkv, t1.logit_scale, t2.logit_scale,
                    t1.bias(table, i1), t2.bias(table, i2), stripe, df,
                    bands=bands, bands_a=bands_a, shift=shift, kernels=kernels)
                return torch.roll(y, shift, dims=(1, 2)) if self.shift else y
            block_attn.unrouted_halves += 1
        if self.shift:
            x = torch.roll(x, (-shift[0], -shift[1]), dims=(1, 2))
        q, k, v = _qkv_cm_heads(window_partition_cm(x, stripe), wqkv, bqkv, dt, h)
        B, nW, _, d, N1 = q.shape
        a = window_partition_cm(anchor, (stripe[0] // df, stripe[1] // df))
        a = a.reshape(B, nW, h, d, -1)                        # (B, nW, h, d, N2)
        if self.mode == "fused" and max(N1, a.shape[-1]) > _FLASH_MIN_TOKENS:
            y = flash_rect_attention(a, k, v, t1.logit_scale,
                                     t1.bias(table, i1, k.dtype), bands_a, bands,
                                     kernels)
            y = flash_rect_attention(q, a, y, t2.logit_scale,
                                     t2.bias(table, i2, q.dtype), bands, bands_a,
                                     kernels)
        else:
            y = self._attend(q, k, v, a, tim, dt, bands, bands_a, kernels)
        y = window_reverse_cm(y.reshape(B, nW, -1, N1), stripe, (H, W))
        return torch.roll(y, shift, dims=(1, 2)) if self.shift else y

    def _attend(self, q, k, v, a, tim, dt, bands, bands_a, kernels: bool):
        """The two cosine attentions, a2w then w2a: B7 in mode "fused", the
        plain path otherwise and for the Euclidean logits."""
        fused = self.mode == "fused"
        m1 = m2 = None
        if self.shift:
            m1 = _inflate_mask(bands_a, bands, dt)
            m2 = _inflate_mask(bands, bands_a, dt)
        table = tim["table_s"]
        y = cosine_attention(a, k, v, self.attn_transform1, table, tim["index_a2w"],
                             m1, fused, kernels, self.euclidean)
        return cosine_attention(q, a, y, self.attn_transform2, table,
                                tim["index_w2a"], m2, fused, kernels, self.euclidean)

    def forward_projected(self, qkv, anchor, tim, dt, kernels: bool):
        """qkv: (B, H, W, 3Cs) projected beforehand; anchor (B, H/df, W/df,
        Cs)."""
        _, H, W, _ = qkv.shape
        df, h = self.df, self.heads
        stripe, shift, anchor, bands, bands_a = self._geometry((H, W), anchor, tim)
        if self.shift:
            qkv = torch.roll(qkv, (-shift[0], -shift[1]), dims=(1, 2))
        q, k, v = _split_qkv_cm(window_partition_cm(qkv, stripe), h)
        B, nW, _, d, N1 = q.shape
        a = window_partition_cm(anchor, (stripe[0] // df, stripe[1] // df))
        y = self._attend(q, k, v, a.reshape(B, nW, h, d, -1), tim, dt, bands,
                         bands_a, kernels)
        y = window_reverse_cm(y.reshape(B, nW, -1, N1), stripe, (H, W))
        return torch.roll(y, shift, dims=(1, 2)) if self.shift else y


class StripeAttention(nn.Module):
    """Anchor-free stripe attention, the stripe half at df 1: plain cosine
    attention within each stripe on qkv projected beforehand, with the df 1
    geometry's w2a table, index and mask (grlir/models/blocks.py:770-800;
    grlir sends it to no kernel)."""

    def __init__(self, stripe_size, stripe_groups, shift: bool, heads: int,
                 euclidean: bool = False, device=None):
        super().__init__()
        self.stripe_size = tuple(stripe_size)
        self.stripe_groups = tuple(stripe_groups)
        self.shift = shift
        self.heads = heads
        self.euclidean = euclidean
        self.attn_transform = AffineTransform(heads, device=device)

    def forward(self, qkv, tim, dt):
        _, H, W, _ = qkv.shape
        stripe, shift = get_stripe_info(self.stripe_size, self.stripe_groups,
                                        self.shift, (H, W))
        if self.shift:
            qkv = torch.roll(qkv, (-shift[0], -shift[1]), dims=(1, 2))
        qw = window_partition_cm(qkv, stripe)
        q, k, v = _split_qkv_cm(qw, self.heads)
        mask = (_inflate_mask(tim["bands_s"], tim["bands_s_a"], dt)
                if self.shift else None)
        y = cosine_attention(q, k, v, self.attn_transform, tim["table_s"],
                             tim["index_w2a"], mask, euclidean=self.euclidean)
        B, nW, _, N = qw.shape
        y = window_reverse_cm(y.reshape(B, nW, -1, N), stripe, (H, W))
        return torch.roll(y, shift, dims=(1, 2)) if self.shift else y


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
    """Shared qkv projection (key qkv.body): a Linear, or for any other
    proj_type a 3x3 separable conv (grlir/models/blocks.py:901-918).  The
    fused route reads the Linear's weight, split per half, instead of
    calling it."""

    def __init__(self, dim: int, bias: bool = True, proj_type: str = "linear",
                 act: bool = True, device=None):
        super().__init__()
        self.linear = proj_type == "linear"
        self.body = (nn.Linear(dim, 3 * dim, bias=bias, device=device) if self.linear
                     else SeparableConv(dim, 3 * dim, 3, 1, bias, act, device=device))

    def forward(self, x, dt):
        return linear(self.body, x, dt) if self.linear else self.body(x, dt)


# grlir's ablation fields of MixedAttention, with the recipes' values
ATTENTION_OPTIONS = {
    "qkv_bias": True, "qkv_proj_type": "linear", "anchor_proj_type": "avgpool",
    "anchor_one_stage": True, "separable_conv_act": True,
    "euclidean_dist": False, "double_window": False, "stripe_square": False,
    "out_proj_type": "linear",
}


class MixedAttention(nn.Module):
    """Shared-qkv window + stripe attention: the first half of the qkv
    channels feeds the window half, the second the stripe half; the outputs
    concatenate before the output projection (a Linear, or a 3x3 conv with
    out_proj_type "conv2d").  engine: a key of ENGINE_HALVES, the attention
    each half runs.

    grlir's routing (grlir/models/blocks.py:1040-1138): with a linear qkv,
    an anchor (df > 1), one window half and cosine logits the halves take
    the block input and the raw qkv weights (`fused_io`); every other
    combination projects qkv first and takes the legacy route, where the
    v3 engine runs the plain path, the fused engines B6 on the window half
    and B7 twice on the anchored stripe half.  The stripe half is then the
    anchored one, a second (always plain) window attention with
    double_window, or at df 1 the anchor-free StripeAttention, on
    window-sized squares with stripe_square."""

    def __init__(self, dim: int, heads_w: int, heads_s: int, window: int,
                 window_shift: bool, stripe_size, stripe_groups,
                 stripe_shift: bool, df: int, engine: str = "v3", device=None,
                 **options):
        super().__init__()
        unknown = set(options) - set(ATTENTION_OPTIONS)
        if unknown:
            raise TypeError(f"unknown attention options {sorted(unknown)}")
        o = {**ATTENTION_OPTIONS, **options}
        mode_w, mode_s = ENGINE_HALVES[engine]
        euclid = o["euclidean_dist"]
        self.dim = dim
        self.fused_io = (o["qkv_proj_type"] == "linear" and not o["double_window"]
                         and df > 1 and not euclid)
        self.qkv = QKVProjection(dim, o["qkv_bias"], o["qkv_proj_type"],
                                 o["separable_conv_act"], device=device)
        self.window_attn = WindowAttention(window, heads_w, window_shift,
                                           mode_w, euclid, device=device)
        self.anchor = None
        if o["double_window"]:
            self.stripe_attn = WindowAttention(window, heads_w, window_shift,
                                               "plain", euclid, device=device)
        elif df > 1:
            self.anchor = AnchorProjection(dim, df, o["anchor_proj_type"],
                                           o["anchor_one_stage"],
                                           o["separable_conv_act"], device=device)
            self.stripe_attn = AnchorStripeAttention(
                stripe_size, stripe_groups, stripe_shift, heads_s, df, mode_s,
                euclid, device=device)
        elif o["stripe_square"]:
            self.stripe_attn = StripeAttention((window, window), (None, None),
                                               stripe_shift, heads_s, euclid,
                                               device=device)
        else:
            self.stripe_attn = StripeAttention(stripe_size, stripe_groups,
                                               stripe_shift, heads_s, euclid,
                                               device=device)
        if o["out_proj_type"] == "conv2d":
            self.proj = nn.Conv2d(dim, dim, 3, padding=1, device=device)
        elif o["out_proj_type"] == "linear":
            self.proj = nn.Linear(dim, dim, device=device)
        else:
            raise ValueError(f"out_proj_type {o['out_proj_type']!r}")

    def forward(self, x, tim, dt, kernels: bool):
        if self.fused_io:
            wqkv = self.qkv.body.weight.t()           # (C, 3C), JAX layout
            b = self.qkv.body.bias
            half = 3 * self.dim // 2
            x_win = self.window_attn(x, wqkv[:, :half],
                                     None if b is None else b[:half], tim, dt,
                                     kernels)
            x_str = self.stripe_attn(x, self.anchor(x, dt), wqkv[:, half:],
                                     None if b is None else b[half:], tim, dt,
                                     kernels)
        else:
            qkv = self.qkv(x, dt)
            q_win, q_str = qkv.chunk(2, dim=-1)
            x_win = self.window_attn.forward_projected(q_win, tim, dt, kernels)
            if isinstance(self.stripe_attn, StripeAttention):
                x_str = self.stripe_attn(q_str, tim, dt)
            elif self.anchor is None:
                x_str = self.stripe_attn.forward_projected(q_str, tim, dt, kernels)
            else:
                x_str = self.stripe_attn.forward_projected(
                    q_str, self.anchor(x, dt), tim, dt, kernels)
        y = torch.cat([x_win, x_str], dim=-1)
        if isinstance(self.proj, nn.Conv2d):
            return conv_nhwc(self.proj, y, dt)
        return linear(self.proj, y, dt)


def drop_path(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Stochastic depth on the batch axis (timm DropPath semantics, as
    grlir/models/blocks.py:197-205): samples whose mask is set are scaled by
    1 / (1 - rate), the others zeroed.  keep: (B,) bool, drawn by the
    caller, so that a recomputed forward (remat) applies the same masks."""
    k = keep.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(k, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class EfficientMixAttnTransformerBlock(nn.Module):
    """GRL block: mixed attention and MLP with post-norm residuals, plus the
    CAB local branch beside the attention when local_connection is set
    (key conv).  stripe_type "W" (vertical stripes) reverses the stripe size
    and groups and reads the `sv` geometry.  options: ATTENTION_OPTIONS'
    fields, handed to MixedAttention.  In training both residual
    branches take stochastic depth at drop_path_rate and are scaled by
    res_scale (grlir/models/blocks.py:1222-1233)."""

    def __init__(self, dim: int, heads_w: int, heads_s: int, window: int,
                 window_shift: bool, stripe_size, stripe_groups,
                 stripe_type: str, stripe_shift: bool, mlp_ratio: float,
                 df: int, local_connection: bool = False, engine: str = "v3",
                 drop_path_rate: float = 0.0, res_scale: float = 1.0,
                 device=None, **options):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.res_scale = res_scale
        self.geometry_key = "sv" if stripe_type == "W" else "sh"
        if stripe_type == "W":
            stripe_size, stripe_groups = stripe_size[::-1], stripe_groups[::-1]
        self.attn = MixedAttention(dim, heads_w, heads_s, window, window_shift,
                                   stripe_size, stripe_groups, stripe_shift,
                                   df, engine, device=device, **options)
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

    def forward(self, x, geometry, dt, kernels: bool,
                keep: Optional[torch.Tensor] = None):
        """keep: None, or this block's stochastic-depth masks, (2, B) bool,
        for the attention and the MLP branch (`drop_path`)."""
        tim = self.select_geometry(geometry)

        def residual(y, i):
            if keep is not None and self.drop_path_rate > 0.0:
                y = drop_path(y, keep[i], self.drop_path_rate)
            return y if self.res_scale == 1.0 else self.res_scale * y

        branch = residual(layer_norm(self.norm1, self.attn(x, tim, dt, kernels)), 0)
        if self.conv is not None:
            branch = branch + self.conv(x, dt)
        x = x + branch
        return x + residual(layer_norm(self.norm2, self.mlp(x, dt)), 1)
