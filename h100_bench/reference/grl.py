"""GRL in plain PyTorch, float32: the benchmark's reference forward.

A frozen copy of GRL's equations (Li et al., "Efficient and Explicit
Modelling of Image Hierarchies for Image Restoration", CVPR 2023;
https://github.com/ofsoundof/GRL-Image-Restoration), for the variants the
benchmark's configurations run: a linear qkv projection shared by a
window half and an anchored stripe half (avg-pool anchors, one stage),
cosine attention with a logit scale and a continuous position bias,
post-norm residual blocks, the CAB local branch, 3x3 stage convolutions
and the pixel-shuffle tail.  NHWC in [0, 1] in and out.

It imports nothing of the program under test and takes only what the
benchmark hands both sides: the parameters, by the state-dict names GRL's
released checkpoints use, and the inputs.  Geometry is worked out here
(`geometry.py`).  Every product runs in float32 with TF32 off, softmax,
LayerNorm and GELU (exact) in float32; `prec="fp8"` rounds each product's
operands to float8 e4m3 with a per-tensor scale, the benchmark's control.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100_bench.reference import geometry as G

RGB_MEAN = (0.4488, 0.4371, 0.4040)
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _RoundFP8(torch.autograd.Function):
    """x rounded to float8 e4m3 at a per-tensor scale (amax to 448);
    the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


def operand(t: torch.Tensor, prec: Optional[str]) -> torch.Tensor:
    """A product's operand in the precision `prec` (None: as it is)."""
    return _RoundFP8.apply(t) if prec == "fp8" else t


# --------------------------------------------------------------- parameters

def blocks(m: dict) -> List[Tuple[int, int]]:
    """(stage, block) of every transformer block, in order."""
    return [(s, b) for s, d in enumerate(m["depths"]) for b in range(d)]


def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter of the GRL `m` describes,
    under GRL's state-dict names.  kind: "linear", "conv", "bias",
    "conv_bias", "norm_weight", "norm_bias", "logit_scale", "cpb_in",
    "cpb_in_bias", "cpb_out": the benchmark draws each kind from its own
    distribution (`h100_bench.weights`)."""
    C, nf, cin = m["embed_dim"], m["num_out_feats"], m["in_channels"]
    r = int(C * m["mlp_ratio"])
    spec = []

    def lin(name, o, i, bias=True):
        spec.append((f"{name}.weight", (o, i), "linear"))
        if bias:
            spec.append((f"{name}.bias", (o,), "bias"))

    def conv(name, o, i, k=3):
        spec.append((f"{name}.weight", (o, i, k, k), "conv"))
        spec.append((f"{name}.bias", (o,), "conv_bias"))

    def norm(name):
        spec.append((f"{name}.weight", (C,), "norm_weight"))
        spec.append((f"{name}.bias", (C,), "norm_bias"))

    def transform(name, heads):
        spec.append((f"{name}.logit_scale", (heads, 1, 1), "logit_scale"))
        spec.append((f"{name}.cpb_mlp.0.weight", (512, 2), "cpb_in"))
        spec.append((f"{name}.cpb_mlp.0.bias", (512,), "cpb_in_bias"))
        spec.append((f"{name}.cpb_mlp.2.weight", (heads, 512), "cpb_out"))

    conv("conv_first", C, cin)
    norm("norm_start")
    for s, b in blocks(m):
        p = f"layers.{s}.blocks.{b}"
        lin(f"{p}.attn.qkv.body", 3 * C, C)
        transform(f"{p}.attn.window_attn.attn_transform", m["num_heads_window"][s])
        lin(f"{p}.attn.anchor.body.0.reduction", C // 2, C)
        transform(f"{p}.attn.stripe_attn.attn_transform1", m["num_heads_stripe"][s])
        transform(f"{p}.attn.stripe_attn.attn_transform2", m["num_heads_stripe"][s])
        lin(f"{p}.attn.proj", C, C)
        norm(f"{p}.norm1")
        lin(f"{p}.mlp.fc1", r, C)
        lin(f"{p}.mlp.fc2", C, r)
        norm(f"{p}.norm2")
        if m["local_connection"]:
            conv(f"{p}.conv.cab.0", C // 4, C)
            conv(f"{p}.conv.cab.2", C, C // 4)
            conv(f"{p}.conv.cab.3.attention.1", C // 18, C, 1)
            conv(f"{p}.conv.cab.3.attention.3", C, C // 18, 1)
        if b == m["depths"][s] - 1:
            conv(f"layers.{s}.conv", C, C)
    norm("norm_end")
    conv("conv_after_body", C, C)
    conv("conv_before_upsample.0", nf, C)
    for i in range(int(math.log2(m["upscale"]))):
        conv(f"upsample.up.{2 * i}", 4 * nf, nf)
    conv("conv_last", m["in_channels"], nf)
    return spec


def tiny_model(config: dict) -> dict:
    """The configuration cut to a size the CPU rehearsal runs in a second:
    the same kinds of layers (window and anchored stripe halves, CAB, the
    tail), one stage of four blocks at embed 24, 2+2 heads, window 8, and
    stripes 16x16 where a geometry's stripes are not grouped."""
    cfg = copy.deepcopy(config)
    cfg["model"].update(embed_dim=24, depths=[4], num_heads_window=[2], num_heads_stripe=[2])
    for g in cfg["geometry"].values():
        g["window_size"] = 8
        if g["stripe_groups"][1] is None:
            g["stripe_size"] = [16, 16]
    return cfg


def check_supported(m: dict) -> None:
    """Raise for a GRL variant this reference does not write down."""
    want = {"upsampler": "pixelshuffle", "qkv_proj_type": "linear",
            "anchor_proj_type": "avgpool", "anchor_one_stage": True,
            "out_proj_type": "linear", "conv_type": "1conv", "img_range": 1.0,
            "euclidean_dist": False, "double_window": False,
            "stripe_square": False, "init_method": "n"}
    for k, v in want.items():
        if m.get(k, v) != v:
            raise ValueError(f"reference GRL: {k}={m[k]!r} is not written down")
    if m["anchor_window_down_factor"] < 2 or m["upscale"] & (m["upscale"] - 1):
        raise ValueError("reference GRL: anchors (df >= 2) and x2^k tails only")


# ------------------------------------------------------------------ layers

class Ops:
    """The products of one forward in precision `prec`."""

    def __init__(self, P: Dict[str, torch.Tensor], prec: Optional[str]):
        self.P, self.prec = P, prec

    def q(self, t):
        return operand(t, self.prec)

    def linear(self, name, x, bias=True):
        y = self.q(x) @ self.q(self.P[f"{name}.weight"]).t()
        return y + self.P[f"{name}.bias"] if bias else y

    def conv(self, name, x, padding=1):
        """NHWC conv."""
        y = F.conv2d(self.q(x.permute(0, 3, 1, 2)), self.q(self.P[f"{name}.weight"]),
                     self.P[f"{name}.bias"], padding=padding)
        return y.permute(0, 2, 3, 1)

    def norm(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], 1e-5)

    def bias(self, name, table, index):
        """(heads, Nq, Nk) position bias 16 * sigmoid(cpb_mlp(table))."""
        h = torch.relu(self.linear(f"{name}.cpb_mlp.0", table))
        t = self.linear(f"{name}.cpb_mlp.2", h, bias=False)       # (T, heads)
        return 16.0 * torch.sigmoid(t).t()[:, index]

    def attend(self, name, q, k, v, table, index, mask):
        """Cosine attention: q (..., h, Nq, d), k and v (..., h, Nk, d)."""
        q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        k = k / k.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        logits = self.q(q) @ self.q(k).transpose(-1, -2)
        scale = torch.exp(torch.clamp(self.P[f"{name}.logit_scale"], max=math.log(100.0)))
        logits = logits * scale + self.bias(name, table, index)
        if mask is not None:
            logits = logits + mask[:, None]
        return self.q(torch.softmax(logits, -1)) @ self.q(v)


def partition(x, win):
    """(B, H, W, C) -> (B, windows, tokens, C), windows row-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // win[0], win[0], W // win[1], win[1], C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, -1, win[0] * win[1], C)


def unpartition(x, win, res):
    B, C = x.shape[0], x.shape[-1]
    H, W = res
    x = x.reshape(B, H // win[0], W // win[1], win[0], win[1], C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def heads(t, h):
    """(B, n, N, h*d) -> (B, n, h, N, d)."""
    B, n, N, C = t.shape
    return t.reshape(B, n, N, h, C // h).transpose(2, 3)


def merge(t):
    B, n, h, N, d = t.shape
    return t.transpose(2, 3).reshape(B, n, N, h * d)


class Geometry:
    """Tables, indices and band ids of one padded size, on a device."""

    def __init__(self, m: dict, res, device):
        self.m, self.res, self.device = m, tuple(res), device
        self._cache = {}

    def get(self, key, make):
        if key not in self._cache:
            v = make()
            dt = torch.float32 if v.dtype == np.float32 else torch.int64
            self._cache[key] = torch.as_tensor(v, dtype=dt, device=self.device)
        return self._cache[key]

    def mask(self, key, make):
        """(n, Nq, Nk) additive shift mask, -100 where the band ids that
        make() gives for the queries and the keys differ."""
        if key not in self._cache:
            bq, bk = (torch.as_tensor(b, device=self.device) for b in make())
            self._cache[key] = torch.where(bq[:, :, None] != bk[:, None, :], -100.0, 0.0)
        return self._cache[key]


def window_half(ops, pre, x3, h, win, shift, geo):
    """Window attention of qkv x3 (B, H, W, 3 * Cw); returns (B, H, W, Cw)."""
    res = x3.shape[1:3]
    if shift:
        x3 = torch.roll(x3, (-shift, -shift), (1, 2))
    t = partition(x3, (win, win))
    Cw = t.shape[-1] // 3
    q, k, v = (heads(t[..., i * Cw:(i + 1) * Cw], h) for i in range(3))
    table = geo.get("table_w", lambda: G.coords_table((win, win)))
    index = geo.get("index_w", lambda: G.position_index((win, win)))
    mask = None
    if shift:
        mask = geo.mask("mask_w", lambda: 2 * [G.band_ids(res, (win, win), (win // 2, win // 2))])
    y = ops.attend(pre, q, k, v, table, index, mask)
    y = unpartition(merge(y), (win, win), res)
    return torch.roll(y, (shift, shift), (1, 2)) if shift else y


def stripe_half(ops, pre, x3, anchor, h, m, vertical, shifted, geo):
    """Anchored stripe attention of qkv x3 (B, H, W, 3 * Cs) through the
    anchor map (B, H/df, W/df, Cs): anchors attend to stripe tokens (a2w),
    then stripe tokens to the anchors (w2a)."""
    res = tuple(x3.shape[1:3])
    df = m["anchor_window_down_factor"]
    size, groups = tuple(m["stripe_size"]), tuple(m["stripe_groups"])
    if vertical:
        size, groups = size[::-1], groups[::-1]
    stripe, shift = G.stripe_info(size, groups, shifted, res)
    if not shifted:
        shift = (0, 0)
    astripe = (stripe[0] // df, stripe[1] // df)
    if shifted:
        x3 = torch.roll(x3, (-shift[0], -shift[1]), (1, 2))
        anchor = torch.roll(anchor, (-(shift[0] // df), -(shift[1] // df)), (1, 2))
    t = partition(x3, stripe)
    Cs = t.shape[-1] // 3
    q, k, v = (heads(t[..., i * Cs:(i + 1) * Cs], h) for i in range(3))
    a = heads(partition(anchor, astripe), h)
    g = "sv" if vertical else "sh"
    table = geo.get(f"table_{g}", lambda: G.coords_table(
        stripe, tuple(m["pretrained_stripe_size"]), df))
    i_a2w = geo.get(f"a2w_{g}", lambda: G.position_index(stripe, df, False))
    i_w2a = geo.get(f"w2a_{g}", lambda: G.position_index(stripe, df, True))
    m1 = m2 = None
    if shifted:
        def bands():
            _, s_all = G.stripe_info(size, groups, True, res)
            return (G.band_ids(res, stripe, s_all),
                    G.band_ids((res[0] // df, res[1] // df), astripe,
                               (s_all[0] // df, s_all[1] // df)))

        m1 = geo.mask(f"a2w_mask_{g}", lambda: bands()[::-1])
        m2 = geo.mask(f"w2a_mask_{g}", bands)
    y = ops.attend(f"{pre}1", a, k, v, table, i_a2w, m1)
    y = ops.attend(f"{pre}2", q, a, y, table, i_w2a, m2)
    y = unpartition(merge(y), stripe, res)
    return torch.roll(y, shift, (1, 2)) if shifted else y


def cab(ops, p, x):
    """GRL-base's local branch: 3x3 conv to C/4, GELU, 3x3 conv back,
    then the squeeze-excite channel gate."""
    y = ops.conv(f"{p}.cab.2", F.gelu(ops.conv(f"{p}.cab.0", x)))
    s = y.mean((1, 2), keepdim=True)
    s = torch.relu(ops.conv(f"{p}.cab.3.attention.1", s, padding=0))
    return y * torch.sigmoid(ops.conv(f"{p}.cab.3.attention.3", s, padding=0))


def block(ops, m, s, b, x, geo, keep=None, rate=0.0):
    """One transformer block; keep: (2, B) stochastic-depth masks or None."""
    p = f"layers.{s}.blocks.{b}"
    C = x.shape[-1]
    win = m["window_size"]
    shift_w = win // 2 if b % 2 == 0 else 0
    shifted = (b % 4 in (2, 3)) if m["stripe_shift"] else False
    qkv = ops.linear(f"{p}.attn.qkv.body", x)
    pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), m["anchor_window_down_factor"])
    anchor = ops.linear(f"{p}.attn.anchor.body.0.reduction", pooled.permute(0, 2, 3, 1))
    yw = window_half(ops, f"{p}.attn.window_attn.attn_transform", qkv[..., :3 * C // 2],
                     m["num_heads_window"][s], win, shift_w, geo)
    ys = stripe_half(ops, f"{p}.attn.stripe_attn.attn_transform", qkv[..., 3 * C // 2:],
                     anchor, m["num_heads_stripe"][s], m, b % 2 == 1, shifted, geo)
    y = ops.linear(f"{p}.attn.proj", torch.cat([yw, ys], -1))

    def dropped(t, i):
        if keep is None or rate <= 0.0:
            return t
        k = keep[i].reshape(-1, 1, 1, 1)
        return torch.where(k, t / (1.0 - rate), torch.zeros((), device=t.device))

    branch = dropped(ops.norm(f"{p}.norm1", y), 0)
    if m["local_connection"]:
        branch = branch + cab(ops, f"{p}.conv", x)
    x = x + branch
    y = ops.linear(f"{p}.mlp.fc2", F.gelu(ops.linear(f"{p}.mlp.fc1", x)))
    return x + dropped(ops.norm(f"{p}.norm2", y), 1)


def drop_rates(m: dict) -> List[float]:
    """Each block's stochastic-depth rate: linspace(0, rate) over the blocks."""
    return np.linspace(0, m["drop_path_rate"], sum(m["depths"])).tolist()


def pad_multiple(x, k):
    """Bottom/right pad of NHWC x to multiples of k: reflect, or zeros when
    the pad is not smaller than the image."""
    H, W = x.shape[1:3]
    ph, pw = -H % k, -W % k
    if ph == 0 and pw == 0:
        return x
    mode = "reflect" if (ph < H and pw < W) else "constant"
    return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode).permute(0, 2, 3, 1)


def forward(P: Dict[str, torch.Tensor], m: dict, x: torch.Tensor,
            keep: Optional[torch.Tensor] = None, prec: Optional[str] = None,
            recompute: bool = False) -> torch.Tensor:
    """GRL's forward: x (B, H, W, C_in) in [0, 1] -> (B, sH, sW, C_in).

    keep: (blocks, 2, B) bool stochastic-depth masks (training), or None.
    recompute: each block under torch.utils.checkpoint, so that a backward
    holds one block's activations at a time."""
    check_supported(m)
    H, W = x.shape[1:3]
    ops = Ops(P, prec)
    x = pad_multiple(x, G.pad_size(m))
    geo = Geometry(m, x.shape[1:3], x.device)
    mean = torch.tensor(RGB_MEAN, device=x.device)
    feat = ops.conv("conv_first", x - mean)
    y = ops.norm("norm_start", feat)
    rates = drop_rates(m)
    i = 0
    for s, depth in enumerate(m["depths"]):
        res = y
        for b in range(depth):
            k = None if keep is None else keep[i]
            if recompute and torch.is_grad_enabled():
                res = checkpoint(block, ops, m, s, b, res, geo, k, rates[i],
                                 use_reentrant=False)
            else:
                res = block(ops, m, s, b, res, geo, k, rates[i])
            i += 1
        y = ops.conv(f"layers.{s}.conv", res) + y
    y = ops.conv("conv_after_body", ops.norm("norm_end", y)) + feat
    y = F.leaky_relu(ops.conv("conv_before_upsample.0", y), 0.01)
    for i in range(int(math.log2(m["upscale"]))):
        y = ops.conv(f"upsample.up.{2 * i}", y)
        y = F.pixel_shuffle(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    y = ops.conv("conv_last", y) + mean
    return y[:, :H * m["upscale"], :W * m["upscale"]]


def restore(P, m, img: torch.Tensor, bucket: int, prec: Optional[str] = None):
    """A served request as the reference answers it: img (B, h, w, C) padded
    bottom/right to multiples of `bucket` in one reflect (edge where a pad
    is not smaller than the image), restored, and cropped to (B, s*h, s*w)."""
    h, w = img.shape[1:3]
    if bucket:
        ph, pw = -h % bucket, -w % bucket
        if ph or pw:
            mode = "reflect" if (ph < h and pw < w) else "replicate"
            img = F.pad(img.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode).permute(0, 2, 3, 1)
    with exact_fp32():
        y = forward(P, m, img, prec=prec)
    s = m["upscale"]
    return y[:, :h * s, :w * s]
