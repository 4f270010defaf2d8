"""GRL network in PyTorch: NHWC in [0, 1] in, NHWC out (counterpart of
`grlir.models.grl`).

Geometry (position-bias tables, indices, shift-band ids) comes from the
port's numpy geometry code (`grlir_torch.ops.geometry`), once per padded
input size and device, and is held as plain tensors on the module, never
in the state_dict.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from grlir_torch.models.blocks import (
    ENGINE_HALVES,
    EfficientMixAttnTransformerBlock,
    conv_nhwc,
    layer_norm,
)
from grlir_torch.ops.geometry import GeometryConfig, build_geometry_compact
from grlir_torch.ops.layout import nearest_upsample, pad_to_multiple

Size2 = Tuple[int, int]

RGB_MEAN = (0.4488, 0.4371, 0.4040)
NUM_OUT_FEATS = 64  # channels of the upsampling tails


@dataclass(frozen=True)
class GRLConfig:
    """Static hyperparameters of a GRL network: the fields of
    `grlir.models.grl.GRLConfig` that the zoo's recipes set, with their
    defaults.  The JAX package's other fields are TPU layout knobs, training
    options or ablations, fixed here at the recipes' values (qkv bias,
    linear qkv, one-stage avgpool anchor, 1conv, img_range 1, 64 tail
    features, no drop path at inference).

    engine: "v3" | "fused" | "window" | "stripe", the attention engine.
    "v3" runs the whole block-half kernels (B1-B4) where a TPU route takes
    the geometry and the plain cosine attention where none does; "fused"
    runs the kernels on q, k, v projected beforehand on both halves (B6 or
    B5 for windows, B7 or B5 for stripes); "window" and "stripe" run them
    on that half only and the plain cosine attention on the other.
    kernels: "auto" | True | False.  "auto" runs the CUDA attention kernels
    for CUDA inputs at inference (grad mode off, or the module in eval mode)
    and the plain PyTorch versions otherwise; False runs the plain version
    of each of the engine's kernels.

    The JAX package's `use_pallas_attention` maps so:

      use_pallas_attention   port
      "auto"                 engine "v3", kernels "auto"
      "v3"                   engine "v3", kernels True
      True                   engine "fused"
      "window"               engine "window"
      "stripe"               engine "stripe"
      False                  kernels False
    """

    in_channels: int = 3
    out_channels: Optional[int] = None
    embed_dim: int = 96
    upscale: int = 2
    upsampler: str = ""  # pixelshuffle | pixelshuffledirect | nearest+conv | ""
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads_window: Tuple[int, ...] = (3, 3, 3, 3, 3, 3)
    num_heads_stripe: Tuple[int, ...] = (3, 3, 3, 3, 3, 3)
    window_size: int = 8
    stripe_size: Tuple[Optional[int], Optional[int]] = (8, 8)
    stripe_groups: Tuple[Optional[int], Optional[int]] = (None, None)
    stripe_shift: bool = False
    mlp_ratio: float = 4.0
    anchor_window_down_factor: int = 1
    local_connection: bool = False
    engine: str = "v3"
    kernels: object = "auto"
    dtype: torch.dtype = torch.float32

    @property
    def resolved_out_channels(self) -> int:
        return self.out_channels or self.in_channels

    @property
    def geometry_config(self) -> GeometryConfig:
        return GeometryConfig(
            window_size=(self.window_size, self.window_size),
            stripe_size=tuple(self.stripe_size),
            stripe_groups=tuple(self.stripe_groups),
            anchor_window_down_factor=self.anchor_window_down_factor,
        )

    @property
    def pad_size(self) -> int:
        return self.geometry_config.pad_size


def check_ported(cfg: GRLConfig) -> None:
    """Raise for the variants this port does not carry yet."""
    if cfg.anchor_window_down_factor < 2:
        raise NotImplementedError(
            "plain stripe attention (anchor_window_down_factor=1) is not "
            "ported yet (ROADMAP A10)")
    if cfg.kernels not in ("auto", True, False):
        raise ValueError(f"kernels must be 'auto', True or False: {cfg.kernels!r}")
    if cfg.engine not in ENGINE_HALVES:
        raise ValueError(f"engine must be one of {sorted(ENGINE_HALVES)}: "
                         f"{cfg.engine!r}")


@functools.lru_cache(maxsize=64)
def _geometry_np(gcfg: GeometryConfig, x_size: Size2):
    return build_geometry_compact(gcfg, x_size)


def geometry_tensors(gcfg: GeometryConfig, x_size: Size2,
                      device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in _geometry_np(gcfg, x_size).items():
        if k.startswith("table_"):
            out[k] = torch.as_tensor(v, dtype=torch.float32, device=device)
        elif k.startswith("index_"):
            out[k] = torch.as_tensor(v.astype(np.int64), device=device)
        elif k.startswith("bands_"):
            out[k] = torch.as_tensor(v, dtype=torch.int32, device=device)
    return out


def _conv(cin: int, cout: int, device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, device=device)


class TransformerStage(nn.Module):
    """Blocks then a 3x3 conv, with an outer residual.  Block schedule:
    window shift on even blocks, H stripes on even and vertical (W) on odd
    blocks, stripe shift on blocks i % 4 in {2, 3} (grlir/models/grl.py:243-276)."""

    def __init__(self, cfg: GRLConfig, depth: int, heads_w: int, heads_s: int,
                 device=None):
        super().__init__()
        self.blocks = nn.ModuleList([
            EfficientMixAttnTransformerBlock(
                cfg.embed_dim, heads_w, heads_s, cfg.window_size,
                window_shift=i % 2 == 0,
                stripe_size=tuple(cfg.stripe_size),
                stripe_groups=tuple(cfg.stripe_groups),
                stripe_type="H" if i % 2 == 0 else "W",
                stripe_shift=(i % 4 in (2, 3)) if cfg.stripe_shift else False,
                mlp_ratio=cfg.mlp_ratio, df=cfg.anchor_window_down_factor,
                local_connection=cfg.local_connection, engine=cfg.engine,
                device=device)
            for i in range(depth)])
        self.conv = _conv(cfg.embed_dim, cfg.embed_dim, device=device)

    def forward(self, x, geometry, dt, kernels: bool):
        res = x
        for block in self.blocks:
            res = block(res, geometry, dt, kernels)
        return conv_nhwc(self.conv, res, dt) + x


class Upsample(nn.Module):
    """Conv + PixelShuffle steps under the reference's key `upsample.up`."""

    def __init__(self, steps, device=None):
        super().__init__()
        layers = []
        for cin, cout, r in steps:
            layers += [_conv(cin, cout, device=device), nn.PixelShuffle(r)]
        self.up = nn.Sequential(*layers)

    def forward(self, x, dt):
        x = x.permute(0, 3, 1, 2)
        for layer in self.up:
            if isinstance(layer, nn.Conv2d):
                b = layer.bias.to(dt)
                x = F.conv2d(x.to(dt), layer.weight.to(dt), b, padding=1)
            else:
                x = layer(x)
        return x.permute(0, 2, 3, 1)


class GRL(nn.Module):
    """GRL restoration transformer.  Input and output NHWC in [0, 1]."""

    def __init__(self, cfg: GRLConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dim, nf = cfg.embed_dim, NUM_OUT_FEATS
        out_ch = cfg.resolved_out_channels
        self.conv_first = _conv(cfg.in_channels, dim, device=device)
        self.norm_start = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.layers = nn.ModuleList([
            TransformerStage(cfg, depth, cfg.num_heads_window[i],
                             cfg.num_heads_stripe[i], device=device)
            for i, depth in enumerate(cfg.depths)])
        self.norm_end = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.conv_after_body = _conv(dim, dim, device=device)
        up = cfg.upscale
        if cfg.upsampler in ("pixelshuffle", "nearest+conv"):
            self.conv_before_upsample = nn.Sequential(
                _conv(dim, nf, device=device), nn.LeakyReLU(0.01))
        if cfg.upsampler == "pixelshuffle":
            if up & (up - 1) == 0:
                steps = [(nf, 4 * nf, 2)] * int(math.log2(up))
            elif up == 3:
                steps = [(nf, 9 * nf, 3)]
            else:
                raise ValueError(f"unsupported scale {up}")
            self.upsample = Upsample(steps, device=device)
            self.conv_last = _conv(nf, out_ch, device=device)
        elif cfg.upsampler == "pixelshuffledirect":
            self.upsample = Upsample([(dim, up * up * out_ch, up)],
                                     device=device)
        elif cfg.upsampler == "nearest+conv":
            if up != 4:
                raise ValueError("nearest+conv tail supports x4 only")
            self.conv_up1 = _conv(nf, nf, device=device)
            self.conv_up2 = _conv(nf, nf, device=device)
            self.conv_hr = _conv(nf, nf, device=device)
            self.conv_last = _conv(nf, out_ch, device=device)
        elif cfg.upsampler == "":
            self.conv_last = _conv(dim, out_ch, device=device)
        else:
            raise ValueError(f"unknown upsampler {cfg.upsampler!r}")
        self._geometry: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def use_kernels(self, x: torch.Tensor) -> bool:
        """Resolve cfg.kernels for this call (see GRLConfig)."""
        if self.cfg.kernels == "auto":
            return x.is_cuda and (not torch.is_grad_enabled()
                                  or not self.training)
        return bool(self.cfg.kernels)

    def geometry(self, x_size: Size2, device) -> Dict[str, torch.Tensor]:
        key = (tuple(x_size), str(device))
        if key not in self._geometry:
            self._geometry[key] = geometry_tensors(
                self.cfg.geometry_config, tuple(x_size), device)
        return self._geometry[key]

    def forward_features(self, x, geometry, dt, kernels):
        x = layer_norm(self.norm_start, x)
        for stage in self.layers:
            x = stage(x, geometry, dt, kernels)
        return layer_norm(self.norm_end, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        kernels = self.use_kernels(x)
        _, H, W, _ = x.shape
        x = pad_to_multiple(x, cfg.pad_size)
        if cfg.in_channels == 3:
            mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
        else:
            mean = torch.zeros(1, dtype=x.dtype, device=x.device)
        x = x - mean
        geometry = self.geometry(x.shape[1:3], x.device)

        def body(feat):
            y = self.forward_features(feat, geometry, dt, kernels)
            return conv_nhwc(self.conv_after_body, y, dt) + feat

        if cfg.upsampler == "pixelshuffle":
            x = body(conv_nhwc(self.conv_first, x, dt))
            x = F.leaky_relu(conv_nhwc(self.conv_before_upsample[0], x, dt), 0.01)
            x = conv_nhwc(self.conv_last, self.upsample(x, dt), dt)
        elif cfg.upsampler == "pixelshuffledirect":
            x = self.upsample(body(conv_nhwc(self.conv_first, x, dt)), dt)
        elif cfg.upsampler == "nearest+conv":
            x = body(conv_nhwc(self.conv_first, x, dt))
            x = F.leaky_relu(conv_nhwc(self.conv_before_upsample[0], x, dt), 0.01)
            x = F.leaky_relu(conv_nhwc(self.conv_up1, nearest_upsample(x, 2), dt), 0.2)
            x = F.leaky_relu(conv_nhwc(self.conv_up2, nearest_upsample(x, 2), dt), 0.2)
            x = F.leaky_relu(conv_nhwc(self.conv_hr, x, dt), 0.2)
            # fp32, as the JAX tail's conv_last has no compute dtype
            x = conv_nhwc(self.conv_last, x, torch.float32)
        else:
            res = body(conv_nhwc(self.conv_first, x, dt))
            if cfg.in_channels == cfg.resolved_out_channels:
                x = x + conv_nhwc(self.conv_last, res, dt)
            else:
                x = conv_nhwc(self.conv_last, res, dt)
        x = x.float() + mean.float()
        return x[:, :H * cfg.upscale, :W * cfg.upscale, :]


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in the reference's distributions: Linear weights
    trunc_normal(std 0.02) and zero bias, LayerNorm ones/zeros, Conv2d
    torch's default U(+-1/sqrt(fan_in)), logit scales log(10).  Every value
    is drawn on the CPU from `generator` and copied to the parameter's
    device, so a seed gives the same weights on any device."""
    def fill(p: torch.Tensor, t: torch.Tensor):
        with torch.no_grad():
            p.copy_(t)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=0.02, generator=generator)
            fill(m.weight, w)
            if m.bias is not None:
                fill(m.bias, torch.zeros(m.bias.shape))
        elif isinstance(m, nn.LayerNorm):
            fill(m.weight, torch.ones(m.weight.shape))
            fill(m.bias, torch.zeros(m.bias.shape))
        elif isinstance(m, nn.Conv2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    u = torch.empty(p.shape).uniform_(-bound, bound,
                                                      generator=generator)
                    fill(p, u)
    for name, p in model.named_parameters():
        if name.endswith("logit_scale"):
            fill(p, torch.full(p.shape, math.log(10.0)))
    return model
