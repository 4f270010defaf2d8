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
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from grlir_torch.models.blocks import (
    ATTENTION_OPTIONS,
    ENGINE_HALVES,
    EfficientMixAttnTransformerBlock,
    conv_nhwc,
    layer_norm,
    linear,
)
from grlir_torch.ops.geometry import GeometryConfig, build_geometry_compact
from grlir_torch.ops.layout import nearest_upsample, pad_to_multiple

Size2 = Tuple[int, int]

RGB_MEAN = (0.4488, 0.4371, 0.4040)


@dataclass(frozen=True)
class GRLConfig:
    """Static hyperparameters of a GRL network: the fields of
    `grlir.models.grl.GRLConfig` but its TPU layout knobs (attn_layout,
    attn_io, tail_layout), with their defaults.  Training fields: img_range
    (the input scaled by it after the mean is taken off, the output divided
    by it), drop_path_rate (stochastic depth at np.linspace(0, rate,
    sum(depths)) over the blocks, in training only), init_method ("r"
    scales both residual branches by 0.1), remat (each transformer block
    under torch.utils.checkpoint) and remat_policy (None recomputes the
    whole block; "dots" keeps every matrix product's output, "dots_no_batch"
    those without a batch dimension: `REMAT_SAVED`).  The ablation fields
    (qkv_bias ... out_proj_type, as grlir names them) select MixedAttention's
    branches (`blocks.ATTENTION_OPTIONS`), conv_type the conv after each
    stage and the body ("1conv" 3x3, "1conv1x1", "linear", "3conv"), and
    num_out_feats the width of the upsampling tails.

    engine: "v3" | "fused" | "window" | "stripe", the attention engine.
    "v3" runs the whole block-half kernels (B1-B4) where a TPU route takes
    the geometry and the plain cosine attention where none does; "fused"
    runs the kernels on q, k, v projected beforehand on both halves (B6 or
    B5 for windows, B7 or B5 for stripes); "window" and "stripe" run them
    on that half only and the plain cosine attention on the other.  The
    ablation branches that project qkv first (a separable-conv qkv,
    double_window, df 1, euclidean_dist) take grlir's legacy route: the
    plain path on "v3", B6 and B7 on the fused engines
    (`blocks.MixedAttention`).
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
    qkv_bias: bool = True
    qkv_proj_type: str = "linear"
    out_proj_type: str = "linear"
    anchor_proj_type: str = "avgpool"
    anchor_one_stage: bool = True
    anchor_window_down_factor: int = 1
    local_connection: bool = False
    img_range: float = 1.0
    drop_path_rate: float = 0.1
    conv_type: str = "1conv"
    init_method: str = "n"
    separable_conv_act: bool = True
    euclidean_dist: bool = False
    double_window: bool = False
    stripe_square: bool = False
    pretrained_window_size: Tuple[int, int] = (0, 0)
    pretrained_stripe_size: Tuple[int, int] = (0, 0)
    num_out_feats: int = 64
    remat: bool = False
    remat_policy: Optional[str] = None
    engine: str = "v3"
    kernels: object = "auto"
    dtype: torch.dtype = torch.float32

    @property
    def res_scale(self) -> float:
        return 0.1 if self.init_method == "r" else 1.0

    @property
    def drop_path_rates(self) -> Tuple[float, ...]:
        """Each block's stochastic-depth rate, in block order."""
        return tuple(np.linspace(0, self.drop_path_rate, sum(self.depths)).tolist())

    @property
    def resolved_out_channels(self) -> int:
        return self.out_channels or self.in_channels

    @property
    def attention_options(self) -> Dict[str, object]:
        """The ablation fields MixedAttention takes."""
        return {k: getattr(self, k) for k in ATTENTION_OPTIONS}

    @property
    def geometry_config(self) -> GeometryConfig:
        return GeometryConfig(
            window_size=(self.window_size, self.window_size),
            stripe_size=tuple(self.stripe_size),
            stripe_groups=tuple(self.stripe_groups),
            anchor_window_down_factor=self.anchor_window_down_factor,
            pretrained_window_size=tuple(self.pretrained_window_size),
            pretrained_stripe_size=tuple(self.pretrained_stripe_size),
        )

    @property
    def pad_size(self) -> int:
        return self.geometry_config.pad_size


# the matrix products each remat policy keeps for the backward (grlir's
# jax.checkpoint_policies.dots_saveable and
# dots_with_no_batch_dims_saveable); every other op is recomputed
REMAT_SAVED = {
    "dots": (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
             torch.ops.aten.baddbmm),
    "dots_no_batch": (torch.ops.aten.mm, torch.ops.aten.addmm),
}


def check_config(cfg: GRLConfig) -> None:
    """Raise for a config the model cannot build."""
    if cfg.kernels not in ("auto", True, False):
        raise ValueError(f"kernels must be 'auto', True or False: {cfg.kernels!r}")
    if cfg.remat_policy is not None and cfg.remat_policy not in REMAT_SAVED:
        raise ValueError(f"remat_policy must be None or one of "
                         f"{sorted(REMAT_SAVED)}: {cfg.remat_policy!r}")
    if cfg.engine not in ENGINE_HALVES:
        raise ValueError(f"engine must be one of {sorted(ENGINE_HALVES)}: "
                         f"{cfg.engine!r}")


def remat_kwargs(policy: Optional[str]) -> Dict[str, object]:
    """torch.utils.checkpoint's keyword arguments for a remat policy: none
    for full recompute, else a selective-checkpoint context_fn that saves
    the outputs of REMAT_SAVED[policy]."""
    if policy is None:
        return {}
    saved = REMAT_SAVED[policy]

    def policy_fn(ctx, op, *args, **kwargs):
        if op.overloadpacket in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                            policy_fn)}


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


def make_last_conv(conv_type: str, dim: int, device=None) -> nn.Module:
    """The conv block before a residual (grlir/models/grl.py:184-210):
    "1conv" a 3x3 conv, "1conv1x1" a 1x1 conv, "linear" a Linear, "3conv"
    3x3 to dim/4, LeakyReLU(0.2), 1x1, LeakyReLU(0.2), 3x3 back to dim
    (keys .0, .2, .4)."""
    if conv_type == "1conv":
        return _conv(dim, dim, device=device)
    if conv_type == "1conv1x1":
        return nn.Conv2d(dim, dim, 1, device=device)
    if conv_type == "linear":
        return nn.Linear(dim, dim, device=device)
    if conv_type == "3conv":
        return nn.Sequential(
            _conv(dim, dim // 4, device=device), nn.LeakyReLU(0.2),
            nn.Conv2d(dim // 4, dim // 4, 1, device=device), nn.LeakyReLU(0.2),
            _conv(dim // 4, dim, device=device))
    raise ValueError(f"conv_type {conv_type!r}")


def last_conv(layer: nn.Module, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Apply a `make_last_conv` block to NHWC x in dtype dt."""
    if isinstance(layer, nn.Linear):
        return linear(layer, x, dt)
    if isinstance(layer, nn.Sequential):
        x = F.leaky_relu(conv_nhwc(layer[0], x, dt), 0.2)
        x = F.leaky_relu(conv_nhwc(layer[2], x, dt), 0.2)
        return conv_nhwc(layer[4], x, dt)
    return conv_nhwc(layer, x, dt)


class TransformerStage(nn.Module):
    """Blocks then the conv_type block, with an outer residual.  Block schedule:
    window shift on even blocks, H stripes on even and vertical (W) on odd
    blocks, stripe shift on blocks i % 4 in {2, 3} (grlir/models/grl.py:243-276)."""

    def __init__(self, cfg: GRLConfig, depth: int, heads_w: int, heads_s: int,
                 drop_path_rates: Tuple[float, ...], device=None):
        super().__init__()
        self.remat = cfg.remat
        self.remat_kwargs = remat_kwargs(cfg.remat_policy)
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
                drop_path_rate=drop_path_rates[i], res_scale=cfg.res_scale,
                device=device, **cfg.attention_options)
            for i in range(depth)])
        self.conv = make_last_conv(cfg.conv_type, cfg.embed_dim, device=device)

    def forward(self, x, geometry, dt, kernels: bool,
                keep: Optional[torch.Tensor] = None):
        """keep: None, or (depth, 2, B) bool stochastic-depth masks."""
        res = x
        for i, block in enumerate(self.blocks):
            k = None if keep is None else keep[i]
            if self.remat and torch.is_grad_enabled():
                res = checkpoint(block, res, geometry, dt, kernels, k,
                                 use_reentrant=False, **self.remat_kwargs)
            else:
                res = block(res, geometry, dt, kernels, k)
        return last_conv(self.conv, res, dt) + x


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
        check_config(cfg)
        self.cfg = cfg
        dim, nf = cfg.embed_dim, cfg.num_out_feats
        out_ch = cfg.resolved_out_channels
        self.conv_first = _conv(cfg.in_channels, dim, device=device)
        self.norm_start = nn.LayerNorm(dim, eps=1e-5, device=device)
        rates = cfg.drop_path_rates
        self.layers = nn.ModuleList([
            TransformerStage(cfg, depth, cfg.num_heads_window[i],
                             cfg.num_heads_stripe[i],
                             rates[sum(cfg.depths[:i]):sum(cfg.depths[:i + 1])],
                             device=device)
            for i, depth in enumerate(cfg.depths)])
        self.norm_end = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.conv_after_body = make_last_conv(cfg.conv_type, dim, device=device)
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
        self._mean: Dict[tuple, torch.Tensor] = {}

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

    def mean(self, dtype, device) -> torch.Tensor:
        """The input mean subtracted before the body (RGB_MEAN for 3
        channels, else 0), cached per type and device as the geometry is:
        built on the first forward, so a captured forward copies nothing
        from the host."""
        key = (dtype, str(device))
        if key not in self._mean:
            if self.cfg.in_channels == 3:
                self._mean[key] = torch.tensor(RGB_MEAN, dtype=dtype, device=device)
            else:
                self._mean[key] = torch.zeros(1, dtype=dtype, device=device)
        return self._mean[key]

    def draw_drop_masks(self, batch: int, generator: Optional[torch.Generator] = None,
                        device=None, rows: Optional[slice] = None) -> torch.Tensor:
        """(sum(depths), 2, batch) bool stochastic-depth masks, each set with
        probability 1 - its block's rate, drawn on the CPU from
        `generator` (torch's default one when None) and moved to
        `device`; `rows`, when given, keeps only those of the batch (a
        process's share of a global batch: `engines.train.drop_masks`)."""
        keep = 1.0 - torch.tensor(self.cfg.drop_path_rates, dtype=torch.float64)
        u = torch.rand((len(keep), 2, batch), generator=generator,
                       dtype=torch.float64)
        masks = u < keep[:, None, None]
        if rows is not None:
            masks = masks[:, :, rows]
        if device is not None and torch.device(device).type == "cuda":
            # from pinned memory, so that the copy does not wait for the
            # work already queued on the device
            return masks.pin_memory().to(device, non_blocking=True)
        return masks.to(device)

    def forward_features(self, x, geometry, dt, kernels, keep=None):
        x = layer_norm(self.norm_start, x)
        start = 0
        for stage in self.layers:
            n = len(stage.blocks)
            k = None if keep is None else keep[start:start + n]
            x = stage(x, geometry, dt, kernels, k)
            start += n
        return layer_norm(self.norm_end, x)

    def forward(self, x: torch.Tensor, drop_masks: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: NHWC in [0, 1].  In training with drop_path_rate > 0, the
        blocks' stochastic-depth masks are `drop_masks` ((sum(depths), 2, B)
        bool) or, when None, drawn from `generator`; in eval mode no block
        drops."""
        cfg = self.cfg
        dt = cfg.dtype
        kernels = self.use_kernels(x)
        _, H, W, _ = x.shape
        keep = None
        if self.training and cfg.drop_path_rate > 0.0:
            keep = (drop_masks if drop_masks is not None
                    else self.draw_drop_masks(x.shape[0], generator, x.device))
            keep = keep.to(x.device)
        x = pad_to_multiple(x, cfg.pad_size)
        mean = self.mean(x.dtype, x.device)
        x = x - mean
        if cfg.img_range != 1.0:
            x = x * cfg.img_range
        geometry = self.geometry(x.shape[1:3], x.device)

        def body(feat):
            y = self.forward_features(feat, geometry, dt, kernels, keep)
            return last_conv(self.conv_after_body, y, dt) + feat

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
        x = x.float()
        if cfg.img_range != 1.0:
            x = x / cfg.img_range
        x = x + mean.float()
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
