"""Canonical GRL recipes (the deployed configs of `grlir.models.zoo`)."""

from __future__ import annotations

from dataclasses import replace

from grlir_torch.models.grl import GRLConfig

# config/model/grl/grl_tiny.yaml
GRL_TINY = GRLConfig(
    upscale=4,
    in_channels=3,
    embed_dim=64,
    upsampler="pixelshuffledirect",
    depths=(4, 4, 4, 4),
    num_heads_window=(2, 2, 2, 2),
    num_heads_stripe=(2, 2, 2, 2),
    window_size=8,
    stripe_size=(8, None),
    stripe_groups=(None, 4),
    stripe_shift=True,
    mlp_ratio=2.0,
    anchor_window_down_factor=4,
    local_connection=False,
)

# config/model/grl/grl_small.yaml
GRL_SMALL = replace(GRL_TINY, embed_dim=128, upsampler="pixelshuffle")

# config/model/grl/grl_base.yaml (needs CAB: GRL(GRL_BASE) raises until the
# second slice ports it)
GRL_BASE = replace(
    GRL_SMALL,
    embed_dim=180,
    depths=(4, 4, 8, 8, 8, 4, 4),
    num_heads_window=(3, 3, 3, 3, 3, 3, 3),
    num_heads_stripe=(3, 3, 3, 3, 3, 3, 3),
    local_connection=True,
)


def make_config(name: str, task: str = "sr", upscale: int = 4,
                in_channels: int = 3, **overrides) -> GRLConfig:
    """Task-adapted config, as `grlir.models.zoo.make_config`."""
    cfg = {"tiny": GRL_TINY, "small": GRL_SMALL, "base": GRL_BASE}[name]
    if task in ("dn", "jpeg", "dm", "db", "paired"):
        cfg = replace(cfg, upsampler="", upscale=1, in_channels=in_channels,
                      out_channels=3 if task == "dm" else None)
    elif task == "bsr":
        cfg = replace(cfg, upsampler="nearest+conv", upscale=4)
    elif task == "sr":
        cfg = replace(cfg, upscale=upscale, in_channels=in_channels)
    else:
        raise ValueError(f"unknown task {task}")
    return replace(cfg, **overrides) if overrides else cfg
