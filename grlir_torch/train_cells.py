"""The train step's cells on the card, shared by `chip_smoke.py` and
`tests/test_torch_train_cuda.py`.

Cell "a" is the SR recipe (config/experiment/sr/grl_p256.yaml: window 32,
stripes 64x64, anchor df 4) at GRL-S's width; cell "b" is
`zoo.GRL_SMALL`'s own geometry (window 8, stripes 8 x W/4).  Both train
x4 SR at batch 8 on 64^2 LR patches with the recipe's optimizer (AdamW,
LR 1e-4, weight decay 1e-2, the multi-step schedule) and L1 loss, through
`engines.train.make_train_step`.

`gate_fp32` and `gate_bf16` hold the kernels-on train step against the
kernels-off one (the acceptance gates of the training path, fixed before
any card run); `replay_after_steps` holds a Restorer's CUDA-graph replay,
after optimizer steps, against an eager forward with the current weights.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from grlir_torch.engines.train import TrainState, make_train_step
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL, GRLConfig, init_weights
from grlir_torch.optim import build_optimizer
from grlir_torch.optim.schedules import multi_step_warmup

BATCH, LR_HW, SCALE = 8, 64, 4
LOSS = {"l1": 1.0}
CELLS = {
    "a": replace(zoo.GRL_SMALL, window_size=32, stripe_size=(64, 64),
                 stripe_groups=(None, None)),
    "b": zoo.GRL_SMALL,
}
# the gates (kernels on against off)
FP32_LOSS_REL = 1e-5
FP32_GRAD_REL, FP32_GRAD_FLOOR = 1e-3, 1e-7     # x max|g| of each tensor, + floor
BF16_LOSS_REL = 2e-2
GATE_STEPS = 10


def cell_config(cell: str, dtype=torch.bfloat16, kernels=True, **kw) -> GRLConfig:
    return replace(CELLS[cell], dtype=dtype, kernels=kernels, **kw)


def make_state(cfg: GRLConfig, device, seed: int = 0) -> TrainState:
    """A seeded GRL on the device with the recipe's AdamW and schedule.
    The model is built on the host and moved: torch's default init would
    draw from the card's generator, which a failed CUDA-graph capture
    earlier in the process leaves unusable."""
    model = init_weights(GRL(cfg), torch.Generator().manual_seed(seed)).to(device)
    opt, sched = build_optimizer(
        model.parameters(), "adamw",
        schedule=multi_step_warmup(1e-4, [100000, 150000, 175000, 200000], 0.5),
        weight_decay=1e-2)
    return TrainState(model.train(), opt, sched,
                      generator=torch.Generator().manual_seed(seed + 1),
                      rng=np.random.default_rng(seed + 2))


def twin_state(state: TrainState, cfg: GRLConfig, device, seed: int = 0) -> TrainState:
    """A state of cfg carrying state's weights, with fresh optimizer state
    and the generators of make_state(seed)."""
    twin = make_state(cfg, device, seed)
    twin.model.load_state_dict(state.model.state_dict())
    return twin


def structured(seed: int, n: int, hw: int) -> np.ndarray:
    """n structured RGB images (gradients, edges, checks, texture) on the
    1/255 grid, (n, hw, hw, 3) float32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    out = []
    for i in range(n):
        f = 3 + (seed * 7 + i) % 11
        base = (0.5 + 0.25 * np.sin(2 * np.pi * f * x) * np.cos(2 * np.pi * (f - 1) * y)
                + 0.15 * (((x * 8).astype(int) + (y * 8).astype(int)) % 2) - 0.075)
        tint = np.array([1.0, 0.85 + 0.02 * (i % 5), 0.75 + 0.04 * (i % 5)], np.float32)
        img = base[..., None] * tint + 0.03 * rng.standard_normal((hw, hw, 3))
        out.append(np.round(np.clip(img, 0, 1) * 255) / 255)
    return np.stack(out).astype(np.float32)


def batches(n: int, device, seed: int = 0) -> List[Dict[str, torch.Tensor]]:
    """n batches of BATCH GT patches (LR_HW * SCALE)^2 with their area-mean
    LR, on the device."""
    out = []
    for i in range(n):
        gt = torch.from_numpy(structured(seed * 1000 + i, BATCH, LR_HW * SCALE)).to(device)
        lq = F.avg_pool2d(gt.permute(0, 3, 1, 2), SCALE).permute(0, 2, 3, 1).contiguous()
        out.append({"img_lq": lq, "img_gt": gt})
    return out


def run_steps(state: TrainState, data, step_fn=None) -> List[float]:
    """One train step a batch; the losses as floats."""
    step_fn = step_fn or make_train_step(LOSS)
    return [float(step_fn(state, b)["loss"]) for b in data]


def gate_fp32(device, seed: int = 0):
    """Cell a in fp32 at drop path 0, one step on one batch, kernels on
    against off: (loss rel diff, worst max|dg| / (1e-3 max|g| + 1e-7) over
    the parameters, its name).  Passes when the first is <= FP32_LOSS_REL
    and the second <= 1."""
    data = batches(1, device, seed)
    grads, losses = [], []
    for kernels in (True, False):
        cfg = cell_config("a", torch.float32, kernels, drop_path_rate=0.0)
        model = init_weights(GRL(cfg), torch.Generator().manual_seed(seed)).to(device)
        opt, sched = build_optimizer(model.parameters(), "sgd", learning_rate=0.0)
        state = TrainState(model.train(), opt, sched)
        losses.append(run_steps(state, data)[0])
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    worst, where = 0.0, ""
    for n, g in grads[1].items():
        r = ((grads[0][n] - g).abs().max()
             / (FP32_GRAD_REL * g.abs().max() + FP32_GRAD_FLOOR)).item()
        if r >= worst:
            worst, where = r, n
    return rel, worst, where


def gate_bf16(cell: str, device, seed: int = 0):
    """GATE_STEPS bf16 steps of a cell, kernels on and off, from the same
    weights on the same batches with the same generator seeds: ({kernels:
    losses}, per-step rel diffs).  Passes when every loss is finite, every
    rel diff <= BF16_LOSS_REL, and in both modes the mean of the last three
    losses is below the mean of the first three."""
    data = batches(GATE_STEPS, device, seed)
    on = make_state(cell_config(cell, torch.bfloat16, True), device, seed)
    off = twin_state(on, cell_config(cell, torch.bfloat16, False), device, seed)
    losses = {True: run_steps(on, data), False: run_steps(off, data)}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False])]
    return losses, rel


def bf16_gate_ok(losses, rel) -> bool:
    finite = all(math.isfinite(v) for ls in losses.values() for v in ls)
    falls = all(np.mean(ls[-3:]) < np.mean(ls[:3]) for ls in losses.values())
    return finite and falls and max(rel) <= BF16_LOSS_REL


def replay_after_steps(cell: str, device, steps: int = 3, seed: int = 0) -> Tuple[float, int]:
    """A Restorer captures cell's bf16 model (kernels on) on a 64^2 image,
    the optimizer then takes `steps` steps in place, and the next replay
    is held against an eager no_grad forward with the updated weights:
    (max|replay - eager|, graphs)."""
    from grlir_torch.engines.inference import Restorer

    state = make_state(cell_config(cell, torch.bfloat16, True), device, seed)
    restorer = Restorer(state.model, device, scale=SCALE)
    img = np.ascontiguousarray(structured(seed + 77, 1, LR_HW))
    state.model.eval()
    before = restorer(img)
    state.model.train()
    run_steps(state, batches(steps, device, seed + 5))
    state.model.eval()
    after = restorer(img)
    with torch.no_grad():
        eager = state.model(torch.from_numpy(img).to(device)).float().cpu().numpy()
    state.model.train()
    if np.array_equal(after, before):
        raise RuntimeError("the replay did not move after the optimizer steps")
    return float(np.abs(after - eager).max()), len(restorer.graphs)


def admitted(cfg: GRLConfig, hw=(LR_HW, LR_HW)) -> Dict[str, str]:
    """{kernel wrapper: route} of the B1-B4 kernels whose TPU route admits
    one of cfg's block halves at an hw input (padded as the model pads
    it): window_route "small" -> B1 window_half, "large" -> B3
    window_half_large; stripe_route "resident" -> B2 stripe_half, "large"
    -> B4 stripe_a2w_large and stripe_w2a_large."""
    from grlir_torch.ops import block_attn as ba
    from grlir_torch.ops.geometry import get_stripe_info

    p = cfg.pad_size
    H, W = (-(-d // p) * p for d in hw)
    out = {}
    for heads_w, heads_s in zip(cfg.num_heads_window, cfg.num_heads_stripe):
        r = ba.window_route((H, W), (cfg.window_size, cfg.window_size), heads_w)
        if r is not None:
            out["window_half" if r == "small" else "window_half_large"] = r
        for sizes, groups in ((cfg.stripe_size, cfg.stripe_groups),
                              (cfg.stripe_size[::-1], cfg.stripe_groups[::-1])):
            stripe, _ = get_stripe_info(sizes, groups, cfg.stripe_shift, (H, W))
            r = ba.stripe_route((H, W), stripe, cfg.anchor_window_down_factor, heads_s)
            if r == "resident":
                out["stripe_half"] = r
            elif r == "large":
                out["stripe_a2w_large"] = out["stripe_w2a_large"] = r
    return out
