"""The GAN train step's cells on the card, shared by `chip_smoke.py` and
`tests/test_torch_gan_cuda.py`.

The cell is real-world SR stage 2 (config/experiment/bsr/grl.yaml): the
GRL-base-bsr generator (embed 180, depths 4,4,8,8,8,4,4, 3 + 3 heads of
d = 30, window 16, fixed 32x64 / 64x32 stripes, anchor df 4, the
nearest+conv x4 tail) at LR 128^2 and batch 1, UNet-SN with num_feat 64 on
the 512^2 output, VGG19's five recipe layers for the perceptual loss (at
random init: the repository carries no released weights), Adam at 1e-5 on
the recipe's multi-step schedule, remat on, through
`engines.gan.make_gan_train_step`.  `depth` cuts the generator to its
first stages for the card tests.

`gate_fp32` and `gate_bf16` hold the kernels-on GAN step against the
kernels-off one (fixed before any card run): fp32 one step, loss_g and
loss_d within 1e-5 relative, every G and D gradient within
1e-3 max|g| + 1e-7, the spectral vectors after the step within 1e-5; bf16
ten steps, every loss finite and within 2e-2 relative of kernels off.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from grlir_torch.engines.gan import GANLossConfig, GANTrainState, make_gan_train_step
from grlir_torch.models import zoo
from grlir_torch.models.discriminator import UNetDiscriminatorSN
from grlir_torch.models.grl import GRL, GRLConfig, init_weights
from grlir_torch.models.vgg import VGGFeatureExtractor, perceptual_loss
from grlir_torch.optim import build_optimizer
from grlir_torch.optim.schedules import multi_step_warmup
from grlir_torch.train_cells import structured

BATCH, LR_HW, SCALE = 1, 128, 4
NUM_FEAT = 64
LR = 1e-5
BSR_G = replace(zoo.GRL_BASE_BSR, window_size=16, stripe_size=(32, 64),
                stripe_groups=(None, None))
LAYERS = dict(GANLossConfig().perceptual_layer_weights)
# the gates (kernels on against off)
FP32_LOSS_REL = 1e-5
FP32_GRAD_REL, FP32_GRAD_FLOOR = 1e-3, 1e-7     # x max|g| of each tensor, + floor
FP32_U_ATOL = 1e-5
BF16_LOSS_REL = 2e-2
GATE_STEPS = 10


def g_config(dtype=torch.float32, kernels=True, depth=None, **kw) -> GRLConfig:
    """The generator: GRL-base-bsr at the recipe's geometry, `depth` stages
    of it when given, remat on."""
    cfg = replace(BSR_G, dtype=dtype, kernels=kernels, remat=True, **kw)
    if depth is not None:
        cfg = replace(cfg, depths=cfg.depths[:depth],
                      num_heads_window=cfg.num_heads_window[:depth],
                      num_heads_stripe=cfg.num_heads_stripe[:depth])
    return cfg


def random_vgg(seed: int) -> VGGFeatureExtractor:
    """VGG19 cut at the recipe's layers, weights U(+-1/sqrt(fan_in)) and
    biases N(0, 0.05^2) from a seed, frozen, in eval mode."""
    vgg = VGGFeatureExtractor(tuple(LAYERS))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in vgg.names:
            if name.startswith("conv"):
                conv = getattr(vgg, name)
                bound = 1 / np.sqrt(conv.weight[0].numel())
                conv.weight.uniform_(-bound, bound, generator=g)
                conv.bias.normal_(0, 0.05, generator=g)
    return vgg.eval().requires_grad_(False)


def vgg19_state_dict(seed: int) -> Dict[str, torch.Tensor]:
    """random_vgg(seed)'s weights in torchvision's `features.<i>` layout, as
    a `vgg_pretrained` file holds them."""
    vgg = random_vgg(seed)
    return {f"features.{i}.{leaf}": getattr(getattr(vgg, name), leaf).detach().clone()
            for i, name in enumerate(vgg.names) if name.startswith("conv")
            for leaf in ("weight", "bias")}


def make_state(cfg: GRLConfig, device, seed: int = 0, opt: str = "adam",
               lr: float = LR) -> Tuple[GANTrainState, object]:
    """(state, perceptual_fn): a seeded G of cfg and UNet-SN, built on the
    host and moved, with the optimizer `opt` at `lr` on the recipe's
    schedule, and the perceptual loss on random_vgg(seed + 2)."""
    net_g = init_weights(GRL(cfg), torch.Generator().manual_seed(seed))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 1)
        net_d = UNetDiscriminatorSN(num_feat=NUM_FEAT)
    net_g, net_d = net_g.to(device), net_d.to(device)
    sched = multi_step_warmup(lr, [600000], 0.5)
    opt_g, sched_g = build_optimizer(net_g.parameters(), opt, schedule=sched)
    opt_d, sched_d = build_optimizer(net_d.parameters(), opt, schedule=sched)
    vgg = random_vgg(seed + 2).to(device)

    def perceptual_fn(pred, target):
        return perceptual_loss(vgg, pred, target, LAYERS)[0]

    state = GANTrainState(net_g, net_d, opt_g, opt_d, sched_g, sched_d,
                          rng=torch.Generator().manual_seed(seed + 3))
    return state, perceptual_fn


def twin_state(state: GANTrainState, cfg: GRLConfig, device, seed: int = 0, **kw):
    """make_state(cfg, seed) carrying state's G and D weights and buffers."""
    twin, percep = make_state(cfg, device, seed, **kw)
    twin.generator.load_state_dict(state.generator.state_dict())
    twin.discriminator.load_state_dict(state.discriminator.state_dict())
    return twin, percep


def batches(n: int, device, seed: int = 0) -> List[Dict[str, torch.Tensor]]:
    """n batches of BATCH structured GT 512^2 images, their area-mean LR and
    an unsharp-masked GT (gt + 0.5 (gt - 5x5 mean), clipped), on the
    device."""
    out = []
    for i in range(n):
        gt = torch.from_numpy(structured(seed * 1000 + i, BATCH, LR_HW * SCALE)).to(device)
        nchw = gt.permute(0, 3, 1, 2)
        lq = F.avg_pool2d(nchw, SCALE).permute(0, 2, 3, 1).contiguous()
        blur = F.avg_pool2d(F.pad(nchw, (2, 2, 2, 2), mode="reflect"), 5, stride=1)
        usm = torch.clamp(nchw + 0.5 * (nchw - blur), 0, 1).permute(0, 2, 3, 1).contiguous()
        out.append({"img_lq": lq, "img_gt": gt, "img_gt_usm": usm})
    return out


def gate_fp32(device, lightning_parity: bool, depth=None, seed: int = 0):
    """One fp32 GAN step at drop path 0 on one batch, kernels on against
    off, from the same weights (SGD at LR 0, so that the step's gradients
    stay on the parameters and the fresh generator forward sees the same
    weights): (losses {kernels: (loss_g, loss_d)}, worst gradient ratio
    max|dg| / (1e-3 max|g| + 1e-7) over G's and D's parameters and its
    name, max|du| over the spectral vectors).  Passes when both losses are
    within FP32_LOSS_REL, the ratio <= 1 and max|du| <= FP32_U_ATOL."""
    data = batches(1, device, seed)
    losses, grads, us = {}, {}, {}
    for kernels in (True, False):
        cfg = g_config(torch.float32, kernels, depth, drop_path_rate=0.0)
        state, percep = make_state(cfg, device, seed, opt="sgd", lr=0.0)
        step = make_gan_train_step(GANLossConfig(), percep, lightning_parity)
        m = step(state, data[0])
        losses[kernels] = (float(m["loss_g"]), float(m["loss_d"]))
        grads[kernels] = {f"G.{n}": p.grad.detach().clone()
                          for n, p in state.generator.named_parameters()}
        grads[kernels].update({f"D.{n}": p.grad.detach().clone()
                               for n, p in state.discriminator.named_parameters()})
        us[kernels] = {n: b.detach().clone() for n, b in
                       state.discriminator.named_buffers() if n.endswith(".u")}
    worst, where = 0.0, ""
    for n, g in grads[False].items():
        r = ((grads[True][n] - g).abs().max()
             / (FP32_GRAD_REL * g.abs().max() + FP32_GRAD_FLOOR)).item()
        if r >= worst:
            worst, where = r, n
    du = max((us[True][n] - u).abs().max().item() for n, u in us[False].items())
    return losses, worst, where, du


def fp32_gate_ok(losses, worst, du) -> bool:
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False])]
    return max(rel) <= FP32_LOSS_REL and worst <= 1.0 and du <= FP32_U_ATOL


def gate_bf16(device, lightning_parity: bool, depth=None, seed: int = 0,
              steps: int = GATE_STEPS):
    """`steps` bf16 GAN steps (the generator in bf16; D and VGG in fp32),
    kernels on and off, from the same weights on the same batches with the
    same mask seeds: ({kernels: [(loss_g, loss_d)]}, per-step max rel
    diff).  Passes when every loss is finite and every rel diff <=
    BF16_LOSS_REL."""
    data = batches(steps, device, seed)
    on, percep_on = make_state(g_config(torch.bfloat16, True, depth), device, seed)
    off, percep_off = twin_state(on, g_config(torch.bfloat16, False, depth), device, seed)
    losses = {}
    for kernels, state, percep in ((True, on, percep_on), (False, off, percep_off)):
        step = make_gan_train_step(GANLossConfig(), percep, lightning_parity)
        losses[kernels] = [(float(m["loss_g"]), float(m["loss_d"]))
                           for m in (step(state, b) for b in data)]
    rel = [max(abs(a - b) / abs(b) for a, b in zip(x, y))
           for x, y in zip(losses[True], losses[False])]
    return losses, rel


def bf16_gate_ok(losses, rel) -> bool:
    finite = all(np.isfinite(v) for ls in losses.values() for pair in ls for v in pair)
    return finite and max(rel) <= BF16_LOSS_REL

