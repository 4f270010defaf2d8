"""GAN training step of real-world SR stage 2 (counterpart of
`grlir.engines.gan`): the generator step (pixel + VGG perceptual + GAN
loss) then the discriminator step (BCE on real and fake, the generator's
output detached), each with its own optimizer and LR scheduler, on the
models' device.

Two protocols (`lightning_parity`):
- True, the recipe's default: the generator step's D(fake) advances the
  spectral-norm power iteration, and the discriminator trains on a fresh
  forward of the updated generator with the same drop-path masks: three
  power iterations and two generator forwards a step;
- False: one generator forward, whose output the discriminator trains on;
  two power iterations a step.

Across processes (`grlir_torch.parallel`) each holds its rows of the
global batch; G's gradients are averaged over the world at the generator
step and D's at the discriminator step (`engines.train.reduce_step`), and
the metrics are the world's means.  D's spectral-norm vectors are buffers
that depend on D's weights only, so they stay equal on every process.

The per-loss USM target choice: `use_usm_pixel/percep/gan` pick
`img_gt_usm` (when the batch has it) over `img_gt` for each loss.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional

import torch

from grlir_torch.engines.train import drop_masks, reduce_step
from grlir_torch.losses import LOSS_FNS
from grlir_torch.losses.gan import gan_loss


@dataclass
class GANLossConfig:
    """The loss settings of configs/loss/gan_training_loss.yaml and the
    data module's USM target choice."""

    pixel_loss: str = "l1"
    pixel_weight: float = 1.0
    perceptual_layer_weights: Mapping[str, float] = field(
        default_factory=lambda: {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1.0,
                                 "conv4_4": 1.0, "conv5_4": 1.0})
    perceptual_weight: float = 1.0
    gan_type: str = "vanilla"
    gan_weight: float = 0.1
    use_usm_pixel: bool = True
    use_usm_percep: bool = True
    use_usm_gan: bool = False


@dataclass
class GANTrainState:
    """What a GAN step changes: both networks (the discriminator's
    spectral-norm vectors are its buffers), their optimizers and LR
    schedulers, the step count, and the generator of the drop-path masks."""

    generator: torch.nn.Module
    discriminator: torch.nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    sched_g: torch.optim.lr_scheduler.LRScheduler
    sched_d: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    rng: torch.Generator = field(default_factory=torch.Generator)

    def state_dicts(self) -> dict:
        """What a checkpoint keeps ("model" is the generator, so that a GAN
        checkpoint serves like a PSNR one)."""
        return {"model": self.generator.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "optimizer": self.opt_g.state_dict(),
                "optimizer_d": self.opt_d.state_dict(),
                "scheduler": self.sched_g.state_dict(),
                "scheduler_d": self.sched_d.state_dict()}

    def load_state_dicts(self, saved: Mapping) -> int:
        """Inverse of state_dicts (a loaded checkpoint); returns its step."""
        self.generator.load_state_dict(saved["model"], strict=True)
        self.discriminator.load_state_dict(saved["discriminator"], strict=True)
        self.opt_g.load_state_dict(saved["optimizer"])
        self.opt_d.load_state_dict(saved["optimizer_d"])
        self.sched_g.load_state_dict(saved["scheduler"])
        self.sched_d.load_state_dict(saved["scheduler_d"])
        self.step = int(saved["step"])
        return self.step


def make_gan_train_step(cfg: GANLossConfig,
                        perceptual_fn: Optional[Callable] = None,
                        lightning_parity: bool = False):
    """step(state, batch) -> metrics.

    perceptual_fn(pred, target) -> the layer-weighted perceptual loss, or
    None to leave the term out.  batch: dict of NHWC tensors on the models'
    device.  Returns {"loss_g", "loss_g_pix", ["loss_g_percep"],
    "loss_g_gan", "loss_d", "loss_d_real", "loss_d_fake", "out_d_real",
    "out_d_fake"} as detached 0-d tensors (reading one waits for the
    device)."""
    pixel_fn = LOSS_FNS[cfg.pixel_loss]

    def step_fn(state: GANTrainState, batch: Dict[str, torch.Tensor]):
        lq, gt = batch["img_lq"], batch["img_gt"]
        gt_usm = batch.get("img_gt_usm", gt)
        t_pix = gt_usm if cfg.use_usm_pixel else gt
        t_per = gt_usm if cfg.use_usm_percep else gt
        t_gan = gt_usm if cfg.use_usm_gan else gt
        net_g, net_d = state.generator, state.discriminator
        net_g.train()
        net_d.train()
        masks = drop_masks(net_g, lq.shape[0], state.rng, lq.device)

        # ---- generator step: D's parameters take no gradient
        net_d.requires_grad_(False)
        restored = net_g(lq, drop_masks=masks)
        parts = {}
        l_pix = pixel_fn(restored, t_pix) * cfg.pixel_weight
        parts["loss_g_pix"] = l_pix
        total = l_pix
        if perceptual_fn is not None:
            l_per = perceptual_fn(restored, t_per) * cfg.perceptual_weight
            parts["loss_g_percep"] = l_per
            total = total + l_per
        fake_pred = net_d(restored, lightning_parity)
        l_gan = gan_loss(fake_pred, True, cfg.gan_type, is_disc=False,
                         loss_weight=cfg.gan_weight)
        parts["loss_g_gan"] = l_gan
        total = total + l_gan
        parts["loss_g"] = total
        state.opt_g.zero_grad(set_to_none=True)
        total.backward()
        g_parts = {k: v.detach() for k, v in parts.items()}
        reduce_step(net_g, g_parts)
        state.opt_g.step()
        net_d.requires_grad_(True)

        # ---- discriminator step
        if lightning_parity:
            # a fresh forward of the updated generator, same masks
            with torch.no_grad():
                fake = net_g(lq, drop_masks=masks)
        else:
            fake = restored.detach()
        real_pred = net_d(t_gan, True)
        l_real = gan_loss(real_pred, True, cfg.gan_type, is_disc=True)
        fake_pred = net_d(fake, True)
        l_fake = gan_loss(fake_pred, False, cfg.gan_type, is_disc=True)
        l_d = l_real + l_fake
        state.opt_d.zero_grad(set_to_none=True)
        l_d.backward()
        d_parts = {k: v.detach() for k, v in (
            ("loss_d_real", l_real), ("loss_d_fake", l_fake),
            ("out_d_real", real_pred.mean()), ("out_d_fake", fake_pred.mean()),
            ("loss_d", l_d))}
        reduce_step(net_d, d_parts)
        state.opt_d.step()

        state.sched_g.step()
        state.sched_d.step()
        state.step += 1
        return {**g_parts, **d_parts}

    return step_fn
