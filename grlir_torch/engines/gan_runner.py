"""GAN training runner of real-world SR stage 2, the `engine: base_gan`
path of `python -m grlir_torch.train` (counterpart of
`grlir.engines.gan_runner`).

Builds the generator (cfg.model.model_g) and the UNet-SN discriminator
(cfg.model.model_d), warm-starts them from the stage-1 PSNR checkpoint (a
checkpoint directory of the port's trainer, a released torch state dict or
a .msgpack file) and a pretrained discriminator, and runs the two-optimizer
step of `grlir_torch.engines.gan` with GT-free NIQE validation,
best-val_niqe checkpoints and resume.  The perceptual term runs only when
`vgg_pretrained` names an existing torchvision vgg19 file.

Across processes (`grlir_torch.parallel`) each loads its stride of the
data (the BSR pipeline's worker processes seeded from its rank's
pipeline seed), the step averages G's and D's gradients over the world,
the NIQE values are gathered, and rank 0 alone writes checkpoints; `say`
is the trainer's print, silent on the other ranks.
"""

from __future__ import annotations

import os.path as osp
import time
from typing import Dict

import numpy as np
import torch


def run_gan(cfg: dict, out_dir: str, device: torch.device, say=print):
    from grlir_torch import serve
    from grlir_torch.data.module import IRDataModule
    from grlir_torch.engines.gan import (GANLossConfig, GANTrainState,
                                         make_gan_train_step)
    from grlir_torch.engines.inference import Restorer
    from grlir_torch.metrics.collect import MetricAccumulator
    from grlir_torch.metrics.niqe import niqe_batch
    from grlir_torch.models.discriminator import UNetDiscriminatorSN
    from grlir_torch.models.grl import GRL, init_weights
    from grlir_torch.optim import build_optimizer
    from grlir_torch.optim.schedules import SCHEDULES
    from grlir_torch.parallel.mesh import world
    from grlir_torch.train import build_model_config
    from grlir_torch.utils import convert as C
    from grlir_torch.utils.checkpoint import CheckpointManager
    from grlir_torch.utils.image import tensor_round

    seed = cfg.get("seed", 1234)
    gcfg = build_model_config({**cfg, "model": cfg["model"]["model_g"]})
    # both drawn on the host from seeded generators, then moved
    net_g = init_weights(GRL(gcfg), torch.Generator().manual_seed(seed))
    dcfg = cfg["model"]["model_d"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 1)
        net_d = UNetDiscriminatorSN(num_in_ch=3, num_feat=dcfg.get("num_feat", 64),
                                    skip_connection=dcfg.get("skip_connection", True))
    n_g = sum(p.numel() for p in net_g.parameters())
    n_d = sum(p.numel() for p in net_d.parameters())
    say(f"[grlir_torch] GAN: G={n_g / 1e6:.2f}M D={n_d / 1e6:.2f}M "
          f"engine={gcfg.engine} kernels={gcfg.kernels}")

    # the reference keeps the hand-off keys at the top level; both places
    # are read
    eng = dict(cfg.get("engine", {}))
    for k in ("bsr_psnr_checkpoint", "bsr_discriminator_checkpoint"):
        if not eng.get(k) and cfg.get(k):
            eng[k] = cfg[k]
    if eng.get("bsr_psnr_checkpoint"):
        serve.load_checkpoint(net_g, eng["bsr_psnr_checkpoint"])
        say(f"[grlir_torch] loaded PSNR generator {eng['bsr_psnr_checkpoint']}")
    if eng.get("bsr_discriminator_checkpoint"):
        sd = C.strip_prefix(C.load_torch_state_dict(
            osp.expanduser(eng["bsr_discriminator_checkpoint"])), "model_d.")
        net_d.load_state_dict(C.convert_unet_discriminator(sd), strict=True)
        say("[grlir_torch] loaded pretrained discriminator")
    net_g.to(device)
    net_d.to(device)

    opt_cfg = cfg["optimizer"]
    sch_cfg = dict(cfg["lr_scheduler"])
    schedule = SCHEDULES[sch_cfg.pop("name")](opt_cfg["lr"], **sch_cfg)
    betas = tuple(opt_cfg.get("betas", (0.9, 0.999)))
    opt_g, sched_g = build_optimizer(net_g.parameters(), opt_cfg["name"],
                                     schedule=schedule, betas=betas)
    opt_d, sched_d = build_optimizer(net_d.parameters(), opt_cfg["name"],
                                     schedule=schedule, betas=betas)
    state = GANTrainState(net_g, net_d, opt_g, opt_d, sched_g, sched_d,
                          rng=torch.Generator().manual_seed(seed))

    loss_cfg = cfg.get("loss", {})
    dm_train = cfg["data_module"].get("train", {})
    gan_cfg = GANLossConfig(
        pixel_loss=loss_cfg.get("pixel_loss", "l1"),
        pixel_weight=loss_cfg.get("pixel_weight", 1.0),
        perceptual_weight=loss_cfg.get("perceptual_weight", 1.0),
        gan_type=loss_cfg.get("gan_type", "vanilla"),
        gan_weight=loss_cfg.get("gan_weight", 0.1),
        use_usm_pixel=dm_train.get("use_usm_pixel", True),
        use_usm_percep=dm_train.get("use_usm_percep", True),
        use_usm_gan=dm_train.get("use_usm_gan", False),
    )

    perceptual_fn = None
    vgg_path = cfg.get("vgg_pretrained")
    if vgg_path and osp.exists(osp.expanduser(vgg_path)):
        from grlir_torch.models.vgg import VGGFeatureExtractor, perceptual_loss

        weights = loss_cfg.get("perceptual_layer_weights",
                               GANLossConfig().perceptual_layer_weights)
        vgg = VGGFeatureExtractor(tuple(weights))
        vgg.load_state_dict(C.convert_vgg_torch_weights(
            C.load_torch_state_dict(osp.expanduser(vgg_path)), tuple(weights)),
            strict=True)
        vgg = vgg.eval().requires_grad_(False).to(device)

        def perceptual_fn(pred, target):  # noqa: F811
            return perceptual_loss(vgg, pred, target, weights)[0]

        say(f"[grlir_torch] perceptual loss active (VGG from {vgg_path})")

    # the reference's protocol (fresh G forward for the D step, 3 power
    # iterations a step) unless engine.lightning_parity is false
    lightning_parity = bool(eng.get("lightning_parity", True))
    say("[grlir_torch] GAN protocol: "
          f"{'lightning-parity' if lightning_parity else 'single-forward'}")
    step = make_gan_train_step(gan_cfg, perceptual_fn=perceptual_fn,
                               lightning_parity=lightning_parity)

    ckpt = CheckpointManager(
        osp.join(out_dir, "checkpoints"),
        monitor=cfg["model_checkpoint"].get("monitor", "val_niqe"),
        mode=cfg["model_checkpoint"].get("mode", "min"),
        save_top_k=cfg["model_checkpoint"].get("save_top_k", 1),
    )
    if cfg.get("resume", True) and ckpt.latest_step() is not None:
        state.load_state_dicts(ckpt.load())
        say(f"[grlir_torch] resumed GAN from step {state.step}")

    dm = IRDataModule({**cfg["data_module"], "worker_mode": cfg.get("worker_mode")},
                      seed=seed)
    scale = int(cfg["data_module"].get("scale", 4))
    restorer = Restorer(net_g, device, scale=scale, tile=cfg.get("tile", 0),
                        tile_overlap=cfg.get("tile_overlap", 0))

    def run_validation(step_num: int) -> Dict[str, Dict[str, float]]:
        net_g.eval()
        results = {}
        for name, loader in dm.val_loaders().items():
            acc = MetricAccumulator(["niqe"])
            for batch in loader:
                restored = restorer(np.asarray(batch["img_lq"]))
                restored = tensor_round(torch.from_numpy(restored)).numpy()
                acc.update({"niqe": niqe_batch(restored)}, batch["indices"],
                           batch["filenames"])
            if world()[1] > 1:
                acc.gather_across_hosts()
            res = acc.compute()
            results[name] = res
            say(f"[grlir_torch] step {step_num} val[{name}]: "
                  f"niqe={res.get('niqe', float('nan')):.4f}")
        net_g.train()
        return results

    if not cfg.get("training", True):
        run_validation(state.step)
        return state

    max_steps = int(cfg["trainer"]["max_steps"])
    log_every = int(cfg["trainer"].get("log_every_n_steps", 50))
    val_every = int(cfg["trainer"].get("val_check_interval", 10000))
    loader = dm.train_loader(int(cfg["batch_size"]),
                             num_workers=cfg.get("num_workers", 2))
    stream = loader.infinite()
    t0 = time.time()
    start = state.step
    try:
        for step_num in range(start, max_steps):
            batch = next(stream)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in batch.items() if k.startswith("img_")}
            metrics = step(state, batch)

            if (step_num + 1) % log_every == 0:
                rate = (step_num + 1 - start) / (time.time() - t0)
                say(f"[grlir_torch] gan step {step_num + 1}/{max_steps} "
                      f"g={float(metrics['loss_g']):.4f} "
                      f"d={float(metrics['loss_d']):.4f} {rate:.2f} it/s")

            if (step_num + 1) % val_every == 0 or (step_num + 1) == max_steps:
                results = run_validation(step_num + 1)
                first = next(iter(results.values())) if results else {}
                ckpt.save(step_num + 1, state.state_dicts(),
                          {f"val_{k}": v for k, v in first.items()})
    finally:
        loader.close()
    say("[grlir_torch] gan done")
    return state
