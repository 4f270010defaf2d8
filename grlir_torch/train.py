"""Training and evaluation entry point on PyTorch (counterpart of
`grlir.train`):

    python -m grlir_torch.train experiment=dn/grl_p256 key=value ... [device=cpu]

Composes the config (`grlir_torch.configs`, grlir's YAML files), builds the
data module, the model (a seeded init drawn on the host and moved to the
device, or a pretrained checkpoint through `serve.load_checkpoint`), the
optimizer and LR schedule, resumes from the run's latest checkpoint, and
runs the step loop with logging, periodic validation, best tracking and
checkpoint saves, then prints the results table.  `training=false`
validates once.  `classification: true` (loss=ce, l1_ce or l2_ce) trains a
head of 256 class logits a channel and validates on the image formed from
their softmax (`prob_to_image`: weighted_sum or argmax).

`device=cuda|cpu` (default cuda) is read off the command line before the
config is composed.  The run is on the card unless it asks for the CPU; a
missing card raises.  `engine: base_gan` (real-world SR stage 2) runs
`grlir_torch.engines.gan_runner.run_gan`.

Across processes, one a device: start one on each with GRLIR_COORDINATOR
(host:port), GRLIR_NUM_PROCESSES and GRLIR_PROCESS_ID, or under torchrun
with GRLIR_DISTRIBUTED=1 (`grlir_torch.parallel.launch`).  `batch_size` is
then a process's batch, as grlir's is a device's: the global batch is
batch_size x processes.  Each process loads its stride of the data, the
gradients are averaged over the processes at every step, validation
metrics are gathered, and rank 0 alone prints, writes results.csv, images
and checkpoints.
"""

from __future__ import annotations

import os
import os.path as osp
import sys
import time
from dataclasses import fields as dc_fields
from typing import Dict, List, Tuple

import numpy as np
import torch

from grlir_torch.models.grl import GRLConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# grlir's use_pallas_attention -> the port's (engine, kernels); see
# GRLConfig's docstring.  Explicit modes run their kernels under grad too,
# as grlir honours them: B1-B4 with the plain backward, B5-B7 raise.
PALLAS_MODES = {
    "auto": ("v3", "auto"),
    "v3": ("v3", True),
    True: ("fused", True),
    "window": ("window", True),
    "stripe": ("stripe", True),
    False: ("v3", False),
}


def build_model_config(cfg: dict) -> GRLConfig:
    """cfg['model'] (+ the global dtype, remat and remat_policy) -> GRLConfig.
    With `classification` the head has 256 classes a channel."""
    model = dict(cfg["model"])
    known = {f.name for f in dc_fields(GRLConfig)}
    m = {k: v for k, v in model.items() if k in known}
    for seq_key in ("depths", "num_heads_window", "num_heads_stripe",
                    "stripe_size", "stripe_groups", "pretrained_window_size",
                    "pretrained_stripe_size"):
        if seq_key in m:
            m[seq_key] = tuple(m[seq_key])
    if "mlp_ratio" in m:
        m["mlp_ratio"] = float(m["mlp_ratio"])
    mode = model.get("use_pallas_attention", "auto")
    if mode not in PALLAS_MODES:
        raise ValueError(f"use_pallas_attention={mode!r}: one of "
                         f"{list(PALLAS_MODES)}")
    m["engine"], m["kernels"] = PALLAS_MODES[mode]
    m["dtype"] = DTYPES[cfg.get("dtype", "float32")]
    m["remat"] = bool(cfg.get("remat", False))
    m["remat_policy"] = cfg.get("remat_policy")
    if cfg.get("classification", False):
        # a 256-way class head a channel (grlir/train.py:42-45)
        m["out_channels"] = 256 * m.get("in_channels", 3)
    return GRLConfig(**m)


def progressive_host_rows(per_dev_target: int, batch_size: int,
                          n_devices: int, n_processes: int) -> int:
    """Rows of one progressive-batch stage: the per-device target (at most
    batch_size) times this process's share of the devices."""
    per_dev = max(1, min(per_dev_target, batch_size))
    return per_dev * (n_devices // n_processes)


def _quiet(*args, **kwargs) -> None:
    """print on the ranks that do not log."""


def split_device(argv: List[str]) -> Tuple[List[str], torch.device]:
    """(the config tokens, the device of `device=...`, default cuda)."""
    rest, device = [], "cuda"
    for tok in argv:
        if tok.startswith("device="):
            device = tok.partition("=")[2]
        else:
            rest.append(tok)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA device is available; "
                           "pass device=cpu to train on the CPU")
    return rest, device


def main(argv=None):
    from grlir_torch import serve
    from grlir_torch.configs import load_config
    from grlir_torch.data import degradations as D
    from grlir_torch.data.module import IRDataModule
    from grlir_torch.engines.inference import Restorer
    from grlir_torch.engines.preprocess import (make_train_preprocess,
                                                progressive_stage)
    from grlir_torch.engines.train import TrainState, make_train_step
    from grlir_torch.engines.validate import validate, write_results_csv
    from grlir_torch.models.grl import GRL, init_weights
    from grlir_torch.optim import build_optimizer
    from grlir_torch.optim.schedules import SCHEDULES
    from grlir_torch.utils.checkpoint import CheckpointManager
    from grlir_torch.utils.profiling import MetricsLogger

    from grlir_torch.parallel.launch import init_distributed
    from grlir_torch.parallel.mesh import world

    tokens, device = split_device(list(argv if argv is not None else sys.argv[1:]))
    device = init_distributed(device)
    rank, n_proc = world()
    say = print if rank == 0 else _quiet
    cfg = load_config(tokens)
    seed = cfg.get("seed", 1234)
    task = cfg["data_module"]["name"]
    if task == "paired" and cfg["data_module"].get("dual_pixel"):
        task = "paired_dual"

    out_dir = osp.expanduser(
        osp.join(cfg["io"]["base_output_path"], cfg["tag"],
                 f"version_{cfg['io']['version']}"))
    os.makedirs(out_dir, exist_ok=True)
    say(f"[grlir_torch] output: {out_dir} device: {device}")

    if cfg.get("engine", {}).get("name") == "base_gan":
        from grlir_torch.engines.gan_runner import run_gan

        return run_gan(cfg, out_dir, device, say)

    # ---- model
    mcfg = build_model_config(cfg)
    # built and drawn on the host (torch's default init draws on the
    # parameters' device), then moved
    model = init_weights(GRL(mcfg), torch.Generator().manual_seed(seed)).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[grlir_torch] model {cfg['model'].get('name')} "
          f"params={n_params / 1e6:.3f}M dtype={cfg.get('dtype', 'float32')} "
          f"engine={mcfg.engine} kernels={mcfg.kernels}")
    if cfg.get("pretrained_checkpoint"):
        serve.load_checkpoint(model, cfg["pretrained_checkpoint"])
        say(f"[grlir_torch] loaded pretrained {cfg['pretrained_checkpoint']}")

    # ---- data
    dm = IRDataModule({**cfg["data_module"],
                       "worker_mode": cfg.get("worker_mode")}, seed=seed)
    scale = int(cfg["data_module"].get("scale", 1))
    blur_kernel = (D.get_blur_kernel(cfg["data_module"].get("kernel_type",
                                                            "gaussian"))
                   if task == "db" else None)

    # ---- optimizer + schedule
    opt_cfg = cfg["optimizer"]
    sch_cfg = dict(cfg["lr_scheduler"])
    schedule = SCHEDULES[sch_cfg.pop("name")](opt_cfg["lr"], **sch_cfg)
    optimizer, scheduler = build_optimizer(
        model.parameters(), opt_cfg["name"], schedule=schedule,
        betas=tuple(opt_cfg.get("betas", (0.9, 0.999))),
        weight_decay=opt_cfg.get("weight_decay", 1e-2))
    state = TrainState(model, optimizer, scheduler,
                       generator=torch.Generator().manual_seed(seed),
                       rng=np.random.default_rng(seed))
    use_usm = (cfg.get("engine", {}).get("name") == "base_psnr"
               and cfg.get("engine", {}).get("use_usm", False))

    # progressive (Restormer-style) batch/patch schedule
    prog_steps = list(cfg.get("steps") or [])
    prog_batches = list(cfg.get("batch_sizes") or [])
    prog_patches = list(cfg.get("patch_sizes") or [])

    classification = cfg.get("classification", False)

    # MixUp starts after six virtual epochs ("current_epoch > 5", 0-based);
    # batch_size is a process's, as grlir's is a device's
    global_batch = int(cfg["batch_size"]) * n_proc
    steps_per_epoch = max(1, len(dm.train_dataset) // max(1, global_batch))
    mixup_start = 6 * steps_per_epoch if cfg.get("mixup", False) else 0

    def build_step(crop_patch=None):
        pre = make_train_preprocess(
            task, blur_kernel, cfg.get("mixup", False), scale,
            crop_patch=crop_patch, use_usm_target=use_usm,
            mixup_start_step=mixup_start)
        return make_train_step(cfg["loss"], preprocess=pre,
                               classification=classification,
                               one_hot_label=cfg.get("one_hot_label", True))

    train_step = build_step()

    logger = MetricsLogger(osp.join(out_dir, "metrics.jsonl")) if rank == 0 else None
    ckpt = CheckpointManager(
        osp.join(out_dir, "checkpoints"),
        monitor=cfg["model_checkpoint"]["monitor"],
        mode=cfg["model_checkpoint"]["mode"],
        save_top_k=cfg["model_checkpoint"]["save_top_k"],
    )
    if cfg.get("resume", True) and ckpt.latest_step() is not None:
        state.step = ckpt.restore(model, optimizer, scheduler)
        say(f"[grlir_torch] resumed from step {state.step}")

    metric_names = cfg["metric"]["val"]
    monitor = cfg["model_checkpoint"]["monitor"].replace("val_", "")
    best = {"value": None, "step": 0}
    # one Restorer for the run: on the card its CUDA graphs (one a padded
    # shape) replay against the weights the optimizer updates in place
    # a classification model validates on the image formed from its class
    # distribution (grlir/train.py:182-192)
    served = model
    if classification:
        from grlir_torch.losses.classification import FormedImage

        served = FormedImage(model, cfg.get("prob_to_image", "weighted_sum"))
    restorer = Restorer(served, device, scale=scale, tile=cfg.get("tile", 0),
                        tile_overlap=cfg.get("tile_overlap", 0))

    def run_validation(step: int) -> Dict[str, Dict[str, float]]:
        model.eval()
        all_results = {}
        for name, loader in dm.val_loaders(num_workers=cfg.get("num_workers", 2)).items():
            res = validate(
                restorer, loader, metric_names, task, scale, blur_kernel,
                save_dir=osp.join(out_dir, "images", name)
                if cfg.get("save_images") and rank == 0 else None,
                gather_across_hosts=n_proc > 1,
                step=step,
            )
            all_results[name] = res
            if rank == 0:
                write_results_csv(osp.join(out_dir, "results.csv"), cfg["tag"],
                                  name, res, step)
            line = " ".join(f"{k}={v:.4f}" for k, v in res.items())
            say(f"[grlir_torch] step {step} val[{name}]: {line}")
        model.train()
        # best-so-far on the monitored metric of the first val set
        first = next(iter(all_results.values()), {})
        cur = first.get(monitor)
        if cur is not None:
            mode = cfg["model_checkpoint"]["mode"]
            if (best["value"] is None or (mode == "max" and cur > best["value"])
                    or (mode == "min" and cur < best["value"])):
                best.update(value=cur, step=step)
            say(f"[grlir_torch] best {monitor}={best['value']:.4f} "
                  f"@ step {best['step']}")
        return all_results

    if not cfg.get("training", True):
        run_validation(state.step)
        if logger is not None:
            logger.close()
        return

    # ---- training loop
    max_steps = int(cfg["trainer"]["max_steps"])
    log_every = int(cfg["trainer"].get("log_every_n_steps", 50))
    val_every = int(cfg["trainer"].get("val_check_interval", 5000))
    loader = dm.train_loader(int(cfg["batch_size"]),
                             num_workers=cfg.get("num_workers", 2))
    stream = loader.infinite()
    model.train()
    t0 = time.time()
    start_step = state.step
    current_stage = -1
    for step in range(start_step, max_steps):
        batch = next(stream)
        batch = {k: v for k, v in batch.items() if k.startswith("img_")}
        if prog_steps:
            stage = progressive_stage(step, prog_steps)
            if stage != current_stage:
                current_stage = stage
                crop = (prog_patches[stage] if stage < len(prog_patches)
                        else None)
                train_step = build_step(
                    crop if crop and crop < cfg["patch_size"] else None)
                say(f"[grlir_torch] progressive stage {stage}: "
                      f"batch={prog_batches[stage] if stage < len(prog_batches) else '-'} "
                      f"patch={crop}")
            if stage < len(prog_batches):
                bs = progressive_host_rows(prog_batches[stage],
                                           int(cfg["batch_size"]), n_proc, n_proc)
                batch = {k: v[:bs] for k, v in batch.items()}
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in batch.items()}
        metrics = train_step(state, batch)

        if (step + 1) % log_every == 0:
            loss = float(metrics["loss"])
            lr = schedule(step)   # the LR of the update just made
            rate = (step + 1 - start_step) / (time.time() - t0)
            if logger is not None:
                logger.log(step + 1, loss=loss, lr=lr, steps_per_sec=rate)
            say(f"[grlir_torch] step {step + 1}/{max_steps} loss={loss:.4f} "
                  f"lr={lr:.2e} {rate:.2f} it/s")

        if (step + 1) % val_every == 0 or (step + 1) == max_steps:
            results = run_validation(step + 1)
            first = next(iter(results.values())) if results else {}
            # grlir hands the manager the first set's metrics as they are
            # (keyed "psnr", while it monitors "val_psnr"): kept as grlir
            # keeps them
            ckpt.save(step + 1, state.state_dicts(), dict(first))

    loader.close()
    if logger is not None:
        logger.close()
    csv_path = osp.join(out_dir, "results.csv")
    if rank == 0 and osp.exists(csv_path):
        from grlir_torch.utils.report import parse_csv

        say(parse_csv(csv_path))
    say("[grlir_torch] done")


if __name__ == "__main__":
    main()
