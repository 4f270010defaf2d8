"""Runs across processes, one rank a process: the scenarios that the
multi-process tests (tests/test_torch_parallel*.py, gloo on the CPU) and
the card cell (`chip_smoke.py`'s parallel phase,
tests/test_torch_parallel_cuda.py) hold against one process on the global
batch.  Each rank is

    python3 -m grlir_torch.parallel_cells <spec.pt> <rank>

The spec (`launch` writes it with torch.save) gives the world size, a free
port on 127.0.0.1, the device, how the group forms, the scenarios
{name: (run, kwargs)} and the output directory; the rank runs every
scenario in order on its rows of the global batch and writes
{name: result, "backend": ...} to <out>/rank<rank>.pt.  How the group forms:

- "env": GRLIR_COORDINATOR / GRLIR_NUM_PROCESSES / GRLIR_PROCESS_ID
  through `launch.init_distributed`, so gloo on the CPU and NCCL on the
  card;
- "gloo": the rank forms a gloo group itself (then `init_distributed`
  leaves it as it is).  NCCL refuses two ranks on one GPU, so two ranks
  share the card this way: gloo all-reduces and all-gathers CUDA tensors
  through the host.

Every run takes the whole global batch and keeps this process's rows
(`shard_rows`), so `reference` runs the same scenarios in one process, a
world of one, on the global batch.  On the CPU a rank runs one intra-op
thread; on the card TF32 is off in the ranks and in `reference`.

The card cell (`card_scenarios`): GRL-S (`zoo.GRL_SMALL`: window 8 and
stripes 8 x W/4, B1 and B2 under grad) in fp32, kernels on, drop path
0.1, SGD at LR 0.05, STEPS steps of x4 SR at PER_RANK rows a rank of a
global batch of 64^2 LR patches; then, with the initial weights, a tiled
Restorer across the ranks (mesh=make_mesh()) and `validate` on the rank's
stride of a val set (short ranks padded with a duplicate), the metrics
gathered.  The gates of `compare`, fixed before the first card run:
losses within LOSS_REL relative and parameters within PARAM_RTOL /
PARAM_ATOL of one process (fp32 with TF32 off; a rank's batch of 2
against 4 moves cuDNN's algorithm choice and the order of the atomic adds
in the bias gathers' backward), the Restorer within RESTORE_ATOL (each
rank's tiles on its own CUDA graph), the gathered metrics within
METRIC_REL of one process's (the gather averages in float64, one process
in the metrics' float32).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from grlir_torch.models import zoo

STEPS, PER_RANK, LR_HW, SCALE = 3, 2, 64, 4
LR = 0.05
CFG = replace(zoo.GRL_SMALL, dtype=torch.float32, kernels=True, drop_path_rate=0.1)
TILE, TILE_OVERLAP, IMAGE_HW = 64, 16, (96, 112)
VAL_IMAGES = 3
LOSS_REL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
RESTORE_ATOL = 1e-5
METRIC_REL = 1e-6


def _rows(a: np.ndarray, device) -> torch.Tensor:
    from grlir_torch.parallel.mesh import shard_rows

    return torch.from_numpy(np.ascontiguousarray(a[shard_rows(a.shape[0])])).to(device)


def _grl(cfg, init: str, device):
    """A GRL of `cfg` with the state dict in `init`, built on the host and
    moved, as the trainer builds its models."""
    from grlir_torch.models.grl import GRL

    model = GRL(cfg)
    model.load_state_dict(torch.load(init, weights_only=True))
    return model.to(device)


def psnr_run(cfg, init: str, data: str, mixup: bool = False, lr: float = LR,
             opt: str = "sgd", resume: str = None, save: str = None, record: bool = False,
             device="cpu"):
    """Steps of the PSNR engine's train step (l1), one a global batch of
    `data` (lq, gt: (steps, global batch, H, W, C)): the losses, each
    step's wall in ms, the final parameters, the step count, and the
    launches by kernel and route; with `record`, also the parameters
    before and the gradients (the world's mean) of each step.  resume: a
    checkpoint directory to restore first; save: one to save the final
    step to (rank 0 writes)."""
    from grlir_torch.engines.preprocess import make_train_preprocess
    from grlir_torch.engines.train import TrainState, make_train_step
    from grlir_torch.ops import block_attn as ba
    from grlir_torch.optim import build_optimizer
    from grlir_torch.utils.checkpoint import CheckpointManager

    model = _grl(cfg, init, device)
    optimizer, scheduler = build_optimizer(model.parameters(), opt, learning_rate=lr)
    state = TrainState(model, optimizer, scheduler, generator=torch.Generator().manual_seed(7),
                       rng=np.random.default_rng(8))
    if resume:
        state.step = CheckpointManager(resume).restore(model, optimizer, scheduler)
    pre = make_train_preprocess("dn", use_mixup=True) if mixup else None
    step = make_train_step({"l1": 1.0}, preprocess=pre)
    arrays = np.load(data)
    ba.reset_launches()
    losses, walls, grads, before = [], [], [], []
    for lq, gt in zip(arrays["lq"], arrays["gt"]):
        if record:
            before.append({n: v.detach().cpu().clone() for n, v in model.state_dict().items()})
        batch = {"img_lq": _rows(lq, device), "img_gt": _rows(gt, device)}
        t0 = time.perf_counter()
        losses.append(float(step(state, batch)["loss"]))   # float() waits for the step
        walls.append((time.perf_counter() - t0) * 1e3)
        if record:
            grads.append({n: p.grad.cpu().clone() for n, p in model.named_parameters()})
    if save:
        CheckpointManager(save).save(state.step, state.state_dicts(), {"psnr": 0.0})
    return {"losses": losses, "step_ms": walls, "grads": grads, "before": before,
            "params": {n: v.detach().cpu() for n, v in model.state_dict().items()},
            "step": state.step,
            "launches": {k.__name__: k.launches for k in ba.KERNELS if k.launches},
            "routes": {k.__name__: dict(k.route_launches) for k in ba.ROUTED
                       if any(k.route_launches.values())},
            "unrouted": ba.unrouted_halves}


def restorer_run(cfg, init: str, image: str, tile: int, overlap: int, scale: int,
                 device="cpu"):
    """A tiled Restorer whose tile groups are split over the world's
    processes (mesh=make_mesh())."""
    from grlir_torch.engines.inference import Restorer
    from grlir_torch.parallel.mesh import make_mesh

    model = _grl(cfg, init, device).eval()
    r = Restorer(model, device, scale=scale, tile=tile, tile_overlap=overlap,
                 mesh=make_mesh())
    return {"out": r(np.load(image)), "tile_batch": r.tile_batch}


def validate_run(cfg, init: str, val: str, scale: int, device="cpu"):
    """`validate` (psnr, ssim) of x`scale` SR on this rank's stride of the
    val images (`val`: (n, H, W, C), the LR their scale x scale means), one
    a batch, padded to the longest stride with the first images (a
    distributed sampler's padding), the metrics gathered across the
    processes."""
    from grlir_torch.engines.inference import Restorer
    from grlir_torch.engines.validate import validate
    from grlir_torch.parallel.mesh import world

    rank, n_proc = world()
    images = np.load(val)
    n = len(images)
    idx = list(range(rank, n, n_proc))
    idx += list(range(-(-n // n_proc) - len(idx)))
    batches = []
    for i in idx:
        gt = torch.from_numpy(images[i:i + 1])
        lq = torch.nn.functional.avg_pool2d(gt.permute(0, 3, 1, 2), scale)
        batches.append({"img_lq": lq.permute(0, 2, 3, 1).numpy(), "img_gt": images[i:i + 1],
                        "indices": np.array([i]), "filenames": [f"v{i}.png"]})
    model = _grl(cfg, init, device).eval()
    return validate(Restorer(model, device, scale=scale), batches, ["psnr", "ssim"], "sr",
                    scale, gather_across_hosts=True)


def gather_run(values: dict, idx: list, device="cpu"):
    """This rank's (value, index) vectors of a validation pass: values
    {metric: per-rank lists}, idx per-rank lists; gathered and deduped."""
    from grlir_torch.metrics.collect import MetricAccumulator
    from grlir_torch.parallel.mesh import world

    rank = world()[0]
    acc = MetricAccumulator(sorted(values))
    acc.update({n: np.asarray(v[rank], np.float32) for n, v in values.items()}, idx[rank])
    acc.gather_across_hosts()
    return acc.compute()


def loader_run(root: str, device="cpu"):
    """The indices of one epoch of the dn train loader, batch 1 a process."""
    from grlir_torch.data.module import IRDataModule

    os.environ["GRLIR_DATA_ROOT"] = root
    os.environ["GRLIR_CACHE_DIR"] = os.path.join(root, "cache")
    dm = IRDataModule({"name": "dn", "patch_size": 8, "use_cache": False,
                       "train": {"dataset": "div2k"}}, seed=3)
    loader = dm.train_loader(1, num_workers=1)
    items = [int(i) for b in loader for i in b["indices"]]
    loader.close()
    return items


def gan_run(cfg, g_init: str, d_init: str, data: str, lightning_parity: bool,
            lr: float = LR, device="cpu"):
    """GAN steps of both networks with SGD, one a global batch of `data`
    (lq, gt, gt_usm), UNet-SN num_feat 8 and VGG19 at a seeded init: the
    metrics of each step, then G's and D's state (D's spectral vectors
    included).  On the CPU the convolutions run on PyTorch's native
    kernels, not oneDNN's: oneDNN's fp32 backward sums D's last bias
    gradient over the 4 x 64^2 pixels 1.3e-5 away from float64 (0.054 in
    all; the native kernel 2e-8), in the one process and not in the
    ranks, which sum half as many each."""
    from grlir_torch.engines.gan import GANLossConfig, GANTrainState, make_gan_train_step
    from grlir_torch.models.discriminator import UNetDiscriminatorSN
    from grlir_torch.models.vgg import VGGFeatureExtractor, perceptual_loss
    from grlir_torch.optim import build_optimizer

    g = _grl(cfg, g_init, device)
    d = UNetDiscriminatorSN(num_in_ch=3, num_feat=8)
    d.load_state_dict(torch.load(d_init, weights_only=True))
    d.to(device)
    layers = dict(GANLossConfig().perceptual_layer_weights)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        vgg = VGGFeatureExtractor(tuple(layers)).eval().requires_grad_(False).to(device)

    def percep(pred, target):
        return perceptual_loss(vgg, pred, target, layers)[0]

    opt_g, sched_g = build_optimizer(g.parameters(), "sgd", learning_rate=lr)
    opt_d, sched_d = build_optimizer(d.parameters(), "sgd", learning_rate=lr)
    state = GANTrainState(g, d, opt_g, opt_d, sched_g, sched_d,
                          rng=torch.Generator().manual_seed(9))
    step = make_gan_train_step(GANLossConfig(), perceptual_fn=percep,
                               lightning_parity=lightning_parity)
    arrays = np.load(data)
    metrics = []
    onednn = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        for lq, gt, usm in zip(arrays["lq"], arrays["gt"], arrays["gt_usm"]):
            m = step(state, {"img_lq": _rows(lq, device), "img_gt": _rows(gt, device),
                             "img_gt_usm": _rows(usm, device)})
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        torch.backends.mkldnn.enabled = onednn
    return {"metrics": metrics,
            "g": {n: v.detach().cpu() for n, v in g.state_dict().items()},
            "d": {n: v.detach().cpu() for n, v in d.state_dict().items()}}


RUNS = {"psnr": psnr_run, "restorer": restorer_run, "validate": validate_run,
        "gather": gather_run, "loader": loader_run, "gan": gan_run}


def run_scenarios(scenarios: dict, device) -> dict:
    """{name: result} of `scenarios` ({name: (run, kwargs)}) in order, on
    `device` (TF32 off on the card)."""
    device = torch.device(device)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return {name: RUNS[run](**kwargs, device=device)
                for name, (run, kwargs) in scenarios.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def reference(scenarios: dict, device) -> dict:
    """`scenarios` in this process alone: one process on the global batch,
    the tiles in groups of one, every val image once."""
    from grlir_torch.parallel.mesh import world

    assert world()[1] == 1
    return run_scenarios(scenarios, device)


def card_scenarios(out: str) -> dict:
    """The card cell's inputs, written under `out` from fixed seeds on the
    host, and its scenarios: "train", "restorer" and "validate"."""
    from grlir_torch.models.grl import GRL, init_weights
    from grlir_torch.train_cells import structured

    os.makedirs(out, exist_ok=True)
    init = os.path.join(out, "init.pt")
    torch.save(init_weights(GRL(CFG), torch.Generator().manual_seed(0)).state_dict(), init)
    n = PER_RANK * 2
    gt = np.stack([structured(100 + i, n, LR_HW * SCALE) for i in range(STEPS)])
    lq = torch.nn.functional.avg_pool2d(
        torch.from_numpy(gt).reshape(-1, *gt.shape[2:]).permute(0, 3, 1, 2), SCALE)
    lq = lq.permute(0, 2, 3, 1).reshape(STEPS, n, LR_HW, LR_HW, 3).numpy()
    data = os.path.join(out, "data.npz")
    np.savez(data, lq=lq, gt=gt)
    image = os.path.join(out, "image.npy")
    np.save(image, structured(200, 1, max(IMAGE_HW))[:, :IMAGE_HW[0], :IMAGE_HW[1]])
    val = os.path.join(out, "val.npy")
    np.save(val, structured(300, VAL_IMAGES, LR_HW * SCALE))
    return {"train": ("psnr", dict(cfg=CFG, init=init, data=data)),
            "restorer": ("restorer", dict(cfg=replace(CFG, drop_path_rate=0.0), init=init,
                                          image=image, tile=TILE, overlap=TILE_OVERLAP,
                                          scale=SCALE)),
            "validate": ("validate", dict(cfg=replace(CFG, drop_path_rate=0.0), init=init,
                                          val=val, scale=SCALE))}


def compare(ranks, ref) -> list:
    """The card cell's gate failures, as text ([] if none), of the ranks'
    results against one process's."""
    fails = []
    a = ranks[0]
    for r in ranks[1:]:
        if r["train"]["losses"] != a["train"]["losses"] or any(
                not torch.equal(r["train"]["params"][n], v)
                for n, v in a["train"]["params"].items()):
            fails.append("ranks not in lockstep")
        if (not np.array_equal(r["restorer"]["out"], a["restorer"]["out"])
                or r["validate"] != a["validate"]):
            fails.append("ranks restore or score differently")
    for g, w in zip(a["train"]["losses"], ref["train"]["losses"]):
        if not abs(g - w) <= LOSS_REL * abs(w):
            fails.append(f"loss {g} vs one process {w}")
    for n, w in ref["train"]["params"].items():
        got = a["train"]["params"][n]
        if not torch.allclose(got, w, rtol=PARAM_RTOL, atol=PARAM_ATOL):
            fails.append(f"parameter {n}: max|diff| {(got - w).abs().max():.3e}")
    err = np.abs(a["restorer"]["out"] - ref["restorer"]["out"]).max()
    if not err <= RESTORE_ATOL:
        fails.append(f"Restorer max|diff| {err:.3e}")
    for k, w in ref["validate"].items():
        if not abs(a["validate"][k] - w) <= METRIC_REL * abs(w):
            fails.append(f"metric {k} {a['validate'][k]} vs one process {w}")
    return fails


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, argv, out: str, timeout: float = 600) -> None:
    """Run `argv + [rank]` for every rank of `world` at once, with this
    checkout on PYTHONPATH, each writing to <out>/rank<rank>.log, and wait
    for all of them.  A rank that fails, or a launch that outlasts
    `timeout` seconds, kills every rank and raises."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    logs = [open(os.path.join(out, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([*argv, str(r)], stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env, cwd=root) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"ranks outlasted {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n{f.read()[-4000:]}")


def launch(world: int, scenarios: dict, out: str, device: str = "cpu", group: str = "env",
           timeout: float = 600) -> list:
    """`world` ranks of this module on `scenarios`, on `device`, the group
    formed as `group` says ("env" or "gloo", see the module's docstring)
    on a free port of 127.0.0.1: each rank's {name: result, "backend"}."""
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, "spec.pt")
    torch.save({"world": world, "port": free_port(), "device": device, "group": group,
                "scenarios": scenarios, "out": out}, spec)
    spawn(world, [sys.executable, "-m", "grlir_torch.parallel_cells", spec], out, timeout)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main() -> int:
    import torch.distributed as dist

    from grlir_torch.parallel.launch import init_distributed

    spec = torch.load(sys.argv[1], weights_only=False)
    rank = int(sys.argv[2])
    device = torch.device(spec["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    if spec["group"] == "gloo":
        if device.type == "cuda":
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                                world_size=spec["world"], rank=rank)
        assert init_distributed(device) == device
    else:
        os.environ.update(GRLIR_COORDINATOR=f"127.0.0.1:{spec['port']}",
                          GRLIR_NUM_PROCESSES=str(spec["world"]), GRLIR_PROCESS_ID=str(rank))
        device = init_distributed(device)
    out = run_scenarios(spec["scenarios"], device)
    out["backend"] = dist.get_backend()
    torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
