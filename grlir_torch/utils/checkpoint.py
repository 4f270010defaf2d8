"""Training checkpoints: save/restore with best-k retention and resume
discovery (counterpart of `grlir.utils.checkpoint`, in the port's own
format instead of orbax's).

A checkpoint is one directory a step, `<directory>/step_<N>/`, holding
`checkpoint.pt` (a `torch.save` of {"step", "model", "optimizer",
"scheduler", "metrics"}) and `metrics.json`.  It is written under a
temporary name and moved into place with `os.replace`, so a reader never
sees half a checkpoint.

Retention is orbax's as grlir configures it (max_to_keep = save_top_k + 1,
best_fn on the monitored metric, best_mode "max"): while more than
max_to_keep checkpoints exist, only the max_to_keep best by the monitored
metric stay, a later step winning a tie.  grlir always hands orbax a metrics
dict (empty when a save has none), so a checkpoint without the monitored
metric ranks last in either mode; the same sequence of saves keeps the same
steps here.

Across processes (`grlir_torch.parallel`) rank 0 writes and every process
reads, so a run resumes on another number of processes.
"""

from __future__ import annotations

import json
import math
import os
import os.path as osp
import shutil
from typing import Any, Dict, List, Optional

import torch

CHECKPOINT_FILE = "checkpoint.pt"
METRICS_FILE = "metrics.json"
STEP_PREFIX = "step_"


def _step_of(name: str) -> Optional[int]:
    if name.startswith(STEP_PREFIX) and name[len(STEP_PREFIX):].isdigit():
        return int(name[len(STEP_PREFIX):])
    return None


def list_steps(directory: str) -> List[int]:
    """The steps saved under `directory`, ascending."""
    if not osp.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        step = _step_of(name)
        if step is not None and osp.isfile(osp.join(directory, name, CHECKPOINT_FILE)):
            steps.append(step)
    return sorted(steps)


def read_step_dir(path: str) -> Optional[dict]:
    """The saved dict of a `step_N` directory, or of the latest step of a
    checkpoints directory; None when `path` holds neither."""
    if osp.isfile(osp.join(path, CHECKPOINT_FILE)):
        return torch.load(osp.join(path, CHECKPOINT_FILE), map_location="cpu",
                          weights_only=True)
    steps = list_steps(path)
    if not steps:
        return None
    return read_step_dir(osp.join(path, f"{STEP_PREFIX}{steps[-1]}"))


class CheckpointManager:
    """last + best-k checkpoints under `directory`."""

    def __init__(self, directory: str, monitor: str = "val_psnr",
                 mode: str = "max", save_top_k: int = 1):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min': {mode!r}")
        self.directory = osp.abspath(osp.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.max_to_keep = save_top_k + 1

    def _path(self, step: int) -> str:
        return osp.join(self.directory, f"{STEP_PREFIX}{step}")

    def _score(self, metrics: Dict[str, float]) -> float:
        """grlir's best_fn: higher is better in either mode."""
        if self.mode == "max":
            return metrics.get(self.monitor, -math.inf)
        return -metrics.get(self.monitor, math.inf)

    def metrics(self, step: int) -> Dict[str, float]:
        with open(osp.join(self._path(step), METRICS_FILE)) as f:
            return json.load(f)

    def all_steps(self) -> List[int]:
        return list_steps(self.directory)

    def save(self, step: int, state: Dict[str, Any],
             metrics: Optional[dict] = None):
        """state: {"model", "optimizer", "scheduler"} state dicts.  Across
        processes every one calls save with the same state: rank 0 writes,
        and all wait for it, so any may read the checkpoint after."""
        from grlir_torch.parallel.mesh import barrier, world

        if world()[0] == 0:
            self._write(step, state, metrics)
        barrier()

    def _write(self, step: int, state: Dict[str, Any], metrics: Optional[dict]):
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        final = self._path(step)
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"step": int(step), **state, "metrics": metrics},
                   osp.join(tmp, CHECKPOINT_FILE))
        with open(osp.join(tmp, METRICS_FILE), "w") as f:
            json.dump(metrics, f)
        if osp.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._remove_old()

    def _remove_old(self):
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        ranked = sorted(steps, key=lambda s: self._score(self.metrics(s)))
        keep = set(ranked[-self.max_to_keep:])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._path(s))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None) -> dict:
        """The saved dict of a step (the latest by default)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(osp.join(self._path(step), CHECKPOINT_FILE),
                          map_location="cpu", weights_only=True)

    def restore(self, model, optimizer=None, scheduler=None,
                step: Optional[int] = None) -> int:
        """Load a saved step (the latest by default) into the model and, when
        given, the optimizer and the LR scheduler; returns the step."""
        saved = self.load(step)
        model.load_state_dict(saved["model"], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(saved["optimizer"])
        if scheduler is not None:
            scheduler.load_state_dict(saved["scheduler"])
        return int(saved["step"])

    def restore_params_only(self, model, step: Optional[int] = None):
        """Load only the model weights of a saved step (a cross-stage
        hand-off), cast to the model's parameter types."""
        saved = self.load(step)["model"]
        own = model.state_dict()
        model.load_state_dict({k: v.to(own[k].dtype) for k, v in saved.items()},
                              strict=True)
        return model


def find_last_checkpoint_dir(output_path: str) -> Optional[str]:
    """Resume discovery: the checkpoints directory of the latest version_N
    under output_path that holds any checkpoint."""
    if not osp.isdir(output_path):
        return None
    versions = sorted(
        (d for d in os.listdir(output_path)
         if d.startswith("version_") and d[len("version_"):].isdigit()),
        key=lambda d: int(d.split("_")[1]),
        reverse=True,
    )
    for v in versions:
        ckpt_dir = osp.join(output_path, v, "checkpoints")
        if list_steps(ckpt_dir):
            return ckpt_dir
    return None
