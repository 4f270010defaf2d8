"""Task name -> dataset wiring (the port's copy of `grlir.data.module`):
one train loader and one val loader per '+'-joined val dataset.  Across
processes (`grlir_torch.parallel`) the train loader reads this process's
stride of the shared shuffled order, with a pipeline seed of its own;
every process reads the whole of each val set, as grlir's do."""

from __future__ import annotations

from dataclasses import fields
from typing import Optional

from grlir_torch.data.base import TRAIN, VAL
from grlir_torch.data.loader import DataLoader
from grlir_torch.data.tasks import (
    DeblurDataset,
    DemosaicDataset,
    DnDataset,
    JPEGDataset,
    PairedDataset,
    SRDataset,
    TaskConfig,
)
from grlir_torch.parallel.mesh import world

TASK_DATASETS = {
    "dn": DnDataset,
    "sr": SRDataset,
    "jpeg": JPEGDataset,
    "dm": DemosaicDataset,
    "db": DeblurDataset,
    "paired": PairedDataset,
}


def task_config(name: str, shared: dict, section: dict,
                extra: Optional[dict] = None) -> TaskConfig:
    """Build a TaskConfig: shared data_module scalars are inherited by the
    train/val section; section and extra override."""
    known = {f.name for f in fields(TaskConfig)}
    merged = {"name": name}
    for src in (shared, section, extra or {}):
        merged.update({k: v for k, v in src.items() if k in known})
    return TaskConfig(**merged)


class IRDataModule:
    """Builds the train loader and one val loader per val dataset."""

    def __init__(self, cfg: dict, num_train_samples: int = 0, seed: int = 0):
        self.name = cfg["name"]
        if self.name == "bsr":
            from grlir_torch.data.bsr import BSRDataset as ds_cls
        else:
            ds_cls = TASK_DATASETS[self.name]

        shared = {k: v for k, v in cfg.items()
                  if k not in ("train", "val", "test", "name")}
        self.train_cfg = task_config(self.name, shared, cfg.get("train", {}))
        self.train_dataset = ds_cls(self.train_cfg, TRAIN, num_train_samples)

        self.val_datasets = {}
        val_section = cfg.get("val", {}) or {}
        for ds_name in str(val_section.get("dataset", "")).split("+"):
            if not ds_name:
                continue
            # bsr validates on synthetic SR pairs unless the set is real-world
            # imagery ("realsr")
            if self.name == "bsr" and ds_name != "realsr":
                val_cls, val_task = SRDataset, "sr"
            else:
                val_cls, val_task = ds_cls, self.name
            vc = task_config(val_task, shared, val_section, {"dataset": ds_name})
            self.val_datasets[ds_name] = val_cls(vc, VAL)

        self._cfg = cfg
        self._seed = seed

    def train_loader(self, batch_size: int, num_workers: int = 2) -> DataLoader:
        # the GIL-bound BSR pipeline runs in worker processes, the cheap
        # decode/crop pipelines on threads (see data/loader.py)
        mode = (self._cfg.get("worker_mode")
                or ("process" if self.name == "bsr" else "thread"))
        return DataLoader(self.train_dataset, batch_size, shuffle=True,
                          drop_last=True, num_workers=num_workers,
                          seed=self._seed, worker_mode=mode, shard=world())

    def val_loaders(self, batch_size: int = 1, num_workers: int = 2):
        return {
            name: DataLoader(ds, batch_size, shuffle=False, drop_last=False,
                             num_workers=num_workers)
            for name, ds in self.val_datasets.items()
        }
