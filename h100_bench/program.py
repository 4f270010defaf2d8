"""The program under test, `grlir_torch`, as the cells build it: a GRL of
the cell's configuration with the benchmark's weights loaded by name.
Only this module and the cell modules import the program."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def grl(cell, P: Dict[str, torch.Tensor], device):
    """The port's GRL of `cell`, on device, holding the parameters P."""
    from grlir_torch.models.grl import GRL, GRLConfig

    known = {f.name for f in dataclasses.fields(GRLConfig)}
    m = {k: tuple(v) if isinstance(v, list) else v
         for k, v in cell.model().items() if k in known}
    cfg = GRLConfig(**m, dtype=DTYPES[cell.config["dtype"]], engine=cell.config["engine"])
    model = GRL(cfg, device=device)
    model.load_state_dict(P, strict=True)
    return model


def unrouted_halves() -> int:
    """The port's count of block halves no kernel took (plain attention)."""
    from grlir_torch.ops import block_attn

    return block_attn.unrouted_halves
