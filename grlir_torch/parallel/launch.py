"""Joining the process group of a multi-process run (counterpart of
`grlir.parallel.launch`).

One process a device.  Set on every process either

- GRLIR_COORDINATOR (host:port of rank 0, joined over `tcp://`),
  GRLIR_NUM_PROCESSES and GRLIR_PROCESS_ID, as for grlir; or
- GRLIR_DISTRIBUTED=1 under torchrun, which sets MASTER_ADDR,
  MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK (`env://`).

With neither, or with a process group already formed (a caller may form
its own first), `init_distributed` does nothing.  The backend is NCCL on
the card and gloo on the CPU.  A group that cannot form raises: no rank
carries on alone.

Usage:
    from grlir_torch.parallel.launch import init_distributed
    device = init_distributed(torch.device("cuda"))
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def local_device(device: torch.device, process_id: int) -> torch.device:
    """This process's device: a CUDA device without an index becomes
    cuda:$LOCAL_RANK when that is set, else cuda:(process_id mod the
    visible devices)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = _int_env("LOCAL_RANK")
    if local is None:
        local = process_id % torch.cuda.device_count()
    return torch.device("cuda", local)


def init_distributed(device, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> torch.device:
    """Join the process group that the arguments or the environment
    describe (see the module's docstring) and return the device this
    process runs on; return `device` unchanged when there is no group to
    join or one exists already."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        return device
    coordinator = coordinator or os.environ.get("GRLIR_COORDINATOR")
    num_processes = num_processes or _int_env("GRLIR_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("GRLIR_PROCESS_ID")
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("GRLIR_COORDINATOR needs GRLIR_NUM_PROCESSES and "
                             "GRLIR_PROCESS_ID")
        init_method = f"tcp://{coordinator}"
    elif os.environ.get("GRLIR_DISTRIBUTED") == "1":
        init_method = "env://"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA device is available")
    device = local_device(device, process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return device


def per_host_batch(global_batch: int) -> int:
    """This process's rows of a global batch: global batch = processes x
    rows a process, as in grlir."""
    from grlir_torch.parallel.mesh import world

    n = world()[1]
    assert global_batch % n == 0, (global_batch, n)
    return global_batch // n
