"""The data-parallel world and its collectives (counterpart of
`grlir.parallel.mesh`).

grlir lays a 1-D `data` mesh over its devices: the batch is sharded over
it, parameters are replicated, and XLA inserts the gradient all-reduce.
The port runs one process a device in a torch.distributed process group
(`grlir_torch.parallel.launch`): a process holds the contiguous block of
rows `shard_rows` gives it, as grlir's batch sharding gives a device its
block, and the trainers call `all_reduce_mean_` on the gradients.

The training stack (the loaders, the steps, the preprocessing, the metric
gather, the checkpoints) reads the world from the process group
(`world()`): every process takes part in every step.  A Restorer shares
its calls across the processes only when given `mesh=make_mesh()`, as
grlir's does, since a process may also run one alone.  Without a process
group every collective returns its input; in a group of one it runs all
the same, an identity on the backend.  grlir's TPU layout helpers
(`replicated`, `batch_sharding`) have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def grouped() -> bool:
    """Whether this process is in a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if grouped():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class Mesh:
    """The processes of a run along grlir's `data` axis, one device each."""

    rank: int
    size: int


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The world as a mesh; n_devices, when given, must be its size (each
    process drives one device)."""
    rank, size = world()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices in a world of {size} "
                         "processes: the port runs one process a device")
    return Mesh(rank, size)


def maybe_initialize_distributed(device="cuda") -> bool:
    """Join the group the environment describes (`launch.init_distributed`),
    a process on `device` (the card unless the caller asks for the CPU);
    True when a process group is active."""
    from grlir_torch.parallel.launch import init_distributed

    init_distributed(device)
    return grouped()


def shard_rows(global_rows: int, rank: Optional[int] = None,
               size: Optional[int] = None) -> slice:
    """The rows of a global batch that `rank` (this process by default)
    holds: the rank-th of `size` equal contiguous blocks."""
    r, n = world()
    rank = r if rank is None else rank
    size = n if size is None else size
    if global_rows % size:
        raise ValueError(f"{global_rows} rows do not split over {size} processes")
    per = global_rows // size
    return slice(rank * per, (rank + 1) * per)


def _on_backend(t: torch.Tensor) -> torch.Tensor:
    """t where the backend takes it: NCCL reduces on this process's card,
    gloo on the CPU or the card."""
    if dist.get_backend() == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor, in place, by its mean over the world: one
    flattened buffer a dtype, summed across the processes, then divided by
    the world size."""
    if not grouped():
        return
    n = world()[1]
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for ts in groups.values():
        flat = _on_backend(torch.cat([t.detach().reshape(-1) for t in ts]))
        dist.all_reduce(flat)
        flat /= n
        i = 0
        for t in ts:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's t (equal shapes) concatenated along the rows, in
    rank order: the global batch of row-sharded tensors."""
    if not grouped():
        return t
    src = _on_backend(t.contiguous())
    out = [torch.empty_like(src) for _ in range(world()[1])]
    dist.all_gather(out, src)
    return torch.cat(out, 0).to(t.device)


def all_gather_ragged(a: np.ndarray) -> List[np.ndarray]:
    """Every process's 1-D array, of any length, in rank order: each is
    padded to the longest and the lengths are gathered beside them."""
    a = np.ascontiguousarray(np.asarray(a).reshape(-1))
    if not grouped():
        return [a]
    n = world()[1]
    length = _on_backend(torch.tensor([a.size], dtype=torch.int64))
    lengths = [torch.empty_like(length) for _ in range(n)]
    dist.all_gather(lengths, length)
    lengths = [int(x.item()) for x in lengths]
    buf = np.zeros(max(lengths), a.dtype)
    buf[:a.size] = a
    src = _on_backend(torch.from_numpy(buf))
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src)
    return [o.cpu().numpy()[:k] for o, k in zip(out, lengths)]


def barrier() -> None:
    """Wait for every process of the group (nothing to wait for without
    one)."""
    if grouped():
        dist.barrier()
