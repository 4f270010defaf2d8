"""JAX parameter tree -> torch state_dict for the port.

The key mapping is the JAX package's own (`grlir.utils.convert
.flax_path_to_torch_key`); the array transforms invert its `_to_flax`:
Linear kernel (in, out) -> weight (out, in), Conv kernel (kh, kw, I, O) ->
weight (O, I, kh, kw), LayerNorm scale -> weight, everything else as is.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from grlir.utils.convert import flax_path_to_torch_key


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': {...}} or the bare tree, leaves as numpy arrays (or
    anything np.asarray takes) -> {torch key: fp32 tensor}."""
    out = {}
    for path, value in _flatten(params):
        a = np.asarray(value, dtype=np.float32)
        if path[-1] == "kernel":
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
        out[flax_path_to_torch_key(path)] = torch.from_numpy(
            np.ascontiguousarray(a))
    return out
