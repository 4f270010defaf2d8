"""Parameter-name mapping and checkpoint helpers for the port.

`flax_path_to_torch_key` maps a JAX parameter path of grlir's GRL to the
reference's torch state_dict key (the port's modules use the reference's
names), `jax_params_to_state_dict` converts a whole JAX parameter tree, and
`strip_prefix` selects a reference checkpoint's model keys.  The port's own
copies of the numpy-only helpers of `grlir.utils.convert`; the tests hold
the key mapping equal to grlir's over whole parameter trees.

Array transforms: Linear kernel (in, out) -> weight (out, in), Conv kernel
(kh, kw, I, O) -> weight (O, I, kh, kw), LayerNorm scale -> weight,
everything else as is.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# Buffer keys the reference strips on load: geometry tables, indices and
# masks, the mean, and trainer metrics.
_BUFFER_RE = re.compile(
    r"(relative_coords_table|relative_position_index|attn_mask"
    r"|(^|\.)table_|(^|\.)index_|(^|\.)mask_|(^|\.)mean$"
    r"|current_val_metric|best_val_metric|best_iter)"
)

# flax submodule name -> torch module path, for names that map one to one
_RENAMES = {
    "conv_before_upsample": "conv_before_upsample.0",  # Sequential(conv, lrelu)
    "cab0": "cab.0",            # CAB: Sequential(conv, GELU, conv, CA)
    "cab2": "cab.2",
    "conv1": "0", "conv2": "2", "conv3": "4",   # 3conv: conv, lrelu, conv, ...
    "depthwise": "0", "pointwise": "2",         # SeparableConv: dw, GELU, pw
}


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """Translate one flax parameter path to the reference torch key."""
    parts = list(path)
    if parts[0] == "params":
        parts = parts[1:]
    leaf, body = parts[-1], parts[:-1]

    out = []
    i = 0
    while i < len(body):
        p = body[i]
        nxt = body[i + 1] if i + 1 < len(body) else None
        m = re.fullmatch(r"(layers|blocks)_(\d+)", p)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}")
        elif re.fullmatch(r"upsample_(\d+)", p):
            out.append(f"upsample.up.{2 * int(p.split('_')[1])}")
        elif p == "anchor" and nxt is not None and (
                nxt in ("reduction", "body") or re.fullmatch(r"body\d+", nxt)):
            # AnchorProjection.body is a ModuleList
            if nxt == "reduction":      # avgpool/maxpool AnchorLinear
                out.append("anchor.body.0.reduction")
            elif nxt == "body":         # one-stage conv projection
                out.append("anchor.body.0")
            else:                       # multi-stage
                out.append(f"anchor.body.{nxt[4:]}")
            i += 1
        elif p == "cpb_mlp":
            # Sequential(linear, relu, linear)
            out.append("cpb_mlp.0" if nxt == "fc1" else "cpb_mlp.2")
            i += 1
        elif p == "ca":
            # ChannelAttention.attention = Sequential(pool, conv, relu, conv,
            # sigmoid), the fourth module of CAB's Sequential
            out.append("cab.3.attention.1" if nxt == "fc1"
                       else "cab.3.attention.3")
            i += 1
        else:
            out.append(_RENAMES.get(p, p))
        i += 1

    key = ".".join(out)
    suffix = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "logit_scale": "logit_scale"}[leaf]
    return f"{key}.{suffix}" if key else suffix


def strip_prefix(state_dict: Mapping, prefix: str = "model.") -> dict:
    """Select keys under a prefix (`model.` / `model_g.` / `model_d.`, or ""
    for all) with the prefix removed, dropping geometry and metric
    buffers."""
    out = {}
    for k, v in state_dict.items():
        if prefix and not k.startswith(prefix):
            continue
        k2 = k[len(prefix):] if prefix else k
        if _BUFFER_RE.search(k2) or _BUFFER_RE.search(k):
            continue
        out[k2] = v
    return out


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
