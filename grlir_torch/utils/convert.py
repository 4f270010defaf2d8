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


# ---- the GAN path's networks: discriminators, VGG19, LPIPS

# leaf of a flax variable tree -> the port's parameter or buffer name
_VARIABLE_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                    "mean": "running_mean", "var": "running_var", "u": "u"}


def jax_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax variable tree of grlir's discriminators, VGG or LPIPS
    ({'params': ..., 'spectral': ..., 'batch_stats': ...}, leaves numpy
    arrays) -> the port module's state dict: module path joined by '.',
    Conv kernels (kh, kw, I, O) -> (O, I, kh, kw), Dense kernels
    transposed, BatchNorm scale/mean/var -> weight/running_mean/running_var,
    the spectral `u` as is, a bare parameter (LPIPS' lin<i>) under its own
    name."""
    out = {}
    for path, value in _flatten(variables):
        a = np.array(value, dtype=np.float32)
        body, leaf = path[1:-1], path[-1]
        if leaf == "kernel":
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
        name = _VARIABLE_LEAVES.get(leaf, leaf)
        out[".".join((*body, name))] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def convert_unet_discriminator(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's UNetDiscriminatorSN state dict (torch spectral_norm:
    `weight_orig`, `weight_u`, `weight_v`; conv0/conv9 plain) -> the port's
    (`weight`, `u`)."""
    out = {}
    for k, v in state_dict.items():
        t = torch.as_tensor(np.asarray(v, np.float32))
        if k.endswith(".weight_orig"):
            out[k[: -len("_orig")]] = t
        elif k.endswith(".weight_u"):
            out[k[: -len("weight_u")] + "u"] = t
        elif not k.endswith(".weight_v"):
            out[k] = t
    return out


def _torchvision_convs(names, features_sd: Mapping) -> Dict[str, torch.Tensor]:
    """{conv name: features.<i>} for a VGG layer-name sequence: torchvision
    indexes `features` in the sequence's order."""
    out = {}
    for i, name in enumerate(names):
        if name.startswith("conv"):
            for leaf in ("weight", "bias"):
                out[f"{name}.{leaf}"] = torch.as_tensor(
                    np.asarray(features_sd[f"features.{i}.{leaf}"], np.float32))
    return out


def convert_vgg_torch_weights(torch_state_dict: Mapping,
                              layer_name_list) -> Dict[str, torch.Tensor]:
    """torchvision vgg19 `features.*` state dict -> the state dict of
    `VGGFeatureExtractor(layer_name_list)` (the convolutions up to its
    deepest layer)."""
    from grlir_torch.models.vgg import VGG19_NAMES

    last = max(VGG19_NAMES.index(n) for n in layer_name_list)
    return _torchvision_convs(VGG19_NAMES[: last + 1], torch_state_dict)


def convert_lpips_torch_weights(lpips_state_dict: Mapping,
                                vgg_features_state_dict: Mapping) -> dict:
    """The official LPIPS `.pth` (lin layers) and torchvision's vgg16
    `features` state dict -> grlir's parameter tree {'params': {conv:
    {'kernel', 'bias'}, 'lin<i>': (C,)}} of numpy arrays, the tree that
    `save_lpips_params` writes and both packages read."""
    from grlir_torch.metrics.lpips import LPIPS_TAPS, VGG16_NAMES

    params: Dict[str, object] = {}
    for key, t in _torchvision_convs(VGG16_NAMES, vgg_features_state_dict).items():
        name, leaf = key.split(".")
        a = t.numpy()
        params.setdefault(name, {})["kernel" if leaf == "weight" else "bias"] = (
            a.transpose(2, 3, 1, 0) if leaf == "weight" else a)
    for i in range(len(LPIPS_TAPS)):
        key = f"lins.{i}.model.1.weight"
        if key not in lpips_state_dict:
            key = f"lin{i}.model.1.weight"
        params[f"lin{i}"] = np.asarray(lpips_state_dict[key], np.float32).reshape(-1)
    return {"params": params}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.pth`/`.ckpt` file's state dict (its "state_dict" entry where it
    has one) on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("state_dict", ckpt)
