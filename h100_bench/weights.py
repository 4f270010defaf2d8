"""Weights made from the seed, on the device, in a few large calls.

Every parameter the cell's reference names (its `param_spec`) is one
slice of one float32 buffer drawn by a single `torch.randn` on a
generator seeded with the run's seed, then scaled and shifted by its
kind's spread and centre (two `repeat_interleave` calls): `KINDS` below,
with the reference's own `KINDS` merged over them.  Both sides get
the same tensors: the program loads them by name, the reference reads
them as they are.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (centre, spread) of each kind of parameter; spreads as GRL's own init
# draws them (Linear 0.02, convolutions at torch's default variance), with
# small random biases and norms so that every parameter takes part, and a
# position-bias MLP whose output varies over the table
KINDS = {
    "linear": (0.0, 0.02),
    "bias": (0.0, 0.02),
    "norm_weight": (1.0, 0.02),
    "norm_bias": (0.0, 0.02),
    "logit_scale": (math.log(10.0), 0.1),
    "cpb_in": (0.0, 0.5),
    "cpb_in_bias": (0.0, 0.5),
    "cpb_out": (0.0, 0.05),
}


def conv_spread(shape) -> float:
    """Spread of torch's default conv init, U(+-1/sqrt(fan_in))."""
    fan_in = math.prod(shape[1:])
    return 1.0 / math.sqrt(3.0 * fan_in)


def make_weights(spec: List[Tuple[str, Tuple[int, ...], str]], seed: int, device,
                 kinds: Dict[str, Tuple[float, float]] = KINDS) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on device} for the (name, shape, kind) of `spec`,
    each kind drawn at its (centre, spread) in `kinds`."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    centre, spread = [], []
    for _, shape, kind in spec:
        if kind == "conv":
            conv = conv_spread(shape)
        # a conv's bias follows its weight in the spec, and takes its spread
        c, s = (0.0, conv) if kind in ("conv", "conv_bias") else kinds[kind]
        centre.append(c)
        spread.append(s)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat.mul_(torch.repeat_interleave(torch.tensor(spread, device=device), counts))
    flat.add_(torch.repeat_interleave(torch.tensor(centre, device=device), counts))
    return {name: t.view(shape) for (name, shape, _), t in
            zip(spec, torch.split(flat, sizes))}


def cell_weights(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of the cell's model, as the cell's reference names them."""
    ref = cell.reference
    return make_weights(ref.param_spec(cell.model()), seed, device,
                        {**KINDS, **getattr(ref, "KINDS", {})})
