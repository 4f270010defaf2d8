"""Images made from the seed: structured, not noise, so that the windows
and stripes of a forward see edges, gradients and texture as photographs
give them.  Made on the device in a few batched calls.

An image is a smooth random field (coarse noise, bilinearly enlarged), a
few sharp edges (random half-planes of random contrast) and a fine texture,
around mid-grey, clipped to [0, 1].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EDGES = 6


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed (weights, images, order)."""
    hi, lo = np.random.SeedSequence([seed, *tags]).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def structured(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """(n, h, w, 3) float32 images in [0, 1]."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.rand(*shape, generator=g, device=device)

    coarse = torch.randn(n, 3, h // 16 + 2, w // 16 + 2, generator=g, device=device)
    field = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None] / max(h, w)
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :] / max(h, w)
    angle = draw(n, EDGES) * 2 * math.pi
    offset = draw(n, EDGES) * (h + w) / max(h, w) - 0.5
    contrast = (draw(n, EDGES, 3) - 0.5) * 0.3
    side = ((torch.cos(angle)[..., None, None] * ys + torch.sin(angle)[..., None, None] * xs)
            > offset[..., None, None]).float()                       # (n, E, h, w)
    edges = torch.einsum("nehw,nec->nchw", side, contrast)
    texture = torch.randn(n, 3, h, w, generator=g, device=device) * 0.03
    img = 0.45 + 0.12 * field + edges + texture
    return img.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()
