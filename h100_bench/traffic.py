"""The one generator of traffic: a mix file's parameters in, requests out.

A serving mix ("kind": "serve") lists LR shapes (h, w); the requests walk
them in blocks, each block every shape once, in the file's order
("order": "cycle") or in a permutation drawn from the seed for each block
("order": "permuted_blocks"), so that every seed serves the same mix and
only the order changes.  Each request takes the next of the shape's
`pool` images, round robin.  A training mix ("kind": "train") gives the
batch, the LR patch, the scale and the pool of pairs each step takes its
rows from.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def requests(mix: dict, seed: int) -> Iterator[Tuple[int, int]]:
    """(shape index, pool index) of every request, without end."""
    n = len(mix["shapes"])
    rng = np.random.default_rng(seed)
    served = [0] * n
    while True:
        block = (rng.permutation(n) if mix["order"] == "permuted_blocks"
                 else range(n))
        for s in block:
            yield int(s), served[s] % mix["pool"]
            served[s] += 1


def step_rows(mix: dict, step: int) -> slice:
    """The pool rows of a training step: consecutive batches, wrapping."""
    b = mix["batch"]
    start = (step * b) % mix["pool"]
    return slice(start, start + b)
