"""Static attention geometry of GRL: relative-coordinate tables, position
indices and shift-band ids, as numpy arrays of static shapes.

The port's own copy of what it uses from `grlir.ops.geometry`; the tests
hold the two equal array for array.  Built on the host once per padded
input size; the model turns the arrays into tensors on its device.  The
one-hot bias factors of the JAX version are left out: the port gathers the
bias by index.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Optional, Sequence, Tuple

import numpy as np

Size2 = Tuple[int, int]


def get_stripe_info(
    stripe_size_in: Sequence[Optional[int]],
    stripe_groups_in: Sequence[Optional[int]],
    stripe_shift: bool,
    input_resolution: Size2,
) -> Tuple[Size2, Size2]:
    """Per-axis stripe size and shift.  A None group means a fixed stripe
    extent on that axis; otherwise the stripe spans resolution // groups."""
    stripe_size, shift_size = [], []
    for s, g, d in zip(stripe_size_in, stripe_groups_in, input_resolution):
        if g is None:
            stripe_size.append(s)
            shift_size.append(s // 2 if stripe_shift else 0)
        else:
            stripe_size.append(d // g)
            shift_size.append(0 if g == 1 else d // (g * 2))
    return tuple(stripe_size), tuple(shift_size)


def _region_id_1d(length: int, window: int, shift: int) -> np.ndarray:
    """Shift-band id of each coordinate along one axis: 0 in the bulk, 1 in
    the partly wrapped band, 2 in the wrapped band (2 everywhere when
    shift is 0, as the reference's slice(-0, None) covers the axis)."""
    ids = np.zeros(length, dtype=np.int64)
    ids[length - window:] = 1
    if shift > 0:
        ids[length - shift:] = 2
    else:
        ids[:] = 2
    return ids


def fill_window(input_resolution: Size2, window_size: Size2,
                shift_size: Size2) -> np.ndarray:
    """(num_windows, prod(window_size)) band id 3 * band(h) + band(w) of
    every token, windows row-major."""
    H, W = input_resolution
    ids = (3 * _region_id_1d(H, window_size[0], shift_size[0])[:, None]
           + _region_id_1d(W, window_size[1], shift_size[1])[None, :])
    nH, nW = H // window_size[0], W // window_size[1]
    ids = ids.reshape(nH, window_size[0], nW, window_size[1])
    return ids.transpose(0, 2, 1, 3).reshape(nH * nW, prod(window_size))


def get_relative_coords_table(window_size: Size2,
                              pretrained_window_size: Size2 = (0, 0),
                              anchor_window_down_factor: int = 1) -> np.ndarray:
    """(1, Th, Tw, 2) log-scaled relative coordinates, Th = wh + wh/df - 1,
    Tw = ww + ww/df - 1."""
    ws = window_size
    aws = [w // anchor_window_down_factor for w in window_size]
    pws = pretrained_window_size
    paws = [w // anchor_window_down_factor for w in pretrained_window_size]

    ts_p = [w1 - 1 - (w1 - w2) // 2 for w1, w2 in zip(ws, aws)]
    ts_n = [-(w2 - 1) - (w1 - w2) // 2 for w1, w2 in zip(ws, aws)]
    pts = [w1 - 1 - (w1 - w2) // 2 for w1, w2 in zip(pws, paws)]

    coord_h = np.arange(ts_n[0], ts_p[0] + 1, dtype=np.float64)
    coord_w = np.arange(ts_n[1], ts_p[1] + 1, dtype=np.float64)
    table = np.stack(np.meshgrid(coord_h, coord_w, indexing="ij"), axis=-1)[None]
    denom = [pts[0], pts[1]] if pts[0] > 0 else [ts_p[0], ts_p[1]]
    table[..., 0] /= denom[0]
    table[..., 1] /= denom[1]
    table *= 8
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8)
    return table.astype(np.float32)


def _meshgrid_coords(end: Size2) -> np.ndarray:
    ch, cw = np.arange(end[0]), np.arange(end[1])
    return np.stack(np.meshgrid(ch, cw, indexing="ij")).reshape(2, -1)


def get_relative_position_index(window_size: Size2,
                                anchor_window_down_factor: int = 1,
                                window_to_anchor: bool = True) -> np.ndarray:
    """Flat table index of every (window token, anchor token) pair, int32,
    (N_window, N_anchor) when window_to_anchor else transposed."""
    ws = window_size
    aws = [w // anchor_window_down_factor for w in window_size]
    max_diff = aws[1] + ws[1] - 1
    if window_to_anchor:
        c1, c2, offset = _meshgrid_coords(ws), _meshgrid_coords(aws), aws
    else:
        c1, c2, offset = _meshgrid_coords(aws), _meshgrid_coords(ws), ws
    coords = (c1[:, :, None] - c2[:, None, :]).transpose(1, 2, 0).copy()
    coords[:, :, 0] += offset[0] - 1
    coords[:, :, 1] += offset[1] - 1
    coords[:, :, 0] *= max_diff
    return coords.sum(-1).astype(np.int32)


@dataclass(frozen=True)
class GeometryConfig:
    """Static attention-geometry hyperparameters of a GRL network."""

    window_size: Size2
    stripe_size: Tuple[Optional[int], Optional[int]]
    stripe_groups: Tuple[Optional[int], Optional[int]]
    anchor_window_down_factor: int = 1
    pretrained_window_size: Size2 = (0, 0)
    pretrained_stripe_size: Size2 = (0, 0)

    @property
    def pad_size(self) -> int:
        """Spatial sizes must be multiples of this."""
        max_ss = max(0 if s is None else s for s in self.stripe_size)
        max_sg = max(0 if g is None else g for g in self.stripe_groups)
        max_sg *= self.anchor_window_down_factor
        return max(self.window_size[0], self.window_size[1], max_ss, max_sg)


def build_geometry_compact(cfg: GeometryConfig, x_size: Size2) -> dict:
    """Tables, indices and shift-band ids for one padded resolution: the
    window ("w"), horizontal-stripe ("sh") and vertical-stripe ("sv")
    geometries, with anchor<->stripe ("a2w"/"w2a") index pairs.  A shift
    mask is -100 where the band ids of its two tokens differ."""
    ss, sss = get_stripe_info(cfg.stripe_size, cfg.stripe_groups, True, x_size)
    sv, svs = get_stripe_info(cfg.stripe_size[::-1], cfg.stripe_groups[::-1],
                              True, x_size)
    df = cfg.anchor_window_down_factor
    w = cfg.window_size
    shift = tuple(s // 2 for s in w)

    def bands(res, win, sh):
        return fill_window(res, win, sh).astype(np.int32)

    a_res = tuple(s // df for s in x_size)
    return {
        "table_w": get_relative_coords_table(w, cfg.pretrained_window_size),
        "table_sh": get_relative_coords_table(ss, cfg.pretrained_stripe_size, df),
        "table_sv": get_relative_coords_table(sv, cfg.pretrained_stripe_size, df),
        "index_w": get_relative_position_index(w),
        "index_sh_a2w": get_relative_position_index(ss, df, False),
        "index_sh_w2a": get_relative_position_index(ss, df, True),
        "index_sv_a2w": get_relative_position_index(sv, df, False),
        "index_sv_w2a": get_relative_position_index(sv, df, True),
        "bands_w": bands(x_size, w, shift),
        "bands_sh": bands(x_size, ss, sss),
        "bands_sh_a": bands(a_res, tuple(s // df for s in ss),
                            tuple(s // df for s in sss)),
        "bands_sv": bands(x_size, sv, svs),
        "bands_sv_a": bands(a_res, tuple(s // df for s in sv),
                            tuple(s // df for s in svs)),
    }
