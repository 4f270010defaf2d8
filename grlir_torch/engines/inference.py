"""Whole-image and overlap-tile inference (counterpart of
`grlir.engines.inference`).

Tiles share one shape and run in fixed-size groups; the overlapping outputs
are averaged on the host.  Given a mesh (`grlir_torch.parallel.mesh`),
each process runs its rows of every group and the outputs are gathered
before the blend, as grlir shards a group over its `data` axis.  On a
CUDA device each padded input shape (a bucket, or a tile group) runs one
CUDA graph of the model's forward, captured at its first call: the port's
counterpart of grlir's jit, compiled once a shape.  The graph replays every kernel of the forward from one
launch, so the host no longer dispatches a thousand operations a forward.
A CPU device runs the forward eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch


def reflect_pad_to(img: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Pad (..., H, W, C) to target (H', W') bottom/right with reflect (edge
    when a pad exceeds the image, numpy's reflect limit).

    INVARIANT: pad an image to its canonical shape in ONE reflect.  GRL's
    stripe attention is global over the padded canvas, so chained pads change
    the restored output everywhere, not only at the borders."""
    h, w = img.shape[-3], img.shape[-2]
    ph, pw = target_hw[0] - h, target_hw[1] - w
    if ph == 0 and pw == 0:
        return img
    if ph < 0 or pw < 0:
        raise ValueError(f"cannot pad {img.shape} to {target_hw}")
    pad = [(0, 0)] * (img.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
    mode = "reflect" if (ph < h and pw < w) else "edge"
    return np.pad(img, pad, mode=mode)


# forwards run eagerly on a side stream before a shape's capture: they
# build and load the kernels, and set up cuBLAS and cuDNN, outside it
WARMUP_FORWARDS = 2


def _release_cuda_generator() -> None:
    """A capture that fails ends before it hands the current device's
    default CUDA generator back, and every later draw from it would raise
    ("Offset increment outside graph capture"): give the generator a fresh
    state with its seed and offset."""
    gen = torch.cuda.default_generators[torch.cuda.current_device()]
    gen.graphsafe_set_state(gen.clone_state())


class _Graph:
    """One captured forward: its static input buffer, the graph, and the
    output tensor each replay rewrites."""

    def __init__(self, static_in, graph, static_out):
        self.static_in = static_in
        self.graph = graph
        self.static_out = static_out


class Restorer:
    """Runs a model on numpy NHWC images, whole or in overlapping tiles.

    model: NHWC tensor in [0, 1] on `device` -> NHWC tensor (a GRL).
    tile=0 runs whole images; shape_bucket pads whole images up to the next
    multiple (one reflect) and crops the output, so assorted sizes share a
    few shapes.  Calls run under torch.no_grad().

    On a CUDA device every padded input shape gets one CUDA graph, captured
    at its first call after WARMUP_FORWARDS eager forwards on a side
    stream; each call copies its input into the graph's static buffer,
    replays the graph and copies the output to the host.  The graphs share
    one memory pool: they replay one after another, and each replay's
    output is copied out before the next.  The model's weights are read
    where they lie on every replay, so a write to them in place is seen by
    the next call.  A capture that fails raises.

    mesh: the processes that share each call (all of them call it with the
    same images): each runs its contiguous rows of every batch or tile
    group, on graphs of its own, and the outputs are all-gathered; tile
    groups then hold max(tile_batch, mesh.size) tiles, and every batch
    must split evenly over the processes."""

    def __init__(self, model: Callable[[torch.Tensor], torch.Tensor],
                 device, scale: int = 1, tile: int = 0,
                 tile_overlap: int = 0, tile_batch: int = 1,
                 shape_bucket: int = 0, mesh=None):
        self.model = model
        self.device = torch.device(device)
        self.scale = scale
        self.tile = tile
        self.tile_overlap = tile_overlap
        # across a mesh's processes a group holds at least a row a process
        self.mesh = mesh
        if mesh is not None:
            tile_batch = max(tile_batch, mesh.size)
        self.tile_batch = tile_batch
        self.shape_bucket = shape_bucket
        # padded input shape -> its captured forward (CUDA only)
        self.graphs: Dict[tuple, _Graph] = {}
        self._pool = None

    def _capture(self, x: torch.Tensor) -> _Graph:
        """Warm up on a side stream, then capture one forward on x's shape."""
        static_in = torch.empty(x.shape, dtype=torch.float32, device=self.device)
        static_in.copy_(x)
        with torch.cuda.device(self.device), torch.no_grad():
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_FORWARDS):
                    self.model(static_in)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool):
                    static_out = self.model(static_in)
            except RuntimeError:
                _release_cuda_generator()
                raise
        return _Graph(static_in, graph, static_out)

    def _run(self, img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
        if self.device.type != "cuda":
            with torch.no_grad():
                return self.model(x.to(self.device)).float().cpu().numpy()
        g = self.graphs.get(tuple(x.shape))
        if g is None:
            g = self.graphs[tuple(x.shape)] = self._capture(x)
        else:
            g.static_in.copy_(x)
        with torch.cuda.device(self.device):
            g.graph.replay()
        return g.static_out.float().cpu().numpy()

    def _apply(self, img: np.ndarray) -> np.ndarray:
        """The model on a batch: all of it, or across the mesh this
        process's rows, gathered."""
        if self.mesh is None:
            return self._run(img)
        from grlir_torch.parallel.mesh import all_gather_rows, shard_rows

        rows = shard_rows(img.shape[0], self.mesh.rank, self.mesh.size)
        y = torch.from_numpy(self._run(img[rows]))
        return all_gather_rows(y).numpy()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img: (B, H, W, C) float32 in [0, 1] -> (B, H*scale, W*scale, C_out)."""
        if self.tile == 0:
            if self.shape_bucket:
                return self._forward_bucketed(img)
            return self._apply(img)
        return self.forward_tile(img)

    def _forward_bucketed(self, img: np.ndarray) -> np.ndarray:
        _, h, w, _ = img.shape
        m = self.shape_bucket
        out = self._apply(reflect_pad_to(img, (h + (-h % m), w + (-w % m))))
        return out[:, :h * self.scale, :w * self.scale]

    def forward_tile(self, img: np.ndarray) -> np.ndarray:
        b, h, w, _ = img.shape
        sf = self.scale
        tile = min(self.tile, h, w)
        stride = tile - self.tile_overlap
        h_idx = list(range(0, h - tile, stride)) + [h - tile]
        w_idx = list(range(0, w - tile, stride)) + [w - tile]
        positions = [(hi, wi) for hi in h_idx for wi in w_idx]

        patches = np.stack([img[i, hi:hi + tile, wi:wi + tile]
                            for hi, wi in positions for i in range(b)])
        group = max(self.tile_batch, 1)
        outs = []
        for s in range(0, patches.shape[0], group):
            chunk = patches[s:s + group]
            pad = group - chunk.shape[0]
            if pad:
                zeros = np.zeros((pad, *chunk.shape[1:]), chunk.dtype)
                chunk = np.concatenate([chunk, zeros], 0)
            y = self._apply(chunk)
            outs.append(y[:group - pad] if pad else y)
        out_patches = np.concatenate(outs, 0)

        E = np.zeros((b, h * sf, w * sf, out_patches.shape[-1]), np.float32)
        Wt = np.zeros_like(E)
        k = 0
        for hi, wi in positions:
            for i in range(b):
                E[i, hi * sf:(hi + tile) * sf, wi * sf:(wi + tile) * sf] += \
                    out_patches[k]
                Wt[i, hi * sf:(hi + tile) * sf, wi * sf:(wi + tile) * sf] += 1.0
                k += 1
        return E / Wt
