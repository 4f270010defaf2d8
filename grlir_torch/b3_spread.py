"""B3's bf16 route against its plain version over several input draws, with
its error split between the projection and the attention (ROADMAP C4).

    python3 -m grlir_torch.b3_spread

On a CUDA device, for each draw (a seed, a shift) at window 32 on 2 x 64^2
tokens, one line with:
  - max|kernel - plain| of y, and how many outputs exceed 1e-2;
  - max|plain - plain64|, plain64 being the plain version with its
    projection summed in float64 (two faithful orders of the same sums);
  - flips: how many bf16 values of q, k and v (the kernel's workspace, the
    plain version's, plain64's) differ between kernel and plain, and
    between plain64 and plain;
  - the attention stage alone: max|kernel y - plain attention on the
    kernel's own q, k, v|;
  - the projection's flips alone: max|plain attention on the kernel's q,
    k, v - plain y|.
The inputs are those of the card tests' `_run_window`
(`tests/test_torch_cuda_kernels.py`), seed 6 being theirs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from grlir_torch.ops import block_attn as ba
from grlir_torch.ops import cuda_build
from grlir_torch.ops.layout import window_partition, window_reverse

# (input channels, heads, head dim): GRL-base's window half, two heads of
# d = 64
SHAPES = ((64, 3, 30), (128, 2, 64))
SEEDS = (6, 16, 26)
WINDOW = (32, 32)


def _rand(rng, *shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _project64(t, wqkv, bqkv, h, mm, parts):
    p = (t.double() @ wqkv.to(mm).double()).float()
    return ba._split_heads(p if bqkv is None else p + bqkv.float(), parts, h)


def _plain_qkv(x, w, b, ls, shift, heads, project):
    """q (unit-normed, times the scale), k (unit-normed) and v of every
    window, rounded to bf16 as B3 rounds them: (B, nW, h, N, d) each."""
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    q, k, v = project(window_partition(x, WINDOW), w, b, heads, torch.bfloat16, 3)
    s = ba._scale(ls).reshape(heads, 1, 1)
    return [(ba._unit(q) * s).to(torch.bfloat16).float(),
            ba._unit(k).to(torch.bfloat16).float(), v.to(torch.bfloat16).float()]


def _attend(q, k, v, bias, bands, size):
    """B3's attention (`window_half_large_ref` after the projection) on
    rounded q, k, v; NHWC y in rolled coordinates, bf16 values as fp32."""
    a = q @ k.transpose(-1, -2) + bias.to(torch.bfloat16).float()
    if bands is not None:
        a = a + ba._band_mask(bands, bands)
    y = ba._softmax_times(a, v, torch.bfloat16)
    B, nW, h, N, d = y.shape
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nW, N, h * d)
    return window_reverse(y, WINDOW, size).to(torch.bfloat16).float()


def _kernel_qkv_y(x, w, b, ls, bias, bands, shift, heads):
    """The bf16 route's C entry called directly: its workspace (q, k, v as
    it rounds them) and y."""
    B, H, W, C = x.shape
    d, n = w.shape[1] // (3 * heads), WINDOW[0] * WINDOW[1]
    nW = (H // WINDOW[0]) * (W // WINDOW[1])
    wt = ba._kernel_w(w, x, (0, 3))
    x, bp, (s,), (bias,), (bands,) = ba._operands(
        x, w, b, [ls], [bias], [bands], bias_dtype=torch.bfloat16, parts=(0, 3))
    ws = torch.empty((B * nW, heads, 3, n, ba._head_cols(d)), dtype=torch.bfloat16,
                     device=x.device)
    y = torch.empty((B, H, W, heads * d), dtype=torch.bfloat16, device=x.device)
    err = cuda_build.library().grlir_window_half_large_mma(
        ba._ptr(x), ba._ptr(wt), ba._ptr(bp), ba._ptr(s), ba._ptr(bias), ba._ptr(bands),
        ba._ptr(ws), ba._ptr(y), B, H, W, C, heads * d, heads, *WINDOW, shift, wt.shape[1],
        ba._stream(x))
    cuda_build.check(err, "window_half_large", f"window {WINDOW} at d={d}")
    parts = ws.reshape(B, nW, heads, 3, n, -1)[..., :d].float().unbind(3)
    return list(parts), y.float()


def main() -> None:
    dev = torch.device("cuda")
    n = WINDOW[0] * WINDOW[1]
    for c, heads, d in SHAPES:
        for seed in SEEDS:
            for shift in (0, 16):
                rng = np.random.default_rng(seed)
                x = _rand(rng, 2, 64, 64, c).to(dev, torch.bfloat16)
                w = _rand(rng, c, 3 * heads * d, std=0.05 * math.sqrt(64 / c)).to(dev)
                b = _rand(rng, 3 * heads * d, std=0.05).to(dev)
                ls = torch.tensor([math.log(10.0), 5.0, 3.0][:heads]).reshape(heads, 1, 1)
                ls = ls.to(dev)
                bias = 16 * torch.sigmoid(_rand(rng, heads, n, n)).to(dev)
                bands = (torch.from_numpy(rng.integers(0, 3, (4, n)).astype(np.int32)).to(dev)
                         if shift else None)
                size = tuple(x.shape[1:3])
                with torch.no_grad():
                    kqkv, yk = _kernel_qkv_y(x, w, b, ls, bias, bands, shift, heads)
                    pqkv = _plain_qkv(x, w, b, ls, shift, heads, ba._project)
                    p64 = _plain_qkv(x, w, b, ls, shift, heads, _project64)
                    yp = _attend(*pqkv, bias, bands, size)
                    y64 = _attend(*p64, bias, bands, size)
                    y_on_k = _attend(*kqkv, bias, bands, size)
                flips_k = [int((u != v).sum()) for u, v in zip(kqkv, pqkv)]
                flips_64 = [int((u != v).sum()) for u, v in zip(p64, pqkv)]
                e = (yk - yp).abs()
                print(f"[B3] C {c}, {heads} heads of d {d}, seed {seed}, shift {shift}: "
                      f"kernel vs plain max {e.max().item():.3e} (> 1e-2: "
                      f"{(e > 1e-2).sum().item()} of {e.numel()}); plain vs plain64 max "
                      f"{(y64 - yp).abs().max().item():.3e}; q/k/v flips kernel vs plain "
                      f"{flips_k}, plain64 vs plain {flips_64} of {kqkv[0].numel()} each; "
                      f"attention alone {(yk - y_on_k).abs().max().item():.3e}; the kernel's "
                      f"flips alone {(y_on_k - yp).abs().max().item():.3e}; max|plain| "
                      f"{yp.abs().max().item():.3f}")


if __name__ == "__main__":
    main()
