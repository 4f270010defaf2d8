"""B3's bf16 route against its plain version over several input draws, with
its error split between the projection and the attention, and the three
stage gates that hold the route (ROADMAP C4).

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
    k, v - plain y|;
  - the stage gates (`stage_failures`): the draw passes or the gates it
    fails.
The inputs are those of the card tests' `_run_window`
(`tests/test_torch_cuda_kernels.py`), seed 6 being theirs.

The stage gates replace a flat end-to-end bound for B3's bf16 route: at
logit scale 100 one bf16 flip of a large q or k value in a near-tied row
moves y by several ulps, so max|kernel - plain| measures how the function
is conditioned as much as the kernel.  `b3_stage_check` runs the route's C
entry and the plain stages on the same inputs; `stage_stats` and
`stage_failures` are the gates' pure-tensor part:
  - attention: attn_err = max|kernel y - plain attention on the kernel's
    own q, k, v| <= ATTN_MAX_ERR;
  - projection: for each of q, k and v, the kernel's bf16 values that
    differ from the float64-summed projection's (flips_kernel) number at
    most FLIP_RATIO times the plain fp32 path's (flips_plain) plus
    FLIP_SLACK, which keeps a draw with a handful of flips from deciding;
  - end to end: e2e_over, the outputs with |kernel y - plain y| > E2E_ATOL,
    are at most E2E_MAX_SHARE of the outputs (e2e_err, their max, is
    printed).
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
SHIFTS = (0, 16)
WINDOW = (32, 32)

ATTN_MAX_ERR = 1e-2    # attention stage: one bf16 ulp is 3.9e-3 to 7.8e-3 at |y| in [1, 2)
FLIP_RATIO, FLIP_SLACK = 2, 16
E2E_ATOL = 1e-2
E2E_MAX_SHARE = 1e-4


def _rand(rng, *shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def draw(seed: int, shift: int, c: int, heads: int, d: int, dev):
    """The inputs of one draw, as the card tests' `_run_window` makes them:
    x (2, 64, 64, c) bf16, w, b, ls, bias and bands (None unshifted)."""
    rng = np.random.default_rng(seed)
    n = WINDOW[0] * WINDOW[1]
    x = _rand(rng, 2, 64, 64, c).to(dev, torch.bfloat16)
    w = _rand(rng, c, 3 * heads * d, std=0.05 * math.sqrt(64 / c)).to(dev)
    b = _rand(rng, 3 * heads * d, std=0.05).to(dev)
    ls = torch.tensor([math.log(10.0), 5.0, 3.0][:heads]).reshape(heads, 1, 1).to(dev)
    bias = 16 * torch.sigmoid(_rand(rng, heads, n, n)).to(dev)
    bands = (torch.from_numpy(rng.integers(0, 3, (4, n)).astype(np.int32)).to(dev)
             if shift else None)
    return x, w, b, ls, bias, bands


def _project64(t, wqkv, bqkv, h, mm, parts):
    p = (t.double() @ wqkv.to(mm).double()).float()
    return ba._split_heads(p if bqkv is None else p + bqkv.float(), parts, h)


def _plain_qkv(x, w, b, ls, shift, heads, project, window=WINDOW):
    """q (unit-normed, times the scale), k (unit-normed) and v of every
    window, rounded to bf16 as B3 rounds them: (B, nW, h, N, d) each."""
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    q, k, v = project(window_partition(x, window), w, b, heads, torch.bfloat16, 3)
    s = ba._scale(ls).reshape(heads, 1, 1)
    return [(ba._unit(q) * s).to(torch.bfloat16).float(),
            ba._unit(k).to(torch.bfloat16).float(), v.to(torch.bfloat16).float()]


def _attend(q, k, v, bias, bands, size, window=WINDOW):
    """B3's attention (`window_half_large_ref` after the projection) on
    rounded q, k, v; NHWC y in rolled coordinates, bf16 values as fp32."""
    a = q @ k.transpose(-1, -2) + bias.to(torch.bfloat16).float()
    if bands is not None:
        a = a + ba._band_mask(bands, bands)
    y = ba._softmax_times(a, v, torch.bfloat16)
    B, nW, h, N, d = y.shape
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nW, N, h * d)
    return window_reverse(y, window, size).to(torch.bfloat16).float()


def stage_stats(kernel_qkv, plain_qkv, plain64_qkv, y_kernel, y_on_kernel,
                y_plain) -> dict:
    """The numbers of the stage gates.  kernel_qkv, plain_qkv, plain64_qkv:
    [q, k, v] as the kernel, the plain fp32 path and the float64-summed
    projection round them (bf16 values, any float type); y_kernel: the
    kernel's y; y_on_kernel: the plain attention on kernel_qkv; y_plain:
    the plain path's y."""
    e = (y_kernel.float() - y_plain.float()).abs()
    return {
        "attn_err": (y_kernel.float() - y_on_kernel.float()).abs().max().item(),
        "flips_kernel": [int((u != r).sum()) for u, r in zip(kernel_qkv, plain64_qkv)],
        "flips_plain": [int((u != r).sum()) for u, r in zip(plain_qkv, plain64_qkv)],
        "e2e_err": e.max().item(),
        "e2e_over": int((e > E2E_ATOL).sum()),
        "outputs": e.numel(),
    }


def stage_failures(st: dict) -> list:
    """The stage gates a `stage_stats` dict fails, as text ([] if none)."""
    fails = []
    if not st["attn_err"] <= ATTN_MAX_ERR:
        fails.append(f"attention stage max|diff| {st['attn_err']:.3e} > {ATTN_MAX_ERR}")
    for part, fk, fp in zip("qkv", st["flips_kernel"], st["flips_plain"]):
        if fk > FLIP_RATIO * fp + FLIP_SLACK:
            fails.append(f"projection: {fk} flips of {part} > {FLIP_RATIO} x {fp} "
                         f"+ {FLIP_SLACK}")
    if not st["e2e_over"] <= E2E_MAX_SHARE * st["outputs"]:
        fails.append(f"end to end: {st['e2e_over']} of {st['outputs']} outputs off by "
                     f"> {E2E_ATOL} (max {st['e2e_err']:.3e})")
    return fails


def stage_line(st: dict) -> str:
    """The gates' numbers and verdict on one line."""
    fails = stage_failures(st)
    return (f"attention {st['attn_err']:.3e} (max {ATTN_MAX_ERR}); q/k/v flips vs float64 "
            f"projection kernel {st['flips_kernel']}, plain {st['flips_plain']} (max "
            f"{FLIP_RATIO} x plain + {FLIP_SLACK}); end to end {st['e2e_over']} of "
            f"{st['outputs']} over {E2E_ATOL} (max {E2E_MAX_SHARE:g} of them), max "
            f"{st['e2e_err']:.3e}: {'pass' if not fails else 'FAIL: ' + '; '.join(fails)}")


def _kernel_qkv_y(x, w, b, ls, bias, bands, shift, heads, window=WINDOW):
    """The bf16 route's C entry called directly (no launch is counted): its
    workspace (q, k, v as it rounds them) and y."""
    B, H, W, C = x.shape
    d, n = w.shape[1] // (3 * heads), window[0] * window[1]
    nW = (H // window[0]) * (W // window[1])
    wt = ba._kernel_w(w, x, (0, 3))
    x, bp, (s,), (bias,), (bands,) = ba._operands(
        x, w, b, [ls], [bias], [bands], bias_dtype=torch.bfloat16, parts=(0, 3))
    ws = torch.empty((B * nW, heads, 3, n, ba._head_cols(d)), dtype=torch.bfloat16,
                     device=x.device)
    y = torch.empty((B, H, W, heads * d), dtype=torch.bfloat16, device=x.device)
    err = cuda_build.library().grlir_window_half_large_mma(
        ba._ptr(x), ba._ptr(wt), ba._ptr(bp), ba._ptr(s), ba._ptr(bias), ba._ptr(bands),
        ba._ptr(ws), ba._ptr(y), B, H, W, C, heads * d, heads, *window, shift, wt.shape[1],
        ba._stream(x))
    cuda_build.check(err, "window_half_large", f"window {window} at d={d}")
    parts = ws.reshape(B, nW, heads, 3, n, -1)[..., :d].float().unbind(3)
    return list(parts), y.float()


def b3_stage_check(x, w, b, ls, bias, bands, shift, heads, window=WINDOW) -> dict:
    """B3's bf16 route split into its stages on one input: x (B, H, W, C)
    bf16 on the card, the other operands as `block_attn.window_half` takes
    them.  Returns `stage_stats`'s numbers, and for the printed line
    spread64 (max|plain y - plain64 y|), flips_vs_plain (the kernel's q, k,
    v values that differ from the plain path's), flips_alone (max|plain
    attention on the kernel's q, k, v - plain y|), top (max|plain y|) and
    values (the values of one part); y and y_plain are the kernel's and the
    plain path's y (bf16 values as fp32, rolled coordinates)."""
    size = tuple(x.shape[1:3])
    with torch.no_grad():
        kqkv, yk = _kernel_qkv_y(x, w, b, ls, bias, bands, shift, heads, window)
        pqkv = _plain_qkv(x, w, b, ls, shift, heads, ba._project, window)
        p64 = _plain_qkv(x, w, b, ls, shift, heads, _project64, window)
        yp = _attend(*pqkv, bias, bands, size, window)
        y64 = _attend(*p64, bias, bands, size, window)
        y_on_k = _attend(*kqkv, bias, bands, size, window)
    st = stage_stats(kqkv, pqkv, p64, yk, y_on_k, yp)
    st.update(spread64=(y64 - yp).abs().max().item(),
              flips_vs_plain=[int((u != v).sum()) for u, v in zip(kqkv, pqkv)],
              flips_alone=(y_on_k - yp).abs().max().item(), top=yp.abs().max().item(),
              values=kqkv[0].numel(), y=yk, y_plain=yp)
    return st


def main() -> int:
    dev = torch.device("cuda")
    failed = 0
    for c, heads, d in SHAPES:
        for seed in SEEDS:
            for shift in SHIFTS:
                st = b3_stage_check(*draw(seed, shift, c, heads, d, dev), shift, heads)
                failed += bool(stage_failures(st))
                print(f"[B3] C {c}, {heads} heads of d {d}, seed {seed}, shift {shift}: "
                      f"kernel vs plain max {st['e2e_err']:.3e} (> 1e-2: "
                      f"{st['e2e_over']} of {st['outputs']}); plain vs plain64 max "
                      f"{st['spread64']:.3e}; q/k/v flips kernel vs plain "
                      f"{st['flips_vs_plain']}, plain64 vs plain {st['flips_plain']} of "
                      f"{st['values']} each; attention alone {st['attn_err']:.3e}; the "
                      f"kernel's flips alone {st['flips_alone']:.3e}; max|plain| "
                      f"{st['top']:.3f}")
                print(f"[B3]   stage gates: {stage_line(st)}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
