"""B1's bf16 route against its plain version over twelve input draws at
GRL-base-bsr's window half, with its error split between the projection
and the attention, and the stage gates of `b3_spread` that hold the route
(ROADMAP C9).

    python3 -m grlir_torch.b1_spread

On a CUDA device, for each draw (a seed, a shift) of the real-world SR
generator's window half at 256^2 (window 16, N = 256, 3 heads of d = 30,
C = 180; the band ids of its shift-8 geometry), one line with
max|kernel - plain| of y and how many outputs exceed 1e-2, the plain
path's own spread against its float64-summed projection, the q/k/v flips,
the attention alone and the kernel's flips alone, then the stage gates'
numbers and verdict (`b3_spread.stage_line`):
  - attention: max|kernel y - plain attention on the kernel's own q, k, v|
    <= 1e-2;
  - projection: the kernel's bf16 values of q, k and v that differ from a
    float64-summed projection's number at most twice the plain fp32
    path's plus 16;
  - end to end: at most 1e-4 of the outputs off by more than 1e-2.
Exits 1 if a draw fails a gate.

B1's tensor-core route (`csrc/window_half.cu` `window_half_mma_kernel`)
keeps q, k and v in shared memory; its C entry `grlir_window_half_mma_qkv`
runs the same launch and also writes them out, so the attention stage can
be held on the kernel's own rounding.  B1 keeps the position bias in fp32,
as the TPU's small-window branch does.  The inputs are drawn as
`chip_smoke.py`'s GRL-base-bsr window cases draw theirs: x N(0, 1), w and
b N(0, 0.02^2), logit scales log 10, 5 and 3 (the second clamped to
log 100), biases 16 sigmoid(N(0, 1)); every value on the CPU from a
generator of the draw's seed.
"""

from __future__ import annotations

import math

import torch

from grlir_torch.b3_spread import (_attend, _plain_qkv, _project64, stage_failures,
                                   stage_line, stage_stats)
from grlir_torch.gan_cells import BSR_G
from grlir_torch.models.grl import geometry_tensors
from grlir_torch.ops import block_attn as ba
from grlir_torch.ops import cuda_build

# twelve draws, fixed before the card run that checks them
SEEDS = (6, 16, 26, 36, 46, 56)
SHIFTS = (0, 8)
HW = (256, 256)
WINDOW = (16, 16)
HEADS, D, C = 3, 30, 180


def draw(seed: int, shift: int, dev):
    """x (1, 256, 256, 180) bf16 and the window half's w, b, ls, bias and
    bands (None unshifted) on dev."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    n = WINDOW[0] * WINDOW[1]
    x = rnd(1, *HW, C).to(torch.bfloat16)
    w, b = rnd(C, 3 * HEADS * D, std=0.02), rnd(3 * HEADS * D, std=0.02)
    ls = torch.tensor([math.log(10.0), 5.0, 3.0], device=dev).reshape(HEADS, 1, 1)
    bias = 16 * torch.sigmoid(rnd(HEADS, n, n))
    bands = None
    if shift:
        assert BSR_G.window_size == WINDOW[0] and shift == WINDOW[0] // 2
        bands = geometry_tensors(BSR_G.geometry_config, HW, dev)["bands_w"]
    return x, w, b, ls, bias, bands


def _kernel_qkv_y(x, w, b, ls, bias, bands, shift, heads, window):
    """The bf16 route's C entry with its q/k/v output (no launch is
    counted): q, k and v as the kernel rounds them, and y."""
    B, H, W, Cx = x.shape
    Cw = w.shape[1] // 3
    d, n = Cw // heads, window[0] * window[1]
    nW = (H // window[0]) * (W // window[1])
    x, bp, (s,), (bias,), (bands,) = ba._operands(x, w, b, [ls], [bias], [bands])
    qkv = torch.zeros((B * nW, heads, 3, n, ba._head_cols(d)), dtype=torch.bfloat16,
                      device=x.device)
    y = torch.empty((B, H, W, Cw), dtype=torch.bfloat16, device=x.device)
    err = cuda_build.library().grlir_window_half_mma_qkv(
        ba._ptr(x), ba._ptr(w), w.stride(0), w.stride(1), int(w.dtype == torch.bfloat16),
        ba._ptr(bp), ba._ptr(s), ba._ptr(bias), ba._ptr(bands), ba._ptr(y), B, H, W, Cx,
        Cw, heads, *window, int(shift), ba._ptr(qkv), ba._stream(x))
    cuda_build.check(err, "window_half", f"window {window} at d={d}")
    parts = qkv.reshape(B, nW, heads, 3, n, -1)[..., :d].float().unbind(3)
    return list(parts), y.float()


def b1_stage_check(x, w, b, ls, bias, bands, shift, heads, window=WINDOW) -> dict:
    """B1's bf16 route split into its stages on one input: x (B, H, W, C)
    bf16 on the card, the other operands as `block_attn.window_half` takes
    them.  Returns what `b3_spread.b3_stage_check` returns: `stage_stats`'s
    numbers, spread64, flips_vs_plain, flips_alone, top, values, and y and
    y_plain (the kernel's and the plain path's y, bf16 values as fp32,
    rolled coordinates)."""
    size = tuple(x.shape[1:3])
    f32 = torch.float32
    with torch.no_grad():
        kqkv, yk = _kernel_qkv_y(x, w, b, ls, bias, bands, shift, heads, window)
        pqkv = _plain_qkv(x, w, b, ls, shift, heads, ba._project, window)
        p64 = _plain_qkv(x, w, b, ls, shift, heads, _project64, window)
        yp = _attend(*pqkv, bias, bands, size, window, f32)
        y64 = _attend(*p64, bias, bands, size, window, f32)
        y_on_k = _attend(*kqkv, bias, bands, size, window, f32)
    st = stage_stats(kqkv, pqkv, p64, yk, y_on_k, yp)
    st.update(spread64=(y64 - yp).abs().max().item(),
              flips_vs_plain=[int((u != v).sum()) for u, v in zip(kqkv, pqkv)],
              flips_alone=(y_on_k - yp).abs().max().item(), top=yp.abs().max().item(),
              values=kqkv[0].numel(), y=yk, y_plain=yp)
    return st


def main() -> int:
    dev = torch.device("cuda")
    failed = 0
    for seed in SEEDS:
        for shift in SHIFTS:
            st = b1_stage_check(*draw(seed, shift, dev), shift, HEADS)
            failed += bool(stage_failures(st))
            print(f"[B1] window {WINDOW}, C {C}, {HEADS} heads of d {D}, seed {seed}, "
                  f"shift {shift}: kernel vs plain max {st['e2e_err']:.3e} (> 1e-2: "
                  f"{st['e2e_over']} of {st['outputs']}); plain vs plain64 max "
                  f"{st['spread64']:.3e}; q/k/v flips kernel vs plain {st['flips_vs_plain']}, "
                  f"plain64 vs plain {st['flips_plain']} of {st['values']} each; attention "
                  f"alone {st['attn_err']:.3e}; the kernel's flips alone "
                  f"{st['flips_alone']:.3e}; max|plain| {st['top']:.3f}")
            print(f"[B1]   stage gates: {stage_line(st)}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
