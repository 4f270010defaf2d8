"""B5's bf16 route against its plain version over twelve input draws at
GRL-base's eval shapes, with its error split between the prologue's unit
norm and the attention, and the stage gates of `b3_spread` that hold the
route (ROADMAP C5).

    python3 -m grlir_torch.b5_spread

On a CUDA device, for each draw (a seed) and each of the three B5 steps of
GRL-base x4 at 256^2 (window 32 shifted by 16; the 64x64 stripes' a2w and
w2a steps at anchor df 2, shifted; 3 heads of d = 30), one line with
max|kernel - plain| of y and how many outputs exceed 1e-2, then the stage
gates' numbers and verdict (`b3_spread.stage_line`):
  - attention: max|kernel y - plain attention on the kernel's own unit q,
    unit k and v| <= 1e-2;
  - prologue: the kernel's bf16 values of unit q and unit k that differ
    from a float64-normed reference number at most twice the plain fp32
    path's plus 16 (v is copied: no flips);
  - end to end: at most 1e-4 of the outputs off by more than 1e-2.
Exits 1 if a draw fails a gate.  A flat bound on the end-to-end error does
not hold the route (ROADMAP C5): at logit scale 100 one bf16 flip of a
unit q or k value in a near-tied row moves y by several ulps, as for B3
(C4).

The inputs are drawn as `chip_smoke.py`'s GRL-base B5 cases draw theirs:
q and k N(0, 1), the values (v, x1) N(0, 0.25^2), biases 16 sigmoid(N(0,
1)), logit scales log 10, 5 and 3 (the second clamped to log 100), the
shift's band ids of the geometry.
"""

from __future__ import annotations

import math

import torch

from grlir_torch.b3_spread import stage_failures, stage_line, stage_stats
from grlir_torch.models import zoo
from grlir_torch.models.grl import geometry_tensors
from grlir_torch.ops import block_attn as ba
from grlir_torch.ops import cuda_build
from grlir_torch.ops import flash_attention as tfa

SEEDS = tuple(range(12))
STEPS = ("window (32, 32) shift 16", "stripe (64, 64) a2w", "stripe (64, 64) w2a")
HW = (256, 256)
HEADS, D = 3, 30
BF16 = torch.bfloat16

# GRL-base x4 at its released eval geometry
CFG = zoo.make_config("base", task="sr", upscale=4, window_size=32,
                      anchor_window_down_factor=2, stripe_size=(64, 64),
                      stripe_groups=(None, None))


def draw(seed: int, dev) -> dict:
    """{step: the operands of `flash_rect_attention`} for one seed, q, k, v
    bf16 on dev; every value drawn on the CPU from a generator of that
    seed."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    def bf(*ts):
        return [t.to(BF16) for t in ts]

    ls = torch.tensor([math.log(10.0), 5.0, 3.0], device=dev).reshape(HEADS, 1, 1)
    geo = geometry_tensors(CFG.geometry_config, HW, dev)
    nw, n = geo["bands_w"].shape
    q, k, v = bf(rnd(1, nw, HEADS, D, n), rnd(1, nw, HEADS, D, n),
                 rnd(1, nw, HEADS, D, n, std=0.25))
    out = {STEPS[0]: (q, k, v, ls, 16 * torch.sigmoid(rnd(HEADS, n, n)),
                      geo["bands_w"], geo["bands_w"])}
    bs, bsa = geo["bands_sh"], geo["bands_sh_a"]
    (ns, n1), n2 = bs.shape, bsa.shape[1]
    a, x1 = bf(rnd(1, ns, HEADS, D, n2), rnd(1, ns, HEADS, D, n2, std=0.25))
    q, k, v = bf(rnd(1, ns, HEADS, D, n1), rnd(1, ns, HEADS, D, n1),
                 rnd(1, ns, HEADS, D, n1, std=0.25))
    out[STEPS[1]] = (a, k, v, ls, 16 * torch.sigmoid(rnd(HEADS, n2, n1)), bsa, bs)
    out[STEPS[2]] = (q, a, x1, ls, 16 * torch.sigmoid(rnd(HEADS, n1, n2)), bs, bsa)
    return out


def _kernel_rows_y(q, k, v, logit_scale, bias, bands_q, bands_k):
    """The bf16 route's C entry called directly (no launch is counted): its
    prologue's rows (unit q, unit k, v token-major, (B, nW, h, N, d) as
    fp32) and y (channel-major, bf16 values as fp32)."""
    B, nW, h, d, N1 = q.shape
    N2 = k.shape[4]
    ld = ba._head_cols(d)
    scale = ba._scale(logit_scale).contiguous()
    bias = bias.to(BF16).contiguous()
    bands = [None if t is None else t.to(torch.int32).contiguous()
             for t in (bands_q, bands_k)]
    ws_q = torch.empty((B * nW * h, N1, ld), dtype=BF16, device=q.device)
    ws_kv = torch.empty((2, B * nW * h, N2, ld), dtype=BF16, device=q.device)
    y = torch.empty_like(q)
    err = cuda_build.library().grlir_flash_rect_attention(
        ba._ptr(q), ba._ptr(k), ba._ptr(v), ba._ptr(scale), ba._ptr(bias),
        ba._ptr(bands[0]), ba._ptr(bands[1]), ba._ptr(ws_q), ba._ptr(ws_kv), ba._ptr(y),
        B * nW, nW, h, d, N1, N2, 1, ba._stream(q))
    cuda_build.check(err, "flash_rect_attention", f"N1={N1}, N2={N2} at d={d}")
    rows = [ws_q, ws_kv[0], ws_kv[1]]
    return ([r[..., :d].reshape(B, nW, h, -1, d).float() for r in rows], y.float())


def _rows(t, norm: str):
    """Channel-major t (B, nW, h, d, N) bf16 as token-major rows, unit-normed
    over d ("fp32": as the plain version, "fp64": summed and scaled in
    float64) or as they are ("none"), rounded to bf16, as fp32."""
    if norm == "fp32":
        t = ba._unit(t.float(), -2)
    elif norm == "fp64":
        u = t.double()
        t = (u / u.square().sum(-2, keepdim=True).clamp_min(1e-24).sqrt()).float()
    return t.to(BF16).float().transpose(-1, -2)


def _attend(q, k, v, logit_scale, bias, bands_q, bands_k):
    """The plain version's attention (`flash_rect_attention_ref` after the
    unit norm) on token-major rows; channel-major y, bf16 values as fp32."""
    h = q.shape[2]
    a = (q @ k.transpose(-1, -2)) * ba._scale(logit_scale).reshape(h, 1, 1) \
        + bias.to(BF16).float()
    if bands_q is not None:
        a = a + ba._band_mask(bands_q, bands_k)
    p = torch.softmax(a, -1).to(BF16).float()
    return (p @ v).to(BF16).float().transpose(-1, -2)


def b5_stage_check(q, k, v, logit_scale, bias, bands_q=None, bands_k=None) -> dict:
    """B5's bf16 route split into its stages on one input (the operands of
    `flash_rect_attention`, q, k, v bf16 on the card).  Returns
    `stage_stats`'s numbers, top (max|plain y|), values (the values of one
    part) and y and y_plain, the kernel's and the plain version's y (bf16
    values as fp32)."""
    args = (logit_scale, bias, bands_q, bands_k)
    with torch.no_grad():
        krows, yk = _kernel_rows_y(q, k, v, *args)
        prows = [_rows(q, "fp32"), _rows(k, "fp32"), _rows(v, "none")]
        rows64 = [_rows(q, "fp64"), _rows(k, "fp64"), prows[2]]
        yp = tfa.flash_rect_attention_ref(q, k, v, *args).float()
        y_on_k = _attend(*krows, *args)
    st = stage_stats(krows, prows, rows64, yk, y_on_k, yp)
    st.update(top=yp.abs().max().item(), values=q.numel(), y=yk, y_plain=yp)
    return st


def main() -> int:
    dev = torch.device("cuda")
    failed = 0
    worst = {s: 0.0 for s in STEPS}
    for seed in SEEDS:
        for step, args in draw(seed, dev).items():
            st = b5_stage_check(*args)
            failed += bool(stage_failures(st))
            worst[step] = max(worst[step], st["e2e_err"])
            print(f"[B5] GRL-base {step}, seed {seed}: kernel vs plain max "
                  f"{st['e2e_err']:.3e} (> 1e-2: {st['e2e_over']} of {st['outputs']}); "
                  f"max|plain| {st['top']:.3f}")
            print(f"[B5]   stage gates: {stage_line(st)}")
    print("[B5] max|kernel - plain| over the draws: "
          + ", ".join(f"{s} {e:.3e}" for s, e in worst.items()))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
