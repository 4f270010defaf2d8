"""Device time of the kernels by CUDA kernel (B1-B4 on their tensor-core
routes, B5-B7), and the device-busy share of the GRL-S and GRL-base
forwards.

    python3 -m grlir_torch.profile_b4

Runs on the card in bf16, the served route, under `torch.profiler`, with
inputs random from seed 0:

  B3  `window_half_large` at GRL-base x4 SR 256^2 (window 32, one image,
      shifted by 16 with band ids), 3 heads of d = 30, C = 180;
  B4  its two steps (`stripe_a2w_large`, then `stripe_w2a_large`) at
      GRL-base's eval shapes: x4 SR at 256^2 (stripes 64x64, df 2, one
      image) and its denoising tile (stripes 64x128, two images), stripes
      shifted by half with band ids;
  B2  `stripe_half` at GRL-S x4 256^2 (vertical stripes 64x8, df 4,
      shifted with band ids), 2 heads of d = 32, C = 128;
  B1  `window_half` at GRL-S x4 256^2 (window 8, shifted by 4 with band
      ids), 2 heads of d = 32, C = 128;
  B5-B7 at the shapes of chip_smoke.py's timing rows (GRL-S, 2 heads of
      d = 32): B5 `flash_rect_attention` on the 256^2 H stripes' w2a and
      a2w steps (8x64 stripes, shifted), B6 `fused_window_attention_qkv` and B7b
      `fused_cosine_attention_packed` (P 4) on the 256^2 windows (shifted),
      B7a `fused_cosine_attention` on the 128^2 H stripes' w2a step
      (shifted);
  B5 at GRL-base's eval shapes, x4 SR 256^2, 3 heads of d = 30, with band
      ids: window 32 shifted by 16, and the 64x64 stripes' a2w (1024
      anchors against 4096 tokens) and w2a steps at df 2;
  GRL-S x4 256^2 bs1 forward and GRL-base x4 256^2 bs1 forward at its
      released eval geometry (window 32, stripes 64x64, df 2), engine v3,
      and GRL-base's with engine fused (B5 on every half), random weights
      from seed 0: the device-busy share, the CUDA kernel time of profiled
      forwards over the wall time of as many forwards run without the
      profiler.

Prints, for each, every CUDA kernel's device time a call (a B4 step: a2w
and w2a averaged), then the card's nvidia-smi name and power limit.  Needs
a CUDA device.  It imports only what the port had before B2 and B3 gained
their tensor-core routes, so it runs against an older tree too
(`PYTHONPATH=<tree> python3 <this file>`).
"""

from __future__ import annotations

import math
import subprocess
import sys
import time
from dataclasses import replace

import torch
from torch.profiler import ProfilerActivity, profile

from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL, geometry_tensors, init_weights
from grlir_torch.ops import attention as tatt
from grlir_torch.ops import block_attn as ba
from grlir_torch.ops import flash_attention as tfa

CALLS = 5


def device_us(evt) -> float:
    """Self device time of a profiler average, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    raise AttributeError("profiler event without a device time")


def profiled(fn, calls: int):
    """Run fn once, then `calls` times under the profiler: (CUDA kernel rows
    (us, name, count), wall seconds of the profiled calls)."""
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    # kernels only: an operator's row repeats the time of the kernels it
    # launched
    rows = [(device_us(e), e.key, e.count) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return rows, wall


def report(label: str, fn, per: int, unit: str) -> None:
    """Print the device time a `unit` (`per` of them a call of fn) by
    kernel: each kernel's time a launch times its launches a call (its
    launches over the calls, rounded up) over `per`, so that a call whose
    events the profiler dropped counts for nothing rather than for zero."""
    rows, _ = profiled(fn, CALLS)
    rows = [(t / count * math.ceil(count / CALLS) / per, key, count) for t, key, count in rows]
    print(f"[profile_b4] {label}: {sum(t for t, _, _ in rows) / 1e3:.4f} ms of device time a "
          f"{unit} ({per * CALLS} {unit}s)")
    for t, key, count in sorted(rows, reverse=True):
        print(f"[profile_b4]   {t / 1e3:.4f} ms a {unit}  {count:4d} calls  {key[:90]}")


def forward_busy(label: str, cfg, hw: int, dev, g, engine: str = "v3") -> None:
    """Print the device-busy share of a bs1 bf16 forward of cfg with the
    given engine on a random hw x hw image, and its largest kernels."""
    model = init_weights(GRL(replace(cfg, dtype=torch.bfloat16, engine=engine)),
                         torch.Generator().manual_seed(0)).eval().to(dev)
    lr = torch.rand(1, hw, hw, 3, generator=g).to(dev)
    with torch.no_grad():
        for _ in range(2):
            model(lr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            model(lr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, wall_prof = profiled(lambda: model(lr), CALLS)
    busy = sum(t for t, _, _ in rows) / 1e6
    print(f"[profile_b4] {label} forward, engine {engine}: "
          f"{busy / CALLS * 1e3:.3f} ms of CUDA kernel time (profiled) and "
          f"{wall / CALLS * 1e3:.3f} ms of wall time (not profiled; {wall_prof / CALLS * 1e3:.3f} "
          f"profiled) a forward, {CALLS} forwards each: device busy {100 * busy / wall:.1f}% "
          f"({100 * busy / wall_prof:.1f}% of the profiled wall), "
          f"{sum(c for _, _, c in rows) // CALLS} kernels a forward")
    for t, key, count in sorted(rows, reverse=True)[:8]:
        print(f"[profile_b4]   {t / CALLS / 1e3:.4f} ms a forward  {count:5d} calls  {key[:90]}")


def fused_kernels(cfg, geom, geom128, rnd) -> None:
    """B5, B6, B7a and B7b at chip_smoke.py's timing shapes, bf16."""
    heads = cfg.num_heads_window[0]
    d = cfg.embed_dim // 2 // heads
    ls = torch.tensor([math.log(10.0), 5.0], device=geom["bands_w"].device)
    ls = ls.reshape(heads, 1, 1)

    def dense(bq, bk):
        return torch.where(bq[:, :, None] != bk[:, None, :], -100.0, 0.0)

    bw = geom["bands_w"]
    nw, n = bw.shape
    bias = 16 * torch.sigmoid(rnd(heads, n, n))
    qkv = rnd(1, nw, 3 * heads * d, n, std=0.25).bfloat16()
    report("B6 fused_window_attention_qkv, GRL-S 256^2 windows (8, 8) shift 4",
           lambda: tatt.fused_window_attention_qkv(qkv, ls, bias, heads, bw), 1, "call")
    q, k, v = (rnd(1, nw, heads, n, d, std=sd).bfloat16() for sd in (1.0, 1.0, 0.25))
    mask = dense(bw, bw)
    report("B7b fused_cosine_attention_packed, GRL-S 256^2 windows (8, 8) shift 4, P 4",
           lambda: tatt.fused_cosine_attention_packed(q, k, v, ls, bias, mask, pack=4), 1,
           "call")
    bs, bsa = geom128["bands_sh"], geom128["bands_sh_a"]
    (ns, n1), n2 = bs.shape, bsa.shape[1]
    q, a, x1 = (rnd(1, ns, heads, m, d, std=sd).bfloat16()
                for m, sd in ((n1, 1.0), (n2, 1.0), (n2, 0.25)))
    b2 = 16 * torch.sigmoid(rnd(heads, n1, n2))
    m2 = dense(bs, bsa)
    report("B7a fused_cosine_attention, GRL-S 128^2 H stripes w2a (shifted)",
           lambda: tatt.fused_cosine_attention(q, a, x1, ls, b2, m2), 1, "call")
    bs, bsa = geom["bands_sh"], geom["bands_sh_a"]
    (ns, n1), n2 = bs.shape, bsa.shape[1]
    q, a, x1 = (rnd(1, ns, heads, d, m, std=sd).bfloat16()
                for m, sd in ((n1, 1.0), (n2, 1.0), (n2, 0.25)))
    b2 = 16 * torch.sigmoid(rnd(heads, n1, n2))
    report("B5 flash_rect_attention, GRL-S 256^2 H stripes (8, 64) w2a (shifted)",
           lambda: tfa.flash_rect_attention(q, a, x1, ls, b2, bs, bsa), 1, "call")
    k, v = (rnd(1, ns, heads, d, n1, std=sd).bfloat16() for sd in (1.0, 0.25))
    b1 = 16 * torch.sigmoid(rnd(heads, n2, n1))
    report("B5 flash_rect_attention, GRL-S 256^2 H stripes (8, 64) a2w (shifted)",
           lambda: tfa.flash_rect_attention(a, k, v, ls, b1, bsa, bs), 1, "call")


def flash_base(base, rnd, dev) -> None:
    """B5 at GRL-base's eval shapes (x4 SR 256^2, 3 heads of d = 30), bf16,
    shifted with band ids: window 32 and the 64x64 stripes' two steps."""
    geom = geometry_tensors(base.geometry_config, (256, 256), dev)
    ls = torch.tensor([math.log(10.0), 5.0, 3.0], device=dev).reshape(3, 1, 1)
    bw = geom["bands_w"]
    nw, n = bw.shape
    q, k, v = (rnd(1, nw, 3, 30, n, std=sd).bfloat16() for sd in (1.0, 1.0, 0.25))
    bias = 16 * torch.sigmoid(rnd(3, n, n))
    report("B5 flash_rect_attention, GRL-base 256^2 window (32, 32) shift 16",
           lambda: tfa.flash_rect_attention(q, k, v, ls, bias, bw, bw), 1, "call")
    bs, bsa = geom["bands_sh"], geom["bands_sh_a"]
    (ns, n1), n2 = bs.shape, bsa.shape[1]
    a, x1 = rnd(1, ns, 3, 30, n2).bfloat16(), rnd(1, ns, 3, 30, n2, std=0.25).bfloat16()
    q, k, v = (rnd(1, ns, 3, 30, n1, std=sd).bfloat16() for sd in (1.0, 1.0, 0.25))
    b1, b2 = 16 * torch.sigmoid(rnd(3, n2, n1)), 16 * torch.sigmoid(rnd(3, n1, n2))
    report("B5 flash_rect_attention, GRL-base 256^2 stripe (64, 64) a2w (shifted)",
           lambda: tfa.flash_rect_attention(a, k, v, ls, b1, bsa, bs), 1, "call")
    report("B5 flash_rect_attention, GRL-base 256^2 stripe (64, 64) w2a (shifted)",
           lambda: tfa.flash_rect_attention(q, a, x1, ls, b2, bs, bsa), 1, "call")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_b4: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    # GRL-base: B3 and B4
    C, Cs, heads, df, hw = 180, 90, 3, 2, 256
    w, b = rnd(C, 3 * Cs, std=0.02), rnd(3 * Cs, std=0.02)
    ls = torch.tensor([math.log(10.0), 5.0, 3.0], device=dev).reshape(heads, 1, 1)
    x = rnd(1, hw, hw, C).bfloat16()
    bias = 16 * torch.sigmoid(rnd(heads, 1024, 1024))
    bands = torch.randint(0, 3, (64, 1024), generator=g, dtype=torch.int32).to(dev)
    report("B3 window_half_large, GRL-base x4 SR 256^2 (window 32, shift 16)",
           lambda: ba.window_half_large(x, w, b, ls, bias, (32, 32), bands=bands, shift=16),
           1, "call")
    for label, batch, stripe in (("GRL-base x4 SR 256^2", 1, (64, 64)),
                                 ("GRL-base dn tile 2 x 256^2", 2, (64, 128))):
        n1 = stripe[0] * stripe[1]
        n2 = n1 // (df * df)
        nw = (hw // stripe[0]) * (hw // stripe[1])
        x = rnd(batch, hw, hw, C).bfloat16()
        anchor = rnd(batch, hw // df, hw // df, Cs).bfloat16()
        b1 = (16 * torch.sigmoid(rnd(heads, n2, n1))).bfloat16()
        b2 = (16 * torch.sigmoid(rnd(heads, n1, n2))).bfloat16()
        bands = torch.randint(0, 3, (nw, n1), generator=g, dtype=torch.int32).to(dev)
        bands_a = torch.randint(0, 3, (nw, n2), generator=g, dtype=torch.int32).to(dev)
        kw = dict(bands=bands, bands_a=bands_a, shift=(stripe[0] // 2, stripe[1] // 2))

        def steps():
            x1 = ba.stripe_a2w_large(x, anchor, w, b, ls, b1, stripe, df, **kw)
            return ba.stripe_w2a_large(x, anchor, x1, w, b, ls, b2, stripe, df, **kw)

        report(f"B4 {label}", steps, 2, "step")

    # GRL-S: B2 and the forward
    cfg = zoo.GRL_SMALL
    C, heads, df = cfg.embed_dim, cfg.num_heads_stripe[0], cfg.anchor_window_down_factor
    Cs, stripe = C // 2, (64, 8)
    n1, n2 = stripe[0] * stripe[1], (stripe[0] // df) * (stripe[1] // df)
    nw = (hw // stripe[0]) * (hw // stripe[1])
    w, b = rnd(C, 3 * Cs, std=0.02), rnd(3 * Cs, std=0.02)
    ls1 = torch.tensor([math.log(10.0), 5.0], device=dev).reshape(heads, 1, 1)
    ls2 = torch.tensor([math.log(12.0), 4.0], device=dev).reshape(heads, 1, 1)
    x = rnd(1, hw, hw, C).bfloat16()
    anchor = rnd(1, hw // df, hw // df, Cs).bfloat16()
    b1, b2 = 16 * torch.sigmoid(rnd(heads, n2, n1)), 16 * torch.sigmoid(rnd(heads, n1, n2))
    bands = torch.randint(0, 3, (nw, n1), generator=g, dtype=torch.int32).to(dev)
    bands_a = torch.randint(0, 3, (nw, n2), generator=g, dtype=torch.int32).to(dev)
    report("B2 stripe_half, GRL-S x4 256^2 (stripes 64x8, shift (32, 4))",
           lambda: ba.stripe_half(x, anchor, w, b, ls1, ls2, b1, b2, stripe, df, bands=bands,
                                  bands_a=bands_a, shift=(32, 4)), 1, "call")
    geom = geometry_tensors(cfg.geometry_config, (hw, hw), dev)
    x = rnd(1, hw, hw, C).bfloat16()
    bias_w = 16 * torch.sigmoid(rnd(heads, 64, 64))
    report("B1 window_half, GRL-S x4 256^2 (window 8, shift 4)",
           lambda: ba.window_half(x, w, b, ls1, bias_w, (8, 8), bands=geom["bands_w"],
                                  shift=4), 1, "call")
    fused_kernels(cfg, geom, geometry_tensors(cfg.geometry_config, (128, 128), dev), rnd)
    forward_busy(f"GRL-S x4 {hw}^2 bs1 bf16", cfg, hw, dev, g)
    base = zoo.make_config("base", task="sr", upscale=4, window_size=32,
                           anchor_window_down_factor=2, stripe_size=(64, 64),
                           stripe_groups=(None, None))
    forward_busy(f"GRL-base x4 {hw}^2 bs1 bf16", base, hw, dev, g)
    flash_base(base, rnd, dev)
    forward_busy(f"GRL-base x4 {hw}^2 bs1 bf16", base, hw, dev, g, engine="fused")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
