#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (grlir_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its numbers on lines of its own and raising on failure:
  1. device: name, compute capability (must be 9.0), nvidia-smi name/power limit;
  2. build: every CUDA kernel from grlir_torch/csrc (one nvcc per source, all
     at once), timed, with the compiler's register/spill report;
  3. GRL-S x4 (slice 1: B1 `window_half`, B2 `stripe_half`): each kernel vs
     its plain PyTorch version at GRL-S 256^2 shapes, fp32 and bf16; the model
     with kernels vs the plain path (bf16 256^2 by PSNR, fp32 64^2 by max
     |diff|), 16 + 16 launches a forward; serving four bf16 requests through
     the Restorer (its main path: launch counts reset just before, read just
     after), each checked against the plain path; CUDA-event timing;
  4. GRL-base (slice 2: B3 `window_half_large`, B4 `stripe_a2w_large` and
     `stripe_w2a_large`) at its eval geometry (window 32, anchor df 2, stripes
     64x64 for x4 SR and 64x128 for denoising): each kernel vs its plain
     version at the main path's shapes with 3 heads of d = 30, and B1/B2 at
     GRL-base's heads; the x4 model, kernels vs plain (bf16 128^2 by PSNR,
     40 + 40 + 40 launches a forward and none of B1/B2; fp32 64^2); serving
     two SR requests and one tiled denoising request (its main path, counts
     reset just before), each against the plain path; timing of each kernel
     against its plain version and the nearest PyTorch library composition,
     the x4 forward in LR megapixels a second, and the denoising tile.
     Since slice 4 B4's bf16 steps, and since slice 5 B2's and B3's, run on
     tensor cores: every launch of B2, B3 and B4 is counted by route
     (tensor cores for bf16, CUDA cores for fp32), each kernel case checks
     the route it took, and the model, serve and repair phases print the
     counts and check that every bf16 launch took the tensor-core route and
     every fp32 one the CUDA-core route; the bf16 gate of these three is
     max(1e-2, 2 bf16 ulps of max|plain|), printed beside the plain path's
     own spread, but for B3's bf16 route, which is held to the stage gates
     of `grlir_torch.b3_spread` (its attention against the plain attention
     on its own q, k, v within 1e-2; its q, k, v bf16 flips at most twice
     the plain path's plus 16, both counted against a float64-summed
     projection; at most 1e-4 of the outputs off by more than 1e-2 end to
     end);
  5. the fused engines (slice 3: B5 `flash_rect_attention`, B6
     `fused_window_attention_qkv`, B7a `fused_cosine_attention`, B7b
     `fused_cosine_attention_packed`): each kernel vs its plain version at
     the main path's shapes; GRL-S x4 with engine "fused" at 256^2 and 128^2
     (exact launches a forward), engines "window" and "stripe", fp32 64^2,
     and three served requests, each against the plain path; GRL-base at its
     eval geometry with engine "fused" (120 B5 launches a forward, the x4
     256^2 forward timed); the repair of geometries no TPU kernel takes (a
     GRL-base dn 1080x1920 frame restored whole in engine v3, depth cut to
     one stage of four blocks); timing of each kernel.  B5 takes two routes
     by its operands' type, bf16 on tensor cores (B4's attention kernel) and
     fp32 on CUDA cores, counted like B1-B4's: its kernel cases, the fused
     model phases, the served requests and the head-dim-64 blocks check
     that every bf16 launch took the tensor-core route.
  Across the phases, B1's bf16 launches take one fused tensor-core kernel and
  are counted by route like B2-B4 (B1 is gated like them in bf16, at
  GRL-S's, GRL-base's and head dim 64's widths); B1's comparison is shown
  to be real (its launches counted, `got` and `want` distinct storage, its
  output moving with w x 1.001); B6/B7 run one 3xTF32 tensor-core kernel,
  held to fp32's 1e-4 in both input types beside the plain version's own
  spread against a float64 product, also at head dim 64; one block of
  2 + 2 heads of d = 64 per engine at GRL-S's geometry and one at
  GRL-base's, kernels on against off, every half on its kernel (B1-B5 and
  B6/B7 take head dims up to 64); B1-B4 under grad run their kernel
  forward (its output to the bit) and return the plain version's
  gradients.
Every kernel path holds `block_attn.unrouted_halves` at 0.
Then one JSON line of per-kernel results, the nvidia-smi line, and last the
result line.  Exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch
import torch.nn.functional as F

GRL_S_HW = 256
BASE_HW = 256              # GRL-base x4 LR timing size (an eval tile)
BASE_MODEL_HW = 128        # GRL-base x4 bf16 kernels-vs-plain check
BF16_MAX_ERR = 1e-2        # bf16 outputs: a few ulps at |y| < 1
# The bf16 gate of the tensor-core routes (B1, B2, B4), max(BF16_MAX_ERR, 2
# bf16 ulps of max|plain|): their tensor-core sums of the projection round
# k, q and v to bf16 in another order than the plain path, and the clamped
# head's logit scale of 100 turns a one-ulp flip of k or q into about a
# percent of a probability, so y moves by a fraction of the values it
# averages.  Beside it the plain path's own spread is printed: the plain
# path against itself with its projection summed in float64.  B3's bf16
# route is held to the stage gates of grlir_torch.b3_spread instead.
ULP_GATED = ("window_half", "stripe_half", "stripe_a2w_large", "stripe_w2a_large")
FP32_TOL = 1e-4            # fp32: summation order only
MODEL_FP32_MAX_ERR = 5e-4  # whole-model fp32 rounding-order drift
MODEL_MIN_PSNR = 60.0      # bf16 whole model, kernels vs plain
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# FLOP/s by operand type (bf16 on tensor cores, fp32 on CUDA cores); TF32
# on tensor cores, whose three products a 3xTF32 product takes
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12
REPLACES = {
    "window_half": "grlir/ops/pallas/block_attn.py:214",
    "stripe_half": "grlir/ops/pallas/block_attn.py:589",
    "window_half_large": "grlir/ops/pallas/block_attn.py:311",
    "stripe_a2w_large": "grlir/ops/pallas/block_attn.py:1037",
    "stripe_w2a_large": "grlir/ops/pallas/block_attn.py:1104",
    "flash_rect_attention": "grlir/ops/pallas/flash_attention.py:32",
    "fused_window_attention_qkv": "grlir/ops/pallas/attention.py:159",
    "fused_cosine_attention": "grlir/ops/pallas/attention.py:32",
    "fused_cosine_attention_packed": "grlir/ops/pallas/attention.py:308",
}
SOURCES = {
    "window_half": "grlir_torch/csrc/window_half.cu",
    "stripe_half": "grlir_torch/csrc/stripe_half.cu",
    "window_half_large": "grlir_torch/csrc/window_half_large.cu",
    "stripe_a2w_large": "grlir_torch/csrc/stripe_half_large.cu",
    "stripe_w2a_large": "grlir_torch/csrc/stripe_half_large.cu",
    "flash_rect_attention": "grlir_torch/csrc/flash_attention.cu",
    "fused_window_attention_qkv": "grlir_torch/csrc/cosine_attention.cu",
    "fused_cosine_attention": "grlir_torch/csrc/cosine_attention.cu",
    "fused_cosine_attention_packed": "grlir_torch/csrc/cosine_attention.cu",
}
# the operand type each TPU kernel computes its products in, for the bound:
# B1-B5 round their operands to the input type (bf16 here), B6/B7 compute
# in fp32 whatever the input
COMPUTE_TYPE = {k: torch.float32 if k.startswith("fused_") else torch.bfloat16
                for k in REPLACES}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs, warmup) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ab_ms(plain, kernel, runs=20, warmup=5):
    """Plain and kernel times in turns (plain, kernel, kernel, plain)."""
    p1 = time_ms(plain, runs, warmup)
    k1 = time_ms(kernel, runs, warmup)
    k2 = time_ms(kernel, runs, warmup)
    p2 = time_ms(plain, runs, warmup)
    return statistics.median([k1, k2]), statistics.median([p1, p2])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(n_bytes: float, flops: float, dtype):
    """Least time for the work: bytes at the HBM rate or FLOPs at the peak
    rate of the operand type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNEL_KINDS = ("window_half_kernel", "stripe_half_kernel", "project_regions_kernel",
                "anchor_units_kernel", "attend_kernel", "flash_rows_kernel",
                "cosine_tf32_kernel", "mma_attend_kernel", "mma_project_kernel",
                "pad_rows_kernel", "mma_stripe_resident_kernel", "window_half_mma_kernel")
# kernels of the tensor-core routes: bf16 only, not templated on the type
BF16_KINDS = ("mma_attend_kernel", "mma_project_kernel", "pad_rows_kernel",
              "mma_stripe_resident_kernel", "window_half_mma_kernel")


def ptxas_report(log: str):
    """One line per kernel instantiation from nvcc's `-Xptxas -v` output:
    source, kernel (the longest known name in the symbol), element type."""
    lines, name, spill, src = [], None, "", "?"
    for line in log.splitlines():
        if " -c " in line and ".cu" in line:
            src = line.rsplit("/", 1)[-1].strip()
        elif "Function properties for" in line:
            fn = line.split("for ")[-1]
            kind = max((k for k in KERNEL_KINDS if k in fn), key=len, default=fn)
            first = fn[fn.find(kind) + len(kind):] if kind in fn else ""
            bf16 = first.startswith("I13__nv_bfloat16") or kind in BF16_KINDS
            # mma_attend_kernel<true>: B3's deferred normalisation
            deferred = ", deferred" if first.startswith("ILb1E") else ""
            # the head's columns in shared memory (B1's and B6/B7's tiles)
            cols = first.split("Li", 1)[1].split("E", 1)[0] if "Li" in first else ""
            cols = f", {cols} columns" if cols.isdigit() else ""
            name = f"{src}:{kind}<{'bf16' if bf16 else 'fp32'}{deferred}{cols}>"
        elif "spill" in line and name:
            spill = line.strip()
        elif "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


def bf16_ulp(v: float) -> float:
    """The bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (math.frexp(abs(v))[1] - 8)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.float() - b.float()) ** 2).item()
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


class Phase:
    """Prints a phase's wall time when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        if exc[0] is None:
            print(f"[wall] {self.name}: {time.perf_counter() - self.t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from grlir_torch.b3_spread import b3_stage_check, stage_failures, stage_line
    from grlir_torch.engines.inference import Restorer
    from grlir_torch.models import zoo
    from grlir_torch.models.grl import GRL, geometry_tensors, init_weights
    from grlir_torch.ops import attention as tatt
    from grlir_torch.ops import block_attn as ba
    from grlir_torch.ops import cuda_build
    from grlir_torch.ops import flash_attention as tfa
    from grlir_torch.ops.geometry import get_stripe_info
    from grlir_torch.ops.layout import window_partition, window_reverse

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    # the inputs of the head-dim-64 and gradient checks come from a
    # generator of their own, so the other checks keep their inputs
    g6 = torch.Generator().manual_seed(6)

    def rnd6(*shape, std=1.0):
        return (torch.randn(*shape, generator=g6) * std).to(dev)

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    print(f"[device] {name} capability {cap[0]}.{cap[1]} count "
          f"{torch.cuda.device_count()} torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    check(cap == (9, 0), f"compute capability {cap} is not Hopper (9, 0)")

    # 2. build
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    for line in ptxas_report((cuda_build.BUILD_DIR / "build.log").read_text()):
        print(f"[build] {line}")

    # ---------------------------------------------------------------- cases
    # A case is one call of a kernel's wrapper at fixed inputs: fn(x, kernels)
    # runs it on x (its dtype picks fp32 or bf16); lib(x) is the nearest
    # PyTorch library composition (qkv matmul, then scaled_dot_product_attention
    # with the bias plus the shift mask as attn_mask); cost(x) the bytes and
    # FLOPs the function needs on x.

    def heads_of(t, h):      # (B, nS, N, h*d) -> (B, nS, h, N, d)
        B_, nS, N, Cx = t.shape
        return t.reshape(B_, nS, N, h, Cx // h).permute(0, 1, 3, 2, 4)

    def sdpa(q, k, v, bias, mask):
        """q (B, nS, h, Nq, d) against k, v; bias (h, Nq, Nk); mask
        (nS, 1, Nq, Nk) or None."""
        B_, nS, h, Nq, d = q.shape
        if mask is None:
            m = bias[None].to(q.dtype)
            shape = (B_ * nS, h)
        else:
            m = (bias[None] + mask).to(q.dtype).reshape(1, nS * h, Nq, -1)
            shape = (B_, nS * h)
        q, k, v = (t.reshape(*shape, t.shape[-2], d) for t in (q, k, v))
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=1.0)
        return y.reshape(B_, nS, h, Nq, d)

    def band_mask(bq, bk):
        return None if bq is None else torch.where(
            bq[:, :, None] != bk[:, None, :], -100.0, 0.0)[:, None]

    def window_case(x, w, b, ls, bias, win, bands, shift):
        h = ls.shape[0]
        B_, H, W_, C = x.shape
        Cw, N = w.shape[1] // 3, win[0] * win[1]
        large = ba.window_route((H, W_), win, h) == "large"

        def fn(t, k, w_scale=1.0):
            return ba.window_half(t, w * w_scale, b, ls, bias, win, bands=bands,
                                  shift=shift, kernels=k)

        def lib(t):
            if shift:
                t = torch.roll(t, (-shift, -shift), dims=(1, 2))
            qkv = torch.matmul(window_partition(t, win), w.to(t.dtype)) + b.to(t.dtype)
            q, k, v = (heads_of(p, h) for p in qkv.chunk(3, -1))
            s = ba._scale(ls).reshape(h, 1, 1).to(t.dtype)
            y = sdpa(F.normalize(q, dim=-1) * s, F.normalize(k, dim=-1), v, bias,
                     band_mask(bands, bands))
            return window_reverse(y.permute(0, 1, 3, 2, 4).reshape(*y.shape[:2], N, Cw),
                                  win, (H, W_))

        def cost(t):
            it = t.element_size()
            n = (nbytes(t, bands) + (C * 3 * Cw + 3 * Cw) * it
                 + bias.numel() * (2 if large else 4) + t[..., :Cw].numel() * it)
            return n, 2 * B_ * H * W_ * C * 3 * Cw + 4 * B_ * H * W_ * N * Cw

        if large:   # B3's bf16 route split into its stages (b3_spread)
            return fn, lib, cost, lambda t: b3_stage_check(t, w, b, ls, bias, bands, shift, h)
        return fn, lib, cost

    def stripe_parts(t, anchor, w, b, h, stripe, df, shift):
        """k, v, q (B, nS, h, N1, d) and unit anchors (B, nS, h, N2, d) of a
        library composition."""
        if shift != (0, 0):
            t = torch.roll(t, (-shift[0], -shift[1]), dims=(1, 2))
        qkv = torch.matmul(window_partition(t, stripe), w.to(t.dtype)) + b.to(t.dtype)
        q, k, v = (heads_of(p, h) for p in qkv.chunk(3, -1))
        a = window_partition(anchor.to(t.dtype), (stripe[0] // df, stripe[1] // df))
        return q, k, v, F.normalize(heads_of(a, h), dim=-1)

    def stripe_case(kind, x, anchor, w, b, ls1, ls2, b1, b2, stripe, df, bands,
                    bands_a, shift):
        """kind: "stripe_half" (B2, both steps), "a2w" or "w2a" (B4 steps;
        w2a takes the plain a2w output as x1)."""
        h = ls1.shape[0]
        B_, H, W_, C = x.shape
        Cs = w.shape[1] // 3
        N1, N2 = stripe[0] * stripe[1], (stripe[0] // df) * (stripe[1] // df)
        kw = dict(bands=bands, bands_a=bands_a, shift=shift)
        s1 = ba._scale(ls1).reshape(h, 1, 1)
        s2 = ba._scale(ls2).reshape(h, 1, 1)
        x1s = {}

        def x1_of(t):
            if t.dtype not in x1s:
                with torch.no_grad():
                    x1s[t.dtype] = ba.stripe_a2w_large(t, anchor.to(t.dtype), w, b, ls1,
                                                       b1, stripe, df, kernels=False, **kw)
            return x1s[t.dtype]

        def fn(t, k):
            a = anchor.to(t.dtype)
            if kind == "stripe_half":
                return ba.stripe_half(t, a, w, b, ls1, ls2, b1, b2, stripe, df,
                                      kernels=k, **kw)
            if kind == "a2w":
                return ba.stripe_a2w_large(t, a, w, b, ls1, b1, stripe, df, kernels=k,
                                           **kw)
            return ba.stripe_w2a_large(t, a, x1_of(t), w, b, ls2, b2, stripe, df,
                                       kernels=k, **kw)

        def lib(t):
            q, k, v, an = stripe_parts(t, anchor, w, b, h, stripe, df, shift)
            m1, m2 = band_mask(bands_a, bands), band_mask(bands, bands_a)
            if kind == "w2a":
                x1 = x1_of(t)
            else:
                x1 = sdpa(an * s1.to(t.dtype), F.normalize(k, dim=-1), v, b1, m1)
                if kind == "a2w":
                    return x1
            y = sdpa(F.normalize(q, dim=-1) * s2.to(t.dtype), an, x1, b2, m2)
            return ba._stripe_out(y, stripe, (H, W_))

        def cost(t):
            it = t.element_size()
            io = nbytes(t, anchor.to(t.dtype), bands, bands_a)
            out_y = t[..., :Cs].numel() * it
            out_x1 = anchor.numel() * it
            attn = 4 * B_ * H * W_ * N2 * Cs      # one step: logits and product
            if kind == "stripe_half":
                n = io + (C * 3 * Cs + 3 * Cs) * it + nbytes(b1, b2) + out_y
                return n, 2 * B_ * H * W_ * C * 3 * Cs + 2 * attn
            bias = (b1 if kind == "a2w" else b2).numel() * it
            if kind == "a2w":
                n = io + (C * 2 * Cs + 2 * Cs) * it + bias + out_x1
                return n, 2 * B_ * H * W_ * C * 2 * Cs + attn
            n = io + out_x1 + (C * Cs + Cs) * it + bias + out_y
            return n, 2 * B_ * H * W_ * C * Cs + attn

        return fn, lib, cost

    def fp64_projection_spread(fn, xt, want):
        """max|diff| between the plain path and itself with its projection
        summed in float64: how far two faithful orders of the same sums
        land apart."""
        plain_project = ba._project

        def project64(t, wqkv, bqkv, h, mm, parts):
            p = (t.double() @ wqkv.to(mm).double()).float()
            return ba._split_heads(p if bqkv is None else p + bqkv.float(), parts, h)

        ba._project = project64
        try:
            other = fn(xt, False)
        finally:
            ba._project = plain_project
        return (other.float() - want.float()).abs().max().item()

    def cosine64(q, k, v, ls, bias, mask):
        """B6/B7's function in float64 on token-major q (.., Nq, d), k, v:
        the spread of the plain fp32 version against it."""
        h = q.shape[2]
        un = [u.double() / u.double().square().sum(-1, keepdim=True).clamp_min(1e-24).sqrt()
              for u in (q, k)]
        s_ = ba._scale(ls).double().reshape(h, 1, 1)
        a = un[0] @ un[1].transpose(-1, -2) * s_ + bias.double()
        if mask is not None:
            a = a + mask.double()[:, None]
        return torch.softmax(a, -1) @ v.double()

    def fp32_gate(got, want):
        """B6/B7 in either input type: |got - want| <= FP32_TOL (1 + |want|)
        plus, for bf16 outputs, one bf16 ulp of |want| (both round only y);
        returns (ok, the largest excess over FP32_TOL (1 + |want|))."""
        err = (got.float() - want.float()).abs()
        tol = FP32_TOL * (1 + want.float().abs())
        if want.dtype == torch.bfloat16:
            a = want.float().abs().clamp_min(2.0 ** -126)
            tol = tol + torch.exp2(torch.floor(torch.log2(a)) - 7)
        return bool((err <= tol).all()), (err - FP32_TOL * (1 + want.float().abs())).max().item()

    def run_cases(cases, max_err):
        """Each case's kernel against its plain version, fp32 and bf16: one
        launch of the kernel a call (on the route of the type where it has
        two); B1's comparison shown real (C1)."""
        with torch.no_grad():
            for kname, label, (fn, _, _, *spread), x in cases:
                kfn = next(k for k in all_kernels if k.__name__ == kname)
                for dtype in (torch.float32, torch.bfloat16):
                    xt = x.to(dtype)
                    before, n0 = routes(), kfn.launches
                    got, want = fn(xt, True), fn(xt, False)
                    torch.cuda.synchronize()
                    check(kfn.launches == n0 + 1, f"{kname} {label} {dtype}: launches")
                    if kname in before:
                        route = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
                        before[kname][route] += 1
                        check(routes() == before, f"{kname} {label} {dtype}: routes {routes()}")
                    err = (got.float() - want.float()).abs().max().item()
                    max_err[kname] = max(max_err.get(kname, 0.0), err)
                    if kname == "window_half":
                        moved = fn(xt, True, w_scale=1.001)
                        torch.cuda.synchronize()
                        dmove = (moved.float() - got.float()).abs().max().item()
                        distinct = got.data_ptr() != want.data_ptr()
                        print(f"[C1] window_half {label} {str(dtype)[6:]}: launches +1 (count "
                              f"{n0} -> {kfn.launches - 1}), got/want distinct storage "
                              f"{distinct} ({got.data_ptr():#x} vs {want.data_ptr():#x}), "
                              f"max|y(w x 1.001) - y(w)| {dmove:.3e}, max|got - want| {err:.3e}")
                        check(distinct and dmove > 0, f"C1 {label} {dtype}")
                    if kname.startswith("fused_"):
                        ok, excess = fp32_gate(got, want)
                        f64 = (want.float() - spread[0](xt).float()).abs().max().item()
                        tol = (f"fp32 gate atol/rtol {FP32_TOL} plus one bf16 ulp of |plain| for "
                               f"bf16 y, largest excess over atol/rtol {excess:.3e}; plain vs "
                               f"float64 {f64:.3e}")
                    elif dtype == torch.float32:
                        ok = torch.allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)
                        tol = f"atol {FP32_TOL} rtol {FP32_TOL}"
                    elif kname == "window_half_large":
                        # the stage gates; the gated y is the wrapper's, the
                        # stage split's plain y the plain version's
                        st = spread[0](xt)
                        same = (torch.equal(st["y"], got.float())
                                and torch.equal(st["y_plain"], want.float()))
                        ok = not stage_failures(st) and same
                        tol = (f"stage gates: {stage_line(st)}; kernel and plain y those of the "
                               f"stage split {same}")
                    elif kname in ULP_GATED:
                        top = want.float().abs().max().item()
                        gate = max(BF16_MAX_ERR, 2 * bf16_ulp(top))
                        ok = err <= gate
                        tol = (f"max {gate:.3e} = max({BF16_MAX_ERR}, 2 bf16 ulps of max|plain| "
                               f"{top:.3f}); plain vs plain with float64 projection sums "
                               f"{fp64_projection_spread(fn, xt, want):.3e}")
                    else:
                        ok, tol = err <= BF16_MAX_ERR, f"max {BF16_MAX_ERR}"
                    print(f"[kernel] {kname} {label} {str(dtype)[6:]}: "
                          f"max|diff| {err:.3e} ({tol})")
                    check(bool(ok) and math.isfinite(err), f"{kname} {label} {dtype}")

    def time_case(kname, label, case, x, runs, warmup, timing):
        fn, lib, cost = case[:3]
        xb = x.to(torch.bfloat16)
        with torch.no_grad():
            k_ms, p_ms = ab_ms(lambda: fn(xb, False), lambda: fn(xb, True), runs, warmup)
            l_ms = time_ms(lambda: lib(xb), runs, warmup)
        n_bytes, flops = cost(xb)
        b_ms, b_by = bound_ms(n_bytes, flops, COMPUTE_TYPE[kname.split(" ")[0]])
        tf32 = ""
        if COMPUTE_TYPE[kname.split(" ")[0]] == torch.float32:
            t3 = max(n_bytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS) * 1e3
            tf32 = f", bound as 3 TF32 products {t3:.4f} ms"
        print(f"[time] {kname} {label} bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"library composition {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}){tf32} "
              f"[{smi}]")
        timing[kname] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                         "bound_ms": b_ms, "bound_by": b_by}

    all_kernels = ba.KERNELS + tfa.KERNELS + tatt.KERNELS

    def counts():
        return {k.__name__: k.launches for k in all_kernels}

    def expect(**launched):
        """A counts() dict: the given launches, 0 for every other kernel."""
        return {k.__name__: launched.get(k.__name__, 0) for k in all_kernels}

    routed_kernels = ba.ROUTED + tfa.KERNELS

    def reset_counts():
        """Every launch count, the counts by route and
        block_attn.unrouted_halves to 0."""
        ba.reset_launches()
        for k in all_kernels:
            k.launches = 0
        for k in tfa.KERNELS:
            for r in k.route_launches:
                k.route_launches[r] = 0

    def routes():
        """Launches by route of B1-B5 (bf16 on tensor cores, fp32 on CUDA
        cores)."""
        return {k.__name__: dict(k.route_launches) for k in routed_kernels}

    def expect_routes(route="tensor_core", **launched):
        """A routes() dict: the given launches on `route`, none elsewhere."""
        return {k.__name__: {r: launched.get(k.__name__, 0) if r == route else 0
                             for r in ("tensor_core", "cuda_core")} for k in routed_kernels}

    max_err, timing, served = {}, {}, {}

    # 3. GRL-S x4 (slice 1)
    with Phase("GRL-S kernels"):
        cfg = zoo.GRL_SMALL
        C, heads, df = cfg.embed_dim, cfg.num_heads_window[0], cfg.anchor_window_down_factor
        hw = (GRL_S_HW, GRL_S_HW)
        geom = geometry_tensors(cfg.geometry_config, hw, dev)
        x = rnd(1, *hw, C)
        w, b = rnd(C, 3 * C // 2, std=0.02), rnd(3 * C // 2, std=0.02)
        ls1 = torch.full((heads, 1, 1), math.log(10.0), device=dev)
        ls2 = torch.full((heads, 1, 1), math.log(12.0), device=dev)
        anchor = rnd(1, hw[0] // df, hw[1] // df, C // 2)
        win = (cfg.window_size, cfg.window_size)
        bias_w = 16 * torch.sigmoid(rnd(heads, win[0] ** 2, win[0] ** 2))
        cases_s = []
        for s in (0, 4):
            cases_s.append(("window_half", f"window {win} shift {s}", window_case(
                x, w, b, ls1, bias_w, win, geom["bands_w"] if s else None, s), x))
        for key, sizes, groups in (("sh", cfg.stripe_size, cfg.stripe_groups),
                                   ("sv", cfg.stripe_size[::-1], cfg.stripe_groups[::-1])):
            stripe, shift = get_stripe_info(sizes, groups, True, hw)
            n1, n2 = stripe[0] * stripe[1], (stripe[0] // df) * (stripe[1] // df)
            b1, b2 = 16 * torch.sigmoid(rnd(heads, n2, n1)), 16 * torch.sigmoid(rnd(heads, n1, n2))
            for shifted in (False, True):
                cases_s.append(("stripe_half", f"stripe {stripe} shift "
                                f"{shift if shifted else (0, 0)}", stripe_case(
                                    "stripe_half", x, anchor, w, b, ls1, ls2, b1, b2, stripe,
                                    df, geom[f"bands_{key}"] if shifted else None,
                                    geom[f"bands_{key}_a"] if shifted else None,
                                    shift if shifted else (0, 0)), x))
        # B1 at two heads of d = 64 (C = 256): the bf16 kernel holds one
        # head's w at a time
        x64 = rnd6(1, *hw, 256)
        w64, b64 = rnd6(256, 3 * 128, std=0.02 * math.sqrt(128 / 256)), rnd6(3 * 128, std=0.02)
        for s in (0, 4):
            cases_s.append(("window_half", f"window {win} shift {s} h2 d64", window_case(
                x64, w64, b64, ls1, bias_w, win, geom["bands_w"] if s else None, s), x64))
        run_cases(cases_s, max_err)

    with Phase("GRL-S model"):
        model = init_weights(GRL(replace(cfg, dtype=torch.bfloat16)),
                             torch.Generator().manual_seed(0)).eval().to(dev)
        plain = GRL(replace(cfg, dtype=torch.bfloat16, kernels=False)).eval().to(dev)
        plain.load_state_dict(model.state_dict())
        lr = torch.rand(1, *hw, 3, generator=g).to(dev)
        n_blocks = sum(cfg.depths)
        with torch.no_grad():
            reset_counts()
            y_k = model(lr)
            torch.cuda.synchronize()
            per_fwd, per_route = counts(), routes()
            y_p = plain(lr)
        print(f"[model] GRL-S x4 bf16 {GRL_S_HW}^2: out {tuple(y_k.shape)}, launches "
              f"{per_fwd} per forward, B1-B4 by route {per_route}, unrouted halves "
              f"{ba.unrouted_halves}, PSNR kernels vs plain {psnr(y_k, y_p):.2f} dB, rel L2 "
              f"{rel_l2(y_k, y_p):.3e}")
        check(per_fwd == expect(window_half=n_blocks, stripe_half=n_blocks)
              and ba.unrouted_halves == 0, f"GRL-S launches {per_fwd}")
        check(per_route == expect_routes(window_half=n_blocks, stripe_half=n_blocks),
              f"GRL-S bf16 routes {per_route}")
        check(tuple(y_k.shape) == (1, 4 * GRL_S_HW, 4 * GRL_S_HW, 3)
              and bool(torch.isfinite(y_k).all()), "bf16 model output")
        check(psnr(y_k, y_p) >= MODEL_MIN_PSNR, f"bf16 PSNR < {MODEL_MIN_PSNR} dB")
        m32 = GRL(replace(cfg, dtype=torch.float32)).eval().to(dev)
        p32 = GRL(replace(cfg, dtype=torch.float32, kernels=False)).eval().to(dev)
        m32.load_state_dict(model.state_dict())
        p32.load_state_dict(model.state_dict())
        with torch.no_grad():
            reset_counts()
            err32 = (m32(lr[:, :64, :64]) - p32(lr[:, :64, :64])).abs().max().item()
            per_route = routes()
        print(f"[model] GRL-S x4 fp32 64^2: max|diff| kernels vs plain {err32:.3e} "
              f"(max {MODEL_FP32_MAX_ERR}), B1-B4 by route {per_route}")
        check(err32 <= MODEL_FP32_MAX_ERR, "fp32 model kernels vs plain")
        check(per_route == expect_routes("cuda_core", window_half=n_blocks,
                                         stripe_half=n_blocks),
              f"GRL-S fp32 routes {per_route}")
        del m32, p32

    with Phase("GRL-S serve"):
        bucket = {"shape_bucket": 64}
        requests = [
            ("256x256", torch.rand(1, 256, 256, 3, generator=g), bucket),
            ("200x232 (64-bucket)", torch.rand(1, 200, 232, 3, generator=g), bucket),
            ("batch of 2 192x160", torch.rand(2, 192, 160, 3, generator=g), bucket),
            ("384x384 tiled 256/32", torch.rand(1, 384, 384, 3, generator=g),
             {"tile": 256, "tile_overlap": 32, "tile_batch": 4}),
        ]
        reset_counts()
        t0 = time.perf_counter()
        outs = [Restorer(model, dev, scale=4, **kw)(img.numpy()) for _, img, kw in requests]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        got, unrouted, got_routes = counts(), ba.unrouted_halves, routes()
        served.update(window_half=got["window_half"], stripe_half=got["stripe_half"])
        print(f"[serve] GRL-S: 4 requests in {serve_s:.2f} s, launches {got}, B1-B4 by "
              f"route {got_routes}, unrouted halves {unrouted}")
        for (label, img, kw), out in zip(requests, outs):
            ref = Restorer(plain, dev, scale=4, **kw)(img.numpy())
            bsz, h_, w_, _ = img.shape
            out = torch.from_numpy(out)
            finite = bool(torch.isfinite(out).all())
            p = psnr(out, torch.from_numpy(ref))
            print(f"[serve] GRL-S {label}: out {tuple(out.shape)}, finite {finite}, "
                  f"PSNR vs plain {p:.2f} dB")
            check(tuple(out.shape) == (bsz, 4 * h_, 4 * w_, 3) and finite, label)
            check(p >= MODEL_MIN_PSNR, f"{label}: PSNR vs plain path")
        check(got == expect(window_half=4 * n_blocks, stripe_half=4 * n_blocks)
              and unrouted == 0,
              f"GRL-S served launches {got} != 4 forwards x {n_blocks}")
        check(got_routes == expect_routes(window_half=4 * n_blocks, stripe_half=4 * n_blocks),
              f"GRL-S served routes {got_routes}")

    with Phase("GRL-S timing"):
        last_stripe = [c for c in cases_s if c[0] == "stripe_half"][-1]
        for kname, label, case, xc in (cases_s[1], last_stripe):
            time_case(kname, label, case, xc, 10, 3, timing)
        with torch.no_grad():
            k_ms, p_ms = ab_ms(lambda: plain(lr), lambda: model(lr), 10, 3)
        mp = GRL_S_HW * GRL_S_HW / 1e6
        print(f"[time] GRL-S x4 {GRL_S_HW}^2 bs1 bf16 forward: kernels {k_ms:.3f} ms "
              f"({mp / (k_ms / 1e3):.4f} MP/s), plain {p_ms:.3f} ms "
              f"({mp / (p_ms / 1e3):.4f} MP/s) [{smi}]")
        del model, plain, cases_s

    # 4. GRL-base at its eval geometry (slice 2)
    base_geo = dict(window_size=32, anchor_window_down_factor=2,
                    stripe_groups=(None, None))
    sr_cfg = zoo.make_config("base", task="sr", upscale=4, stripe_size=(64, 64), **base_geo)
    dn_cfg = zoo.make_config("base", task="dn", stripe_size=(64, 128), **base_geo)
    C, heads, df = sr_cfg.embed_dim, sr_cfg.num_heads_window[0], 2
    n_blocks = sum(sr_cfg.depths)
    with Phase("GRL-base kernels"):
        cases_b = []
        win = (32, 32)
        w, b = rnd(C, 3 * C // 2, std=0.02), rnd(3 * C // 2, std=0.02)
        ls1 = torch.tensor([math.log(10.0), 5.0, 3.0], device=dev).reshape(heads, 1, 1)
        ls2 = torch.tensor([math.log(12.0), 4.0, 2.5], device=dev).reshape(heads, 1, 1)
        for bsz, cfg_b in ((1, sr_cfg), (2, dn_cfg)):
            hw = (BASE_HW, BASE_HW)
            geom = geometry_tensors(cfg_b.geometry_config, hw, dev)
            x = rnd(bsz, *hw, C)
            anchor = rnd(bsz, hw[0] // df, hw[1] // df, C // 2)
            if bsz == 1:
                bias_w = 16 * torch.sigmoid(rnd(heads, 1024, 1024))
                for s in (0, 16):
                    cases_b.append(("window_half_large", f"window {win} shift {s} bs1",
                                    window_case(x, w, b, ls1, bias_w, win,
                                                geom["bands_w"] if s else None, s), x))
            keys = [("sh", cfg_b.stripe_size)]
            if cfg_b.stripe_size[0] != cfg_b.stripe_size[1]:
                keys.append(("sv", cfg_b.stripe_size[::-1]))
            for key, stripe in keys:
                n1, n2 = stripe[0] * stripe[1], (stripe[0] // df) * (stripe[1] // df)
                b1 = 16 * torch.sigmoid(rnd(heads, n2, n1))
                b2 = 16 * torch.sigmoid(rnd(heads, n1, n2))
                half = (stripe[0] // 2, stripe[1] // 2)
                for shifted in (False, True):
                    args = (x, anchor, w, b, ls1, ls2, b1, b2, stripe, df,
                            geom[f"bands_{key}"] if shifted else None,
                            geom[f"bands_{key}_a"] if shifted else None,
                            half if shifted else (0, 0))
                    label = f"stripe {stripe} shift {args[-1]} bs{bsz}"
                    for step in ("a2w", "w2a"):
                        cases_b.append((f"stripe_{step}_large", label,
                                        stripe_case(step, *args), x))
        # B1/B2 at GRL-base's heads (3 of d = 30): its deployed zoo geometry
        base_zoo = zoo.GRL_BASE
        hw = (BASE_HW, BASE_HW)
        geom = geometry_tensors(base_zoo.geometry_config, hw, dev)
        x = rnd(1, *hw, C)
        anchor = rnd(1, hw[0] // 4, hw[1] // 4, C // 2)
        bias8 = 16 * torch.sigmoid(rnd(heads, 64, 64))
        for s in (0, 4):
            cases_b.append(("window_half", f"window (8, 8) shift {s} h3 d30", window_case(
                x, w, b, ls1, bias8, (8, 8), geom["bands_w"] if s else None, s), x))
        stripe, shift = get_stripe_info(base_zoo.stripe_size, base_zoo.stripe_groups, True, hw)
        n1, n2 = stripe[0] * stripe[1], (stripe[0] // 4) * (stripe[1] // 4)
        cases_b.append(("stripe_half", f"stripe {stripe} shift {shift} h3 d30", stripe_case(
            "stripe_half", x, anchor, w, b, ls1, ls2, 16 * torch.sigmoid(rnd(heads, n2, n1)),
            16 * torch.sigmoid(rnd(heads, n1, n2)), stripe, 4, geom["bands_sh"],
            geom["bands_sh_a"], shift), x))
        run_cases(cases_b, max_err)

    with Phase("GRL-base model"):
        base = init_weights(GRL(replace(sr_cfg, dtype=torch.bfloat16)),
                            torch.Generator().manual_seed(1)).eval().to(dev)
        base_plain = GRL(replace(sr_cfg, dtype=torch.bfloat16, kernels=False)).eval().to(dev)
        base_plain.load_state_dict(base.state_dict())
        lr = torch.rand(1, BASE_MODEL_HW, BASE_MODEL_HW, 3, generator=g).to(dev)
        mem = {}
        with torch.no_grad():
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            y_k = base(lr)
            torch.cuda.synchronize()
            mem["kernels"] = torch.cuda.max_memory_allocated() / 2**30
            per_fwd, per_route = counts(), routes()
            torch.cuda.reset_peak_memory_stats()
            y_p = base_plain(lr)
            torch.cuda.synchronize()
            mem["plain"] = torch.cuda.max_memory_allocated() / 2**30
        p = psnr(y_k, y_p)
        print(f"[model] GRL-base x4 bf16 {BASE_MODEL_HW}^2 (window 32, stripes 64x64, df 2): "
              f"out {tuple(y_k.shape)}, launches {per_fwd} per forward, B1-B4 by route "
              f"{per_route}, PSNR kernels vs plain {p:.2f} dB, rel L2 {rel_l2(y_k, y_p):.3e}, "
              f"max_memory_allocated kernels {mem['kernels']:.2f} GiB, plain "
              f"{mem['plain']:.2f} GiB")
        check(per_fwd == expect(window_half_large=n_blocks, stripe_a2w_large=n_blocks,
                                stripe_w2a_large=n_blocks) and ba.unrouted_halves == 0,
              f"GRL-base launches {per_fwd}, unrouted halves {ba.unrouted_halves}")
        base_launches = dict(window_half_large=n_blocks, stripe_a2w_large=n_blocks,
                             stripe_w2a_large=n_blocks)
        check(per_route == expect_routes(**base_launches), f"GRL-base bf16 routes {per_route}")
        check(tuple(y_k.shape) == (1, 4 * BASE_MODEL_HW, 4 * BASE_MODEL_HW, 3)
              and bool(torch.isfinite(y_k).all()), "GRL-base bf16 output")
        check(p >= MODEL_MIN_PSNR, f"GRL-base bf16 PSNR < {MODEL_MIN_PSNR} dB")
        m32 = GRL(sr_cfg).eval().to(dev)
        p32 = GRL(replace(sr_cfg, kernels=False)).eval().to(dev)
        m32.load_state_dict(base.state_dict())
        p32.load_state_dict(base.state_dict())
        with torch.no_grad():
            reset_counts()
            err32 = (m32(lr[:, :64, :64]) - p32(lr[:, :64, :64])).abs().max().item()
            per_route = routes()
        print(f"[model] GRL-base x4 fp32 64^2: max|diff| kernels vs plain {err32:.3e} "
              f"(max {MODEL_FP32_MAX_ERR}), B1-B4 by route {per_route}")
        check(err32 <= MODEL_FP32_MAX_ERR, "GRL-base fp32 kernels vs plain")
        check(per_route == expect_routes("cuda_core", **base_launches),
              f"GRL-base fp32 routes {per_route}")
        del m32, p32

    with Phase("GRL-base serve"):
        dn = init_weights(GRL(replace(dn_cfg, dtype=torch.bfloat16)),
                          torch.Generator().manual_seed(2)).eval()
        # With the reference's conv init the identity tail adds a residual
        # several times an image's range, and its bf16 rounding alone would
        # set the PSNR; a tenth of it gives a denoiser's residual scale.
        with torch.no_grad():
            dn.conv_last.weight.mul_(0.1)
            dn.conv_last.bias.mul_(0.1)
        dn = dn.to(dev)
        dn_plain = GRL(replace(dn_cfg, dtype=torch.bfloat16, kernels=False)).eval().to(dev)
        dn_plain.load_state_dict(dn.state_dict())
        tiled = {"tile": 256, "tile_overlap": 32, "tile_batch": 2}
        requests = [
            ("SR x4 256x192", base, base_plain, 4,
             torch.rand(1, 256, 192, 3, generator=g), {"shape_bucket": 64}),
            ("SR x4 200x232 (64-bucket)", base, base_plain, 4,
             torch.rand(1, 200, 232, 3, generator=g), {"shape_bucket": 64}),
            ("dn 321x481 tiled 256/32, stripes 64x128", dn, dn_plain, 1,
             torch.rand(1, 321, 481, 3, generator=g), tiled),
        ]
        forwards = 1 + 1 + 3   # the dn request: 6 tiles in batches of 2
        reset_counts()
        t0 = time.perf_counter()
        outs = [Restorer(m, dev, scale=sc, **kw)(img.numpy())
                for _, m, _, sc, img, kw in requests]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        got, unrouted, got_routes = counts(), ba.unrouted_halves, routes()
        served.update({k: got[k] for k in ("window_half_large", "stripe_a2w_large",
                                           "stripe_w2a_large")})
        print(f"[serve] GRL-base: 3 requests in {serve_s:.2f} s, launches {got}, B1-B4 by "
              f"route {got_routes}, unrouted halves {unrouted}")
        for (label, _, m_plain, sc, img, kw), out in zip(requests, outs):
            ref = Restorer(m_plain, dev, scale=sc, **kw)(img.numpy())
            bsz, h_, w_, _ = img.shape
            out = torch.from_numpy(out)
            finite = bool(torch.isfinite(out).all())
            p = psnr(out, torch.from_numpy(ref))
            resid = f", residual std {(out - img).std().item():.4f}" if sc == 1 else ""
            print(f"[serve] GRL-base {label}: out {tuple(out.shape)}, finite {finite}, "
                  f"PSNR vs plain {p:.2f} dB{resid}")
            check(tuple(out.shape) == (bsz, sc * h_, sc * w_, 3) and finite, label)
            check(p >= MODEL_MIN_PSNR, f"{label}: PSNR vs plain path")
        check(got == expect(window_half_large=forwards * n_blocks,
                            stripe_a2w_large=forwards * n_blocks,
                            stripe_w2a_large=forwards * n_blocks) and unrouted == 0,
              f"GRL-base served launches {got} != {forwards} forwards x {n_blocks}")
        check(got_routes == expect_routes(**{k: forwards * n for k, n in base_launches.items()}),
              f"GRL-base served routes {got_routes}")
        d32 = GRL(dn_cfg).eval().to(dev)
        q32 = GRL(replace(dn_cfg, kernels=False)).eval().to(dev)
        d32.load_state_dict(dn.state_dict())
        q32.load_state_dict(dn.state_dict())
        tiles = torch.rand(2, 256, 256, 3, generator=g).to(dev)
        with torch.no_grad():
            err32 = (d32(tiles) - q32(tiles)).abs().max().item()
        print(f"[serve] GRL-base dn fp32 two 256^2 tiles: max|diff| kernels vs plain "
              f"{err32:.3e} (max {MODEL_FP32_MAX_ERR})")
        check(err32 <= MODEL_FP32_MAX_ERR, "GRL-base dn fp32 kernels vs plain")
        del d32, q32

    with Phase("GRL-base timing"):
        for kname, label, case, xc in cases_b:
            if kname == "window_half_large" and "shift 16" in label or (
                    kname.startswith("stripe_") and kname.endswith("_large")
                    and "bs1" in label and "(32, 32)" in label):
                time_case(kname, label, case, xc, 5, 2, timing)
        for kname, label, case, xc in cases_b:
            if kname.endswith("_large") and "bs2" in label and "(32, 64)" in label:
                time_case(kname + " (dn)", label, case, xc, 3, 1, {})
        lr = torch.rand(1, BASE_HW, BASE_HW, 3, generator=g).to(dev)
        with torch.no_grad():
            # the plain forward takes ~0.74 s, the plain dn tile pair ~2.2 s
            k_ms, p_ms = ab_ms(lambda: base_plain(lr), lambda: base(lr), 5, 2)
        mp = BASE_HW * BASE_HW / 1e6
        print(f"[time] GRL-base x4 {BASE_HW}^2 bs1 bf16 forward (window 32, stripes 64x64, "
              f"df 2): kernels {k_ms:.3f} ms ({mp / (k_ms / 1e3):.4f} MP/s), plain "
              f"{p_ms:.3f} ms ({mp / (p_ms / 1e3):.4f} MP/s) [{smi}]")
        tiles = torch.rand(2, 256, 256, 3, generator=g).to(dev)
        with torch.no_grad():
            k_ms, p_ms = ab_ms(lambda: dn_plain(tiles), lambda: dn(tiles), 3, 1)
            for tag, m in (("kernels", dn), ("plain", dn_plain)):
                torch.cuda.reset_peak_memory_stats()
                m(tiles)
                torch.cuda.synchronize()
                mem[f"dn {tag}"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"[time] GRL-base dn 256^2 tile (stripes 64x128, tile batch 2) bf16: kernels "
              f"{k_ms / 2:.3f} ms a tile, plain {p_ms / 2:.3f} ms a tile; "
              f"max_memory_allocated kernels {mem['dn kernels']:.2f} GiB, plain "
              f"{mem['dn plain']:.2f} GiB [{smi}]")

    # 5. the fused engines (slice 3)
    # Cases as above: fn(t, kernels) runs the kernel's wrapper with t as its
    # first operand, the others cast to t's type; lib(t) is one PyTorch
    # attention call on the same operands; cost(t) the bytes and FLOPs.

    def dense_mask(bq, bk):
        return None if bq is None else torch.where(
            bq[:, :, None] != bk[:, None, :], -100.0, 0.0)

    def flash_case(q, k, v, ls, bias, bq, bk):
        """B5 on channel-major q (B, nW, h, d, N1), k, v (.., d, N2)."""
        h = ls.shape[0]

        def fn(t, kern):
            return tfa.flash_rect_attention(t, k.to(t.dtype), v.to(t.dtype), ls, bias, bq,
                                            bk, kernels=kern)

        def lib(t):
            s_ = ba._scale(ls).reshape(h, 1, 1).to(t.dtype)
            tq, tk, tv = (u.to(t.dtype).transpose(-1, -2) for u in (t, k, v))
            y = sdpa(F.normalize(tq, dim=-1) * s_, F.normalize(tk, dim=-1), tv,
                     bias.to(t.dtype), band_mask(bq, bk))
            return y.transpose(-1, -2)

        def cost(t):
            it = t.element_size()
            B_, nW, _, d, N1 = t.shape
            N2 = k.shape[-1]
            n = 2 * t.numel() * it + 2 * k.numel() * it + bias.numel() * it + nbytes(bq, bk)
            return n, 4 * B_ * nW * h * N1 * N2 * d

        return fn, lib, cost

    def window_qkv_case(ls, bias, bands):
        """B6 on channel-major qkv (B, nW, 3C, N)."""
        h = ls.shape[0]

        def fn(t, kern):
            return tatt.fused_window_attention_qkv(t, ls, bias, h, bands, kernels=kern)

        def lib(t):
            B_, nW, C3, N = t.shape
            q, k, v = (p.reshape(B_, nW, h, C3 // (3 * h), N).transpose(-1, -2)
                       for p in t.chunk(3, 2))
            s_ = ba._scale(ls).reshape(h, 1, 1).to(t.dtype)
            y = sdpa(F.normalize(q, dim=-1) * s_, F.normalize(k, dim=-1), v, bias,
                     band_mask(bands, bands))
            return y.transpose(-1, -2).reshape(B_, nW, C3 // 3, N)

        def cost(t):
            B_, nW, C3, N = t.shape
            n = t.numel() * t.element_size() * 4 // 3 + nbytes(bias, bands)
            return n, 4 * B_ * nW * N * N * (C3 // 3)

        def f64(t):
            B_, nW, C3, N = t.shape
            q, k, v = (p.reshape(B_, nW, h, C3 // (3 * h), N).transpose(-1, -2)
                       for p in t.chunk(3, 2))
            mask = None if bands is None else dense_mask(bands, bands)
            y = cosine64(q, k, v, ls, bias, mask)
            return y.transpose(-1, -2).reshape(B_, nW, C3 // 3, N)

        return fn, lib, cost, f64

    def cosine_case(k, v, ls, bias, mask, pack=0):
        """B7a (pack 0) or B7b on token-major q (B, nW, h, N1, d), k, v;
        mask (nW, N1, N2) fp32 or None."""
        h = ls.shape[0]

        def fn(t, kern):
            args = (t, k.to(t.dtype), v.to(t.dtype), ls, bias, mask)
            if pack:
                return tatt.fused_cosine_attention_packed(*args, pack=pack, kernels=kern)
            return tatt.fused_cosine_attention(*args, kernels=kern)

        def lib(t):
            s_ = ba._scale(ls).reshape(h, 1, 1).to(t.dtype)
            return sdpa(F.normalize(t, dim=-1) * s_, F.normalize(k.to(t.dtype), dim=-1),
                        v.to(t.dtype), bias, None if mask is None else mask[:, None])

        def cost(t):
            it = t.element_size()
            B_, nW, _, N1, d = t.shape
            N2 = k.shape[3]
            n = 2 * t.numel() * it + 2 * k.numel() * it + nbytes(bias, mask)
            return n, 4 * B_ * nW * h * N1 * N2 * d

        def f64(t):
            return cosine64(t, k.to(t.dtype), v.to(t.dtype), ls, bias, mask)

        return fn, lib, cost, f64

    s_cfg = zoo.GRL_SMALL
    with Phase("fused engines kernels"):
        cases_f = []
        heads, d = s_cfg.num_heads_window[0], s_cfg.embed_dim // 2 // s_cfg.num_heads_window[0]
        ls = torch.tensor([math.log(10.0), 5.0], device=dev).reshape(heads, 1, 1)
        # B6 and B7b: GRL-S 256^2 windows (1024 of 8x8, 2 heads of d = 32)
        hw = (GRL_S_HW, GRL_S_HW)
        geom = geometry_tensors(s_cfg.geometry_config, hw, dev)
        bands_w = geom["bands_w"]
        nw, n = bands_w.shape
        bias_w = 16 * torch.sigmoid(rnd(heads, n, n))
        # values (v, x1) at std 0.25 keep |y| < 1, where the bf16 gate's
        # 1e-2 is a few ulps (q and k are unit-normed: their scale is moot)
        qkv = rnd(1, nw, 3 * heads * d, n, std=0.25)
        for sh in (0, 4):
            cases_f.append(("fused_window_attention_qkv", f"GRL-S windows (8, 8) shift {sh}",
                            window_qkv_case(ls, bias_w, bands_w if sh else None), qkv))
        qw = rnd(1, nw, heads, n, d)
        cases_f.append(("fused_cosine_attention_packed", "GRL-S windows (8, 8) shift 4, P 4",
                        cosine_case(rnd(1, nw, heads, n, d), rnd(1, nw, heads, n, d, std=0.25),
                                    ls, bias_w, dense_mask(bands_w, bands_w), pack=4), qw))
        # B5: GRL-S 256^2 H stripes (8x64 at df 4: 512 tokens, 32 anchors)
        stripe, shift = get_stripe_info(s_cfg.stripe_size, s_cfg.stripe_groups, True, hw)
        bs, bsa = geom["bands_sh"], geom["bands_sh_a"]
        (ns, n1), n2 = bs.shape, bsa.shape[1]
        a_t, x1_t = rnd(1, ns, heads, d, n2), rnd(1, ns, heads, d, n2, std=0.25)
        q_t, k_t, v_t = (rnd(1, ns, heads, d, n1, std=sd) for sd in (1.0, 1.0, 0.25))
        b1, b2 = 16 * torch.sigmoid(rnd(heads, n2, n1)), 16 * torch.sigmoid(rnd(heads, n1, n2))
        for shifted in (False, True):
            sb, sba = (bs, bsa) if shifted else (None, None)
            lab = f"GRL-S stripe {stripe} shift {shift if shifted else (0, 0)}"
            cases_f.append(("flash_rect_attention", f"{lab} a2w",
                            flash_case(a_t, k_t, v_t, ls, b1, sba, sb), a_t))
            cases_f.append(("flash_rect_attention", f"{lab} w2a",
                            flash_case(q_t, a_t, x1_t, ls, b2, sb, sba), q_t))
        # B7a: GRL-S 128^2 stripes (8x32 and 32x8: 256 tokens, 16 anchors)
        geom128 = geometry_tensors(s_cfg.geometry_config, (128, 128), dev)
        for key in ("sh", "sv"):
            bs, bsa = geom128[f"bands_{key}"], geom128[f"bands_{key}_a"]
            (ns, n1), n2 = bs.shape, bsa.shape[1]
            a_t, x1_t = rnd(1, ns, heads, n2, d), rnd(1, ns, heads, n2, d, std=0.25)
            q_t, k_t, v_t = (rnd(1, ns, heads, n1, d, std=sd) for sd in (1.0, 1.0, 0.25))
            b1, b2 = 16 * torch.sigmoid(rnd(heads, n2, n1)), 16 * torch.sigmoid(rnd(heads, n1, n2))
            lab = f"GRL-S 128^2 stripes {key} shifted"
            cases_f.append(("fused_cosine_attention", f"{lab} a2w",
                            cosine_case(k_t, v_t, ls, b1, dense_mask(bsa, bs)), a_t))
            cases_f.append(("fused_cosine_attention", f"{lab} w2a",
                            cosine_case(a_t, x1_t, ls, b2, dense_mask(bs, bsa)), q_t))
        # the same kernel at head dim 64 (its 64-column tiles): B6 and B7b on
        # GRL-S's windows, B7a on its 128^2 H stripes
        qkv64 = rnd6(1, nw, 3 * heads * 64, n, std=0.25)
        cases_f.append(("fused_window_attention_qkv", "GRL-S windows (8, 8) shift 4 d64",
                        window_qkv_case(ls, bias_w, bands_w), qkv64))
        cases_f.append(("fused_cosine_attention_packed", "GRL-S windows (8, 8) shift 4, P 4 d64",
                        cosine_case(rnd6(1, nw, heads, n, 64), rnd6(1, nw, heads, n, 64, std=0.25),
                                    ls, bias_w, dense_mask(bands_w, bands_w), pack=4),
                        rnd6(1, nw, heads, n, 64)))
        bs, bsa = geom128["bands_sh"], geom128["bands_sh_a"]
        (ns, n1), n2 = bs.shape, bsa.shape[1]
        cases_f.append(("fused_cosine_attention", "GRL-S 128^2 stripes sh shifted w2a d64",
                        cosine_case(rnd6(1, ns, heads, n2, 64),
                                    rnd6(1, ns, heads, n2, 64, std=0.25), ls,
                                    16 * torch.sigmoid(rnd6(heads, n1, n2)), dense_mask(bs, bsa)),
                        rnd6(1, ns, heads, n1, 64)))
        # B5: GRL-base at its eval geometry, 256^2 (3 heads of d = 30)
        ls3 = torch.tensor([math.log(10.0), 5.0, 3.0], device=dev).reshape(3, 1, 1)
        gb = geometry_tensors(sr_cfg.geometry_config, (BASE_HW, BASE_HW), dev)
        nw, n = gb["bands_w"].shape
        qb = rnd(1, nw, 3, 30, n)
        cases_f.append(("flash_rect_attention", "GRL-base window (32, 32) shift 16", flash_case(
            qb, rnd(1, nw, 3, 30, n), rnd(1, nw, 3, 30, n, std=0.25), ls3,
            16 * torch.sigmoid(rnd(3, n, n)), gb["bands_w"], gb["bands_w"]), qb))
        bs, bsa = gb["bands_sh"], gb["bands_sh_a"]
        (ns, n1), n2 = bs.shape, bsa.shape[1]
        a_t, x1_t = rnd(1, ns, 3, 30, n2), rnd(1, ns, 3, 30, n2, std=0.25)
        q_t, k_t, v_t = (rnd(1, ns, 3, 30, n1, std=sd) for sd in (1.0, 1.0, 0.25))
        cases_f.append(("flash_rect_attention", "GRL-base stripe (64, 64) shifted a2w",
                        flash_case(a_t, k_t, v_t, ls3, 16 * torch.sigmoid(rnd(3, n2, n1)),
                                   bsa, bs), a_t))
        cases_f.append(("flash_rect_attention", "GRL-base stripe (64, 64) shifted w2a",
                        flash_case(q_t, a_t, x1_t, ls3, 16 * torch.sigmoid(rnd(3, n1, n2)),
                                   bs, bsa), q_t))
        run_cases(cases_f, max_err)

    with Phase("GRL-S fused engine"):
        fz = init_weights(GRL(replace(s_cfg, dtype=torch.bfloat16, engine="fused")),
                          torch.Generator().manual_seed(3)).eval().to(dev)

        def twin(m, **kw):
            """A GRL of m's config with kw replaced, carrying m's weights."""
            t = GRL(replace(m.cfg, **kw)).eval().to(dev)
            t.load_state_dict(m.state_dict())
            return t

        fz_plain = twin(fz, kernels=False)
        n_blocks = sum(s_cfg.depths)
        runs = [("fused", 256, fz, fz_plain,
                 expect(fused_window_attention_qkv=n_blocks, flash_rect_attention=2 * n_blocks)),
                ("fused", 128, fz, fz_plain,
                 expect(fused_window_attention_qkv=n_blocks,
                        fused_cosine_attention=2 * n_blocks))]
        for engine, want in (("window", expect(fused_window_attention_qkv=n_blocks)),
                             ("stripe", expect(flash_rect_attention=2 * n_blocks))):
            runs.append((engine, 256, twin(fz, engine=engine),
                         twin(fz, engine=engine, kernels=False), want))
        for engine, size, m, m_plain, want in runs:
            lr = torch.rand(1, size, size, 3, generator=g).to(dev)
            with torch.no_grad():
                reset_counts()
                y_k = m(lr)
                torch.cuda.synchronize()
                per_fwd, unrouted, per_route = counts(), ba.unrouted_halves, routes()
                y_p = m_plain(lr)
            p = psnr(y_k, y_p)
            print(f"[model] GRL-S x4 bf16 {size}^2 engine {engine}: out {tuple(y_k.shape)}, "
                  f"launches {per_fwd} per forward, B5 by route "
                  f"{per_route['flash_rect_attention']}, unrouted halves {unrouted}, PSNR "
                  f"kernels vs plain {p:.2f} dB, rel L2 {rel_l2(y_k, y_p):.3e}")
            check(per_fwd == want and unrouted == 0,
                  f"GRL-S engine {engine} {size}^2 launches {per_fwd}")
            check(per_route == expect_routes(
                flash_rect_attention=want["flash_rect_attention"]),
                f"GRL-S engine {engine} {size}^2 routes {per_route}")
            check(tuple(y_k.shape) == (1, 4 * size, 4 * size, 3)
                  and bool(torch.isfinite(y_k).all()), f"engine {engine} output")
            check(p >= MODEL_MIN_PSNR, f"engine {engine} {size}^2 PSNR < {MODEL_MIN_PSNR} dB")
        del runs
        m32, p32 = twin(fz, dtype=torch.float32), twin(fz, dtype=torch.float32, kernels=False)
        lr = torch.rand(1, 64, 64, 3, generator=g).to(dev)
        with torch.no_grad():
            err32 = (m32(lr) - p32(lr)).abs().max().item()
        print(f"[model] GRL-S x4 fp32 64^2 engine fused: max|diff| kernels vs plain "
              f"{err32:.3e} (max {MODEL_FP32_MAX_ERR})")
        check(err32 <= MODEL_FP32_MAX_ERR, "GRL-S fp32 engine fused kernels vs plain")
        del m32, p32

    with Phase("GRL-S fused serve"):
        bucket = {"shape_bucket": 64}
        requests = [
            ("256x256", torch.rand(1, 256, 256, 3, generator=g), bucket),
            ("120x128 (64-bucket)", torch.rand(1, 120, 128, 3, generator=g), bucket),
            ("384x384 tiled 256/32", torch.rand(1, 384, 384, 3, generator=g),
             {"tile": 256, "tile_overlap": 32, "tile_batch": 4}),
        ]
        reset_counts()
        t0 = time.perf_counter()
        outs = [Restorer(fz, dev, scale=4, **kw)(img.numpy()) for _, img, kw in requests]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        got, unrouted, got_routes = counts(), ba.unrouted_halves, routes()
        served.update({k: got[k] for k in ("flash_rect_attention", "fused_window_attention_qkv",
                                           "fused_cosine_attention",
                                           "fused_cosine_attention_packed")})
        print(f"[serve] GRL-S engine fused: 3 requests in {serve_s:.2f} s, launches {got}, "
              f"B5 by route {got_routes['flash_rect_attention']}, unrouted halves {unrouted}")
        for (label, img, kw), out in zip(requests, outs):
            ref = Restorer(fz_plain, dev, scale=4, **kw)(img.numpy())
            bsz, h_, w_, _ = img.shape
            out = torch.from_numpy(out)
            finite = bool(torch.isfinite(out).all())
            p = psnr(out, torch.from_numpy(ref))
            print(f"[serve] GRL-S engine fused {label}: out {tuple(out.shape)}, finite "
                  f"{finite}, PSNR vs plain {p:.2f} dB")
            check(tuple(out.shape) == (bsz, 4 * h_, 4 * w_, 3) and finite, label)
            check(p >= MODEL_MIN_PSNR, f"{label}: PSNR vs plain path")
        # 256^2 and the 4 tiles of 384^2 (one batch) take B5 and B6, the
        # 128^2 bucket of 120x128 B7a and B6
        check(got == expect(fused_window_attention_qkv=3 * n_blocks,
                            flash_rect_attention=2 * 2 * n_blocks,
                            fused_cosine_attention=2 * n_blocks) and unrouted == 0,
              f"GRL-S engine fused served launches {got}")
        check(got_routes == expect_routes(flash_rect_attention=2 * 2 * n_blocks),
              f"GRL-S engine fused served routes {got_routes}")

    with Phase("GRL-base fused engine"):
        bf = twin(base, engine="fused")
        bf_plain = twin(base, engine="fused", kernels=False)
        n_blocks = sum(sr_cfg.depths)
        lr = torch.rand(1, BASE_MODEL_HW, BASE_MODEL_HW, 3, generator=g).to(dev)
        with torch.no_grad():
            reset_counts()
            y_k = bf(lr)
            torch.cuda.synchronize()
            per_fwd, unrouted, per_route = counts(), ba.unrouted_halves, routes()
            y_p = bf_plain(lr)
        p = psnr(y_k, y_p)
        print(f"[model] GRL-base x4 bf16 {BASE_MODEL_HW}^2 engine fused (window 32, stripes "
              f"64x64, df 2): out {tuple(y_k.shape)}, launches {per_fwd} per forward, B5 by "
              f"route {per_route['flash_rect_attention']}, unrouted halves {unrouted}, PSNR "
              f"kernels vs plain {p:.2f} dB, rel L2 {rel_l2(y_k, y_p):.3e}")
        check(per_fwd == expect(flash_rect_attention=3 * n_blocks) and unrouted == 0,
              f"GRL-base engine fused launches {per_fwd}")
        check(per_route == expect_routes(flash_rect_attention=3 * n_blocks),
              f"GRL-base engine fused routes {per_route}")
        check(tuple(y_k.shape) == (1, 4 * BASE_MODEL_HW, 4 * BASE_MODEL_HW, 3)
              and bool(torch.isfinite(y_k).all()), "GRL-base engine fused output")
        check(p >= MODEL_MIN_PSNR, f"GRL-base engine fused PSNR < {MODEL_MIN_PSNR} dB")

    with Phase("repair: GRL-base dn 1080x1920 whole"):
        # zoo GRL-base denoiser (window 8, stripes 8 x W/4, df 4) cut to one
        # stage of four blocks; at 1088x1920 its H stripes (8, 480) fit no
        # TPU route and run the plain cosine attention, its V stripes
        # (272, 8) B4, its windows B1
        rp_cfg = zoo.make_config("base", task="dn", depths=(4,), num_heads_window=(3,),
                                 num_heads_stripe=(3,), dtype=torch.bfloat16)
        rp = init_weights(GRL(rp_cfg), torch.Generator().manual_seed(4)).eval()
        with torch.no_grad():
            rp.conv_last.weight.mul_(0.1)
            rp.conv_last.bias.mul_(0.1)
        rp = rp.to(dev)
        rp_plain = twin(rp, kernels=False)
        frame = torch.rand(1, 1080, 1920, 3, generator=g)
        reset_counts()
        t0 = time.perf_counter()
        out = torch.from_numpy(Restorer(rp, dev, scale=1)(frame.numpy()))
        rp_s = time.perf_counter() - t0
        got, unrouted, got_routes = counts(), ba.unrouted_halves, routes()
        ref = torch.from_numpy(Restorer(rp_plain, dev, scale=1)(frame.numpy()))
        finite = bool(torch.isfinite(out).all())
        p = psnr(out, ref)
        print(f"[repair] GRL-base dn 1080x1920 whole, 4 blocks, engine v3 bf16: out "
              f"{tuple(out.shape)} in {rp_s:.2f} s, finite {finite}, launches {got}, "
              f"B1-B4 by route {got_routes}, unrouted halves {unrouted}, PSNR vs "
              f"kernels=False {p:.2f} dB")
        check(unrouted == 2 and got == expect(window_half=4, stripe_a2w_large=2,
                                              stripe_w2a_large=2),
              f"repair launches {got}, unrouted halves {unrouted}")
        check(got_routes == expect_routes(window_half=4, stripe_a2w_large=2,
                                          stripe_w2a_large=2),
              f"repair routes {got_routes}")
        check(tuple(out.shape) == (1, 1080, 1920, 3) and finite, "repair output")
        check(p >= MODEL_MIN_PSNR, "repair: PSNR vs kernels=False")
        del rp, rp_plain, out, ref

    with Phase("C2: head dim 64 blocks"):
        # one GRL block of 2 + 2 heads of d = 64 (dim 256) per engine, bf16,
        # kernels on against off: at GRL-S's geometry on 256^2 B1 and B2
        # (v3) or B6 and B5 twice (fused, 8 x 64 stripes); at GRL-base's
        # eval geometry on 128^2 B3 and B4's two steps (v3) or B5 three
        # times (fused).  Every half runs its kernel.
        from grlir_torch.models.blocks import EfficientMixAttnTransformerBlock
        x = rnd6(1, GRL_S_HW, GRL_S_HW, 256)
        for cfg, hw, engine, want in (
                (s_cfg, GRL_S_HW, "v3", dict(window_half=1, stripe_half=1)),
                (s_cfg, GRL_S_HW, "fused", dict(fused_window_attention_qkv=1,
                                                flash_rect_attention=2)),
                (sr_cfg, BASE_MODEL_HW, "v3", dict(window_half_large=1, stripe_a2w_large=1,
                                                   stripe_w2a_large=1)),
                (sr_cfg, BASE_MODEL_HW, "fused", dict(flash_rect_attention=3))):
            geom = geometry_tensors(cfg.geometry_config, (hw, hw), dev)
            blk = init_weights(EfficientMixAttnTransformerBlock(
                256, 2, 2, cfg.window_size, True, cfg.stripe_size, cfg.stripe_groups,
                "H", True, 2.0, cfg.anchor_window_down_factor, engine=engine),
                torch.Generator().manual_seed(5)).eval().to(dev)
            xb = x[:, :hw, :hw].bfloat16()
            with torch.no_grad():
                reset_counts()
                y_k = blk(xb, geom, torch.bfloat16, kernels=True)
                torch.cuda.synchronize()
                got, got_routes = counts(), routes()
                y_p = blk(xb, geom, torch.bfloat16, kernels=False)
            r = rel_l2(y_k, y_p)
            name_ = "GRL-S" if cfg is s_cfg else "GRL-base"
            print(f"[C2] block 2+2 heads of d 64 at {name_}'s geometry, engine {engine}, bf16 "
                  f"{hw}^2: launches { {k: n for k, n in got.items() if n} }, routes "
                  f"{ {k: r_ for k, r_ in got_routes.items() if any(r_.values())} }, "
                  f"unrouted halves {ba.unrouted_halves}, rel L2 kernels vs plain {r:.3e} "
                  f"(max 1e-2), finite {bool(torch.isfinite(y_k).all())}")
            routed = {k: n for k, n in want.items() if k in got_routes}
            check(got == expect(**want) and got_routes == expect_routes(**routed)
                  and ba.unrouted_halves == 0, f"C2 {name_} engine {engine} launches {got}")
            check(bool(torch.isfinite(y_k).all()) and r <= 1e-2,
                  f"C2 {name_} engine {engine} output")
            del blk

    with Phase("C3: kernels under grad"):
        # B1-B4 with kernels on under grad: the kernel runs forward (its
        # output equals the no-grad launch's to the bit, and the plain
        # version's within the route's gate), the backward is the plain
        # version's, so every operand's gradient equals kernels=False's;
        # fp32 and bf16, small shapes
        def grad_case(kind, dtype):
            w_, b_ = rnd6(64, 3 * 96, std=0.05), rnd6(3 * 96, std=0.05)
            l1 = torch.tensor([math.log(10.0), 5.0, 3.0], device=dev).reshape(3, 1, 1)
            if kind in ("window_half", "window_half_large"):
                win_ = (8, 8) if kind == "window_half" else (32, 32)
                size = (32, 32) if kind == "window_half" else (64, 64)
                n_ = win_[0] * win_[1]
                g_ = geometry_tensors(replace(s_cfg.geometry_config, window_size=win_),
                                      size, dev)
                args = [rnd6(1, *size, 64).to(dtype), w_, b_, l1,
                        16 * torch.sigmoid(rnd6(3, n_, n_))]
                return args, lambda a, k: ba.window_half(*a, win_, g_["bands_w"], win_[0] // 2,
                                                         kernels=k)
            stripe, df_ = ((8, 16), 4) if kind == "stripe_half" else ((64, 64), 2)
            size = (32, 64) if kind == "stripe_half" else (64, 64)
            n1_, n2_ = stripe[0] * stripe[1], (stripe[0] // df_) * (stripe[1] // df_)
            args = [rnd6(1, *size, 64).to(dtype),
                    rnd6(1, size[0] // df_, size[1] // df_, 96).to(dtype), w_, b_, l1,
                    l1 * 0.9, 16 * torch.sigmoid(rnd6(3, n2_, n1_)),
                    16 * torch.sigmoid(rnd6(3, n1_, n2_))]
            return args, lambda a, k: ba.stripe_half(*a, stripe, df_, kernels=k)

        for kind, tag in (("window_half", "B1"), ("window_half_large", "B3"),
                          ("stripe_half", "B2"), ("stripe_a2w_large", "B4a + B4b")):
            for dtype in (torch.float32, torch.bfloat16):
                args, call = grad_case(kind, dtype)
                with torch.no_grad():
                    y_ng = {kern: call(args, kern) for kern in (True, False)}
                grads, ran, same = [], [], []
                for kern in (True, False):
                    leaves = [a.detach().clone().requires_grad_(True) for a in args]
                    reset_counts()
                    y = call(leaves, kern)
                    ran.append(sum(counts().values()))
                    same.append(torch.equal(y.detach(), y_ng[kern]))
                    (y.float() * torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)
                     ).sum().backward()
                    grads.append([t.grad.float() for t in leaves])
                worst = max(((g - h).abs().max() / h.abs().max().clamp_min(1e-30)).item()
                            for g, h in zip(*grads))
                y_k_, y_p_ = y_ng[True].float(), y_ng[False].float()
                y_err = (y_k_ - y_p_).abs().max().item()
                if dtype == torch.float32:
                    y_ok = torch.allclose(y_k_, y_p_, atol=FP32_TOL, rtol=FP32_TOL)
                    y_gate = f"atol {FP32_TOL} rtol {FP32_TOL}"
                else:
                    top = y_p_.abs().max().item()
                    y_ok = y_err <= max(BF16_MAX_ERR, 2 * bf16_ulp(top))
                    y_gate = f"max {max(BF16_MAX_ERR, 2 * bf16_ulp(top)):.3e}"
                n_k = {"stripe_a2w_large": 2}.get(kind, 1)
                print(f"[C3] {tag} {str(dtype)[6:]}: launches under grad {ran[0]} (plain "
                      f"{ran[1]}), y under grad equal to the no-grad launch's {same[0]}, "
                      f"kernel y vs plain max|diff| {y_err:.3e} (gate {y_gate}), every "
                      f"operand's gradient vs kernels=False: largest max|diff| / max|grad| "
                      f"{worst:.3e}")
                check(ran == [n_k, 0] and all(same) and y_ok and worst <= 1e-5,
                      f"C3 {tag} {dtype}")

    with Phase("fused engines timing"):
        # one shape a kernel for the per-kernel line (the shifted shapes of
        # the served GRL-S requests; B7b at its window shapes); the others
        # print only
        keep = {"GRL-S windows (8, 8) shift 4", "GRL-S windows (8, 8) shift 4, P 4",
                "GRL-S stripe (8, 64) shift (4, 32) w2a", "GRL-S 128^2 stripes sh shifted w2a"}
        also = {"GRL-S stripe (8, 64) shift (4, 32) a2w", "GRL-S 128^2 stripes sh shifted a2w",
                "GRL-base window (32, 32) shift 16", "GRL-base stripe (64, 64) shifted a2w",
                "GRL-base stripe (64, 64) shifted w2a"}
        for kname, label, case, xc in cases_f:
            if label in keep | also:
                time_case(kname, label, case, xc, 5, 2, timing if label in keep else {})
        lr = torch.rand(1, GRL_S_HW, GRL_S_HW, 3, generator=g).to(dev)
        with torch.no_grad():
            k_ms, p_ms = ab_ms(lambda: fz_plain(lr), lambda: fz(lr), 10, 3)
        mp = GRL_S_HW * GRL_S_HW / 1e6
        print(f"[time] GRL-S x4 {GRL_S_HW}^2 bs1 bf16 forward, engine fused: kernels "
              f"{k_ms:.3f} ms ({mp / (k_ms / 1e3):.4f} MP/s), plain {p_ms:.3f} ms "
              f"({mp / (p_ms / 1e3):.4f} MP/s) [{smi}]")
        lr = torch.rand(1, BASE_HW, BASE_HW, 3, generator=g).to(dev)
        with torch.no_grad():
            k_ms, p_ms = ab_ms(lambda: bf_plain(lr), lambda: bf(lr), 3, 1)
        mp = BASE_HW * BASE_HW / 1e6
        print(f"[time] GRL-base x4 {BASE_HW}^2 bs1 bf16 forward, engine fused (window 32, "
              f"stripes 64x64, df 2): kernels {k_ms:.3f} ms ({mp / (k_ms / 1e3):.4f} MP/s), "
              f"plain {p_ms:.3f} ms ({mp / (p_ms / 1e3):.4f} MP/s) [{smi}]")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": served[k], "max_abs_err": max_err[k], **timing[k]}
        for k in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
