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
     end); since slice 11 B3 also at the JPEG experiment's window 36 on
     288^2 (GRL-S width, shifts 0 and 18), and B1's bf16 route at window
     16 on the same stage gates (`grlir_torch.b1_spread`), over its twelve
     input draws too (ROADMAP C9);
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
     B5's bf16 route is also run over the twelve input draws of
     `grlir_torch.b5_spread` at GRL-base's three steps and held to the stage
     gates of `b3_spread` (ROADMAP C5);
  6. the Restorer on CUDA graphs (ROADMAP A6): GRL-S x4 256^2 (bucket 64) and
     GRL-base's dn tile pair (a 256x480 image as two 256^2 tiles, stripes
     64x128), each on its one graph: the replay against the eager kernel
     path on the same input (equal to the bit, PSNR >= 60 dB); the launches
     counted over the shape's first call (WARMUP_FORWARDS eager forwards and
     the capture), over WARMUP_FORWARDS + 1, equal to an eager forward's (B1
     and B2 16 each; B3, B4a and B4b 40 each): with the bit-equal replay,
     these show that a replay runs the captured kernels; PROFILED_RUNS
     profiled replays and eager forwards recording every CUDA kernel of the
     port PROFILED_RUNS times as often as those calls launch it (PER_CALL),
     one record short at most (C10: CUPTI drops a record at times); a qkv
     weight scaled by 1.001 in place moving the next replay, which matches
     eager with that weight;
     eager against replay in paired CUDA-event runs, ms a forward, MP/s and
     the device-busy share of each;
  7. validation (ROADMAP A6): three structured 1024^2 GT images, LR by the
     port's imresize(1/4), in two batches that repeat one index, through
     `validate` with GRL-S x4 on its graph and again with kernels=False
     (PSNR, PSNR-Y, SSIM, SSIM-Y, PSNR-B, PSNR-B-Y, then NIQE on a GT-free
     copy): the two within 0.01 dB and 1e-4 of SSIM, and the card's metrics
     of the first batch within 1e-3 dB and 1e-5 of the same restorations
     scored on the CPU.
  8. the trainer (ROADMAP A7): `grlir_torch.train.main` on a synthetic data
     root (16 structured 320^2 GT PNGs with x4 LR, two val images) with
     experiment=sr/grl_p256 at GRL-S width, bs8, bf16, kernels on (v3): 3
     steps, then a resume to 6 (the saved optimizer state and LR checked),
     validation and checkpoints at 3 and 6, results.csv, and the final
     checkpoint served through `grlir_torch.serve` from a PNG file; launch
     counts reset just before the CLI run and read just after (B3, B4a and
     B4b, the routes the recipe's window 32 and 64x64 stripes take, must
     launch under grad); then (slice 11) the JPEG recipe
     (experiment=jpeg/grl_p288 at its geometry: GRL-S, window 36, fixed
     72x144 stripes, df 4, patch 288, bf16 with the kernels under grad) on
     the same root with a two-image LIVE1 set: 2 steps, a resume to 3,
     every B3 launch on the tensor-core route, the stripe halves unrouted
     and no B4, then its step timed; the gates of `grlir_torch.train_cells` (fp32 one
     step, kernels on vs off: loss within 1e-5 relative, gradients within
     1e-3 max|g| + 1e-7; bf16 ten steps of cells a and b: finite losses
     within 2e-2 of kernels off at every step, falling in both modes; a
     Restorer's replay after optimizer steps equal to eager); then each
     cell's train step timed kernels off and on (10 steps after 3, CUDA
     events: median, min-max, samples/s, peak memory, device-busy share,
     launches a step by kernel and route).  The JSON line adds
     `train_launches` (the CLI run) and `train_step_launches` (one step of
     cell a, the recipe, and b, zoo.GRL_SMALL's geometry) to every kernel.
  9. real-world SR training (ROADMAP A9) on a synthetic BSR data root
     (OST-style train images, one under 400^2; GT-free RealSR and Set5 x4
     val sets): stage 1 `experiment=bsr/grl_psnr` 2 steps, then stage 2
     `experiment=bsr/grl` (the GAN runner) at GRL-base-bsr's full width
     (window 16, stripes 32x64, df 4, UNet-SN 64, LR 128^2, GT 512^2, bs1,
     remat, Adam 1e-5, lightning parity, a random VGG19 file so that the
     perceptual term runs) warm-started from stage 1's checkpoints: 3
     steps, NIQE validation and a best-val_niqe checkpoint, then a resume
     to 6 (the step, both optimizer states and the u vectors checked);
     launch counts reset just before stage 2 and read just after (B1, B4a
     and B4b must launch, no half unrouted); the host time of a BSR
     sample; the BSR data's OpenCV calls (`grlir_torch/bsr_ops_cells.py`:
     GaussianBlur, filter2D, the three resizes, HSV and one
     degradation_sr2 draw at the 400^2 crop's shapes) bit for bit
     against the committed cv2 fixture; the gates of
     `grlir_torch/gan_cells.py` for both protocols
     (fp32 one step: losses within 1e-5 relative, every G and D gradient
     within 1e-3 max|g| + 1e-7, u within 1e-5; bf16 ten steps: finite and
     within 2e-2); then the GAN step timed per protocol, kernels off and
     on (10 steps after 1, CUDA events, peak memory, device-busy share,
     launches a step by route), once with cuDNN's TF32 on as the CLI
     runs, and in bf16 (lightning-parity, kernels off and on, every
     kernels-on launch of B1 and B4 on its tensor-core route).  The JSON line adds `gan_launches` (stage 2's CLI runs) and
     `gan_step_launches` (one step of each protocol).
 10. training across processes (ROADMAP A8): the PSNR CLI at world size 1
     on NCCL through GRLIR_COORDINATOR, in a process of its own beside the
     same run undistributed (deterministic algorithms, one hash seed): the
     last loss and the saved parameters equal to the bit; then two ranks
     sharing the card over gloo (`grlir_torch.parallel_cells`: GRL-S fp32,
     kernels on, 3 SGD steps at 2 rows a rank; a tiled Restorer across the
     ranks; validation metrics gathered from the ranks' strides) against
     one process on the global batch at that module's gates, both ranks
     launching B1 and B2.  The JSON line adds `jpeg_launches` (the JPEG
     CLI run) and `parallel_launches` (the NCCL CLI run, each gloo rank).
 11. the rest of GRL's model surface (slice 12, `grlir_torch.ablation_cells`):
     GRL-S x4 at 256^2, bs1, bf16 with each ablation switch on its own, on
     the engine where it reaches a kernel (fused for the branches grlir
     sends down its legacy route, which project qkv first: B6 on the window
     half, B7a twice on an anchored stripe half, both also held against
     their plain versions in phase 5 on that route's inputs, the projected
     qkv and GRL-S 256^2's d-major 512-token stripes; v3 for the anchor,
     output-projection and last-conv variants: B1 and B2): launches a
     forward against the prediction, kernels vs kernels=False PSNR >= 60 dB
     and fp32 64^2 max|diff| <= 5e-4, the forward timed, peak memory;
 12. classification training: the train phase's CLI with loss=l1_ce on gray
     images (3 steps, validation on the formed image, a resume to 6), one
     step's launches, time and peak memory, one fp32 step kernels on vs off
     at the train cells' gates;
 13. remat policies: train cell b under remat with policies None, "dots" and
     "dots_no_batch", the fp32 gradients of each against None's (within
     1e-5 max|g| + 1e-9), each policy's bf16 step timed with its launches
     (the kernels run in the forward and again in the recompute).  The JSON
     line adds `ablation_launches` (a forward of each variant),
     `classification_launches` (the CLI run) and `remat_step_launches`;
 14. host_io (`grlir_torch/host_io_cells.py`, the committed fixtures of
     `grlir_torch/assets/host_io/`): JPEG (baseline, progressive, EXIF 6),
     BMP (8-bit palette, 24-bit), TIFF (LZW) and PPM files decoded equal to
     their stored cv2 decodings (ms a file); served through
     `grlir_torch.serve` with GRL-S x4 bf16 v3 (B1 and B2 16 a forward),
     equal to the bit to serving the same pixels from PNG; grlir's orbax
     checkpoint read without orbax into a Restorer equal to the same params
     from `.msgpack` (read MB/s); `profiling.trace` of five GRL-S forwards
     naming B1's and B2's kernels at the counters' counts, one record short
     at most; `device_memory_stats`; `cost_analysis` FLOPs kernels on within
     1% of off; the PSNR CLI on GT images smaller than the patch.  The JSON
     line adds `host_io_launches`.
  On the card the Restorer runs every served request on a CUDA graph, so
  the serve phases count the launches of the traced forwards (each graph's
  warm-up forwards and capture); its replays launch without counting.
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

import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

GRL_S_HW = 256
BASE_HW = 256              # GRL-base x4 LR timing size (an eval tile)
BASE_MODEL_HW = 128        # GRL-base x4 bf16 kernels-vs-plain check
BF16_MAX_ERR = 1e-2        # bf16 outputs: a few ulps at |y| < 1
# The bf16 gate of the tensor-core routes (B1, B2, B4), max(BF16_MAX_ERR, 2
# bf16 ulps of max|plain|, the plain path's own spread): their tensor-core
# sums of the projection round k, q and v to bf16 in another order than the
# plain path, and the clamped head's logit scale of 100 turns a one-ulp
# flip of k or q into about a percent of a probability, so y moves by a
# fraction of the values it averages.  The spread is max|plain - the plain
# path with its projection summed in float64|: where two faithful orders of
# the plain path's own sums land further apart than 2 ulps (B1 at window
# 16, ROADMAP C8), the kernel may land as far.  B3's bf16 route is held to
# the stage gates of grlir_torch.b3_spread instead.
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


def time_ms(fn, runs, warmup) -> list:
    """Per-call CUDA-event times after warm-up."""
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
    return times


def ab_ms(plain, kernel, runs=20, warmup=5):
    """Plain and kernel times in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = (statistics.median(time_ms(f, runs, warmup))
                      for f in (plain, kernel, kernel, plain))
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
            # the head's columns in shared memory (B1's and B3-B7's tiles)
            cols = first.split("Li", 1)[1].split("E", 1)[0] if "Li" in first else ""
            cols = f", {cols} columns" if cols.isdigit() else ""
            name = f"{src}:{kind}<{'bf16' if bf16 else 'fp32'}{cols}>"
        elif "spill" in line and name:
            spill = line.strip()
        elif "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


# the CUDA kernels one bf16 call of each block-half wrapper launches
# (csrc/*.cu): B2, B3 and B4 project on tensor cores first; B4's steps
# unit-norm the anchors, w2a pads x1's rows
PER_CALL = {
    "window_half": {"window_half_mma_kernel": 1},
    "stripe_half": {"mma_project_kernel": 1, "mma_stripe_resident_kernel": 1},
    "window_half_large": {"mma_project_kernel": 1, "mma_attend_kernel": 1},
    "stripe_a2w_large": {"anchor_units_kernel": 1, "mma_project_kernel": 1,
                         "mma_attend_kernel": 1},
    "stripe_w2a_large": {"anchor_units_kernel": 1, "mma_project_kernel": 1,
                         "pad_rows_kernel": 1, "mma_attend_kernel": 1},
}
GRAPH_RUNS = 10            # paired eager / replay timings of a forward
PROFILED_RUNS = 5          # profiled replays (and eager forwards) a graph case
VAL_HW = 1024              # validation GT size (LR 256^2 at x4)
VAL_DB_TOL, VAL_SSIM_TOL = 0.01, 1e-4          # kernels vs kernels=False
HOST_DB_TOL, HOST_SSIM_TOL = 1e-3, 1e-5        # card vs CPU metrics


def profile_kernels(fn, calls: int = 1):
    """fn() `calls` times under torch.profiler: ({CUDA kernel of the port:
    launches}, device ms a call of every CUDA kernel and copy)."""
    from torch.profiler import ProfilerActivity, profile

    from grlir_torch.profile_b4 import device_us

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    port, dev_us = {}, 0.0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us += device_us(e)
        m = re.search(r"(\w+_kernel)[<(]", e.key)
        if m and m.group(1) in KERNEL_KINDS:
            port[m.group(1)] = port.get(m.group(1), 0) + e.count
    return port, dev_us / 1e3 / calls


def kernels_of(calls: dict) -> dict:
    """The CUDA kernels that `calls` ({wrapper: bf16 calls}) launch."""
    want = {}
    for w, n in calls.items():
        for k, c in PER_CALL.get(w, {}).items() if n else ():
            want[k] = want.get(k, 0) + n * c
    return want


def paired_ms(fn_a, fn_b, runs):
    """CUDA-event times of fn_a and fn_b in turns (a, b, b, a, ...): two
    lists of ms."""
    times = ([], [])
    for i in range(runs):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            (fn_a, fn_b)[j]()
            b.record()
            b.synchronize()
            times[j].append(a.elapsed_time(b))
    return times


def spread(ts) -> str:
    return f"{statistics.median(ts):.3f} ms (min {min(ts):.3f}, max {max(ts):.3f})"


def val_images(seed: int, n: int, hw: int) -> np.ndarray:
    """n structured RGB images (gradients, edges, checks, texture) on the
    1/255 grid, (n, hw, hw, 3) float32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    out = []
    for i in range(n):
        f = 6 + 4 * i
        base = (0.5 + 0.25 * np.sin(2 * np.pi * f * x) * np.cos(2 * np.pi * (f - 3) * y)
                + 0.15 * (((x * 16).astype(int) + (y * 16).astype(int)) % 2) - 0.075)
        tint = np.array([1.0, 0.9 - 0.1 * i, 0.8 + 0.1 * i], np.float32)
        img = base[..., None] * tint + 0.03 * rng.standard_normal((hw, hw, 3))
        out.append(np.round(np.clip(img, 0, 1) * 255) / 255)
    return np.stack(out).astype(np.float32)


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


TRAIN_WARMUP, TRAIN_RUNS = 3, 10     # train-step timing: warm-up, timed steps
# the trainer CLI of the train and classification phases: the SR recipe
# (experiment=sr/grl_p256's own defaults select grl_tiny after the CLI's
# model=grl/grl_small, as grlir composes; GRL-S's width and tail are set
# explicitly), bs8, bf16, the v3 kernels under grad
TRAIN_CLI_ARGS = ["experiment=sr/grl_p256", "model=grl/grl_small", "model.name=grl_small",
                  "model.embed_dim=128", "model.upsampler=pixelshuffle", "batch_size=8",
                  "dtype=bfloat16", "model.use_pallas_attention=v3",
                  "trainer.val_check_interval=3", "trainer.log_every_n_steps=1",
                  "data_module.train.dataset=div2k", "data_module.val.dataset=set5",
                  "num_workers=4"]
TRAIN_GT_HW, TRAIN_IMAGES = 320, 16  # the trainer's synthetic data root


def profile_step(fn, top: int = 6):
    """fn() once under torch.profiler: (device ms of every CUDA kernel and
    copy, the `top` largest as (ms, launches, name)).  The optimizer's
    `record_function` range also shows as a device row, over kernels
    already counted: user annotations are left out."""
    from torch.profiler import ProfilerActivity, profile

    from grlir_torch.profile_b4 import device_us

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False)):
            ms, n = rows.get(e.name, (0.0, 0))
            rows[e.name] = (ms + device_us(e) / 1e3, n + 1)
    largest = sorted(((ms, n, name) for name, (ms, n) in rows.items()), reverse=True)
    return sum(ms for ms, _ in rows.values()), largest[:top]


def write_train_root(root) -> str:
    """A synthetic data root for `grlir_torch.train`: TRAIN_IMAGES
    structured GT PNGs with their x4 LR (the port's imresize), a DIV2K
    x4 manifest, and a two-image Set5-style x4 val set; returns the first
    val LR file."""
    import os

    from grlir_torch.utils.image import to_uint8
    from grlir_torch.utils.imageio import imwrite
    from grlir_torch.utils.matlab import imresize

    def put(rel, img):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        imwrite(path, to_uint8(img))

    def manifest(rel, entries):
        path = os.path.join(root, "image_info", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(entries, f)

    train, val = [], []
    for i, gt in enumerate(val_images(9, TRAIN_IMAGES, TRAIN_GT_HW)):
        put(f"DIV2K/train/{i:04d}.png", gt)
        put(f"DIV2K/train_x4/{i:04d}.png", imresize(gt, 0.25))
        train.append({"path_gt": f"train/{i:04d}.png", "path_lq": f"train_x4/{i:04d}.png"})
    for i, gt in enumerate(val_images(10, 2, 256)):
        put(f"test_set/Set5/v{i}.png", gt)
        put(f"test_set/Set5/v{i}_x4.png", imresize(gt, 0.25))
        val.append({"path_gt": f"Set5/v{i}.png", "path_lq": f"Set5/v{i}_x4.png"})
    manifest("DIV2K/train_X4.json", train)
    manifest("Set5/test_X4.json", val)
    return os.path.join(root, "test_set", "Set5", "v0_x4.png")


JPEG_STEPS, JPEG_RUNS = 2, 5     # the JPEG recipe's step: warm-up, timed steps


def write_jpeg_root(root) -> None:
    """The JPEG experiment's data on write_train_root's root: a DIV2K
    manifest of its GT images (320^2, over the recipe's 288^2 patch) and a
    two-image LIVE1 val set of 288^2."""
    import os

    from grlir_torch.utils.image import to_uint8
    from grlir_torch.utils.imageio import imwrite

    with open(os.path.join(root, "image_info", "DIV2K", "train.json"), "w") as f:
        json.dump([{"path": f"train/{i:04d}.png"} for i in range(TRAIN_IMAGES)], f)
    os.makedirs(os.path.join(root, "test_set", "LIVE1"), exist_ok=True)
    for i, gt in enumerate(val_images(12, 2, 288)):
        imwrite(os.path.join(root, "test_set", "LIVE1", f"l{i}.png"), to_uint8(gt))
    os.makedirs(os.path.join(root, "image_info", "LIVE1"), exist_ok=True)
    with open(os.path.join(root, "image_info", "LIVE1", "test.json"), "w") as f:
        json.dump([{"path": f"LIVE1/l{i}.png"} for i in range(2)], f)


def jpeg_run(dev, smi, counts, routes, out: str) -> dict:
    """experiment=jpeg/grl_p288 at its own geometry (GRL-S, window 36,
    fixed 72x144 stripes, df 4, patch 288, bs1) in bf16 with the kernels
    on under grad too (model.use_pallas_attention=v3), on the data root of
    $GRLIR_DATA_ROOT: 2 CLI steps, then a resume to 3, validation on LIVE1
    at 2 and 3 (576-tiles clipped to the 288^2 images); every B3 launch on
    the tensor-core route, the stripe halves unrouted, no B4; then the
    step timed.  Returns the CLI run's launches (counts set to 0 just
    before, read just after)."""
    import os

    from grlir_torch.configs import load_config
    from grlir_torch.engines.train import TrainState, make_train_step
    from grlir_torch.models.grl import GRL, init_weights
    from grlir_torch.ops import block_attn as ba
    from grlir_torch.optim import build_optimizer
    from grlir_torch.train import build_model_config
    from grlir_torch.train import main as train_main

    args = ["experiment=jpeg/grl_p288", "data_module.train.dataset=div2k", "dtype=bfloat16",
            "model.use_pallas_attention=v3", "trainer.val_check_interval=2",
            "trainer.log_every_n_steps=1", f"io.base_output_path={out}", "tag=chip_jpeg",
            "num_workers=4"]
    cfg = build_model_config(load_config(args))
    n_blocks = sum(cfg.depths)
    ba.reset_launches()
    t0 = time.perf_counter()
    train_main(args + [f"trainer.max_steps={JPEG_STEPS}"])
    t1 = time.perf_counter()
    train_main(args + [f"trainer.max_steps={JPEG_STEPS + 1}"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cli, by_route, unrouted = counts(), routes(), ba.unrouted_halves
    run = os.path.join(out, "chip_jpeg", "version_0")
    with open(os.path.join(run, "results.csv")) as f:
        rows = f.read().splitlines()
    steps = [r.split(",")[2] for r in rows[1:]]
    print(f"[jpeg] CLI {' '.join(args)}: {JPEG_STEPS} steps in {t1 - t0:.1f} s, resumed to "
          f"{JPEG_STEPS + 1} in {t2 - t1:.1f} s; results.csv {rows[1:]}; checkpoints "
          f"{sorted(os.listdir(os.path.join(run, 'checkpoints')))}; B3 launches by route "
          f"{by_route['window_half_large']}, launches { {k: n for k, n in cli.items() if n} }, "
          f"unrouted halves {unrouted}")
    check(steps == [str(JPEG_STEPS), str(JPEG_STEPS + 1)], f"jpeg CLI: results.csv {steps}")
    check(cli["window_half_large"] > 0
          and by_route["window_half_large"] == {"tensor_core": cli["window_half_large"],
                                                "cuda_core": 0},
          f"jpeg CLI: B3 off its bf16 route {by_route}")
    check(all(n == 0 for k, n in cli.items() if k != "window_half_large"),
          f"jpeg CLI: launches {cli}")
    # every block's stripe half runs the plain attention: each forward
    # (a train step's, a validation graph's warm-up and capture) counts
    # n_blocks
    check(unrouted > 0 and unrouted % n_blocks == 0, f"jpeg CLI: unrouted halves {unrouted}")

    # the step, timed
    model = init_weights(GRL(cfg), torch.Generator().manual_seed(0)).to(dev)
    opt, sched = build_optimizer(model.parameters(), "adamw", learning_rate=1e-4)
    state = TrainState(model.train(), opt, sched, generator=torch.Generator().manual_seed(1),
                       rng=np.random.default_rng(2))
    gt = torch.from_numpy(val_images(13, 1, 288)).to(dev)
    batch = {"img_lq": (gt + 0.05 * torch.randn(gt.shape, generator=torch.Generator()
                                                  .manual_seed(3)).to(dev)).clamp(0, 1),
             "img_gt": gt}
    step = make_train_step({"charbonnier": 1.0})
    for _ in range(JPEG_STEPS):
        step(state, batch)
    torch.cuda.synchronize()
    ba.reset_launches()
    step(state, batch)
    torch.cuda.synchronize()
    launched, unrouted = counts(), ba.unrouted_halves
    torch.cuda.reset_peak_memory_stats()
    times = time_ms(lambda: step(state, batch), JPEG_RUNS, 0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[time] jpeg step GRL-S window 36 stripes 72x144 bf16 bs1 288^2: {spread(times)} a "
          f"step over {JPEG_RUNS} steps after {JPEG_STEPS + 1}, peak {peak:.2f} GiB; launches "
          f"a step { {k: n for k, n in launched.items() if n} }, unrouted halves {unrouted} "
          f"[{smi}]")
    check(launched["window_half_large"] == n_blocks and unrouted == n_blocks,
          f"jpeg step: launches {launched}, unrouted {unrouted}")
    del state, model
    return cli


def train_phase(dev, smi, counts, routes):
    """The trainer (ROADMAP A7) on the card; returns the launches of the
    CLI run (counts set to 0 just before, read just after) and those of one
    kernels-on train step in cells a and b."""
    import copy
    import os
    import tempfile

    from grlir_torch import serve
    from grlir_torch import train_cells as tc
    from grlir_torch.engines.inference import Restorer
    from grlir_torch.engines.train import make_train_step
    from grlir_torch.models import zoo
    from grlir_torch.models.grl import GRL
    from grlir_torch.ops import block_attn as ba
    from grlir_torch.train import main as train_main
    from grlir_torch.utils import checkpoint as ckpt_mod
    from grlir_torch.utils.image import to_uint8
    from grlir_torch.utils.imageio import imread

    cells = {c: tc.cell_config(c) for c in "ab"}
    for c, cfg in cells.items():
        print(f"[train] cell {c}: window {cfg.window_size}, stripes {cfg.stripe_size} groups "
              f"{cfg.stripe_groups}, df {cfg.anchor_window_down_factor}, bs {tc.BATCH}, LR "
              f"{tc.LR_HW}^2 x{tc.SCALE}: routes at {tc.LR_HW}^2 {tc.admitted(cfg)}")

    # ---- the CLI: 3 steps, then a resume to 6, on a synthetic data root
    tmp = tempfile.TemporaryDirectory()
    saved_env = {k: os.environ.get(k) for k in ("GRLIR_DATA_ROOT", "GRLIR_CACHE_DIR")}
    os.environ["GRLIR_DATA_ROOT"] = os.path.join(tmp.name, "data")
    os.environ["GRLIR_CACHE_DIR"] = os.path.join(tmp.name, "cache")
    restore, seen = ckpt_mod.CheckpointManager.restore, {}

    def spy(self, model, optimizer=None, scheduler=None, step=None):
        got = restore(self, model, optimizer, scheduler, step)
        seen.update(step=got, opt=copy.deepcopy(optimizer.state_dict()),
                    lr=optimizer.param_groups[0]["lr"], last_epoch=scheduler.last_epoch)
        return got

    try:
        val_png = write_train_root(os.environ["GRLIR_DATA_ROOT"])
        out = os.path.join(tmp.name, "out")
        args = TRAIN_CLI_ARGS + [f"io.base_output_path={out}", "tag=chip_train"]
        ckpt_mod.CheckpointManager.restore = spy
        ba.reset_launches()
        t0 = time.perf_counter()
        train_main(args + ["trainer.max_steps=3"])
        t1 = time.perf_counter()
        train_main(args + ["trainer.max_steps=6"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cli_counts, cli_routes = counts(), routes()
        run = os.path.join(out, "chip_train", "version_0")
        ckdir = os.path.join(run, "checkpoints")
        saved = torch.load(os.path.join(ckdir, "step_3", "checkpoint.pt"),
                           map_location="cpu", weights_only=True)
        same_opt = seen.get("opt", {}).get("state", {}).keys() == saved["optimizer"]["state"].keys()
        for i, st in saved["optimizer"]["state"].items():
            for k, v in st.items():
                same_opt &= torch.equal(torch.as_tensor(seen["opt"]["state"][i][k]).cpu(),
                                        torch.as_tensor(v))
        with open(os.path.join(run, "results.csv")) as f:
            steps = [row.split(",")[2] for row in f.read().splitlines()[1:]]
        print(f"[train] CLI {' '.join(args)}: 3 steps in {t1 - t0:.1f} s, resumed to 6 in "
              f"{t2 - t1:.1f} s (build, data, steps, validation at 3 and 6); resumed at step "
              f"{seen.get('step')} with the saved optimizer state {same_opt}, LR {seen.get('lr')} "
              f"(schedule(3) 1e-4), scheduler step {seen.get('last_epoch')}; results.csv steps "
              f"{steps}; checkpoints {sorted(os.listdir(ckdir))}; launches "
              f"{ {k: n for k, n in cli_counts.items() if n} }, routes "
              f"{ {k: r for k, r in cli_routes.items() if any(r.values())} }, unrouted halves "
              f"{ba.unrouted_halves}")
        check(seen.get("step") == 3 and same_opt and seen.get("lr") == 1e-4
              and seen.get("last_epoch") == 3, "train CLI: resume at step 3")
        check(steps == ["3", "6"], f"train CLI: results.csv steps {steps}")
        check(all(cli_counts[k] > 0 for k in tc.admitted(cells["a"])) and ba.unrouted_halves == 0,
              f"train CLI: launches {cli_counts}")

        # the final checkpoint served through the file path
        served_dir = os.path.join(tmp.name, "served")
        serve.main(["--input", val_png, "--output", served_dir, "--checkpoint", ckdir,
                    "--model", "small", "--scale", "4", "--dtype", "bfloat16"])
        got = imread(os.path.join(served_dir, "v0_x4.png"))
        ref = GRL(zoo.make_config("small", dtype=torch.bfloat16))
        serve.load_checkpoint(ref, ckdir)
        ref = ref.eval().to(dev)
        want = to_uint8(Restorer(ref, dev, scale=4, shape_bucket=64)(
            imread(val_png)[None].astype(np.float32) / 255.0)[0])
        print(f"[train] serve --checkpoint {os.path.basename(ckdir)}/ (latest step 6) on "
              f"{os.path.basename(val_png)}: {got.shape}, equal to the in-process restore "
              f"{np.array_equal(got, want)}")
        check(got.shape == (256, 256, 3) and np.array_equal(got, want), "train: serve")
        del ref

        # the JPEG artifact-removal recipe (ROADMAP A10a) on the same root
        write_jpeg_root(os.environ["GRLIR_DATA_ROOT"])
        jpeg_cli = jpeg_run(dev, smi, counts, routes, out)
    finally:
        ckpt_mod.CheckpointManager.restore = restore
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()

    # ---- the gates, fixed before any card run (PERF.md)
    t0 = time.perf_counter()
    rel, worst, where = tc.gate_fp32(dev)
    print(f"[train] gate fp32, cell a, one step, kernels on vs off: loss rel diff {rel:.3e} "
          f"(max {tc.FP32_LOSS_REL}); worst gradient max|diff| / (1e-3 max|g| + 1e-7) "
          f"{worst:.3e} at {where} (max 1)")
    check(rel <= tc.FP32_LOSS_REL and worst <= 1.0, "train gate fp32")
    for c in "ab":
        losses, rels = tc.gate_bf16(c, dev)
        print(f"[train] gate bf16, cell {c}, {tc.GATE_STEPS} steps: losses kernels on "
              f"{[round(v, 5) for v in losses[True]]}, off {[round(v, 5) for v in losses[False]]}; "
              f"per-step rel diff max {max(rels):.3e} (max {tc.BF16_LOSS_REL})")
        check(tc.bf16_gate_ok(losses, rels), f"train gate bf16 cell {c}")
        err, graphs = tc.replay_after_steps(c, dev)
        print(f"[train] cell {c}: Restorer replay after 3 optimizer steps vs eager max|diff| "
              f"{err:.3e} ({graphs} graph)")
        check(err == 0.0 and graphs == 1, f"train replay after steps, cell {c}")

    print(f"[train] gates: {time.perf_counter() - t0:.1f} s")

    # ---- the two cells timed, kernels off and on
    t0 = time.perf_counter()
    per_step = {}
    for c, cfg in cells.items():
        for kernels in (False, True):
            state = tc.make_state(replace(cfg, kernels=kernels), dev, seed=0)
            data = tc.batches(4, dev, seed=3)
            step = make_train_step(tc.LOSS)
            for i in range(TRAIN_WARMUP):
                step(state, data[i % 4])
            torch.cuda.synchronize()
            ba.reset_launches()
            step(state, data[0])
            torch.cuda.synchronize()
            launched, by_route, unrouted = counts(), routes(), ba.unrouted_halves
            torch.cuda.reset_peak_memory_stats()
            batch = itertools.cycle(data)
            times = time_ms(lambda: step(state, next(batch)), TRAIN_RUNS, 0)
            peak = torch.cuda.max_memory_allocated() / 2**30
            dev_ms, largest = profile_step(lambda: step(state, data[0]))
            med = statistics.median(times)
            print(f"[time] train step cell {c} bf16 bs{tc.BATCH} LR {tc.LR_HW}^2, kernels "
                  f"{'on' if kernels else 'off'}: {spread(times)} a step over {TRAIN_RUNS} steps "
                  f"after {TRAIN_WARMUP}, {tc.BATCH / (med / 1e3):.2f} samples/s, peak "
                  f"{peak:.2f} GiB, device-busy {100 * dev_ms / med:.1f}% ({dev_ms:.3f} ms of "
                  f"kernels); launches a step "
                  f"{ {k: n for k, n in launched.items() if n} }, routes "
                  f"{ {k: r for k, r in by_route.items() if any(r.values())} }, unrouted "
                  f"halves {unrouted} [{smi}]")
            print(f"[train] cell {c} kernels {'on' if kernels else 'off'}: largest device "
                  f"time in one profiled step: " + "; ".join(
                      f"{ms:.2f} ms x{n} {name[:70]}" for ms, n, name in largest))
            if kernels:
                want = tc.admitted(cfg)
                check(all(launched[k] > 0 for k in want)
                      and all(n == 0 for k, n in launched.items() if k not in want),
                      f"train cell {c}: kernels-on launches {launched}, routes admit {want}")
                per_step[c] = launched
            else:
                check(not any(launched.values()), f"train cell {c}: kernels-off launches {launched}")
            del state, data
    print(f"[train] timing: {time.perf_counter() - t0:.1f} s")
    check(any(n > 0 for c in per_step for n in per_step[c].values()),
          "train: no B1-B4 launch under grad")
    return cli_counts, per_step, jpeg_cli


PARALLEL_STEPS = 3                   # the NCCL world-1 CLI run's steps


def parallel_phase(dev, smi) -> dict:
    """Training across processes (ROADMAP A8) on the one card; returns
    the launches by kernel of the NCCL CLI run and of each gloo rank.

    1. World size 1 on NCCL through GRLIR_COORDINATOR: the PSNR CLI (GRL-S
       width, bf16, v3, bs8, one loader thread) for PARALLEL_STEPS steps in
       a process of its own, beside the same run undistributed, both with
       deterministic algorithms and one hash seed (the datasets' generator
       is seeded from the hash of the stage's name): the last step's loss
       and the saved parameters equal to the bit.
    2. The card cell of `grlir_torch.parallel_cells` (GRL-S fp32, kernels
       on, 3 SGD steps at 2 rows a rank; the tiled Restorer across the
       ranks; the gathered validation metrics) on two ranks that share the
       card over gloo (NCCL refuses two ranks on one GPU), and on one rank
       over NCCL through GRLIR_COORDINATOR, whose group of one runs every
       collective (the gradients' all-reduce, the gathers of host tensors
       through the card), each against one process on the global batch of
       4 at the module's gates."""
    import os
    import subprocess
    import tempfile

    from grlir_torch import parallel_cells as pc

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    data = os.path.join(tmp.name, "data")
    write_train_root(data)
    args = ["experiment=sr/grl_p256", "model=grl/grl_small", "model.name=grl_small",
            "model.embed_dim=128", "model.upsampler=pixelshuffle", "batch_size=8",
            "dtype=bfloat16", "model.use_pallas_attention=v3",
            f"trainer.max_steps={PARALLEL_STEPS}", "trainer.log_every_n_steps=1",
            "data_module.train.dataset=div2k", "data_module.val.dataset=set5",
            "tag=chip_ddp", "num_workers=1"]
    code = ("import json, sys, torch\n"
            "torch.use_deterministic_algorithms(True, warn_only=True)\n"
            "from grlir_torch.train import main\n"
            "main(sys.argv[1:])\n"
            "import torch.distributed as dist\n"
            "from grlir_torch.ops import block_attn as ba\n"
            "print('LAUNCHES', json.dumps({k.__name__: k.launches for k in ba.KERNELS}))\n"
            "print('BACKEND', dist.get_backend() if dist.is_initialized() else None, "
            "dist.get_world_size() if dist.is_initialized() else 1)\n")
    port = pc.free_port()
    procs = {}
    try:
        t0 = time.perf_counter()
        for mode in ("undistributed", "nccl"):
            env = {**os.environ, "PYTHONPATH": repo, "GRLIR_DATA_ROOT": data,
                   "GRLIR_CACHE_DIR": os.path.join(tmp.name, f"cache_{mode}"),
                   "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "PYTHONHASHSEED": "0"}
            if mode == "nccl":
                env.update(GRLIR_COORDINATOR=f"127.0.0.1:{port}", GRLIR_NUM_PROCESSES="1",
                           GRLIR_PROCESS_ID="0")
            procs[mode] = subprocess.Popen(
                [sys.executable, "-c", code, *args,
                 f"io.base_output_path={os.path.join(tmp.name, mode)}"],
                env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        runs = {}
        for mode, p in procs.items():
            out = p.communicate(timeout=600)[0]
            check(p.returncode == 0, f"parallel: the {mode} CLI exited {p.returncode}:\n"
                  f"{out[-4000:]}")
            lines = out.splitlines()
            launches = json.loads(next(ln for ln in lines if ln.startswith("LAUNCHES"))[9:])
            backend = next(ln for ln in lines if ln.startswith("BACKEND"))
            nondet = sorted({ln.strip()[:160] for ln in lines
                             if "does not have a deterministic implementation" in ln})
            run = os.path.join(tmp.name, mode, "chip_ddp", "version_0")
            with open(os.path.join(run, "metrics.jsonl")) as f:
                logged = [json.loads(ln) for ln in f.read().splitlines()]
            saved = torch.load(os.path.join(run, "checkpoints", f"step_{PARALLEL_STEPS}",
                                            "checkpoint.pt"), map_location="cpu",
                               weights_only=True)
            runs[mode] = (logged[-1], saved["model"], launches)
            print(f"[parallel] {mode} CLI: {backend}; step {logged[-1]['step']} loss "
                  f"{logged[-1]['loss']!r}; launches { {k: n for k, n in launches.items() if n} }"
                  f"; ops without a deterministic implementation {nondet}")
        (log_u, sd_u, _), (log_n, sd_n, launches_n) = runs["undistributed"], runs["nccl"]
        same = sd_u.keys() == sd_n.keys() and all(torch.equal(sd_u[k], sd_n[k]) for k in sd_u)
        print(f"[parallel] world size 1 on NCCL vs undistributed, {PARALLEL_STEPS} steps: loss "
              f"{log_n['loss']!r} vs {log_u['loss']!r}, parameters equal to the bit {same} "
              f"({time.perf_counter() - t0:.1f} s, both at once)")
        check(log_n["step"] == log_u["step"] == PARALLEL_STEPS and log_n["loss"] == log_u["loss"]
              and same, "parallel: NCCL world 1 differs from undistributed")
        check(launches_n["window_half_large"] > 0 and launches_n["stripe_a2w_large"] > 0,
              f"parallel: NCCL CLI launches {launches_n}")

        # the card cell on two gloo ranks and on one NCCL rank, against one
        # process
        cell = pc.card_scenarios(os.path.join(tmp.name, "cell"))
        runs, walls = {}, {}
        for name, world, group in (("gloo", 2, "gloo"), ("nccl", 1, "env")):
            t0 = time.perf_counter()
            runs[name] = pc.launch(world, cell, os.path.join(tmp.name, name), device="cuda",
                                   group=group)
            walls[name] = time.perf_counter() - t0
        ref = pc.reference(cell, dev)
        rt = ref["train"]
        print(f"[parallel] one process, {2 * pc.PER_RANK} rows: losses {rt['losses']}, step ms "
              f"{[round(t, 3) for t in rt['step_ms']]}, metrics {ref['validate']}")
        for name, ranks in runs.items():
            fails = pc.compare(ranks, ref)
            for r, o in enumerate(ranks):
                t = o["train"]
                print(f"[parallel] {name} rank {r} of {len(ranks)} ({o['backend']}), GRL-S fp32 "
                      f"kernels on, {pc.PER_RANK * 2 // len(ranks)} rows: losses {t['losses']}, "
                      f"step ms {[round(s, 3) for s in t['step_ms']]}, launches {t['launches']}, "
                      f"routes {t['routes']}, unrouted {t['unrouted']}, "
                      f"metrics {o['validate']}")
            a = ranks[0]
            err = float(np.abs(a["restorer"]["out"] - ref["restorer"]["out"]).max())
            pmax = max(float((a["train"]["params"][n] - v).abs().max())
                       for n, v in rt["params"].items())
            print(f"[parallel] {name} ranks vs one process: parameters max|diff| {pmax:.3e}, "
                  f"Restorer max|diff| {err:.3e}; gates (losses rel {pc.LOSS_REL}, parameters "
                  f"rtol {pc.PARAM_RTOL} atol {pc.PARAM_ATOL}, Restorer {pc.RESTORE_ATOL}, "
                  f"metrics rel {pc.METRIC_REL}): {fails or 'pass'} (ranks {walls[name]:.1f} s) "
                  f"[{smi}]")
            check(not fails, f"parallel: {name} ranks vs one process: {fails}")
            check(all(o["backend"] == name for o in ranks), f"parallel: {name} backend")
            check(all(o["train"]["launches"].get(k, 0) > 0 for o in ranks
                      for k in ("window_half", "stripe_half")),
                  f"parallel: a {name} rank launched no B1 or B2")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()
    return {"nccl_cli": launches_n,
            **{f"{name}_rank{r}": o["train"]["launches"]
               for name, ranks in runs.items() for r, o in enumerate(ranks)}}


GAN_WARMUP, GAN_RUNS = 1, 5         # GAN-step timing: warm-up, timed steps
BSR_HOST_ITEMS = 8                   # BSR train samples timed on the host


def write_bsr_root(root) -> None:
    """A synthetic real-world SR data root: OST train images (three of at
    least 400^2 and one smaller, so that the reflect padding runs), a
    GT-free RealSR val set and a Set5 x4 val set (stage 1 validates on
    USM-sharpened Set5 targets)."""
    import os

    from grlir_torch.utils.image import to_uint8
    from grlir_torch.utils.imageio import imwrite
    from grlir_torch.utils.matlab import imresize

    def put(rel, img):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        imwrite(path, to_uint8(img))

    def manifest(rel, entries):
        path = os.path.join(root, "image_info", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(entries, f)

    train = []
    for i, (h, w) in enumerate([(448, 480), (512, 416), (400, 400), (300, 360)]):
        put(f"OST/train/{i}.png", val_images(20 + i, 1, max(h, w))[0][:h, :w])
        train.append({"path": f"train/{i}.png"})
    manifest("OST/train.json", train)
    realsr = []
    for i, img in enumerate(val_images(30, 2, 96)):
        put(f"test_set/RealSRSetPlus5images/r{i}.png", img)
        realsr.append({"path": f"RealSRSetPlus5images/r{i}.png"})
    manifest("RealSRSetPlus5images/test.json", realsr)
    gt = val_images(31, 1, 256)[0]
    put("test_set/Set5/s0.png", gt)
    put("test_set/Set5/s0_x4.png", imresize(gt, 0.25))
    manifest("Set5/test_X4.json", [{"path_gt": "Set5/s0.png", "path_lq": "Set5/s0_x4.png"}])


def gan_phase(dev, smi, counts, routes):
    """Real-world SR training (ROADMAP A9) on the card; returns the launches
    of the stage-2 CLI runs (counts set to 0 just before, read just after)
    and those of one kernels-on GAN step of each protocol."""
    import copy
    import gc as pygc
    import os
    import tempfile

    from grlir_torch import bsr_host_time, bsr_ops_cells as bsr_ops
    from grlir_torch import gan_cells as gc
    from grlir_torch import serve
    from grlir_torch.engines.gan import GANLossConfig, GANTrainState, make_gan_train_step
    from grlir_torch.ops import block_attn as ba
    from grlir_torch.train import main as train_main
    from grlir_torch.utils.checkpoint import list_steps, read_step_dir

    t_phase = time.perf_counter()
    g = gc.g_config()
    want = ("window_half", "stripe_a2w_large", "stripe_w2a_large")
    print(f"[gan] cell: GRL-base-bsr embed {g.embed_dim} depths {g.depths}, window "
          f"{g.window_size}, stripes {g.stripe_size} groups {g.stripe_groups}, df "
          f"{g.anchor_window_down_factor}, {g.upsampler} x{g.upscale}; UNet-SN num_feat "
          f"{gc.NUM_FEAT}; VGG19 {list(gc.LAYERS)}; LR {gc.LR_HW}^2, GT "
          f"{gc.LR_HW * gc.SCALE}^2, bs {gc.BATCH}, Adam {gc.LR}, remat")

    tmp = tempfile.TemporaryDirectory()
    saved_env = {k: os.environ.get(k) for k in ("GRLIR_DATA_ROOT", "GRLIR_CACHE_DIR")}
    os.environ["GRLIR_DATA_ROOT"] = os.path.join(tmp.name, "data")
    os.environ["GRLIR_CACHE_DIR"] = os.path.join(tmp.name, "cache")
    load_dicts, load_ckpt, seen, handed = (GANTrainState.load_state_dicts,
                                           serve.load_checkpoint, {}, {})

    def resume_spy(self, saved):
        got = load_dicts(self, saved)
        seen.update(step=got, opt_g=copy.deepcopy(self.opt_g.state_dict()),
                    opt_d=copy.deepcopy(self.opt_d.state_dict()),
                    u={n: b.detach().cpu().clone()
                       for n, b in self.discriminator.named_buffers() if n.endswith(".u")})
        return got

    def handoff_spy(model, path):
        load_ckpt(model, path)
        ref = read_step_dir(path)["model"]
        handed[path] = all(torch.equal(v.cpu(), ref[k]) for k, v in model.state_dict().items())

    def same_state(a, b):
        ok = a["state"].keys() == b["state"].keys()
        for i, st in b["state"].items():
            for k, v in st.items():
                ok &= torch.equal(torch.as_tensor(a["state"][i][k]).cpu(), torch.as_tensor(v))
        return ok

    try:
        write_bsr_root(os.environ["GRLIR_DATA_ROOT"])
        vgg_path = os.path.join(tmp.name, "vgg19.pth")
        torch.save(gc.vgg19_state_dict(11), vgg_path)
        out = os.path.join(tmp.name, "out")
        # two workers keep up with a bs1 step (a sample is ~0.2 s of host
        # time, a step ~1.5 s); stage 1 reads on threads, stage 2 in the
        # recipe's worker processes
        common = [f"io.base_output_path={out}", "data_module.train.dataset=ost",
                  "trainer.log_every_n_steps=1", "num_workers=2"]

        # ---- stage 1 (the PSNR trainer on the BSR data), 2 steps
        s1 = ["experiment=bsr/grl_psnr", "tag=chip_bsr_psnr", "model.use_pallas_attention=v3",
              "data_module.val.dataset=set5", "trainer.max_steps=2",
              "trainer.val_check_interval=2", "worker_mode=thread", *common]
        t0 = time.perf_counter()
        train_main(s1)
        s1_dir = os.path.join(out, "chip_bsr_psnr", "version_0", "checkpoints")
        print(f"[gan] stage 1 CLI {' '.join(s1[:2] + s1[3:6])}: {time.perf_counter() - t0:.1f} s, "
              f"checkpoints {list_steps(s1_dir)}")
        check(list_steps(s1_dir) == [2], "gan: stage 1 checkpoint")
        pygc.collect()

        # ---- stage 2 (the GAN runner): 3 steps from stage 1's generator,
        # then a resume to 6
        s2 = ["experiment=bsr/grl", "tag=chip_bsr_gan", "model.model_g.use_pallas_attention=v3",
              f"vgg_pretrained={vgg_path}", f"engine.bsr_psnr_checkpoint={s1_dir}",
              "trainer.val_check_interval=3", *common]
        GANTrainState.load_state_dicts = resume_spy
        serve.load_checkpoint = handoff_spy
        ba.reset_launches()
        t1 = time.perf_counter()
        st = train_main(s2 + ["trainer.max_steps=3"])
        t2 = time.perf_counter()
        del st
        st = train_main(s2 + ["trainer.max_steps=6"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        cli_counts, cli_routes = counts(), routes()
        unrouted = ba.unrouted_halves
        run = os.path.join(out, "chip_bsr_gan", "version_0", "checkpoints")
        saved = torch.load(os.path.join(run, "step_3", "checkpoint.pt"), map_location="cpu",
                           weights_only=True)
        u_ok = seen.get("u", {}).keys() == {k for k in saved["discriminator"] if k.endswith(".u")}
        for k, v in seen.get("u", {}).items():
            u_ok &= torch.equal(v, saved["discriminator"][k])
        opt_ok = (same_state(seen.get("opt_g", {"state": {}}), saved["optimizer"])
                  and same_state(seen.get("opt_d", {"state": {}}), saved["optimizer_d"]))
        last = read_step_dir(run)
        print(f"[gan] stage 2 CLI {' '.join(s2[:3])} vgg_pretrained=<random VGG19> "
              f"engine.bsr_psnr_checkpoint=<stage 1>: 3 steps in {t2 - t1:.1f} s, resumed to 6 "
              f"in {t3 - t2:.1f} s (data, steps, NIQE validation at 3 and 6); generator handed "
              f"from stage 1 {list(handed.values())}; resumed at step {seen.get('step')} with "
              f"the saved G and D optimizer states {opt_ok} and u vectors {u_ok}; final step "
              f"{st.step}, checkpoints {list_steps(run)}, val_niqe {last['metrics']}; launches "
              f"{ {k: n for k, n in cli_counts.items() if n} }, routes "
              f"{ {k: r for k, r in cli_routes.items() if any(r.values())} }, unrouted halves "
              f"{unrouted}")
        check(handed and all(handed.values()), "gan: stage-1 generator handed to stage 2")
        check(seen.get("step") == 3 and opt_ok and u_ok and st.step == 6,
              "gan CLI: resume at step 3")
        check(list_steps(run) == [3, 6] and math.isfinite(last["metrics"].get("val_niqe", math.nan)),
              "gan CLI: checkpoints and val_niqe")
        check(all(cli_counts[k] > 0 for k in want) and unrouted == 0,
              f"gan CLI: launches {cli_counts}")
        del st
        pygc.collect()

        # ---- BSR host time (the degradation pipeline, one process)
        host, item = bsr_host_time.sample_ms(BSR_HOST_ITEMS)
        print(f"[gan] BSR train sample on the host (crop 400, jitter, USM, degradation with "
              f"ISP, JPEG, patch; one process): {spread(host)} over {BSR_HOST_ITEMS} samples "
              f"(the first builds the ISP's tone LUTs), shapes lq {item['img_lq'].shape} gt "
              f"{item['img_gt'].shape}")
        # ---- the BSR data's OpenCV calls against cv2's outputs (committed fixture)
        rows = bsr_ops.check()
        for r in rows:
            print(f"[gan] bsr_ops {r['name']}: {'bit-equal' if r['ok'] else 'NOT bit-equal'} "
                  f"to cv2, {r['ms']:.1f} ms")
        check(all(r["ok"] for r in rows),
              f"gan: cv2_ops bit-equal to the cv2 fixture "
              f"({[r['name'] for r in rows if not r['ok']]} differ)")
    finally:
        GANTrainState.load_state_dicts = load_dicts
        serve.load_checkpoint = load_ckpt
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()
    torch.cuda.empty_cache()

    # ---- the gates, fixed before any card run (grlir_torch/gan_cells.py)
    t0 = time.perf_counter()
    for lp in (True, False):
        proto = "lightning-parity" if lp else "single-forward"
        losses, worst, where, du = gc.gate_fp32(dev, lp)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False])]
        print(f"[gan] gate fp32 {proto}, one step, kernels on vs off: loss_g, loss_d "
              f"{losses[True]} vs {losses[False]}, rel diff {max(rel):.3e} (max "
              f"{gc.FP32_LOSS_REL}); worst gradient max|diff| / (1e-3 max|g| + 1e-7) "
              f"{worst:.3e} at {where} (max 1); u max|diff| {du:.3e} (max {gc.FP32_U_ATOL})")
        check(gc.fp32_gate_ok(losses, worst, du), f"gan gate fp32 {proto}")
        losses, rel = gc.gate_bf16(dev, lp)
        print(f"[gan] gate bf16 {proto}, {gc.GATE_STEPS} steps: (loss_g, loss_d) kernels on "
              f"{[tuple(round(v, 5) for v in p) for p in losses[True]]}, off "
              f"{[tuple(round(v, 5) for v in p) for p in losses[False]]}; per-step max rel "
              f"diff {max(rel):.3e} (max {gc.BF16_LOSS_REL})")
        check(gc.bf16_gate_ok(losses, rel), f"gan gate bf16 {proto}")
        torch.cuda.empty_cache()
    print(f"[gan] gates: {time.perf_counter() - t0:.1f} s")

    # ---- the GAN step timed, fp32 (the recipe's type), kernels off and on
    t0 = time.perf_counter()
    per_step = {}
    for kernels in (False, True):
        state, percep = gc.make_state(gc.g_config(torch.float32, kernels), dev, seed=0)
        data = gc.batches(4, dev, seed=3)
        for lp in (True, False):
            proto = "lightning-parity" if lp else "single-forward"
            step = make_gan_train_step(GANLossConfig(), percep, lp)
            for i in range(GAN_WARMUP):
                step(state, data[i % 4])
            torch.cuda.synchronize()
            ba.reset_launches()
            step(state, data[0])
            torch.cuda.synchronize()
            launched, by_route, unrouted = counts(), routes(), ba.unrouted_halves
            torch.cuda.reset_peak_memory_stats()
            batch = itertools.cycle(data)
            times = time_ms(lambda: step(state, next(batch)), GAN_RUNS, 0)
            peak = torch.cuda.max_memory_allocated() / 2**30
            dev_ms, largest = profile_step(lambda: step(state, data[0]))
            med = statistics.median(times)
            print(f"[time] gan step {proto} fp32 bs{gc.BATCH} LR {gc.LR_HW}^2, kernels "
                  f"{'on' if kernels else 'off'}: {spread(times)} a step over {GAN_RUNS} "
                  f"steps after {GAN_WARMUP}, peak {peak:.2f} GiB, device-busy "
                  f"{100 * dev_ms / med:.1f}% ({dev_ms:.3f} ms of kernels); launches a step "
                  f"{ {k: n for k, n in launched.items() if n} }, routes "
                  f"{ {k: r for k, r in by_route.items() if any(r.values())} }, unrouted "
                  f"halves {unrouted} [{smi}]")
            print(f"[gan] {proto} kernels {'on' if kernels else 'off'}: largest device time "
                  f"in one profiled step: " + "; ".join(
                      f"{ms:.2f} ms x{n} {name[:70]}" for ms, n, name in largest))
            if kernels:
                check(all(launched[k] > 0 for k in want)
                      and all(n == 0 for k, n in launched.items() if k not in want)
                      and unrouted == 0,
                      f"gan step {proto}: kernels-on launches {launched}")
                per_step[proto] = launched
            else:
                check(not any(launched.values()), f"gan step {proto}: kernels-off launches")
        if kernels:
            # the trainer runs with PyTorch's default conv precision: cuDNN
            # TF32 on (this script turns it off for the comparisons)
            step = make_gan_train_step(GANLossConfig(), percep, True)
            torch.backends.cudnn.allow_tf32 = True
            try:
                step(state, data[0])
                batch = itertools.cycle(data)
                times = time_ms(lambda: step(state, next(batch)), GAN_RUNS, 0)
            finally:
                torch.backends.cudnn.allow_tf32 = False
            print(f"[time] gan step lightning-parity fp32, kernels on, cuDNN TF32 on (PyTorch's "
                  f"default, as the CLI runs): {spread(times)} a step over {GAN_RUNS} steps "
                  f"after 1 [{smi}]")
        del state, data
        torch.cuda.empty_cache()
    # bf16 (dtype=bfloat16: the generator in bf16, B1 and B4 on their
    # tensor-core routes), lightning-parity, kernels off and on
    for kernels in (False, True):
        state, percep = gc.make_state(gc.g_config(torch.bfloat16, kernels), dev, seed=0)
        data = gc.batches(4, dev, seed=3)
        step = make_gan_train_step(GANLossConfig(), percep, True)
        step(state, data[0])
        torch.cuda.synchronize()
        ba.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        batch = itertools.cycle(data)
        times = time_ms(lambda: step(state, next(batch)), GAN_RUNS, 0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        by_route = {k: {r: n // GAN_RUNS for r, n in v.items()} for k, v in routes().items()
                    if any(v.values())}
        print(f"[time] gan step lightning-parity bf16 bs{gc.BATCH} LR {gc.LR_HW}^2, kernels "
              f"{'on' if kernels else 'off'}: {spread(times)} a step over {GAN_RUNS} steps "
              f"after 1, peak {peak:.2f} GiB; routes a step {by_route}, unrouted halves "
              f"{ba.unrouted_halves} [{smi}]")
        if kernels:
            check(all(by_route.get(k, {}).get("tensor_core", 0) > 0 for k in want)
                  and not any(r.get("cuda_core", 0) for r in by_route.values())
                  and ba.unrouted_halves == 0, f"gan step bf16: routes {by_route}")
        else:
            check(not by_route, "gan step bf16: kernels-off launches")
        del state, data
        torch.cuda.empty_cache()
    print(f"[gan] timing: {time.perf_counter() - t0:.1f} s")
    print(f"[wall] gan phase total: {time.perf_counter() - t_phase:.1f} s")
    return cli_counts, per_step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from grlir_torch import b1_spread, b5_spread
    from grlir_torch.b1_spread import b1_stage_check
    from grlir_torch.b3_spread import b3_stage_check, stage_failures, stage_line
    from grlir_torch.engines.inference import WARMUP_FORWARDS, Restorer
    from grlir_torch.gan_cells import BSR_G
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

    # and those of the JPEG experiment's window half
    g11 = torch.Generator().manual_seed(11)

    def rnd11(*shape, std=1.0):
        return (torch.randn(*shape, generator=g11) * std).to(dev)

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
            return fn, lib, cost, lambda t: b3_stage_check(t, w, b, ls, bias, bands, shift, h,
                                                           win)
        if (tuple(win), h, C, Cw // h) == (b1_spread.WINDOW, b1_spread.HEADS, b1_spread.C,
                                           b1_spread.D):
            # B1 at GRL-base-bsr's window half, split into its stages (C9)
            return fn, lib, cost, lambda t: b1_stage_check(t, w, b, ls, bias, bands, shift, h,
                                                           win)
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

    def fp64_projection_twin(fn, xt):
        """The plain path with its projection summed in float64: against the
        plain path, how far two faithful orders of the same sums land
        apart."""
        plain_project = ba._project

        def project64(t, wqkv, bqkv, h, mm, parts):
            p = (t.double() @ wqkv.to(mm).double()).float()
            return ba._split_heads(p if bqkv is None else p + bqkv.float(), parts, h)

        ba._project = project64
        try:
            return fn(xt, False)
        finally:
            ba._project = plain_project

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
                    elif kname in ("window_half_large", "window_half") and spread:
                        # the stage gates (B3, and B1 at window 16); the gated
                        # y is the wrapper's, the stage split's plain y the
                        # plain version's
                        st = spread[0](xt)
                        same = (torch.equal(st["y"], got.float())
                                and torch.equal(st["y_plain"], want.float()))
                        ok = not stage_failures(st) and same
                        tol = (f"stage gates: {stage_line(st)}; kernel and plain y those of the "
                               f"stage split {same}")
                    elif kname in ULP_GATED:
                        top = want.float().abs().max().item()
                        twin = (fp64_projection_twin(fn, xt).float() - want.float()).abs()
                        spread = twin.max().item()
                        gate = max(BF16_MAX_ERR, 2 * bf16_ulp(top), spread)
                        ok = err <= gate
                        over = int(((got.float() - want.float()).abs() > BF16_MAX_ERR).sum())
                        tol = (f"max {gate:.3e} = max({BF16_MAX_ERR}, 2 bf16 ulps of max|plain| "
                               f"{top:.3f}, plain vs plain with float64 projection sums "
                               f"{spread:.3e}); outputs over {BF16_MAX_ERR}: kernel {over}, "
                               f"float64-projection plain {int((twin > BF16_MAX_ERR).sum())}, "
                               f"of {want.numel()}")
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
            l_ms = statistics.median(time_ms(lambda: lib(xb), runs, warmup))
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

    def routes():
        """Launches by route of B1-B5 (bf16 on tensor cores, fp32 on CUDA
        cores)."""
        return {k.__name__: dict(k.route_launches) for k in routed_kernels}

    def expect_routes(route="tensor_core", **launched):
        """A routes() dict: the given launches on `route`, none elsewhere."""
        return {k.__name__: {r: launched.get(k.__name__, 0) if r == route else 0
                             for r in ("tensor_core", "cuda_core")} for k in routed_kernels}

    def traced(*restorers) -> int:
        """The forwards that ran the model's Python code, and so moved the
        launch counts, in the calls of these Restorers: on the card each
        padded shape runs WARMUP_FORWARDS eager forwards and one captured;
        its replays launch the captured kernels without counting them."""
        return sum(len(r.graphs) for r in restorers) * (WARMUP_FORWARDS + 1)

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
        # B3 at the JPEG experiment's window half (jpeg/grl_p288: GRL-S
        # width, window 36, N = 1296 in q tiles of 64, the last of 16
        # rows), one 288^2 patch, shifted by 18 and not
        jcfg = zoo.make_config("small", task="jpeg", window_size=36, stripe_size=(72, 144),
                               stripe_groups=(None, None), anchor_window_down_factor=4)
        jhw, jwin = (288, 288), (36, 36)
        jbands = geometry_tensors(jcfg.geometry_config, jhw, dev)["bands_w"]
        xj = rnd11(1, *jhw, C)
        bias36 = 16 * torch.sigmoid(rnd11(heads, jwin[0] ** 2, jwin[0] ** 2))
        for s in (0, 18):
            cases_s.append(("window_half_large", f"window {jwin} shift {s} jpeg 288^2",
                            window_case(xj, w, b, ls1, bias36, jwin, jbands if s else None, s),
                            xj))
        run_cases(cases_s, max_err)

    with Phase("GRL-S model"):
        model = init_weights(GRL(replace(cfg, dtype=torch.bfloat16)),
                             torch.Generator().manual_seed(0)).eval().to(dev)
        plain = GRL(replace(cfg, dtype=torch.bfloat16, kernels=False)).eval().to(dev)
        plain.load_state_dict(model.state_dict())
        lr = torch.rand(1, *hw, 3, generator=g).to(dev)
        n_blocks = sum(cfg.depths)
        with torch.no_grad():
            ba.reset_launches()
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
            ba.reset_launches()
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
        restorers = [Restorer(model, dev, scale=4, **kw) for _, _, kw in requests]
        ba.reset_launches()
        t0 = time.perf_counter()
        outs = [r(img.numpy()) for r, (_, img, _) in zip(restorers, requests)]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        got, unrouted, got_routes = counts(), ba.unrouted_halves, routes()
        fwd = traced(*restorers)
        served.update(window_half=got["window_half"], stripe_half=got["stripe_half"])
        print(f"[serve] GRL-S: 4 requests in {serve_s:.2f} s on {fwd // (WARMUP_FORWARDS + 1)} "
              f"CUDA graphs ({fwd} traced forwards), launches {got}, B1-B4 by route "
              f"{got_routes}, unrouted halves {unrouted}")
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
        check(fwd == 4 * (WARMUP_FORWARDS + 1), f"GRL-S served graphs: {fwd} traced forwards")
        check(got == expect(window_half=fwd * n_blocks, stripe_half=fwd * n_blocks)
              and unrouted == 0,
              f"GRL-S served launches {got} != {fwd} forwards x {n_blocks}")
        check(got_routes == expect_routes(window_half=fwd * n_blocks, stripe_half=fwd * n_blocks),
              f"GRL-S served routes {got_routes}")
        del restorers

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
        # B1 and B4 at the real-world SR generator's geometry, the gan
        # phase's path: window 16 (N = 256, B1's multi-chunk softmax) and
        # stripes 32x64 / 64x32 at anchor df 4 (N1 = 2048, N2 = 128)
        geom = geometry_tensors(BSR_G.geometry_config, hw, dev)
        df = BSR_G.anchor_window_down_factor
        anchor = rnd(1, hw[0] // df, hw[1] // df, C // 2)
        win = (BSR_G.window_size, BSR_G.window_size)
        bias16 = 16 * torch.sigmoid(rnd(heads, win[0] ** 2, win[0] ** 2))
        for s in (0, win[0] // 2):
            cases_b.append(("window_half", f"window {win} shift {s} h3 d30", window_case(
                x, w, b, ls1, bias16, win, geom["bands_w"] if s else None, s), x))
        for key, sizes, groups in (("sh", BSR_G.stripe_size, BSR_G.stripe_groups),
                                   ("sv", BSR_G.stripe_size[::-1], BSR_G.stripe_groups[::-1])):
            stripe, shift = get_stripe_info(sizes, groups, True, hw)
            n1, n2 = stripe[0] * stripe[1], (stripe[0] // df) * (stripe[1] // df)
            b1, b2 = 16 * torch.sigmoid(rnd(heads, n2, n1)), 16 * torch.sigmoid(rnd(heads, n1, n2))
            for shifted in (False, True):
                args = (x, anchor, w, b, ls1, ls2, b1, b2, stripe, df,
                        geom[f"bands_{key}"] if shifted else None,
                        geom[f"bands_{key}_a"] if shifted else None,
                        shift if shifted else (0, 0))
                for step in ("a2w", "w2a"):
                    cases_b.append((f"stripe_{step}_large",
                                    f"stripe {stripe} shift {args[-1]} df {df} h3 d30",
                                    stripe_case(step, *args), x))
        run_cases(cases_b, max_err)
        # C9: B1's bf16 route at GRL-base-bsr's window half over the twelve
        # input draws of b1_spread, held to the stage gates; the C entry is
        # called directly, so no launch is counted
        worst = 0.0
        for seed in b1_spread.SEEDS:
            for sh in b1_spread.SHIFTS:
                st = b1_stage_check(*b1_spread.draw(seed, sh, dev), sh, b1_spread.HEADS)
                worst = max(worst, st["e2e_err"])
                print(f"[C9] window_half window {b1_spread.WINDOW} h3 d30 seed {seed} shift "
                      f"{sh} bf16: max|diff| {st['e2e_err']:.3e}; stage gates: "
                      f"{stage_line(st)}")
                check(not stage_failures(st), f"C9 B1 window 16 seed {seed} shift {sh}")
        print(f"[C9] window_half bf16 max|diff| over the twelve draws: {worst:.3e}")

    with Phase("GRL-base model"):
        base = init_weights(GRL(replace(sr_cfg, dtype=torch.bfloat16)),
                            torch.Generator().manual_seed(1)).eval().to(dev)
        base_plain = GRL(replace(sr_cfg, dtype=torch.bfloat16, kernels=False)).eval().to(dev)
        base_plain.load_state_dict(base.state_dict())
        lr = torch.rand(1, BASE_MODEL_HW, BASE_MODEL_HW, 3, generator=g).to(dev)
        mem = {}
        with torch.no_grad():
            ba.reset_launches()
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
            ba.reset_launches()
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
        # the dn request: 6 tiles in batches of 2, one shape
        restorers = [Restorer(m, dev, scale=sc, **kw) for _, m, _, sc, _, kw in requests]
        ba.reset_launches()
        t0 = time.perf_counter()
        outs = [r(img.numpy()) for r, (_, _, _, _, img, _) in zip(restorers, requests)]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        got, unrouted, got_routes = counts(), ba.unrouted_halves, routes()
        forwards = traced(*restorers)
        served.update({k: got[k] for k in ("window_half_large", "stripe_a2w_large",
                                           "stripe_w2a_large")})
        print(f"[serve] GRL-base: 3 requests in {serve_s:.2f} s on "
              f"{forwards // (WARMUP_FORWARDS + 1)} CUDA graphs ({forwards} traced forwards), "
              f"launches {got}, B1-B4 by route {got_routes}, unrouted halves {unrouted}")
        check(forwards == 3 * (WARMUP_FORWARDS + 1),
              f"GRL-base served graphs: {forwards} traced forwards")
        del restorers
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
        # the legacy route of the ablation branches: B6 on qkv
        # projected beforehand (GRL-S's separable-conv qkv at 256^2, the
        # window half's channels, rolled and partitioned channel-major), and
        # B7a at GRL-S 256^2's stripes (8x64 and 64x8: 512 tokens, 32
        # anchors), shifted, on the d-major views the model passes
        from grlir_torch.models.blocks import QKVProjection
        from grlir_torch.ops.layout import window_partition_cm

        sep = QKVProjection(s_cfg.embed_dim, proj_type="separable_conv").to(dev)
        with torch.no_grad():
            q_sep = sep(rnd(1, *hw, s_cfg.embed_dim), torch.float32)[..., :3 * heads * d]
            q_sep = window_partition_cm(torch.roll(q_sep, (-4, -4), dims=(1, 2)), (8, 8))
        del sep
        cases_f.append(("fused_window_attention_qkv",
                        "GRL-S 256^2 separable-conv qkv projected, windows (8, 8) shift 4",
                        window_qkv_case(ls, bias_w, bands_w), q_sep))
        for key in ("sh", "sv"):
            bs, bsa = geom[f"bands_{key}"], geom[f"bands_{key}_a"]
            (ns, n1), n2 = bs.shape, bsa.shape[1]

            def dmaj(n_, std=1.0):
                return rnd(1, ns, heads, d, n_, std=std).transpose(-1, -2)

            a_t, x1_t = dmaj(n2), dmaj(n2, 0.25)
            q_t, k_t, v_t = dmaj(n1), dmaj(n1), dmaj(n1, 0.25)
            b1, b2 = 16 * torch.sigmoid(rnd(heads, n2, n1)), 16 * torch.sigmoid(rnd(heads, n1, n2))
            lab = f"GRL-S 256^2 legacy stripes {key} shifted (N1 {n1}, N2 {n2}, d-major)"
            cases_f.append(("fused_cosine_attention", f"{lab} a2w",
                            cosine_case(k_t, v_t, ls, b1, dense_mask(bsa, bs)), a_t))
            cases_f.append(("fused_cosine_attention", f"{lab} w2a",
                            cosine_case(a_t, x1_t, ls, b2, dense_mask(bs, bsa)), q_t))
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
        # B5's bf16 route at GRL-base's three steps over the twelve input
        # draws of b5_spread, held to the stage gates (ROADMAP C5: the flat
        # 1e-2 fails on half of them); the C entry is called directly, so
        # no launch is counted
        worst = {}
        for seed in b5_spread.SEEDS:
            for step, args in b5_spread.draw(seed, dev).items():
                st = b5_spread.b5_stage_check(*args)
                worst[step] = max(worst.get(step, 0.0), st["e2e_err"])
                print(f"[C5] flash_rect_attention GRL-base {step} seed {seed} bf16: max|diff| "
                      f"{st['e2e_err']:.3e}; stage gates: {stage_line(st)}")
                check(not stage_failures(st), f"C5 B5 GRL-base {step} seed {seed}")
        print("[C5] flash_rect_attention bf16 max|diff| over the twelve draws: "
              + ", ".join(f"{s_} {e:.3e}" for s_, e in worst.items()))

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
                ba.reset_launches()
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
        restorers = [Restorer(fz, dev, scale=4, **kw) for _, _, kw in requests]
        ba.reset_launches()
        t0 = time.perf_counter()
        outs = [r(img.numpy()) for r, (_, img, _) in zip(restorers, requests)]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        got, unrouted, got_routes = counts(), ba.unrouted_halves, routes()
        # one graph a request: each ran WARMUP_FORWARDS + 1 traced forwards
        w1 = WARMUP_FORWARDS + 1
        check(traced(*restorers) == 3 * w1, "GRL-S engine fused served graphs")
        del restorers
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
        check(got == expect(fused_window_attention_qkv=3 * w1 * n_blocks,
                            flash_rect_attention=2 * 2 * w1 * n_blocks,
                            fused_cosine_attention=2 * w1 * n_blocks) and unrouted == 0,
              f"GRL-S engine fused served launches {got}")
        check(got_routes == expect_routes(flash_rect_attention=2 * 2 * w1 * n_blocks),
              f"GRL-S engine fused served routes {got_routes}")

    with Phase("GRL-base fused engine"):
        bf = twin(base, engine="fused")
        bf_plain = twin(base, engine="fused", kernels=False)
        n_blocks = sum(sr_cfg.depths)
        lr = torch.rand(1, BASE_MODEL_HW, BASE_MODEL_HW, 3, generator=g).to(dev)
        with torch.no_grad():
            ba.reset_launches()
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
        rp_r = Restorer(rp, dev, scale=1)
        ba.reset_launches()
        t0 = time.perf_counter()
        out = torch.from_numpy(rp_r(frame.numpy()))
        rp_s = time.perf_counter() - t0
        got, unrouted, got_routes = counts(), ba.unrouted_halves, routes()
        w1 = traced(rp_r)       # one graph: WARMUP_FORWARDS + 1 traced forwards
        check(w1 == WARMUP_FORWARDS + 1, "repair graphs")
        del rp_r
        ref = torch.from_numpy(Restorer(rp_plain, dev, scale=1)(frame.numpy()))
        finite = bool(torch.isfinite(out).all())
        p = psnr(out, ref)
        print(f"[repair] GRL-base dn 1080x1920 whole, 4 blocks, engine v3 bf16: out "
              f"{tuple(out.shape)} in {rp_s:.2f} s, finite {finite}, launches {got}, "
              f"B1-B4 by route {got_routes}, unrouted halves {unrouted}, PSNR vs "
              f"kernels=False {p:.2f} dB")
        check(unrouted == 2 * w1 and got == expect(window_half=4 * w1,
                                                   stripe_a2w_large=2 * w1,
                                                   stripe_w2a_large=2 * w1),
              f"repair launches {got}, unrouted halves {unrouted}")
        check(got_routes == expect_routes(window_half=4 * w1, stripe_a2w_large=2 * w1,
                                          stripe_w2a_large=2 * w1),
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
                ba.reset_launches()
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
                    ba.reset_launches()
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
                "GRL-base stripe (64, 64) shifted w2a",
                "GRL-S 256^2 separable-conv qkv projected, windows (8, 8) shift 4",
                "GRL-S 256^2 legacy stripes sh shifted (N1 512, N2 32, d-major) a2w",
                "GRL-S 256^2 legacy stripes sh shifted (N1 512, N2 32, d-major) w2a"}
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

    # 6. the Restorer on CUDA graphs (ROADMAP A6): one graph a padded shape
    with Phase("graph"):
        gs = init_weights(GRL(replace(zoo.GRL_SMALL, dtype=torch.bfloat16)),
                          torch.Generator().manual_seed(0)).eval().to(dev)
        graph_cases = [
            # (label, model, image, scale, Restorer options, LR MP a forward, tiles)
            (f"GRL-S x4 {GRL_S_HW}^2 bs1", gs, torch.rand(1, GRL_S_HW, GRL_S_HW, 3, generator=g),
             4, {"shape_bucket": 64}, GRL_S_HW * GRL_S_HW / 1e6, 1),
            ("GRL-base dn 256x480 as 2 x 256^2 tiles (stripes 64x128)", dn,
             torch.rand(1, 256, 480, 3, generator=g), 1,
             {"tile": 256, "tile_overlap": 32, "tile_batch": 2}, 2 * 256 * 256 / 1e6, 2),
        ]
        for label, m, img, sc, kw, mp, tiles in graph_cases:
            r = Restorer(m, dev, scale=sc, **kw)
            ba.reset_launches()
            out = r(img.numpy())     # warm-up forwards, capture, replay
            torch.cuda.synchronize()
            traced_counts, w1 = counts(), WARMUP_FORWARDS + 1
            check(len(r.graphs) == 1 and all(n % w1 == 0 for n in traced_counts.values()),
                  f"{label}: graphs {list(r.graphs)}, counts {traced_counts}")
            per_capture = {k: n // w1 for k, n in traced_counts.items()}
            gr = next(iter(r.graphs.values()))
            x = gr.static_in
            with torch.no_grad():
                ba.reset_launches()
                y_eager = m(x).float()
                torch.cuda.synchronize()
                eager_counts = counts()
            gr.graph.replay()
            torch.cuda.synchronize()
            y_graph = gr.static_out.float().clone()
            err, p = (y_graph - y_eager).abs().max().item(), psnr(y_graph, y_eager)
            print(f"[graph] {label}: input {tuple(x.shape)}, output {tuple(out.shape)}, launches "
                  f"a captured forward {dict((k, n) for k, n in per_capture.items() if n)} "
                  f"(eager {dict((k, n) for k, n in eager_counts.items() if n)}); replay vs "
                  f"eager max|diff| {err:.3e}, PSNR {p:.2f} dB")
            check(per_capture == eager_counts and any(per_capture.values()),
                  f"{label}: captured launches {per_capture} != eager {eager_counts}")
            check(p >= MODEL_MIN_PSNR and bool(torch.isfinite(y_graph).all()),
                  f"{label}: replay vs eager PSNR")
            # a replay runs exactly the captured kernels: the capture launched
            # what an eager forward launches (the counters above), and the
            # replay's output equals eager's to the bit
            check(torch.equal(y_graph, y_eager), f"{label}: replay equals eager to the bit")
            # the profiler's kernel records, over PROFILED_RUNS replays and as
            # many eager forwards: CUPTI has dropped a record (ROADMAP C10),
            # so each kernel's total may fall one short of PROFILED_RUNS x its
            # captured launches, never more, and never exceed it
            want_k = kernels_of(per_capture)
            got_k, dev_replay = profile_kernels(gr.graph.replay, PROFILED_RUNS)
            with torch.no_grad():
                eager_k, dev_eager = profile_kernels(lambda: m(x), PROFILED_RUNS)
            print(f"[graph] {label}: CUDA kernels of the port in {PROFILED_RUNS} profiled "
                  f"replays {got_k}, in {PROFILED_RUNS} eager forwards {eager_k}, from the "
                  f"captured launches x {PROFILED_RUNS} "
                  f"{ {k: PROFILED_RUNS * n for k, n in want_k.items()} }")
            for which, got in (("replay", got_k), ("eager", eager_k)):
                check(set(got) == set(want_k) and all(
                    PROFILED_RUNS * n - 1 <= got[k] <= PROFILED_RUNS * n
                    for k, n in want_k.items()),
                      f"{label}: {which} kernel records {got}, captured {want_k} x "
                      f"{PROFILED_RUNS}")
            # a weight written in place is seen by the next replay
            wt = m.layers[0].blocks[0].attn.qkv.body.weight
            keep = wt.detach().clone()
            with torch.no_grad():
                wt.mul_(1.001)
                gr.graph.replay()
                y_moved = gr.static_out.float().clone()
                y_eager_moved = m(x).float()
                wt.copy_(keep)
            moved = (y_moved - y_graph).abs().max().item()
            p_moved = psnr(y_moved, y_eager_moved)
            print(f"[graph] {label}: qkv weight of block 0 x 1.001 in place: replay moved by "
                  f"max {moved:.3e}, vs eager with that weight max|diff| "
                  f"{(y_moved - y_eager_moved).abs().max().item():.3e}, PSNR {p_moved:.2f} dB")
            check(moved > 0 and p_moved >= MODEL_MIN_PSNR, f"{label}: in-place weight write")
            with torch.no_grad():
                t_eager, t_replay = paired_ms(lambda: m(x), gr.graph.replay, GRAPH_RUNS)
            me, mr = statistics.median(t_eager), statistics.median(t_replay)
            print(f"[time] {label} bf16: eager {spread(t_eager)} a forward, "
                  f"{me / tiles:.3f} ms a tile, {mp / (me / 1e3):.4f} MP/s, device-busy "
                  f"{100 * dev_eager / me:.1f}% ({dev_eager:.3f} ms of kernels); CUDA graph "
                  f"replay {spread(t_replay)} a forward, {mr / tiles:.3f} ms a tile, "
                  f"{mp / (mr / 1e3):.4f} MP/s, device-busy {100 * dev_replay / mr:.1f}% "
                  f"({dev_replay:.3f} ms of kernels); {GRAPH_RUNS} paired runs [{smi}]")
            del r, gr, x
        del graph_cases

    # 7. validation on the card (ROADMAP A6): GRL-S x4 on its graph, then
    # kernels=False, on a synthetic set whose indices overlap across batches
    with Phase("validate"):
        from grlir_torch.engines.validate import validate
        from grlir_torch.utils.matlab import imresize

        gts = val_images(8, 3, VAL_HW)
        lrs = np.stack([imresize(im, 0.25) for im in gts])
        gt_free = np.zeros((3, 1), np.float32)   # blind SR sets' placeholder

        def loader(gt):
            """Two batches of two; the second repeats index 1."""
            return [{"img_lq": lrs[s_], "img_gt": gt[s_], "indices": np.array(i),
                     "filenames": [f"val{j}.png" for j in i]}
                    for s_, i in ((slice(0, 2), [0, 1]), (slice(1, 3), [1, 2]))]

        class OnHost:
            """A Restorer's restorations, scored on the CPU."""
            device = torch.device("cpu")

            def __init__(self, restorer):
                self.restorer = restorer

            def __call__(self, img):
                return self.restorer(img)

        full = ("psnr", "psnr_y", "ssim", "ssim_y", "psnrb", "psnrb_y")
        res = {}
        for tag, m in (("kernels", gs), ("kernels=False", twin(gs, kernels=False))):
            r = Restorer(m, dev, scale=4, shape_bucket=64)
            t0 = time.perf_counter()
            res[tag] = validate(r, loader(gts), full, task="sr", scale=4)
            t_full = time.perf_counter() - t0
            res[tag].update(validate(r, loader(gt_free), ("niqe",), task="sr", scale=4))
            t_all = time.perf_counter() - t0
            print(f"[validate] GRL-S x4 {tag}, 3 images {VAL_HW}^2 (LR {VAL_HW // 4}^2) in 2 "
                  f"batches, index 1 twice, graphs {[tuple(k) for k in r.graphs]}: "
                  f"{ {k: round(v, 6) for k, v in res[tag].items()} }; six metrics "
                  f"{t_full:.2f} s, with NIQE {t_all:.2f} s")
            check(all(math.isfinite(v) for v in res[tag].values()), f"validate {tag}")
            if tag == "kernels":
                # the first batch (two images) scored on the card and on the
                # CPU: float64 SSIM filters take seconds an image on the CPU
                card = validate(r, loader(gts)[:1], full, task="sr", scale=4)
                host = validate(OnHost(r), loader(gts)[:1], full, task="sr", scale=4)
                diff = {k: abs(host[k] - card[k]) for k in full}
                print(f"[validate] card vs CPU metrics of the same restorations (batch 1): |diff| "
                      f"{ {k: f'{v:.2e}' for k, v in diff.items()} } (max {HOST_DB_TOL} dB, "
                      f"SSIM {HOST_SSIM_TOL})")
                check(all(v <= (HOST_SSIM_TOL if k.startswith("ssim") else HOST_DB_TOL)
                          for k, v in diff.items()), "validate: card vs CPU metrics")
            del r
        diff = {k: abs(res["kernels"][k] - res["kernels=False"][k]) for k in res["kernels"]}
        print(f"[validate] kernels vs kernels=False: |diff| "
              f"{ {k: f'{v:.2e}' for k, v in diff.items()} } (max {VAL_DB_TOL} dB, SSIM "
              f"{VAL_SSIM_TOL})")
        check(all(v <= (VAL_SSIM_TOL if k.startswith("ssim") else VAL_DB_TOL)
                  for k, v in diff.items() if k != "niqe"),
              "validate: kernels vs kernels=False")

    # 8. the trainer (ROADMAP A7): the CLI trains, validates, checkpoints,
    # resumes and serves; the train step's gates and its two cells timed
    with Phase("train"):
        train_cli, train_step, jpeg_cli = train_phase(dev, smi, counts, routes)

    # 9. real-world SR training (ROADMAP A9): stage 1 and the GAN runner's
    # CLI, the GAN step's gates, and its two protocols timed
    with Phase("gan"):
        gan_cli, gan_step = gan_phase(dev, smi, counts, routes)

    # 10. training across processes (ROADMAP A8): NCCL at world size 1,
    # and two gloo ranks sharing the card, against one process
    with Phase("parallel"):
        par = parallel_phase(dev, smi)

    # 11.-13. the rest of GRL's model surface: the ablation
    # switches, classification training, the remat policies
    from grlir_torch import ablation_cells as ac

    with Phase("ablation"):
        ablation = ac.ablation_phase(dev, smi, check)
    with Phase("classification"):
        cls_cli = ac.classification_phase(dev, smi, check, write_train_root, TRAIN_CLI_ARGS)
    with Phase("remat"):
        remat = ac.remat_phase(dev, smi, check)

    # 14. the host half (ROADMAP A10b): every image format grlir's datasets
    # read, grlir's orbax checkpoints, the profiling hooks, the enlargement
    # of a small SR training image
    from grlir_torch import host_io_cells as hc

    with Phase("host_io"):
        host_io = hc.host_io_phase(dev, smi, check, TRAIN_CLI_ARGS, PER_CALL)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": served[k], "train_launches": train_cli.get(k, 0),
         "jpeg_launches": jpeg_cli.get(k, 0),
         "parallel_launches": {run: n.get(k, 0) for run, n in par.items()},
         "train_step_launches": {c: n.get(k, 0) for c, n in train_step.items()},
         "gan_launches": gan_cli.get(k, 0),
         "gan_step_launches": {p: n.get(k, 0) for p, n in gan_step.items()},
         "ablation_launches": {v: n.get(k, 0) for v, n in ablation.items()},
         "classification_launches": cls_cli.get(k, 0),
         "remat_step_launches": {p: n.get(k, 0) for p, n in remat.items()},
         "host_io_launches": {run: n.get(k, 0) for run, n in host_io.items()},
         "max_abs_err": max_err[k],
         **timing[k]}
        for k in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
