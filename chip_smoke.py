#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (grlir_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its numbers on its own line and raising on failure:
  1. device: name, compute capability (must be 9.0), nvidia-smi name/power limit;
  2. build: the CUDA kernels from grlir_torch/csrc, timed;
  3. kernels vs their plain PyTorch versions at GRL-S 256^2 shapes (window
     shifted/unshifted, stripes H and V shifted/unshifted), fp32 and bf16;
  4. model: GRL-S x4 from a seeded init, kernel path vs plain path (bf16 at
     256^2 by PSNR, fp32 at 64^2 by max |diff|), 16 + 16 launches a forward;
  5. serve: the Restorer answers four bf16 requests through the kernels
     (the main path; launch counts reset just before it), each checked
     against the plain path;
  6. timing with CUDA events: each kernel vs its plain version, and the whole
     model in megapixels (LR input) per second, kernels vs plain.
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

GRL_S_HW = 256
WARMUP, RUNS = 5, 20
BF16_MAX_ERR = 1e-2        # bf16 outputs: a few ulps at |y| < 1
FP32_TOL = 1e-4            # fp32: summation order only
MODEL_FP32_MAX_ERR = 5e-4  # 16 blocks of fp32 rounding-order drift
MODEL_MIN_PSNR = 60.0      # bf16 whole model, kernels vs plain


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs=RUNS, warmup=WARMUP) -> float:
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


def ab_ms(plain, kernel):
    """Plain and kernel times in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    return statistics.median([k1, k2]), statistics.median([p1, p2])


def ptxas_report(log: str):
    """One line per kernel instantiation from nvcc's `-Xptxas -v` output."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("for ")[-1]
            kind = next((k for k in ("window_half", "stripe_half") if k in fn), fn)
            name = f"{kind}<{'bf16' if 'bfloat16' in fn else 'fp32'}>"
        elif "spill" in line and name:
            spill = line.strip()
        elif "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.float() - b.float()) ** 2).item()
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from grlir.ops.geometry import get_stripe_info
    from grlir_torch.engines.inference import Restorer
    from grlir_torch.models import zoo
    from grlir_torch.models.grl import GRL, geometry_tensors, init_weights
    from grlir_torch.ops import block_attn, cuda_build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    # 3. kernels vs plain at GRL-S 256^2 shapes
    cfg = zoo.GRL_SMALL
    C, heads, df = cfg.embed_dim, cfg.num_heads_window[0], cfg.anchor_window_down_factor
    g = torch.Generator().manual_seed(0)
    geom = geometry_tensors(cfg.geometry_config, (GRL_S_HW, GRL_S_HW), dev)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    x = rnd(1, GRL_S_HW, GRL_S_HW, C)
    wqkv, bqkv = rnd(C, 3 * C // 2, std=0.02), rnd(3 * C // 2, std=0.02)
    ls1 = torch.full((heads, 1, 1), math.log(10.0), device=dev)
    ls2 = torch.full((heads, 1, 1), math.log(12.0), device=dev)
    anchor = rnd(1, GRL_S_HW // df, GRL_S_HW // df, C // 2)
    n_w = cfg.window_size ** 2
    bias_w = 16 * torch.sigmoid(rnd(heads, n_w, n_w))
    win = (cfg.window_size, cfg.window_size)
    cases = {"window_half": [], "stripe_half": []}
    for shifted in (False, True):
        cases["window_half"].append((
            f"window {win} shift {4 if shifted else 0}",
            lambda t, k, s=shifted: block_attn.window_half(
                t, wqkv, bqkv, ls1, bias_w, win,
                bands=geom["bands_w"] if s else None, shift=4 if s else 0,
                kernels=k)))
    hw = (GRL_S_HW, GRL_S_HW)
    for key, sizes, groups in (("sh", cfg.stripe_size, cfg.stripe_groups),
                               ("sv", cfg.stripe_size[::-1], cfg.stripe_groups[::-1])):
        stripe, shift = get_stripe_info(sizes, groups, True, hw)
        n1, n2 = stripe[0] * stripe[1], (stripe[0] // df) * (stripe[1] // df)
        b1 = 16 * torch.sigmoid(rnd(heads, n2, n1))
        b2 = 16 * torch.sigmoid(rnd(heads, n1, n2))
        for shifted in (False, True):
            cases["stripe_half"].append((
                f"stripe {stripe} shift {shift if shifted else (0, 0)}",
                lambda t, k, st=stripe, sft=shift, s=shifted, b1=b1, b2=b2, key=key:
                block_attn.stripe_half(
                    t, anchor.to(t.dtype), wqkv, bqkv, ls1, ls2, b1, b2, st, df,
                    bands=geom[f"bands_{key}"] if s else None,
                    bands_a=geom[f"bands_{key}_a"] if s else None,
                    shift=sft if s else (0, 0), kernels=k)))
    max_err = {}
    with torch.no_grad():
        for kname, kcases in cases.items():
            max_err[kname] = 0.0
            for label, fn in kcases:
                for dtype in (torch.float32, torch.bfloat16):
                    xt = x.to(dtype)
                    got, want = fn(xt, True), fn(xt, False)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    max_err[kname] = max(max_err[kname], err)
                    if dtype == torch.float32:
                        ok = torch.allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)
                        bound = f"atol {FP32_TOL} rtol {FP32_TOL}"
                    else:
                        ok, bound = err <= BF16_MAX_ERR, f"max {BF16_MAX_ERR}"
                    print(f"[kernel] {kname} {label} {str(dtype)[6:]}: "
                          f"max|diff| {err:.3e} ({bound})")
                    check(bool(ok) and math.isfinite(err), f"{kname} {label} {dtype}")

    # 4. model: kernel path vs plain path
    model = init_weights(GRL(replace(cfg, dtype=torch.bfloat16)),
                         torch.Generator().manual_seed(0)).eval().to(dev)
    plain = GRL(replace(cfg, dtype=torch.bfloat16, kernels=False)).eval().to(dev)
    plain.load_state_dict(model.state_dict())
    lr = torch.rand(1, GRL_S_HW, GRL_S_HW, 3, generator=g).to(dev)
    with torch.no_grad():
        block_attn.window_half.launches = block_attn.stripe_half.launches = 0
        y_k = model(lr)
        torch.cuda.synchronize()
        launches = (block_attn.window_half.launches, block_attn.stripe_half.launches)
        y_p = plain(lr)
    n_blocks = sum(cfg.depths)
    print(f"[model] GRL-S x4 bf16 {GRL_S_HW}^2: out {tuple(y_k.shape)}, launches "
          f"window {launches[0]} stripe {launches[1]} per forward, PSNR kernels vs "
          f"plain {psnr(y_k, y_p):.2f} dB, rel L2 {rel_l2(y_k, y_p):.3e}")
    check(launches == (n_blocks, n_blocks), f"launches {launches} != {n_blocks} each")
    check(tuple(y_k.shape) == (1, 4 * GRL_S_HW, 4 * GRL_S_HW, 3)
          and bool(torch.isfinite(y_k).all()), "bf16 model output")
    check(psnr(y_k, y_p) >= MODEL_MIN_PSNR, f"bf16 PSNR < {MODEL_MIN_PSNR} dB")
    m32 = GRL(replace(cfg, dtype=torch.float32)).eval().to(dev)
    p32 = GRL(replace(cfg, dtype=torch.float32, kernels=False)).eval().to(dev)
    m32.load_state_dict(model.state_dict())
    p32.load_state_dict(model.state_dict())
    lr64 = lr[:, :64, :64]
    with torch.no_grad():
        err32 = (m32(lr64) - p32(lr64)).abs().max().item()
    print(f"[model] GRL-S x4 fp32 64^2: max|diff| kernels vs plain {err32:.3e} "
          f"(max {MODEL_FP32_MAX_ERR})")
    check(err32 <= MODEL_FP32_MAX_ERR, "fp32 model kernels vs plain")

    # 5. serve: the main path, four requests through the Restorer
    bucket = {"shape_bucket": 64}
    requests = [
        ("256x256", torch.rand(1, 256, 256, 3, generator=g), bucket),
        ("200x232 (64-bucket)", torch.rand(1, 200, 232, 3, generator=g), bucket),
        ("batch of 2 192x160", torch.rand(2, 192, 160, 3, generator=g), bucket),
        ("384x384 tiled 256/32", torch.rand(1, 384, 384, 3, generator=g),
         {"tile": 256, "tile_overlap": 32, "tile_batch": 4}),
    ]
    outs = []
    block_attn.window_half.launches = block_attn.stripe_half.launches = 0
    t0 = time.perf_counter()
    for label, img, kw in requests:
        outs.append(Restorer(model, dev, scale=4, **kw)(img.numpy()))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    served = {"window_half": block_attn.window_half.launches,
              "stripe_half": block_attn.stripe_half.launches}
    print(f"[serve] 4 requests in {serve_s:.2f} s, launches {served}")
    for (label, img, kw), out in zip(requests, outs):
        ref = Restorer(plain, dev, scale=4, **kw)(img.numpy())
        b, h, w, _ = img.shape
        out = torch.from_numpy(out)
        finite = bool(torch.isfinite(out).all())
        p = psnr(out, torch.from_numpy(ref))
        print(f"[serve] {label}: out {tuple(out.shape)}, finite {finite}, "
              f"PSNR vs plain {p:.2f} dB")
        check(tuple(out.shape) == (b, 4 * h, 4 * w, 3) and finite, label)
        check(p >= MODEL_MIN_PSNR, f"{label}: PSNR vs plain path")
    check(served["window_half"] == served["stripe_half"] == 4 * n_blocks,
          f"served launches {served} != 4 forwards x {n_blocks}")

    # 6. timing (bf16, GRL-S 256^2 shapes)
    xb = x.to(torch.bfloat16)
    timing = {}
    with torch.no_grad():
        for kname, kcases in cases.items():
            for i, (label, fn) in enumerate(kcases):
                k_ms, p_ms = ab_ms(lambda: fn(xb, False), lambda: fn(xb, True))
                print(f"[time] {kname} {label} bf16: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms")
                if i == len(kcases) - 1:
                    timing[kname] = (k_ms, p_ms)
        k_ms, p_ms = ab_ms(lambda: plain(lr), lambda: model(lr))
    mp = GRL_S_HW * GRL_S_HW / 1e6
    print(f"[time] GRL-S x4 {GRL_S_HW}^2 bs1 bf16 forward: kernels {k_ms:.3f} ms "
          f"({mp / (k_ms / 1e3):.4f} MP/s), plain {p_ms:.3f} ms "
          f"({mp / (p_ms / 1e3):.4f} MP/s) [{smi}]")

    replaces = {"window_half": "grlir/ops/pallas/block_attn.py:214",
                "stripe_half": "grlir/ops/pallas/block_attn.py:589"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"grlir_torch/csrc/{k}.cu",
         "replaces": replaces[k], "launches": served[k],
         "max_abs_err": max_err[k], "ms": timing[k][0], "plain_ms": timing[k][1]}
        for k in ("window_half", "stripe_half")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
