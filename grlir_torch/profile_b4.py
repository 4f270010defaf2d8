"""Device time of the streamed-bias stripe half (B4) by CUDA kernel.

    python3 -m grlir_torch.profile_b4

Runs B4's two steps (`stripe_a2w_large`, then `stripe_w2a_large`) on the
card in bf16, the served route, under `torch.profiler`, at GRL-base's eval
shapes: x4 SR at 256^2 (stripes 64x64, df 2, one image) and its denoising
tile (stripes 64x128, two images), 3 heads of d = 30, C = 180, stripes
shifted by half with band ids; inputs random from seed 0.  Prints, for each
shape, every CUDA kernel's device time a step (a2w and w2a averaged), then
the card's nvidia-smi name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from grlir_torch.ops import block_attn as ba

STEPS = 5
SHAPES = (("GRL-base x4 SR 256^2", 1, (64, 64)),
          ("GRL-base dn tile 2 x 256^2", 2, (64, 128)))


def device_us(evt) -> float:
    """Self device time of a profiler average, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    raise AttributeError("profiler event without a device time")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_b4: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    C, Cs, heads, df, hw = 180, 90, 3, 2, 256
    w, b = rnd(C, 3 * Cs, std=0.02), rnd(3 * Cs, std=0.02)
    ls = torch.tensor([math.log(10.0), 5.0, 3.0], device=dev).reshape(heads, 1, 1)
    for label, batch, stripe in SHAPES:
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

        with torch.no_grad():
            steps()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(STEPS):
                    steps()
                torch.cuda.synchronize()
        # kernels only: an operator's row repeats the time of the kernels it
        # launched
        rows = [(device_us(e), e.key, e.count) for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
        total = sum(t for t, _, _ in rows)
        print(f"[profile_b4] {label}: {total / (2 * STEPS) / 1e3:.4f} ms of device time a "
              f"step (a2w and w2a averaged, {STEPS} of each)")
        for t, key, count in sorted(rows, reverse=True):
            print(f"[profile_b4]   {t / (2 * STEPS) / 1e3:.4f} ms a step  {count:4d} calls  "
                  f"{key[:90]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
