"""The BSR data's OpenCV calls on the card's host: `grlir_torch.utils.cv2_ops`
held bit for bit to cv2's outputs through a committed fixture, since the
card's machine has no cv2.

`grlir_torch/assets/bsr_ops/bsr_ops.npz` holds, for each case of `CASES`,
the SHA-256 of cv2's output (shape, dtype and bytes), the float32 filter
kernels the cases use, and one `degradation_sr2` draw of grlir's (the
digests of its LQ and HR, and its generator's state after the call).
tests/torch_bsr_ops_fixtures.py writes the file with cv2 and grlir;
tests/test_torch_cv2_exact.py derives it again and holds the committed
file to what it derives.  The inputs are made here from an integer hash,
so that they are the same on every machine, at the shapes the BSR data
gives each call (the 400^2 crop and its shrinks).

`check()` runs every case through the port and compares; `chip_smoke.py`'s
gan phase runs it, `python -m grlir_torch.bsr_ops_cells` runs it alone
(host only, exit 1 on a mismatch).  The degradation draw passes no camera
ISP, and its generator seed is one whose draw takes no anisotropic kernel
and no multivariate noise: those go through LAPACK, whose last bits may
vary from one machine to another, where the cases are meant to test
cv2_ops alone.
"""

from __future__ import annotations

import hashlib
import json
import os.path as osp
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

FIXTURE = osp.join(osp.dirname(osp.abspath(__file__)), "assets", "bsr_ops", "bsr_ops.npz")

# name -> (call, input (h, w, channels, hash seed), parameter).  Kernels are
# named by the fixture's "kernel_<name>" arrays; resizes take ((w, h), interp)
CASES: Dict[str, Tuple[str, Tuple[int, int, int, int], object]] = {
    "GaussianBlur 51, USM image 400^2 x3": ("gaussian_blur", (400, 400, 3, 1), 51),
    "GaussianBlur 51, USM mask 400^2 x3": ("gaussian_blur_mask", (400, 400, 3, 2), 51),
    "filter2D 11x11 (direct), 400^2 x3": ("filter2d", (400, 400, 3, 3), "iso11"),
    "filter2D 7x7 (direct), 291^2 x3": ("filter2d", (291, 291, 3, 4), "iso7"),
    "filter2D 25x25 (DFT), 400^2 x3": ("filter2d", (400, 400, 3, 5), "shift25"),
    "filter2D 15x15 (DFT), 200^2 x1": ("filter2d", (200, 200, 1, 6), "iso15"),
    "filter2D 5x5 float64 (ISP demosaic), 400^2": ("filter2d_f64", (400, 400, 1, 7), "malvar"),
    "resize INTER_LINEAR 400^2 -> 291^2": ("resize", (400, 400, 3, 8), ((291, 291), 1)),
    "resize INTER_LINEAR 400^2 -> 200^2": ("resize", (400, 400, 3, 9), ((200, 200), 1)),
    "resize INTER_CUBIC 400^2 -> 63^2": ("resize", (400, 400, 3, 10), ((63, 63), 2)),
    "resize INTER_CUBIC 63^2 -> 100^2": ("resize", (63, 63, 3, 11), ((100, 100), 2)),
    "resize INTER_AREA 400^2 -> 58^2": ("resize", (400, 400, 3, 12), ((58, 58), 3)),
    "resize INTER_AREA 400^2 -> 200^2": ("resize", (400, 400, 3, 13), ((200, 200), 3)),
    "resize INTER_AREA 58^2 -> 100^2": ("resize", (58, 58, 3, 14), ((100, 100), 3)),
    "cvtColor RGB2HSV 400^2": ("rgb_to_hsv", (400, 400, 3, 15), None),
    "cvtColor HSV2RGB 400^2": ("hsv_to_rgb", (400, 400, 3, 16), None),
}
DRAW_INPUT = (400, 400, 3, 17)          # degradation_sr2's input image, sf 4


def source(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """float32 values in [0, 1) from a 64-bit integer hash (splitmix64) of
    the position: no generator, no libm, so the same on every machine.
    (h, w) for one channel, (h, w, c) otherwise."""
    with np.errstate(over="ignore"):
        z = np.arange(h * w * c, dtype=np.uint64) + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    x = ((z >> np.uint64(40)).astype(np.float64) / 2.0 ** 24).astype(np.float32)
    return x.reshape((h, w) if c == 1 else (h, w, c))


def case_input(call: str, spec) -> np.ndarray:
    """The input of one case: the hash image, made into a USM mask, an HSV
    image or the ISP's float64 colour-filter image as the call needs."""
    x = source(*spec)
    if call == "gaussian_blur_mask":
        return (x > np.float32(0.5)).astype(np.float32)
    if call == "hsv_to_rgb":
        return np.stack([x[..., 0] * np.float32(360), x[..., 1], x[..., 2]], -1)
    if call == "filter2d_f64":
        return x.astype(np.float64)
    return x


def digest(a: np.ndarray) -> str:
    """SHA-256 of an array's shape, dtype and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.shape} {a.dtype.str}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def malvar_kernels() -> List[np.ndarray]:
    from grlir_torch.data.bsr_utils import _malvar_kernels
    return [k.astype(np.float64) for k in _malvar_kernels()]


def run_case(name: str, ops, kernels: Dict[str, np.ndarray]) -> np.ndarray:
    """One case through `ops`, a module with cv2_ops' functions."""
    call, spec, param = CASES[name]
    x = case_input(call, spec)
    if call in ("gaussian_blur", "gaussian_blur_mask"):
        return ops.gaussian_blur(x, param)
    if call == "filter2d":
        return ops.filter2d(x, kernels[param])
    if call == "filter2d_f64":
        return np.stack([ops.filter2d(x, k) for k in malvar_kernels()])
    if call == "resize":
        return ops.resize(x, *param)
    return getattr(ops, call)(x)


def draw(degradation_sr2, seed: int) -> Tuple[np.ndarray, np.ndarray, dict]:
    """degradation_sr2 on the draw's input at sf 4, no camera ISP, with the
    generator of `seed`: LQ, HR and the generator's state after."""
    rng = np.random.default_rng(seed)
    lq, hr = degradation_sr2(source(*DRAW_INPUT), 4, None, rng)
    return lq, hr, rng.bit_generator.state


def load() -> Tuple[dict, Dict[str, np.ndarray]]:
    """The fixture: its metadata and its kernels."""
    with np.load(FIXTURE, allow_pickle=False) as f:
        meta = json.loads(str(f["meta"]))
        kernels = {k[len("kernel_"):]: f[k] for k in f.files if k.startswith("kernel_")}
    return meta, kernels


def check() -> List[dict]:
    """Every case and the degradation draw through the port against the
    fixture: a row each with the name, whether the digests agree, and ms."""
    from grlir_torch.data.bsr_utils import degradation_sr2
    from grlir_torch.utils import cv2_ops

    meta, kernels = load()
    rows = []
    for name in CASES:
        t0 = time.perf_counter()
        out = run_case(name, cv2_ops, kernels)
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"name": name, "ok": digest(out) == meta["cases"][name], "ms": ms})
    t0 = time.perf_counter()
    lq, hr, state = draw(degradation_sr2, meta["draw"]["seed"])
    ms = (time.perf_counter() - t0) * 1e3
    want = meta["draw"]
    rows.append({"name": f"degradation_sr2 draw, seed {want['seed']}",
                 "ok": (digest(lq) == want["lq"] and digest(hr) == want["hr"]
                        and json.dumps(state, sort_keys=True) == want["state"]),
                 "ms": ms})
    return rows


def main() -> int:
    rows = check()
    for r in rows:
        print(f"[bsr_ops] {r['name']}: {'bit-equal' if r['ok'] else 'NOT bit-equal'} "
              f"to cv2 ({r['ms']:.1f} ms)")
    bad = [r["name"] for r in rows if not r["ok"]]
    print(json.dumps({"bsr_ops_cases": len(rows), "unequal": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
