"""The host half of grlir's surface on the card: image files of every
format grlir's datasets read, grlir's orbax checkpoints, the profiling
hooks, and the SR dataset's enlargement of a small training image.
`chip_smoke.py` runs `host_io_phase`; `python -m grlir_torch.host_io_cells`
runs it alone.

The fixtures are committed under `grlir_torch/assets/host_io/` (the card's
machine has no cv2, PIL or orbax; tests/test_torch_imageio_formats.py and
tests/test_torch_orbax.py derive them again from cv2, PIL and orbax):

- one 256^2 image in each format and variant of `IMAGES`, each beside its
  decoding by cv2 (`<file>.png`, RGB, which the port's PNG reader reads
  bit-exactly);
- `orbax_grl/`, a grlir `CheckpointManager` directory holding one step of
  a narrow GRL's TrainState (params and AdamW state; `ORBAX_CONFIG`), and
  `orbax_grl.msgpack`, the same params as grlir's `.msgpack` files.

The phase: (1) every fixture decodes equal to its stored decoding (ms a
file); (2) `grlir_torch.serve` restores the fixtures and their PNG
decodings with GRL-S x4 at full width, bf16, v3, and the two outputs are
equal to the bit; B1 and B2 launch 16 times a forward; (3) the orbax
fixture and the .msgpack load into two Restorers with equal state dicts
and outputs (read ms and MB/s); (4) `profiling.trace` around GRL-S
forwards names B1's and B2's CUDA kernels at the launch counters' counts
(one record short at most: CUPTI has dropped records, ROADMAP C10);
(5) `device_memory_stats()["cuda:0"]` is non-empty; (6) `cost_analysis`
of the GRL-S forward counts FLOPs within 1% kernels on against off; (7)
the PSNR CLI trains two steps on a root whose GT images are smaller than
the patch.  Any failure raises through `check`.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import re
import shutil
import statistics
import tempfile
import time
from dataclasses import replace
from typing import Callable, Dict, List

import numpy as np
import torch

from grlir_torch.models import zoo
from grlir_torch.ops import block_attn as ba

ASSETS = osp.join(osp.dirname(osp.abspath(__file__)), "assets", "host_io")
# fixture file -> what it is (each has its cv2 decoding beside it as .png)
IMAGES = {
    "jpeg_baseline.jpg": "JPEG baseline, 4:2:0, quality 90 (cv2)",
    "jpeg_progressive.jpg": "JPEG progressive, 4:2:0 (cv2)",
    "jpeg_exif6.jpg": "JPEG baseline with EXIF orientation 6 (PIL)",
    "bmp_palette8.bmp": "BMP, 8 bits through a 256-entry palette (PIL)",
    "bmp_24.bmp": "BMP, 24 bits (cv2)",
    "tiff_lzw.tif": "TIFF, LZW with horizontal predictor (PIL)",
    "ppm.ppm": "PPM, binary P6 (cv2)",
}
ORBAX_DIR, ORBAX_MSGPACK, ORBAX_STEP = "orbax_grl", "orbax_grl.msgpack", 1
# the orbax fixture's model: zoo "tiny" x4 SR, cut to one stage at embed 32
ORBAX_CONFIG = dict(embed_dim=32, depths=(1,), num_heads_window=(2,),
                    num_heads_stripe=(2,))
HW = 256                      # GRL-S's LR size in steps 2, 4 and 6
COST_REL = 0.01               # FLOPs kernels on vs off
TRACE_RUNS = 5                # GRL-S forwards in step 4's trace
# the CLI's GT images, each below the 256^2 GT patch on one axis or both
# (as many as a batch of TRAIN_CLI_ARGS, so that an epoch holds a batch)
SMALL_GT = ((200, 232), (256, 180), (150, 300), (240, 240), (96, 400), (300, 128),
            (255, 255), (64, 64))
B12 = {"window_half": 1, "stripe_half": 1}
SERVE_LISTS = (".png", ".jpg", ".jpeg", ".bmp")   # what serve takes from a folder


def orbax_model_config():
    return zoo.make_config("tiny", task="sr", upscale=4, **ORBAX_CONFIG)


def _counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in ba.COUNTED}


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def _images(seed: int, n: int, hw) -> List[np.ndarray]:
    """n structured uint8 RGB images (gradients, edges, texture)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    out = []
    for i in range(n):
        f = 5 + 3 * i
        base = (0.5 + 0.3 * np.sin(2 * np.pi * f * x) * np.cos(2 * np.pi * (f - 2) * y)
                + 0.1 * (((x * 12).astype(int) + (y * 12).astype(int)) % 2))
        img = base[..., None] * np.array([1.0, 0.85, 0.7], np.float32)
        img = img + 0.03 * rng.standard_normal((h, w, 3))
        out.append(np.round(np.clip(img, 0, 1) * 255).astype(np.uint8))
    return out


def decode_fixtures(check: Callable, smi: str, runs: int = 3) -> Dict[str, float]:
    """Step 1: every image fixture equal to its stored cv2 decoding; ms a
    decode (median of `runs`)."""
    from grlir_torch.utils.imageio import imread

    ms = {}
    for name in IMAGES:
        path = osp.join(ASSETS, name)
        want = imread(path + ".png")
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            got = imread(path)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times)
        same = got.shape == want.shape and np.array_equal(got, want)
        print(f"[host_io] decode {name} ({IMAGES[name]}): {got.shape}, equal to cv2's "
              f"decoding {same}, {ms[name]:.1f} ms (median of {runs}, host) [{smi}]")
        check(same, f"host_io: {name} decodes equal to cv2")
    return ms


def serve_fixtures(device, check: Callable, smi: str) -> Dict[str, int]:
    """Step 2: `grlir_torch.serve` on the fixtures and on their PNG
    decodings, GRL-S x4 bf16 v3 from one random checkpoint: outputs equal
    to the bit; the launches summed over the serve runs (2 warm-up forwards
    and one captured a run's padded shape, replays not counted)."""
    from grlir_torch import serve
    from grlir_torch.models.grl import GRL
    from grlir_torch.utils.imageio import imread

    tmp = tempfile.mkdtemp()
    try:
        torch.manual_seed(0)
        ckpt = osp.join(tmp, "grl_small.pth")
        torch.save(GRL(zoo.make_config("small")).state_dict(), ckpt)
        src, png = osp.join(tmp, "fixtures"), osp.join(tmp, "png")
        os.makedirs(src)
        os.makedirs(png)
        for i, name in enumerate(IMAGES):
            stem = f"{i}_{name.replace('.', '_')}"
            shutil.copy(osp.join(ASSETS, name), osp.join(src, stem + osp.splitext(name)[1]))
            shutil.copy(osp.join(ASSETS, name + ".png"), osp.join(png, stem + ".png"))
        # serve lists a folder's .png/.jpg/.jpeg/.bmp files, as grlir's does;
        # the TIFF and PPM fixtures are served as files of their own
        runs = [("fixtures", src, "out_fixtures"), ("png", png, "out_png")]
        runs += [(f, osp.join(src, f), "out_fixtures") for f in sorted(os.listdir(src))
                 if not f.lower().endswith(SERVE_LISTS)]
        launches = {}
        for label, inp, out in runs:
            ba.reset_launches()
            t0 = time.perf_counter()
            serve.main(["--input", inp, "--output", osp.join(tmp, out),
                        "--checkpoint", ckpt, "--model", "small", "--scale", "4",
                        "--dtype", "bfloat16", "--engine", "v3", "--kernels", "on",
                        "--device", str(device)])
            torch.cuda.synchronize()
            launches[label] = _counts()
            print(f"[host_io] serve {label} in {time.perf_counter() - t0:.1f} s, "
                  f"launches {_nonzero(launches[label])}")
        outs = sorted(os.listdir(osp.join(tmp, "out_png")))
        same = len(outs) == len(IMAGES) and all(
            np.array_equal(imread(osp.join(tmp, "out_fixtures", f)),
                           imread(osp.join(tmp, "out_png", f))) for f in outs)
        shapes = sorted({imread(osp.join(tmp, "out_png", f)).shape for f in outs})
        print(f"[host_io] served outputs {shapes}: fixtures and PNG decodings equal to the "
              f"bit {same} [{smi}]")
        check(same, "host_io: serving the fixtures equals serving their PNG decodings")
        # one padded 256^2 shape a run: 3 traced forwards of 16 blocks
        want = {k: 3 * 16 * n for k, n in B12.items()}
        for label, got in launches.items():
            check(all(got[k] == n for k, n in want.items()),
                  f"host_io: serve {label} launches {got}, want {want}")
        return {k: sum(n[k] for n in launches.values()) for k in launches["png"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def orbax_restorers(device, check: Callable, smi: str) -> float:
    """Step 3: the orbax fixture and its .msgpack into two Restorers: state
    dicts and outputs equal to the bit; returns the read's MB/s."""
    from grlir_torch.engines.inference import Restorer
    from grlir_torch.models.grl import GRL
    from grlir_torch.serve import load_checkpoint

    models = []
    t = {}
    for label, path in (("orbax", osp.join(ASSETS, ORBAX_DIR)),
                        ("msgpack", osp.join(ASSETS, ORBAX_MSGPACK))):
        model = GRL(orbax_model_config())
        t0 = time.perf_counter()
        load_checkpoint(model, path)
        t[label] = time.perf_counter() - t0
        models.append(model.eval().to(device))
    sa, sb = (m.state_dict() for m in models)
    same_sd = sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    x = _images(21, 1, (64, 64))[0].astype(np.float32)[None] / 255.0
    ya, yb = (Restorer(m, device, scale=4)(x) for m in models)
    size = sum(osp.getsize(osp.join(r, f)) for r, _, fs in
               os.walk(osp.join(ASSETS, ORBAX_DIR)) for f in fs)
    rate = size / 1e6 / t["orbax"]
    print(f"[host_io] orbax fixture ({size} bytes, {sum(v.numel() for v in sa.values())} "
          f"params + AdamW state) read in {t['orbax'] * 1e3:.1f} ms = {rate:.2f} MB/s (host), "
          f".msgpack {t['msgpack'] * 1e3:.1f} ms; state dicts equal {same_sd}; Restorer "
          f"outputs {ya.shape} equal {np.array_equal(ya, yb)} [{smi}]")
    check(same_sd and np.array_equal(ya, yb), "host_io: orbax vs .msgpack Restorers")
    return rate


def _grl_small(device):
    from grlir_torch.models.grl import GRL

    torch.manual_seed(0)
    model = GRL(replace(zoo.GRL_SMALL, dtype=torch.bfloat16, engine="v3",
                        kernels=True)).eval().to(device)
    x = torch.from_numpy(_images(22, 1, (HW, HW))[0].astype(np.float32)[None] / 255.0)
    return model, x.to(device)


def trace_forward(device, check: Callable, smi: str, per_call: dict) -> Dict[str, int]:
    """Step 4: `trace()` around TRACE_RUNS GRL-S forwards: the trace names
    B1's and B2's CUDA kernels (per_call: {wrapper: {CUDA kernel: launches
    a bf16 call}}) as often as the launch counters count, one record short
    at most (CUPTI has dropped records, ROADMAP C10)."""
    from grlir_torch.utils.profiling import trace

    model, x = _grl_small(device)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        tmp = tempfile.mkdtemp()
        try:
            ba.reset_launches()
            with trace(tmp):
                for _ in range(TRACE_RUNS):
                    model(x)
            counts = _counts()
            with open(osp.join(tmp, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    seen = {}
    for e in events:
        if e.get("cat") == "kernel":
            m = re.search(r"(\w+_kernel)[<(]", e.get("name", ""))
            if m:
                seen[m.group(1)] = seen.get(m.group(1), 0) + 1
    want = {}
    for w in B12:
        for k, c in per_call[w].items():
            want[k] = want.get(k, 0) + c * counts[w]
    print(f"[host_io] trace of {TRACE_RUNS} GRL-S x4 {HW}^2 bf16 forwards: port kernels "
          f"{ {k: seen.get(k, 0) for k in want} }, launch counters {_nonzero(counts)} -> "
          f"expected {want}")
    check(counts["window_half"] == 16 * TRACE_RUNS and counts["stripe_half"] == 16 * TRACE_RUNS,
          f"host_io: trace forward launches {counts}")
    check(all(n - 1 <= seen.get(k, 0) <= n for k, n in want.items()),
          f"host_io: trace names {seen}, want {want}")
    return counts


def memory_and_cost(device, check: Callable, smi: str) -> None:
    """Steps 5 and 6: device memory stats; cost_analysis of the GRL-S
    forward kernels on against off."""
    from grlir_torch.utils.profiling import cost_analysis, device_memory_stats

    stats = device_memory_stats()
    print(f"[host_io] device_memory_stats: {stats}")
    check(bool(stats.get("cuda:0")), "host_io: device_memory_stats()['cuda:0']")
    model, x = _grl_small(device)
    cost = {}
    with torch.no_grad():
        for on in (True, False):
            model.cfg = replace(model.cfg, kernels=on)
            ba.reset_launches()
            cost[on] = cost_analysis(model, x)
            n = _counts()
            check((n["window_half"] == 16) == on, f"host_io: cost kernels={on} launches {n}")
    model.cfg = replace(model.cfg, kernels=True)
    rel = abs(cost[True]["flops"] - cost[False]["flops"]) / cost[False]["flops"]
    print(f"[host_io] cost_analysis GRL-S x4 {HW}^2 bf16: kernels on {cost[True]}, off "
          f"{cost[False]}; FLOPs differ by {rel:.2e} (max {COST_REL}); bytes on/off "
          f"{cost[True]['bytes_accessed'] / cost[False]['bytes_accessed']:.3f}")
    check(rel <= COST_REL, "host_io: cost_analysis FLOPs kernels on vs off")


def small_image_cli(device, check: Callable, smi: str, cli_args: List[str]) -> Dict[str, int]:
    """Step 7: the PSNR CLI for two steps on a root whose GT images are
    smaller than the GT patch (enlarged by the uint8 bilinear resize)."""
    from grlir_torch.train import main as train_main
    from grlir_torch.utils.imageio import imwrite
    from grlir_torch.utils.matlab import imresize

    tmp = tempfile.mkdtemp()
    saved = {k: os.environ.get(k) for k in ("GRLIR_DATA_ROOT", "GRLIR_CACHE_DIR")}
    root = os.environ["GRLIR_DATA_ROOT"] = osp.join(tmp, "data")
    os.environ["GRLIR_CACHE_DIR"] = osp.join(tmp, "cache")
    try:
        def put(rel, img):
            os.makedirs(osp.dirname(osp.join(root, rel)), exist_ok=True)
            imwrite(osp.join(root, rel), img)

        def manifest(rel, entries):
            os.makedirs(osp.dirname(osp.join(root, "image_info", rel)), exist_ok=True)
            with open(osp.join(root, "image_info", rel), "w") as f:
                json.dump(entries, f)

        def lr(img):
            return np.clip(np.round(imresize(img / 255.0, 0.25) * 255), 0, 255).astype(np.uint8)

        train = []
        for i, hw in enumerate(SMALL_GT):
            gt = _images(23 + i, 1, hw)[0]
            put(f"DIV2K/train/{i:04d}.png", gt)
            put(f"DIV2K/train_x4/{i:04d}.png", lr(gt))
            train.append({"path_gt": f"train/{i:04d}.png", "path_lq": f"train_x4/{i:04d}.png"})
        manifest("DIV2K/train_X4.json", train)
        val = []
        for i, img in enumerate(_images(24, 2, (HW, HW))):
            put(f"test_set/Set5/v{i}.png", img)
            put(f"test_set/Set5/v{i}_x4.png", lr(img))
            val.append({"path_gt": f"Set5/v{i}.png", "path_lq": f"Set5/v{i}_x4.png"})
        manifest("Set5/test_X4.json", val)
        out = osp.join(tmp, "out")
        args = cli_args + ["data_module.load_lr=false", "trainer.max_steps=2",
                           "trainer.val_check_interval=2", f"io.base_output_path={out}",
                           "tag=chip_small_gt"]
        ba.reset_launches()
        t0 = time.perf_counter()
        train_main(args)
        torch.cuda.synchronize()
        cli = _counts()
        run = osp.join(out, "chip_small_gt", "version_0")
        with open(osp.join(run, "results.csv")) as f:
            rows = f.read().splitlines()
        ckpts = sorted(os.listdir(osp.join(run, "checkpoints")))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[host_io] PSNR CLI on GT images {SMALL_GT} (GT patch 256, load_lr=false, "
          f"enlarged by the uint8 bilinear resize): 2 steps in {time.perf_counter() - t0:.1f} s, results.csv "
          f"{rows[1:]}, checkpoints {ckpts}, launches {_nonzero(cli)}")
    check(len(rows) == 2 and rows[1].split(",")[2] == "2" and ckpts and any(cli.values()),
          f"host_io: small-image CLI results {rows}, launches {cli}")
    return cli


def host_io_phase(device, smi: str, check: Callable, cli_args: List[str],
                  per_call: dict) -> Dict[str, Dict]:
    """Steps 1-7 (module docstring), with chip_smoke's trainer CLI
    arguments and CUDA kernels a wrapper call; returns the launches by
    kernel of the serve runs, the traced forwards and the small-image
    CLI."""
    decode_fixtures(check, smi)
    served = serve_fixtures(device, check, smi)
    orbax_restorers(device, check, smi)
    traced = trace_forward(device, check, smi, per_call)
    memory_and_cost(device, check, smi)
    cli = small_image_cli(device, check, smi, cli_args)
    return {"serve": served, "trace": traced, "small_gt_cli": cli}


if __name__ == "__main__":
    import subprocess

    def _check(ok, what):
        if not ok:
            raise RuntimeError(f"FAILED: {what}")

    if not torch.cuda.is_available():
        raise SystemExit("host_io_cells: no CUDA device")
    smi_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    t_start = time.perf_counter()
    from chip_smoke import PER_CALL, TRAIN_CLI_ARGS     # run from the repository's root
    res = host_io_phase(torch.device("cuda"), smi_line, _check, TRAIN_CLI_ARGS, PER_CALL)
    print(f"[wall] host_io: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({k: _nonzero(v) for k, v in res.items()}))
