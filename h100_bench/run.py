"""Run one cell of the port's H100 benchmark once.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Resolves the workload of `BENCHMARK.json`
(`spec.py`), makes weights and inputs from the seed, sets up the port
(`grlir_torch`), measures for `--seconds` and checks the answers against
the plain reference.  Prints, as the last line of standard output, one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics; with `--trace 1` its per-layer metrics, from a
profiled window), `device`, with `--trace 1` `breakdown`, and last
`check`, each compared number beside its limit; the line before it gives
the latency median and sample count and the peak memory.  The compared
numbers are also the last lines of standard error.

Exits non-zero, printing no result, without a CUDA device or with fewer
than the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# whole top-level module names the port's run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "grlir")


def cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    CUDA library into <checkout>/build/grlir_torch by itself)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(names=None) -> list:
    """The FORBIDDEN top-level names among the loaded modules' (or `names`)."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def execute(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """One run of `cell` on `device`: the result object (without `check`'s
    printing), the compared numbers and the log line."""
    import torch

    from h100_bench import check
    from h100_bench.metrics_context import Context

    r = cell.runner.run(cell, seed, seconds, traced, device, t0)
    ok, shown = check.judge(r["numbers"], cell.limits)
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(r["memory_peak_bytes"])}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    out = {"correct": bool(ok and r["failed"] == 0), "attempted": int(r["attempted"]),
           "failed": int(r["failed"])}
    if traced:
        tl = r["timeline"]
        ctx = Context(cell, tl, r["context"])
        metrics = {}
        for name, mod in cell.readers.items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
        device_info.update(busy_s=tl.busy_s, window_s=tl.window_s)
        out.update(metrics=metrics, device=device_info,
                   breakdown={"device_ops": tl.device_ops(),
                              "idle_gaps": tl.idle_gaps(r["spans"])})
    else:
        out.update(metrics={m["name"]: {"value": float(r["end_to_end"][m["name"]]),
                                        "unit": m["unit"]} for m in cell.end_to_end},
                   device=device_info)
    out["check"] = shown
    log = r["log"]
    if traced:
        log += f"; device_activities {len(r['timeline'].device)}"
    return {"result": out, "log": log}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)

    import torch

    from h100_bench import check, spec

    # one host thread for torch's own CPU work: no idle intra-op threads
    # spinning beside the thread that feeds the card
    torch.set_num_threads(1)

    cell = spec.resolve(args.workload)
    chips = next(w["chips"] for w in spec.benchmark()["workloads"] if w["name"] == cell.name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    done = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"h100_bench: the run loaded {found}", file=sys.stderr)
        return 4
    print(done["log"], flush=True)
    check.report(done["result"]["check"])
    print(json.dumps(done["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
