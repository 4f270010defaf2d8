"""Readings that the limits of `limits/<workload>.json` are set from, on
the card at the cell's own size (PERF.md gives them beside each limit):

  program   the check's numbers of sound runs, one a seed;
  control   the reference in the program's place, its products in fp8
            (the precision below the configuration's bf16), against the
            float32 reference;
  fault     training only: the program's step on half of each batch, the
            mean taken over the rest.

    python3 h100_bench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3]

One process: a serving cell sets up once and takes each seed's weights in
place (its CUDA graphs read them where they lie), then serves a short
window of the cell's own traffic and checks as many answers as a run
keeps.  Prints one JSON line a reading.  Not part of a benchmark run.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402

import torch  # noqa: E402

from h100_bench import cell_serve, cell_train, check, spec  # noqa: E402
from h100_bench.reference import grl as ref  # noqa: E402
from h100_bench.run import cache_dirs  # noqa: E402
from h100_bench.weights import make_weights  # noqa: E402


def say(**kw) -> None:
    print(json.dumps(kw), flush=True)


def serve_readings(cell, seeds, control_seeds, seconds, device) -> None:
    m, mix = cell.model(), cell.traffic
    restorer, _, unrouted = cell_serve.setup(cell, seeds[0], device)
    say(workload=cell.name, unrouted_halves=unrouted)
    for seed in seeds:
        t = time.perf_counter()
        restorer.model.load_state_dict(make_weights(m, seed, device))
        images = cell_serve.pools(mix, seed, device)
        got = cell_serve.serve(restorer, mix, images, seed, seconds, device, False)
        say(kind="program", seed=seed, answers=len(got.kept),
            numbers=cell_serve.reference_numbers(cell, seed, images, got.kept, device),
            seconds=time.perf_counter() - t)
        if seed in control_seeds:
            P = make_weights(m, seed, device)
            fp8 = {}
            for key in got.kept:
                img = torch.as_tensor(images[key[0]][key[1]:key[1] + 1], device=device)
                with torch.no_grad():
                    fp8[key] = ref.restore(P, m, img, mix["shape_bucket"], "fp8").cpu().numpy()
            say(kind="control", seed=seed,
                numbers=cell_serve.reference_numbers(cell, seed, images, fp8, device))


def worst(got: dict, want: dict, n: int = 4) -> dict:
    """The look behind a training reading: each step's loss gap, the
    parameters with the largest gradient and change gaps (gap, reference
    norm, program norm), the median parameter's gaps and the parameters
    left out as round-off."""
    g, d = want["grad_norms"], want["delta_norms"]
    keys = check.compared(want)
    out = {"step_loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])],
           "left_out": sorted(set(g) - set(keys))}
    for name, gaps, norms, mine in (
            ("grad", check.leaf_gaps(got["grad_norms"], g, g), g, got["grad_norms"]),
            ("delta", check.leaf_gaps(got["delta_norms"], d, keys), d, got["delta_norms"])):
        top = sorted(gaps, key=gaps.get, reverse=True)[:n]
        out[f"{name}_worst"] = [[k, gaps[k], norms[k], mine[k]] for k in top]
        out[f"{name}_median_gap"] = float(sorted(gaps.values())[len(gaps) // 2])
    return out


def train_readings(cell, seeds, control_seeds, device) -> None:
    m, mix = cell.model(), cell.traffic
    half = mix["batch"] // 2
    for seed in seeds:
        t = time.perf_counter()
        data = cell_train.pool(mix, seed, device)
        want = cell_train.reference(cell, seed, data, device)
        P0 = make_weights(m, seed, device)
        state, step = cell_train.build(cell, P0, seed, device)
        got = cell_train.first_steps(state, step, mix, data, P0)
        say(kind="program", seed=seed, numbers=check.train_numbers(got, want),
            look=worst(got, want), seconds=time.perf_counter() - t)
        del state, step
        if seed in control_seeds:
            fp8 = cell_train.reference(cell, seed, data, device, prec="fp8")
            say(kind="control", seed=seed, numbers=check.train_numbers(fp8, want),
                look=worst(fp8, want))
            state, step = cell_train.build(cell, P0, seed, device)

            def half_step(st, b):
                return step(st, {k: v[:half] for k, v in b.items()})

            bad = cell_train.first_steps(state, half_step, mix, data, P0)
            say(kind="fault_half_batch", seed=seed, numbers=check.train_numbers(bad, want),
                look=worst(bad, want))
            del state, step
        del P0, data
        cell_serve.free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    torch.set_num_threads(1)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    cell = spec.resolve(args.workload)
    device = torch.device("cuda")
    if cell.kind == "serve":
        serve_readings(cell, seeds, control, args.seconds, device)
    else:
        train_readings(cell, seeds, control, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
