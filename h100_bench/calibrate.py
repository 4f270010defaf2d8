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

One process; the cell's runner (`readings` in cell_<kind>.py) takes the
readings: a serving cell sets up once and takes each seed's weights in
place, then serves a short window of the cell's own traffic and checks as
many answers as a run keeps.  Prints one JSON line a reading.  Not part
of a benchmark run.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402

import torch  # noqa: E402

from h100_bench import spec  # noqa: E402
from h100_bench.run import cache_dirs  # noqa: E402


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
    for reading in cell.runner.readings(cell, seeds, control, args.seconds,
                                        torch.device("cuda")):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
