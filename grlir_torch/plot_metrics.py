"""Plot the training and validation curves of a run of the port's trainer
(`python -m grlir_torch.train`), as grlir's `tools/plot_metrics.py` plots
grlir's runs: the trainer logs per-step scalars to `metrics.jsonl` and the
metrics of every validation set to `results.csv`, and this renders them to
PNG files, so that a run is watched with nothing but its directory:

    python -m grlir_torch.plot_metrics runs/sr_grl_p256 [-o curves/] [--watch 60]

Writes <out>/train_<key>.png for every scalar key of metrics.jsonl and
<out>/val_<metric>.png with one line per validation set from results.csv;
--watch renders again every N seconds.  matplotlib is imported only when
plotting (the GPU machine has none: run this where the run directory is
mounted).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import os.path as osp
import time
from collections import defaultdict


def load_jsonl(path):
    """metrics.jsonl -> {key: (steps, values)} (non-numeric keys skipped,
    a torn last line of a live run too)."""
    series = defaultdict(lambda: ([], []))
    if not osp.exists(path):
        return {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            step = rec.get("step")
            if step is None:
                continue
            for k, v in rec.items():
                if k in ("step", "time") or not isinstance(v, (int, float)):
                    continue
                s, y = series[k]
                s.append(step)
                y.append(v)
    return dict(series)


def load_results_csv(path):
    """results.csv -> {metric: {val_set: (steps, values)}}."""
    out = defaultdict(lambda: defaultdict(lambda: ([], [])))
    if not osp.exists(path):
        return {}
    with open(path) as f:
        rows = list(csv.reader(f))
    if not rows:
        return {}
    header = rows[0]
    for row in rows[1:]:
        if len(row) != len(header):
            continue
        val_set, step = row[1], int(float(row[2]))
        for name, cell in zip(header[3:], row[3:]):
            try:
                v = float(cell)
            except ValueError:
                continue
            s, y = out[name][val_set]
            s.append(step)
            y.append(v)
    return {m: dict(d) for m, d in out.items()}


def render(run_dir: str, out_dir: str) -> list:
    """Write the run's plots into out_dir; returns their paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def save(fig, path):
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)

    os.makedirs(out_dir, exist_ok=True)
    name = osp.basename(osp.normpath(run_dir))
    written = []
    for key, (steps, vals) in sorted(load_jsonl(osp.join(run_dir, "metrics.jsonl")).items()):
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(steps, vals, lw=1)
        ax.set_xlabel("step")
        ax.set_ylabel(key)
        ax.set_title(f"{name}: {key}")
        ax.grid(alpha=0.3)
        if key.startswith("loss") and vals and min(vals) > 0:
            ax.set_yscale("log")
        path = osp.join(out_dir, f"train_{key}.png")
        save(fig, path)
        written.append(path)
    for metric, by_set in sorted(load_results_csv(osp.join(run_dir, "results.csv")).items()):
        fig, ax = plt.subplots(figsize=(7, 4))
        for val_set, (steps, vals) in sorted(by_set.items()):
            ax.plot(steps, vals, marker="o", ms=3, lw=1, label=val_set)
        ax.set_xlabel("step")
        ax.set_ylabel(metric)
        ax.set_title(f"{name}: val {metric}")
        ax.grid(alpha=0.3)
        ax.legend(fontsize=8)
        path = osp.join(out_dir, f"val_{metric}.png")
        save(fig, path)
        written.append(path)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("run_dir", help="run directory (holds metrics.jsonl / results.csv)")
    p.add_argument("-o", "--out", default=None,
                   help="output dir (default <run_dir>/curves)")
    p.add_argument("--watch", type=float, default=0,
                   help="render again every N seconds (0 = once)")
    args = p.parse_args(argv)
    out = args.out or osp.join(args.run_dir, "curves")
    while True:
        written = render(args.run_dir, out)
        print(f"[plot_metrics] wrote {len(written)} plots to {out}")
        if not args.watch:
            break
        time.sleep(args.watch)
    return written


if __name__ == "__main__":
    main()
