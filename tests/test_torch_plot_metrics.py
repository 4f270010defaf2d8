"""`python -m grlir_torch.plot_metrics` against grlir's `tools/plot_metrics.py`
on one run directory written by the port's loggers: the same series and
the same PNG names."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from grlir_torch import plot_metrics
from grlir_torch.engines.validate import write_results_csv
from grlir_torch.utils.profiling import MetricsLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "grlir_plot_metrics", os.path.join(ROOT, "tools", "plot_metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def run_dir(tmp_path):
    """A run as the port's trainer leaves it: per-step scalars, two
    validation sets at two steps, and a torn last line."""
    run = tmp_path / "sr_grl"
    run.mkdir()
    rng = np.random.default_rng(0)
    log = MetricsLogger(str(run / "metrics.jsonl"))
    for step in range(1, 11):
        log.log(step, loss=float(rng.random()) + 0.1, lr=1e-4 * step)
    log.close()
    with open(run / "metrics.jsonl", "a") as f:
        f.write('{"step": 11, "loss": ')
    for step in (5, 10):
        for val_set in ("set5", "set14"):
            write_results_csv(str(run / "results.csv"), "sr_grl", val_set,
                              {"psnr": 20 + step / 10, "ssim": 0.5 + step / 100}, step)
    return run


def test_series_equal_grlir(run_dir):
    tool = _tool()
    for name in ("load_jsonl", "load_results_csv"):
        path = run_dir / ("metrics.jsonl" if name == "load_jsonl" else "results.csv")
        assert getattr(plot_metrics, name)(str(path)) == getattr(tool, name)(str(path))
    assert sorted(plot_metrics.load_jsonl(str(run_dir / "metrics.jsonl"))) == ["loss", "lr"]


def test_same_png_names_as_grlir(run_dir, tmp_path):
    tool = _tool()
    want = tool.render(str(run_dir), str(tmp_path / "grlir"))
    got = plot_metrics.main([str(run_dir), "-o", str(tmp_path / "port")])
    names = sorted(os.path.basename(p) for p in got)
    assert names == sorted(os.path.basename(p) for p in want)
    assert names == ["train_loss.png", "train_lr.png", "val_psnr.png", "val_ssim.png"]
    for p in got:
        assert open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_module_cli_default_out_dir(run_dir):
    """`python -m grlir_torch.plot_metrics <run>` writes <run>/curves; the
    module imports no matplotlib until it plots."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-m", "grlir_torch.plot_metrics", str(run_dir)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "wrote 4 plots" in out.stdout
    assert sorted(os.listdir(run_dir / "curves")) == [
        "train_loss.png", "train_lr.png", "val_psnr.png", "val_ssim.png"]
    probe = subprocess.run(
        [sys.executable, "-c", "import sys, grlir_torch.plot_metrics; "
         "print('matplotlib' in sys.modules)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert probe.stdout.strip() == "False", probe.stderr
    assert json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[0])["step"] == 1
