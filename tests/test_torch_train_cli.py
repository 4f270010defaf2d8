"""The port's trainer CLI end to end on the CPU, on a synthetic data root:
`python -m grlir_torch.train ... device=cpu` trains, validates, saves
checkpoints and images; a second run resumes; an eval-only run; a
progressive stage change; eval-only metrics of grlir's CLI and the
port's on the same `.pth` within 1e-4 dB; and the JPEG experiment
(jpeg/grl_p288's geometry: window 36, fixed 72x144 stripes, anchor df 4)
trains and validates at a cut depth and width on 144^2 patches."""

import importlib
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from grlir_torch.models.grl import GRL, init_weights
from grlir_torch.train import build_model_config
from grlir_torch.configs import load_config
from grlir_torch.utils.imageio import imwrite
from torch_parity import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
EVAL_TOL = 1e-4     # dB (and SSIM units): the same .pth through both CLIs


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """DIV2K train images and a CBSD68 val set, written by the port."""
    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    (root / "DIV2K" / "train").mkdir(parents=True)
    (root / "test_set" / "CBSD68").mkdir(parents=True)
    train, val = [], []
    for i in range(4):
        imwrite(str(root / "DIV2K" / "train" / f"{i:04d}.png"),
                (rng.random((40, 48, 3)) * 255).astype(np.uint8))
        train.append({"path": f"train/{i:04d}.png"})
    for i in range(2):
        imwrite(str(root / "test_set" / "CBSD68" / f"val{i}.png"),
                (rng.random((33, 47, 3)) * 255).astype(np.uint8))
        val.append({"path": f"CBSD68/val{i}.png"})
    for name, entries in (("DIV2K/train.json", train), ("CBSD68/test.json", val)):
        path = root / "image_info" / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(entries))
    monkeypatch.setenv("GRLIR_DATA_ROOT", str(root))
    monkeypatch.setenv("GRLIR_CACHE_DIR", str(tmp_path / "cache"))
    return root


def _overrides(tmp_path, steps=4, tag="it"):
    return [
        "experiment=dn/grl_p256", f"tag={tag}", f"io.base_output_path={tmp_path}/out",
        "data_module.train.dataset=div2k", "data_module.val.dataset=cbsd68",
        "model.embed_dim=16", "model.depths=[2]", "model.num_heads_window=[2]",
        "model.num_heads_stripe=[2]", "model.window_size=8", "stripe_size1=8",
        "stripe_size2=16", "patch_size=16", "batch_size=2",
        f"trainer.max_steps={steps}", "trainer.val_check_interval=2",
        "trainer.log_every_n_steps=1", "num_workers=1", "mixup=false",
        "save_images=true",
    ]


def test_train_validate_checkpoint_resume_eval_progressive(data_root, tmp_path, capsys):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "grlir_torch.train",
                          *_overrides(tmp_path, 4), "device=cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "val[cbsd68]" in out.stdout and "psnr=" in out.stdout, out.stdout
    assert "step 4/4 loss=" in out.stdout and "[grlir_torch] done" in out.stdout
    run = tmp_path / "out" / "it" / "version_0"
    rows = (run / "results.csv").read_text().splitlines()
    assert [r.split(",")[2] for r in rows[1:]] == ["2", "4"]
    assert sorted(os.listdir(run / "checkpoints")) == ["step_2", "step_4"]
    assert os.listdir(run / "images" / "cbsd68" / "HQ")
    assert (run / "images" / "cbsd68" / "per_image_metrics.txt").exists()
    logged = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == [1, 2, 3, 4] and all(r["lr"] == 1e-4 for r in logged)

    from grlir_torch.train import main

    main(_overrides(tmp_path, 6) + ["device=cpu"])
    text = capsys.readouterr().out
    assert "resumed from step 4" in text and "step 5/6" in text and "step 4/6" not in text
    rows = (run / "results.csv").read_text().splitlines()
    assert [r.split(",")[2] for r in rows[1:]] == ["2", "4", "6"]
    assert sorted(os.listdir(run / "checkpoints")) == ["step_4", "step_6"]

    main(_overrides(tmp_path, 4, tag="ev") + ["training=false", "device=cpu"])
    text = capsys.readouterr().out
    assert "step 0 val[cbsd68]" in text and "loss=" not in text

    main(_overrides(tmp_path, 4, tag="prog") + [
        "steps=[2]", "batch_sizes=[2,1]", "patch_sizes=[16,8]", "device=cpu"])
    text = capsys.readouterr().out
    assert "progressive stage 0: batch=2 patch=16" in text
    assert "progressive stage 1: batch=1 patch=8" in text


def test_eval_only_metrics_equal_grlir_cli(data_root, tmp_path, monkeypatch):
    """One .pth (the reference's key names) through grlir's CLI and the
    port's, training=false: the metrics of every val image set agree."""
    toks = _overrides(tmp_path, 2, tag="cmp")
    model = GRL(build_model_config(load_config(toks)))
    init_weights(model, torch.Generator().manual_seed(3))
    pth = tmp_path / "m.pth"
    torch.save({"state_dict": {f"model.{k}": v for k, v in model.state_dict().items()}}, pth)
    toks += ["training=false", f"pretrained_checkpoint={pth}"]

    got = {}
    jval = importlib.import_module("grlir.engines.validate")
    tval = importlib.import_module("grlir_torch.engines.validate")
    for side, mod in (("grlir", jval), ("port", tval)):
        write = mod.write_results_csv

        def keep(path, tag, val_set, results, step, side=side, write=write):
            got[side] = dict(results)
            write(path, tag, val_set, results, step)

        monkeypatch.setattr(mod, "write_results_csv", keep)
    from grlir.train import main as jmain
    from grlir_torch.train import main as tmain

    jmain(toks + ["num_devices=1"])
    tmain(toks + ["device=cpu", "tag=cmp_port"])
    assert sorted(got["port"]) == sorted(got["grlir"]) == ["psnr", "psnr_y", "ssim", "ssim_y"]
    for k, v in got["grlir"].items():
        assert abs(got["port"][k] - v) <= EVAL_TOL, (k, got["port"][k], v)


def test_jpeg_experiment_trains(data_root, tmp_path, capsys):
    """experiment=jpeg/grl_p288 on the CPU: two steps and a validation on
    LIVE1 at the recipe's geometry (window 36: the large-window route;
    stripes 72x144 at df 4: the plain stripe half), cut to one block at
    embed 32 and 144^2 patches (a step of two blocks takes 11 s on one
    core); the val image runs as tiles of 144^2 (the recipe's tile of 576
    clipped to the image)."""
    from grlir_torch.ops import block_attn as ba
    from grlir_torch.train import main

    rng = np.random.default_rng(3)
    (data_root / "test_set" / "LIVE1").mkdir(parents=True)
    imwrite(str(data_root / "test_set" / "LIVE1" / "v0.png"),
            (rng.random((144, 168, 3)) * 255).astype(np.uint8))
    (data_root / "image_info" / "LIVE1").mkdir(parents=True)
    (data_root / "image_info" / "LIVE1" / "test.json").write_text(
        json.dumps([{"path": "LIVE1/v0.png"}]))
    assert ba.window_route((144, 144), (36, 36), 2) == "large"
    assert ba.stripe_route((144, 144), (72, 144), 4, 2) is None
    main(["experiment=jpeg/grl_p288", "tag=jpeg", f"io.base_output_path={tmp_path}/out",
          "data_module.train.dataset=div2k", "model.embed_dim=32", "model.depths=[1]",
          "model.num_heads_window=[2]", "model.num_heads_stripe=[2]", "patch_size=144",
          "trainer.max_steps=2", "trainer.log_every_n_steps=1", "num_workers=1",
          "device=cpu"])
    text = capsys.readouterr().out
    assert "step 2/2 loss=" in text and "val[live1]" in text and "psnr=" in text, text
    run = tmp_path / "out" / "jpeg" / "version_0"
    assert sorted(os.listdir(run / "checkpoints")) == ["step_2"]
