"""Training across processes on the card (marker `cuda`; skips without a
CUDA device).  The file imports no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py

- World size 1 on NCCL through GRLIR_COORDINATOR: the trainer's CLI in a
  process of its own, beside the same run undistributed, with
  deterministic algorithms and one hash seed (the datasets' generator is
  seeded from the hash of the stage's name): the last loss and the saved
  parameters equal to the bit.
- The card cell of `grlir_torch.parallel_cells` (GRL-S fp32 with the
  kernels on, 3 SGD steps at 2 rows a rank, the tiled Restorer and the
  gathered validation metrics) on two ranks that share the card over gloo
  (NCCL refuses two ranks on one GPU), and on one NCCL rank, whose group
  of one runs every collective, against one process on the global batch
  at the module's gates; every rank launches B1 and B2.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from grlir_torch import parallel_cells as pc
from grlir_torch.utils.imageio import imwrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
CODE = """
import sys, torch
torch.use_deterministic_algorithms(True, warn_only=True)
from grlir_torch.train import main
main(sys.argv[1:])
import torch.distributed as dist
print("BACKEND", dist.get_backend() if dist.is_initialized() else None)
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data_root(root):
    rng = np.random.default_rng(0)
    (root / "DIV2K" / "train").mkdir(parents=True)
    (root / "test_set" / "CBSD68").mkdir(parents=True)
    for i in range(4):
        imwrite(str(root / "DIV2K" / "train" / f"{i:04d}.png"),
                (rng.random((72, 80, 3)) * 255).astype(np.uint8))
    imwrite(str(root / "test_set" / "CBSD68" / "v0.png"),
            (rng.random((64, 72, 3)) * 255).astype(np.uint8))
    for name, entries in (("DIV2K/train.json", [{"path": f"train/{i:04d}.png"}
                                                 for i in range(4)]),
                          ("CBSD68/test.json", [{"path": "CBSD68/v0.png"}])):
        path = root / "image_info" / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(entries))


@pytest.mark.cuda
def test_nccl_world_one_equals_undistributed(cuda, tmp_path):
    _data_root(tmp_path / "data")
    port = pc.free_port()
    args = ["experiment=dn/grl_p256", "tag=ddp", "data_module.train.dataset=div2k",
            "data_module.val.dataset=cbsd68", "model.embed_dim=32", "model.depths=[2]",
            "model.num_heads_window=[2]", "model.num_heads_stripe=[2]", "patch_size=64",
            "batch_size=2", f"trainer.max_steps={STEPS}", "trainer.log_every_n_steps=1",
            "num_workers=1", "model.use_pallas_attention=v3"]
    procs, runs = {}, {}
    for mode in ("undistributed", "nccl"):
        env = {**os.environ, "PYTHONPATH": ROOT, "GRLIR_DATA_ROOT": str(tmp_path / "data"),
               "GRLIR_CACHE_DIR": str(tmp_path / f"cache_{mode}"),
               "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "PYTHONHASHSEED": "0"}
        if mode == "nccl":
            env.update(GRLIR_COORDINATOR=f"127.0.0.1:{port}", GRLIR_NUM_PROCESSES="1",
                       GRLIR_PROCESS_ID="0")
        procs[mode] = subprocess.Popen(
            [sys.executable, "-c", CODE, *args, f"io.base_output_path={tmp_path / mode}"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for mode, p in procs.items():
            out = p.communicate(timeout=600)[0]
            assert p.returncode == 0, out[-4000:]
            run = tmp_path / mode / "ddp" / "version_0"
            logged = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
            saved = torch.load(run / "checkpoints" / f"step_{STEPS}" / "checkpoint.pt",
                               map_location="cpu", weights_only=True)
            runs[mode] = (out, logged[-1], saved["model"])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    assert "BACKEND nccl" in runs["nccl"][0] and "BACKEND None" in runs["undistributed"][0]
    (_, log_u, sd_u), (_, log_n, sd_n) = runs["undistributed"], runs["nccl"]
    assert log_n["step"] == log_u["step"] == STEPS and log_n["loss"] == log_u["loss"]
    assert sd_u.keys() == sd_n.keys()
    for k, v in sd_u.items():
        assert torch.equal(sd_n[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_card_cell_ranks_equal_one_process(cuda, tmp_path, backend, world):
    cell = pc.card_scenarios(str(tmp_path / "cell"))
    ranks = pc.launch(world, cell, str(tmp_path / "ranks"), device="cuda",
                      group="gloo" if backend == "gloo" else "env")
    ref = pc.reference(cell, cuda)
    assert pc.compare(ranks, ref) == []
    for o in ranks:
        assert o["backend"] == backend
        t = o["train"]
        assert t["launches"].get("window_half", 0) > 0 and t["launches"].get("stripe_half", 0) > 0
        assert t["routes"]["window_half"]["tensor_core"] == 0    # fp32: CUDA cores
