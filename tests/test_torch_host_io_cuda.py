"""The host half on a card: the committed image fixtures decoded equal to
their stored cv2 decodings, the committed orbax checkpoint loaded on the
card equal to its .msgpack, and `profiling.trace` (with the program's
spans of a `Restorer` call and a train step), `device_memory_stats` and
`cost_analysis` on cuda:0.

Needs an NVIDIA Hopper GPU and nvcc; skips without a CUDA device.  The file
imports no JAX, cv2 or orbax, so it runs on a machine without them:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_host_io_cuda.py
"""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from grlir_torch import host_io_cells as hc
from grlir_torch.engines.inference import Restorer
from grlir_torch.engines.train import TrainState, make_train_step
from grlir_torch.models.grl import GRL
from grlir_torch.optim import build_optimizer
from grlir_torch.ops import block_attn as ba
from grlir_torch.serve import load_checkpoint
from grlir_torch.utils import profiling
from grlir_torch.utils.imageio import imread


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(ok, what):
    assert ok, what


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(hc.IMAGES))
def test_fixture_decodes_equal_cv2(cuda, name):
    path = osp.join(hc.ASSETS, name)
    got = imread(path)
    np.testing.assert_array_equal(got, imread(path + ".png"))
    # the decoded pixels on the card, as the server feeds them
    t = torch.from_numpy(got).to(cuda)
    assert torch.equal(t.cpu(), torch.from_numpy(got))


@pytest.mark.cuda
def test_orbax_fixture_on_the_card(cuda):
    models = []
    for path in (hc.ORBAX_DIR, hc.ORBAX_MSGPACK):
        model = GRL(hc.orbax_model_config())
        load_checkpoint(model, osp.join(hc.ASSETS, path))
        models.append(model.eval().to(cuda))
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    with torch.no_grad():
        ya, yb = (m(x) for m in models)
    assert all(torch.equal(a, b) for a, b in zip(models[0].state_dict().values(),
                                                 models[1].state_dict().values()))
    assert torch.equal(ya, yb) and bool(torch.isfinite(ya).all())


@pytest.mark.cuda
def test_trace_and_memory_stats_on_cuda(cuda, tmp_path):
    model = GRL(hc.orbax_model_config()).eval().to(cuda)
    x = torch.rand(1, 32, 32, 3, device=cuda)
    with torch.no_grad():
        model(x)
        ba.reset_launches()
        with profiling.trace(str(tmp_path)):
            for _ in range(5):
                model(x)
    launched = ba.window_half.launches
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert launched > 0 and launched % 5 == 0
    # one record short at most: CUPTI has dropped records (ROADMAP C10)
    assert launched - 1 <= sum("window_half" in k for k in kernels) <= launched
    stats = profiling.device_memory_stats()
    assert stats["cuda:0"]["bytes_in_use_mb"] > 0
    assert stats["cuda:0"]["peak_bytes_mb"] >= stats["cuda:0"]["bytes_in_use_mb"]

    # the program's spans in the trace, on its time base: a warm Restorer
    # call on its CUDA graph, and a train step
    restorer = Restorer(model, cuda, scale=4)
    img = np.random.default_rng(0).random((1, 32, 32, 3), np.float32)
    restorer(img)
    state = TrainState(model, *build_optimizer(model.parameters(), "adamw"))
    batch = {"img_lq": x, "img_gt": torch.rand(1, 128, 128, 3, device=cuda)}
    step = make_train_step({"l1": 1.0})
    step(state, batch)
    profiling.drain_spans()
    with profiling.trace(str(tmp_path / "spans")):
        restorer(img)
        step(state, batch)
    events = json.load(open(tmp_path / "spans" / "trace.json"))["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "grlir_torch"}
    assert set(ours) == {profiling.RESTORER_CALL, profiling.RESTORER_COPY_IN,
                         profiling.RESTORER_REPLAY, profiling.RESTORER_COPY_OUT,
                         profiling.TRAIN_STEP, profiling.TRAIN_FORWARD,
                         profiling.TRAIN_BACKWARD, profiling.TRAIN_UPDATE}
    out = ours[profiling.RESTORER_COPY_OUT]
    d2h = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]
           and out["ts"] <= e["ts"] <= out["ts"] + out["dur"]]
    assert len(d2h) == 1 and d2h[0]["ts"] + d2h[0]["dur"] <= out["ts"] + out["dur"]
    assert profiling.recorded_spans() == []


@pytest.mark.cuda
def test_cost_analysis_kernels_on_equals_off(cuda):
    """The tiny GRL's forward counts the same FLOPs with its kernels (B1,
    B2 reporting their work) as on the plain path."""
    from dataclasses import replace

    cost = {}
    for on in (True, False):
        torch.manual_seed(0)
        model = GRL(replace(hc.orbax_model_config(), kernels=on)).eval().to(cuda)
        x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
        ba.reset_launches()
        with torch.no_grad():
            cost[on] = profiling.cost_analysis(model, x)
        assert (ba.window_half.launches > 0) == on
    assert cost[True]["flops"] == cost[False]["flops"] > 0
    assert 0 < cost[True]["bytes_accessed"] < cost[False]["bytes_accessed"]
