"""The Restorer's CUDA graphs on a card: one graph a padded shape, replayed
against the eager kernel path.

Needs an NVIDIA Hopper GPU and nvcc; skips without a CUDA device.  The file
imports no JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph.py

GRL-S x4 (full width, bf16, engine v3) with random weights from a seed.
"""

import math
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grlir_torch.engines.inference import WARMUP_FORWARDS, Restorer, reflect_pad_to
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL, init_weights
from grlir_torch.ops import block_attn as tba

MIN_PSNR = 60.0   # bf16 whole model: replay vs eager, as chip_smoke.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grl_s(dev):
    cfg = zoo.make_config("small", dtype=torch.bfloat16)
    return init_weights(GRL(cfg), torch.Generator().manual_seed(0)).eval().to(dev)


def _image(seed, h, w):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(np.float32)


def _eager(model, img, bucket, dev):
    """The model on img padded to its bucket in one reflect, cropped."""
    _, h, w, _ = img.shape
    x = reflect_pad_to(img, (h + (-h % bucket), w + (-w % bucket)))
    with torch.no_grad():
        y = model(torch.from_numpy(np.ascontiguousarray(x)).to(dev))
    return y.float().cpu()[:, :4 * h, :4 * w].numpy()


def _psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(1 / mse)


@pytest.mark.cuda
def test_replay_matches_eager_at_two_buckets(cuda):
    """Two bucket shapes, two graphs in one pool; a second call of a shape
    replays its graph without tracing the model again."""
    model = _grl_s(cuda)
    r = Restorer(model, cuda, scale=4, shape_bucket=64)
    imgs = [_image(1, 64, 64), _image(2, 100, 120)]
    outs = [r(img) for img in imgs]
    assert sorted(r.graphs) == [(1, 64, 64, 3), (1, 128, 128, 3)]
    for img, out in zip(imgs, outs):
        assert out.shape == (1, 4 * img.shape[1], 4 * img.shape[2], 3)
        assert _psnr(out, _eager(model, img, 64, cuda)) >= MIN_PSNR
    tba.reset_launches()
    again = r(imgs[0])
    assert all(k.launches == 0 for k in tba.COUNTED)
    np.testing.assert_array_equal(again, outs[0])


@pytest.mark.cuda
def test_weight_written_in_place_is_seen_by_the_next_replay(cuda):
    model = _grl_s(cuda)
    r = Restorer(model, cuda, scale=4, shape_bucket=64)
    img = _image(3, 64, 64)
    before = r(img)
    with torch.no_grad():
        model.layers[0].blocks[0].attn.qkv.body.weight.mul_(1.001)
    after = r(img)
    assert np.abs(after - before).max() > 0
    assert _psnr(after, _eager(model, img, 64, cuda)) >= MIN_PSNR


@pytest.mark.cuda
def test_profiled_replay_launches_b1_and_b2(cuda):
    """One profiled replay launches B1's fused kernel and B2's projection
    and resident attention kernels once a block each: as often as the
    launches counted while the shape was traced say."""
    model = _grl_s(cuda)
    n_blocks = sum(model.cfg.depths)
    r = Restorer(model, cuda, scale=4, shape_bucket=64)
    tba.reset_launches()
    r(_image(4, 64, 64))
    w1 = WARMUP_FORWARDS + 1
    assert tba.window_half.launches == tba.stripe_half.launches == w1 * n_blocks
    graph = next(iter(r.graphs.values())).graph
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    names = {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)[<(]", e.key)
        if m and str(getattr(e, "device_type", "")).endswith("CUDA"):
            names[m.group(1)] = names.get(m.group(1), 0) + e.count
    for k in ("window_half_mma_kernel", "mma_project_kernel", "mma_stripe_resident_kernel"):
        assert names.get(k) == n_blocks, (k, names)


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """A forward that cannot be captured (a host sync) raises; no graph is
    kept, and the card stays usable, its random generator too (ROADMAP
    C7)."""
    r = Restorer(lambda x: x * float(x.sum()), cuda)
    with pytest.raises(RuntimeError):
        r(_image(5, 8, 8))
    assert not r.graphs
    assert (torch.ones(2, device=cuda) + 1).sum().item() == 4
    u = torch.rand(1000, device=cuda)
    assert 0.4 < u.mean().item() < 0.6
