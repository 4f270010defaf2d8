"""The port's own copies of grlir's numpy/scipy host code, held equal to
the originals on the CPU: imresize (bit-equal), NIQE, the metric
accumulator with its dedup, the results pivot, and the asset files."""

import filecmp
import os

import numpy as np
import pytest
import torch

from grlir.metrics import collect as JC
from grlir.metrics import niqe as JN
from grlir.utils import matlab as JM
from grlir.utils import report as JR
from grlir_torch.metrics import collect as TC
from grlir_torch.metrics import niqe as TN
from grlir_torch.utils import matlab as TM
from grlir_torch.utils import report as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _structured(h, w, c, seed):
    """Smooth gradients, edges and texture in [0, 1]: an image with the
    statistics NIQE and the resampling kernels care about."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.3 * np.sin(x / 7.0) * np.cos(y / 11.0)
    base += 0.2 * ((x // 16 + y // 16) % 2) - 0.1
    img = base[..., None] + 0.05 * rng.standard_normal((h, w, c))
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.mark.parametrize("scale", [0.25, 0.5, 2, 4])
@pytest.mark.parametrize("shape", [(37, 29, 3), (33, 27)])
def test_imresize_bit_equal(scale, shape):
    img = _structured(shape[0], shape[1], 3, 1)
    img = img if len(shape) == 3 else img[..., 0]
    got, want = TM.imresize(img, scale), JM.imresize(img, scale)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_niqe_matches_grlir():
    img = _structured(192, 192, 3, 2)
    got, want = TN.calculate_niqe(img), JN.calculate_niqe(img)
    assert np.isfinite(want)
    assert abs(got - want) <= 1e-9 * abs(want)
    np.testing.assert_allclose(TN.niqe_batch(img[None, :, :, :1]),
                               JN.niqe_batch(img[None, :, :, :1]), rtol=1e-9)


@pytest.mark.parametrize("name", ["niqe_pris_params.npz", "Levin09.npy"])
def test_assets_are_byte_copies(name):
    assert filecmp.cmp(os.path.join(ROOT, "grlir_torch", "assets", name),
                       os.path.join(ROOT, "grlir", "assets", name), shallow=False)


def _fill(mod):
    """Two shards' updates with overlapping indices (4 and 5 twice)."""
    acc = mod.MetricAccumulator(["psnr", "ssim"])
    acc.update({"psnr": np.array([30.0, 31.5, 29.25]), "ssim": np.array([0.9, 0.8, 0.7])},
               np.array([3, 4, 5]), ["a.png", "b.png", "c.png"])
    acc.update({"psnr": np.array([40.0, 28.0]), "ssim": np.array([0.1, 0.85])},
               np.array([4, 5]), ["b.png", "c.png"])
    acc.update({"psnr": np.float32(33.0), "ssim": 0.95}, 6)
    return acc


def test_accumulator_matches_grlir():
    vals, idx = np.array([1.0, 2.0, 7.0, 3.0]), np.array([0, 1, 0, 2])
    assert TC.dedup_average(vals, idx) == JC.dedup_average(vals, idx) == 2.0
    got, want = _fill(TC), _fill(JC)
    assert got.compute() == want.compute()
    assert got.compute()["psnr"] == pytest.approx((30.0 + 31.5 + 29.25 + 33.0) / 4)
    assert got.per_image_table() == want.per_image_table()
    got.gather_across_hosts()       # one process: nothing to gather
    assert got.compute() == want.compute()


def test_gather_across_ranks_waits_for_data_parallel(monkeypatch):
    """Rank 0 of two gathers (the all-gather faked: the other rank holds
    indices 5 again and 7): its metrics are grlir's dedup over both ranks'
    vectors in rank order.  tests/test_torch_parallel.py runs the real
    gather over gloo ranks."""
    from grlir_torch.parallel import mesh

    other = [np.array([12.0, 35.0]), np.array([0.2, 0.6]), np.array([5, 7])]
    calls = iter(other)
    monkeypatch.setattr(mesh, "grouped", lambda: True)
    monkeypatch.setattr(mesh, "world", lambda: (0, 2))
    monkeypatch.setattr(mesh, "all_gather_ragged", lambda a: [a, next(calls)])
    got = _fill(TC)
    got.gather_across_hosts()
    want = _fill(JC)
    want.update({"psnr": other[0], "ssim": other[1]}, other[2])
    for k, v in want.compute().items():
        assert got.compute()[k] == pytest.approx(v, rel=1e-12), k


def test_parse_csv_matches_grlir(tmp_path):
    path = tmp_path / "results.csv"
    path.write_text("tag,val_set,step,psnr,ssim\n"
                    "run,Set5,1000,30.1000,0.9000\n"
                    "run,Set14,1000,27.0000,0.8000\n"
                    "\n"
                    "run,Set5,2000,30.5000,0.9100\n")
    assert TR.parse_csv(str(path)) == JR.parse_csv(str(path))
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    assert TR.parse_csv(str(empty)) == JR.parse_csv(str(empty)) == ""
