"""The port's data pipeline against grlir's on a synthetic data root: for
sr (LR files and LR synthesized by MATLAB bicubic), dn, dm, db and paired
data, the first batches of the port's loader (train, with its shuffling,
crops, augmentation and noise draws, and val) are bit-equal to grlir's for
one seed, in thread mode and, for sr, in process mode; and the `.npy`
decode cache is written atomically and re-read equal."""

import json
import os

import cv2
import numpy as np
import pytest

from grlir.data.loader import DataLoader as JLoader
from grlir.data.module import IRDataModule as JModule
from grlir_torch.data.loader import DataLoader as TLoader
from grlir_torch.data.module import IRDataModule as TModule
from grlir_torch.utils.imageio import imread
from torch_parity import one_torch_thread  # noqa: F401

SEED = 3


def _write(path, img):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def _manifest(root, name, entries):
    path = root / "image_info" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(entries))


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """DIV2K train (GT and x2 LR), GoPro pairs, CBSD68 and Set5 x2 val."""
    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    div, div_x2, gopro = [], [], []
    for i in range(5):
        gt = rng.integers(0, 256, (48 + 2 * i, 56, 3), np.uint8)
        _write(root / "DIV2K" / "train" / f"{i:04d}.png", gt)
        _write(root / "DIV2K" / "train_x2" / f"{i:04d}.png", gt[::2, ::2])
        _write(root / "GOPRO" / "blur" / f"{i}.png", np.roll(gt, 1, 0))
        _write(root / "GOPRO" / "sharp" / f"{i}.png", gt)
        div.append({"path": f"train/{i:04d}.png"})
        div_x2.append({"path_gt": f"train/{i:04d}.png", "path_lq": f"train_x2/{i:04d}.png"})
        gopro.append({"path_gt": f"sharp/{i}.png", "path_lq": f"blur/{i}.png"})
    _manifest(root, "DIV2K/train.json", div)
    _manifest(root, "DIV2K/train_X2.json", div_x2)
    _manifest(root, "GOPRO/train.json", gopro)
    _manifest(root, "GOPRO/test.json", gopro[:2])
    val, val_x2 = [], []
    for i in range(2):
        gt = rng.integers(0, 256, (36, 44, 3), np.uint8)
        _write(root / "test_set" / "CBSD68" / f"v{i}_x.png", gt)
        _write(root / "test_set" / "Set5" / f"s{i}.png", gt)
        _write(root / "test_set" / "Set5" / f"s{i}_x2.png", gt[::2, ::2])
        val.append({"path": f"CBSD68/v{i}_x.png"})
        val_x2.append({"path_gt": f"Set5/s{i}.png", "path_lq": f"Set5/s{i}_x2.png"})
    _manifest(root, "CBSD68/test.json", val)
    _manifest(root, "Set5/test_X2.json", val_x2)
    monkeypatch.setenv("GRLIR_DATA_ROOT", str(root))
    return root


TASKS = {
    "sr": {"name": "sr", "scale": 2, "patch_size": 8, "load_lr": True,
           "train": {"dataset": "div2k", "num_patches": 2}, "val": {"dataset": "set5"}},
    "sr_bicubic": {"name": "sr", "scale": 2, "patch_size": 8, "load_lr": False,
                   "train": {"dataset": "div2k"}, "val": {"dataset": "set5"}},
    "dn": {"name": "dn", "patch_size": 16, "noise_sigma": 15,
           "train": {"dataset": "div2k", "noise_sigma_range": [5, 50]},
           "val": {"dataset": "cbsd68"}},
    "dm": {"name": "dm", "patch_size": 16, "train": {"dataset": "div2k"},
           "val": {"dataset": "cbsd68"}},
    "db": {"name": "db", "patch_size": 16, "noise_sigma": 2.55, "kernel_type": "gaussian",
           "train": {"dataset": "div2k"}, "val": {"dataset": "cbsd68"}},
    "paired": {"name": "paired", "patch_size": 16, "train": {"dataset": "gopro"},
               "val": {"dataset": "gopro"}},
}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k], k
            else:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _first(loader, n):
    """The first n batches of `loader.infinite()`.  The epoch that holds
    the last of them is drained to its end, so that the loader's producer
    thread has finished (and its process pool is closed) before the call
    returns: a producer left running draws beside the next loader's
    (ROADMAP C11)."""
    out, epoch = [], 0
    while len(out) < n:
        loader.set_epoch(epoch)
        for batch in loader:
            if len(out) < n:
                out.append(batch)
        epoch += 1
    loader.close()
    return out


@pytest.mark.parametrize("task", sorted(TASKS))
def test_loader_batches_equal_grlir(task, data_root, tmp_path, monkeypatch):
    # grlir reads without its HDF5 cache: the loaders' producer threads run
    # on after the batches taken here, and must not write one cache format
    # where the other side reads
    monkeypatch.setenv("GRLIR_CACHE_DIR", str(tmp_path / "cache"))
    batches = {}
    for side, module, cfg in (("grlir", JModule, dict(TASKS[task], use_cache=False)),
                              ("port", TModule, TASKS[task])):
        dm = module(cfg, seed=SEED)
        dm.train_dataset.seed(11)
        train = _first(dm.train_loader(2, num_workers=1), 3)   # crosses an epoch
        val = [b for loader in dm.val_loaders(num_workers=1).values() for b in loader]
        batches[side] = (train, val)
    _assert_batches_equal(batches["port"][0], batches["grlir"][0])
    _assert_batches_equal(batches["port"][1], batches["grlir"][1])


def test_process_mode_batches_equal_grlir(data_root, tmp_path, monkeypatch):
    """Spawned workers, reseeded per batch: the stream does not depend on
    which worker serves a batch, and equals grlir's."""
    monkeypatch.setenv("GRLIR_CACHE_DIR", str(tmp_path / "cache"))
    cfg = dict(TASKS["dn"], worker_mode="process")
    batches = {}
    for side, module, c in (("grlir", JModule, dict(cfg, use_cache=False)),
                            ("port", TModule, cfg)):
        batches[side] = _first(module(c, seed=SEED).train_loader(2, num_workers=2), 3)
    _assert_batches_equal(batches["port"], batches["grlir"])


def test_npy_cache_is_written_atomically_and_reread(data_root, tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("GRLIR_CACHE_DIR", str(cache))
    ds = TModule(TASKS["dn"], seed=SEED).train_dataset
    ds.seed(0)
    first = [ds[i] for i in range(len(ds))]
    files = sorted(p for p in cache.rglob("*") if p.is_file())
    assert [p.relative_to(cache).as_posix() for p in files] == \
        [f"DIV2K/train/{i:04d}.png" for i in range(5)]   # no temporary left
    for p in files:
        src = data_root / "DIV2K" / "train" / p.name
        cached = np.load(p, allow_pickle=False)
        assert cached.dtype == np.uint8
        np.testing.assert_array_equal(cached, imread(str(src)))
        os.remove(src)      # a second pass can read the cache only
    ds.seed(0)
    for a, b in zip([ds[i] for i in range(len(ds))], first):
        for k in ("img_lq", "img_gt"):
            np.testing.assert_array_equal(a[k], b[k])


def test_jpeg_and_bsr_raise(data_root, tmp_path, monkeypatch):
    """Neither the jpeg nor the bsr data module raises any more.  The jpeg
    module's train batches (crossing an epoch, a quality drawn from a
    range, the noise-level map) and val batches are bit-equal to grlir's;
    the bsr module's first train batches (process workers by default, here
    one thread) equal grlir's within the BSR data's JPEG gate
    (tests/test_torch_bsr.py), the generator-driven parts exactly."""
    from test_torch_bsr import FLOAT_ATOL, USM_NEAR, JpegGate

    monkeypatch.setenv("GRLIR_CACHE_DIR", str(tmp_path / "cache"))
    jpeg = {"name": "jpeg", "patch_size": 16, "quality_factor": 10,
            "quality_factor_range": [10, 40], "noise_level_map": True,
            "train": {"dataset": "div2k"}, "val": {"dataset": "cbsd68"}}
    batches = {}
    for side, module, c in (("grlir", JModule, dict(jpeg, use_cache=False)),
                            ("port", TModule, jpeg)):
        dm = module(c, seed=SEED)
        dm.train_dataset.seed(11)
        train = _first(dm.train_loader(2, num_workers=1), 3)
        val = [b for loader in dm.val_loaders(num_workers=1).values() for b in loader]
        batches[side] = (train, val)
    _assert_batches_equal(batches["port"][0], batches["grlir"][0])
    _assert_batches_equal(batches["port"][1], batches["grlir"][1])
    cfg = {"name": "bsr", "scale": 4, "patch_size": 8, "worker_mode": "thread",
           "train": {"dataset": "div2k"}}
    batches = {}
    for side, module, c in (("grlir", JModule, dict(cfg, use_cache=False)),
                            ("port", TModule, cfg)):
        dm = module(c, seed=SEED)
        assert not dm.val_datasets
        batches[side] = _first(dm.train_loader(2, num_workers=1), 2)
    gate = JpegGate()
    for got, want in zip(batches["port"], batches["grlir"]):
        assert sorted(got) == sorted(want)
        assert list(got["indices"]) == list(want["indices"])
        assert got["filenames"] == want["filenames"]
        gate.check(got["img_lq"], want["img_lq"], "lq")
        np.testing.assert_allclose(got["img_gt"], want["img_gt"], atol=FLOAT_ATOL)
        np.testing.assert_allclose(got["img_gt_usm"], want["img_gt_usm"], atol=USM_NEAR)
    gate.finish()


def test_loader_index_order_equals_grlir():
    """Shuffle, drop_last and shard strides over a plain index dataset."""
    class Idx:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return {"i": np.int64(i)}

    for kw in ({"shuffle": True, "drop_last": True}, {"shuffle": False},
               {"shuffle": True, "shard": (1, 3)}):
        a = JLoader(Idx(), 4, seed=5, num_workers=1, **kw)
        b = TLoader(Idx(), 4, seed=5, num_workers=1, **kw)
        for epoch in (0, 2):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert b._index_batches() == a._index_batches()
            assert len(b) == len(a)
