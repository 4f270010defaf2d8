"""The JPEG artifact-removal data of the port against grlir's: the
one-component (grayscale) JPEG round trip bit-equal to cv2's encode and
decode at 5 qualities x 5 sizes x 2 contents (as tests/test_torch_bsr.py
holds the colour one); `jpeg_compress` on colour and grayscale images
bit-equal to grlir's; `JPEGDataset` items, train (both patchwise orders,
with and without the noise-level map, a fixed quality and one drawn from a
range, colour and grayscale) and val, equal to grlir's at equal generator
states."""

import json

import cv2
import numpy as np
import pytest

from grlir.data import degradations as JD
from grlir.data.base import TRAIN, VAL
from grlir.data.tasks import JPEGDataset as JJPEG
from grlir.data.tasks import TaskConfig as JTaskConfig
from grlir_torch.data import degradations as TD
from grlir_torch.data.tasks import JPEGDataset as TJPEG
from grlir_torch.data.tasks import TaskConfig as TTaskConfig
from grlir_torch.utils.imageio import imwrite
from grlir_torch.utils.jpeg import jpeg_roundtrip_gray


def _cv2_gray_jpeg(gray, quality):
    _, buf = cv2.imencode(".jpg", gray, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    return cv2.imdecode(buf, 0)


def _gray_content(kind, h, w, rng):
    if kind == "random":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    gray = np.zeros((h, w), np.uint8)            # edges
    gray[:, w // 2:] = 200
    gray[h // 3:] = gray[h // 3:] // 2 + 30
    return gray


@pytest.mark.parametrize("quality", [10, 21, 50, 75, 95])
@pytest.mark.parametrize("hw", [(8, 8), (37, 53), (100, 100), (400, 400), (5, 3)])
@pytest.mark.parametrize("kind", ["random", "edges"])
def test_gray_roundtrip_bit_equal_to_cv2(quality, hw, kind):
    img = _gray_content(kind, *hw, np.random.default_rng(quality + sum(hw)))
    np.testing.assert_array_equal(jpeg_roundtrip_gray(img, quality),
                                  _cv2_gray_jpeg(img, quality))


@pytest.mark.parametrize("channels", [3, 1])
def test_jpeg_compress_equals_grlir(channels):
    rng = np.random.default_rng(channels)
    for q in (10, 40, 90):
        img = rng.integers(0, 256, (29, 43, channels), dtype=np.uint8)
        got = TD.jpeg_compress(img, q)
        assert got.shape == img.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, JD.jpeg_compress(img, q))


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """DIV2K train images and a LIVE1 val set, written by the port."""
    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    entries = {"DIV2K/train.json": [], "LIVE1/test.json": []}
    (root / "DIV2K" / "train").mkdir(parents=True)
    (root / "test_set" / "LIVE1").mkdir(parents=True)
    for i in range(3):
        imwrite(str(root / "DIV2K" / "train" / f"{i:04d}.png"),
                (rng.random((40 + 4 * i, 48, 3)) * 255).astype(np.uint8))
        entries["DIV2K/train.json"].append({"path": f"train/{i:04d}.png"})
    for i in range(2):
        imwrite(str(root / "test_set" / "LIVE1" / f"v{i}.png"),
                (rng.random((35, 42, 3)) * 255).astype(np.uint8))
        entries["LIVE1/test.json"].append({"path": f"LIVE1/v{i}.png"})
    for name, e in entries.items():
        path = root / "image_info" / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(e))
    monkeypatch.setenv("GRLIR_DATA_ROOT", str(root))
    monkeypatch.setenv("GRLIR_CACHE_DIR", str(tmp_path / "cache"))
    return root


CASES = {
    "after_patch": dict(patchwise=False, noise_level_map=False),
    "patchwise": dict(patchwise=True, noise_level_map=False),
    "after_patch_map": dict(patchwise=False, noise_level_map=True),
    "patchwise_map_range": dict(patchwise=True, noise_level_map=True,
                                quality_factor_range=(10, 40)),
    "range_gray": dict(patchwise=False, noise_level_map=True, num_channels=1,
                       quality_factor_range=(20, 60)),
}


def _items(ds, seed):
    ds.seed(seed)
    return [ds[i] for i in range(len(ds))]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["indices"] == w["indices"] and g["filenames"] == w["filenames"]
        for k in ("img_lq", "img_gt"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jpeg_dataset_items_equal_grlir(case, data_root):
    kw = dict(name="jpeg", dataset="div2k", patch_size=16, quality_factor=10,
              num_patches=2, use_cache=False, **CASES[case])
    got = _items(TJPEG(TTaskConfig(**kw), TRAIN), 5)
    want = _items(JJPEG(JTaskConfig(**kw), TRAIN), 5)
    _assert_items_equal(got, want)
    channels = kw.get("num_channels", 3)
    assert got[0]["img_lq"].shape == (16, 16, channels + kw["noise_level_map"])
    if kw["noise_level_map"]:
        qf = 1 - got[0]["img_lq"][0, 0, -1]
        lo, hi = kw.get("quality_factor_range", (10, 10))
        assert lo / 100 - 1e-6 <= qf <= hi / 100 + 1e-6
    # val: live1's whole images at the configured quality
    vkw = dict(kw, dataset="live1")
    got = _items(TJPEG(TTaskConfig(**vkw), VAL), 0)
    _assert_items_equal(got, _items(JJPEG(JTaskConfig(**vkw), VAL), 0))
    assert got[0]["img_gt"].shape[:2] == (35, 42)
