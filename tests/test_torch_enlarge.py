"""The SR dataset's enlargement of a training image smaller than the GT
patch: `cv2_ops.resize` on uint8 with INTER_LINEAR bit-equal to
`cv2.resize` (OpenCV's fixed point), the float path bit-equal to cv2 as
well, and the port's `SRDataset._load_pair` and items bit-equal to
grlir's."""

import json

import cv2
import numpy as np
import pytest

from grlir.data.module import IRDataModule as JModule
from grlir_torch.data.module import IRDataModule as TModule
from grlir_torch.utils import cv2_ops

# (source h, w) -> (output h, w): odd sizes, non-integer and integer
# factors, one-pixel sources, one axis unchanged
SIZES = [((5, 7), (16, 16)), ((13, 9), (32, 40)), ((20, 30), (33, 47)),
         ((64, 48), (96, 96)), ((7, 3), (8, 100)), ((100, 90), (128, 131)),
         ((3, 2), (7, 5)), ((1, 1), (4, 6)), ((31, 17), (128, 128)),
         ((64, 48), (96, 48)), ((64, 48), (64, 96)), ((250, 301), (256, 320))]


@pytest.mark.parametrize("channels", [0, 1, 3])
@pytest.mark.parametrize("src,dst", SIZES)
def test_uint8_linear_resize_equals_cv2(src, dst, channels):
    rng = np.random.default_rng(sum(src) + sum(dst) + channels)
    shape = src + ((channels,) if channels else ())
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = cv2_ops.resize(img, (dst[1], dst[0]))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_float_resize_path_unchanged():
    """float32 INTER_LINEAR (the BSR data's path) stays apart from the
    uint8 fixed point: IPP's float bilinear, bit-equal to cv2."""
    rng = np.random.default_rng(0)
    img = rng.random((13, 9, 3)).astype(np.float32)
    got = cv2_ops.resize(img, (40, 32))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, cv2.resize(img, (40, 32)))


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    """DIV2K x2 train manifest of GT images smaller than the 16^2 GT patch
    (scale 2, LR patch 8) on one or both axes, and one larger."""
    root = tmp_path / "data"
    rng = np.random.default_rng(7)
    entries = []
    for i, hw in enumerate(((11, 9), (12, 30), (40, 13), (24, 20))):
        gt = rng.integers(0, 256, (*hw, 3), np.uint8)
        for sub, img in (("train", gt), ("train_x2", gt[::2, ::2])):
            path = root / "DIV2K" / sub / f"{i:04d}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        entries.append({"path_gt": f"train/{i:04d}.png", "path_lq": f"train_x2/{i:04d}.png"})
    info = root / "image_info" / "DIV2K" / "train_X2.json"
    info.parent.mkdir(parents=True)
    info.write_text(json.dumps(entries))
    monkeypatch.setenv("GRLIR_DATA_ROOT", str(root))
    monkeypatch.setenv("GRLIR_CACHE_DIR", str(tmp_path / "cache"))
    return root


def test_small_image_load_pair_equals_grlir(small_root):
    cfg = {"name": "sr", "scale": 2, "patch_size": 8, "load_lr": False,
           "train": {"dataset": "div2k"}}
    sets = {side: module(dict(cfg, use_cache=False), seed=3).train_dataset
            for side, module in (("grlir", JModule), ("port", TModule))}
    for i in range(4):
        (jl, jg), (tl, tg) = sets["grlir"]._load_pair(i), sets["port"]._load_pair(i)
        assert tg.dtype == jg.dtype == np.uint8 and tg.shape == jg.shape
        assert min(tg.shape[:2]) >= 16
        np.testing.assert_array_equal(tg, jg)
        assert tl.dtype == jl.dtype and tl.shape == jl.shape
        np.testing.assert_array_equal(tl, jl)
    for side in sets:
        sets[side].seed(11)
    for i in range(4):
        got, want = sets["port"][i], sets["grlir"][i]
        assert sorted(got) == sorted(want)
        for k in ("img_lq", "img_gt"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
