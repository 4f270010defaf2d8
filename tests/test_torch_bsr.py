"""The BSR degradation data of the port against grlir's on the CPU: the
numpy copies of the OpenCV calls against cv2 itself, the JPEG round trip
bit-equal to cv2's encoder and decoder, USM sharpening, ColorJitter, the
camera ISP and the second-order degradation over several seeds (with the
generators left in grlir's state), and BSRDataset items in train and both
validation modes."""

import json

import cv2
import numpy as np
import pytest
from scipy import ndimage

from grlir.data import bsr_utils as JB
from grlir.data.bsr import BSRDataset as JBSRDataset
from grlir.data.tasks import TaskConfig as JTaskConfig
from grlir_torch.data import bsr_utils as TB
from grlir_torch.data.base import TRAIN, VAL
from grlir_torch.data.bsr import BSRDataset as TBSRDataset
from grlir_torch.data.tasks import TaskConfig as TTaskConfig
from grlir_torch.utils import cv2_ops as O
from grlir_torch.utils.imageio import imwrite
from grlir_torch.utils.jpeg import jpeg_float, jpeg_roundtrip
from torch_parity import one_torch_thread  # noqa: F401

CV2_ATOL = 1e-5          # every float copy of an OpenCV call
FLOAT_ATOL = 1e-5        # USM, ColorJitter, the ISP: no JPEG step after them
USM_FLIP = 1e-3          # |residual| * 255 this near the USM threshold may flip
USM_NEAR = 1e-3          # ... and move the output this far within the blur
# degradation_sr2 and BSR items end in JPEG: a float difference of one
# rounding can flip one 8-bit value before the encoder, and that can move a
# quantized coefficient, i.e. a whole 8x8 luma or 16x16 chroma block (9-25 %
# of a 32x32 LR patch).  Gate: per output PSNR against grlir's >= 40 dB and
# max difference <= 16/255; over all outputs of a test, >= 99 % of values
# within 1/255
JPEG_PSNR_DB = 40.0
MAX_DIFF = 16 / 255
WITHIN_1_SHARE = 0.99
SEEDS = range(8)
SIZES = [(37, 53), (100, 100), (9, 7), (1, 5)]


def _image(rng, h, w, c):
    shape = (h, w, c) if c == 3 else (h, w)
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("c", [1, 3])
def test_blur_and_filter_match_cv2(hw, c):
    rng = np.random.default_rng(hash(hw) % 1000 + c)
    img = _image(rng, *hw, c)
    for k in (3, 5, 7, 9, 11, 51):
        np.testing.assert_allclose(O.gaussian_blur(img, k),
                                   cv2.GaussianBlur(img, (k, k), 0), atol=CV2_ATOL,
                                   err_msg=f"GaussianBlur {k}")
    for k in (3, 7, 25):
        ker = rng.random((k, k)).astype(np.float32)
        ker /= ker.sum()
        np.testing.assert_allclose(
            O.filter2d(img, ker),
            cv2.filter2D(img, -1, ker, borderType=cv2.BORDER_REFLECT_101),
            atol=CV2_ATOL, err_msg=f"filter2D {k}")
    np.testing.assert_array_equal(
        O.copy_make_border_reflect101(img, 0, 13, 0, 29),
        cv2.copyMakeBorder(img, 0, 13, 0, 29, cv2.BORDER_REFLECT_101))


@pytest.mark.parametrize("interp", [O.INTER_LINEAR, O.INTER_CUBIC, O.INTER_AREA])
@pytest.mark.parametrize("hw", SIZES + [(400, 400)])
@pytest.mark.parametrize("c", [1, 3])
def test_resize_matches_cv2(interp, hw, c):
    """Non-integer down- and up-scales on odd sizes, mixed directions, the
    exact 2x shrink and the identity size."""
    h, w = hw
    img = _image(np.random.default_rng(h * w + c), h, w, c)
    sizes = [(max(1, w // 2), max(1, h // 2)), (max(1, int(w / 1.37)), max(1, int(h / 2.9))),
             (w * 2 + 3, h * 3 + 1), (int(w * 1.6) or 1, max(1, h // 3)),
             (max(1, w // 4), h * 2), (w, h)]
    for dsize in sizes:
        np.testing.assert_allclose(O.resize(img, dsize, interp),
                                   cv2.resize(img, dsize, interpolation=interp),
                                   atol=CV2_ATOL, err_msg=f"{interp} {hw} -> {dsize}")


@pytest.mark.parametrize("hw", SIZES + [(400, 400)])
def test_hsv_matches_cv2(hw):
    rng = np.random.default_rng(sum(hw))
    img = _image(rng, *hw, 3)
    img[: max(1, hw[0] // 3)] = img[: max(1, hw[0] // 3), :, :1]    # gray rows
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    got = O.rgb_to_hsv(img)
    np.testing.assert_allclose(got[..., 1:], hsv[..., 1:], atol=CV2_ATOL)
    np.testing.assert_allclose(got[..., 0] / 360, hsv[..., 0] / 360, atol=CV2_ATOL)
    hsv[..., 0] = (hsv[..., 0] + 17.3) % 360.0
    np.testing.assert_allclose(O.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
                               atol=CV2_ATOL)


def _cv2_jpeg(rgb, quality):
    _, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                          [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    return cv2.cvtColor(cv2.imdecode(buf, 1), cv2.COLOR_BGR2RGB)


def _jpeg_content(kind, h, w, rng):
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    gray = np.zeros((h, w), np.uint8)            # gray edges
    gray[:, w // 2:] = 200
    gray[h // 3:] = gray[h // 3:] // 2 + 30
    return np.repeat(gray[..., None], 3, -1)


@pytest.mark.parametrize("quality", [20, 21, 50, 75, 95])
@pytest.mark.parametrize("hw", [(8, 8), (37, 53), (100, 100), (400, 400), (5, 3)])
@pytest.mark.parametrize("kind", ["random", "gray_edges"])
def test_jpeg_roundtrip_bit_equal_to_cv2(quality, hw, kind):
    img = _jpeg_content(kind, *hw, np.random.default_rng(quality + sum(hw)))
    np.testing.assert_array_equal(jpeg_roundtrip(img, quality), _cv2_jpeg(img, quality))


def test_jpeg_float_step_equals_grlir():
    img = ndimage.gaussian_filter(np.random.default_rng(1).random((61, 47, 3)),
                                  (1.5, 1.5, 0)).astype(np.float32)
    for q in (20, 57, 95):
        np.testing.assert_array_equal(jpeg_float(img, q), JB._jpeg(img, q))


def _smooth(rng, h, w):
    """A natural-looking float image: smoothed noise with some edges."""
    img = ndimage.gaussian_filter(rng.random((h, w, 3)), (2, 2, 0))
    img[h // 2:, : w // 3] *= 0.5
    return np.clip(img, 0, 1).astype(np.float32)


def assert_usm_close(got, img, radius=50, threshold=10):
    """usm_sharp against grlir's: its mask is a hard threshold on
    |img - blur| * 255, so a blur one float32 rounding away from cv2's can
    flip a mask pixel.  Flips are allowed only where grlir's residual lies
    within USM_FLIP of the threshold; outside the blur's footprint around
    them the outputs agree within FLOAT_ATOL, inside it within USM_NEAR."""
    want = JB.usm_sharp(img, radius=radius, threshold=threshold)
    k = radius + 1
    res_j = np.abs(img - cv2.GaussianBlur(img, (k, k), 0)) * 255
    res_t = np.abs(img - O.gaussian_blur(img, k)) * 255
    flips = (res_j > threshold) != (res_t > threshold)
    assert np.all(np.abs(res_j[flips] - threshold) < USM_FLIP)
    near = ndimage.maximum_filter(flips.any(-1), size=k)[..., None]
    d = np.abs(got - want)
    assert d[~np.broadcast_to(near, d.shape)].max(initial=0) <= FLOAT_ATOL
    assert d.max() <= USM_NEAR


@pytest.mark.parametrize("seed", SEEDS)
def test_usm_and_color_jitter_match_grlir(seed):
    rng = np.random.default_rng(seed)
    img = _smooth(rng, 64 + seed, 80)
    assert_usm_close(TB.usm_sharp(img), img)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    want, got = JB.color_jitter(img, r1), TB.color_jitter(img, r2)
    assert r1.bit_generator.state == r2.bit_generator.state
    np.testing.assert_allclose(got, want, atol=FLOAT_ATOL)


def test_isp_matches_grlir():
    """ISPModel over 8 draws of camera, tone curve and noise (resampled
    every 64 calls: the counter is advanced to cross a resample)."""
    rng = np.random.default_rng(5)
    jisp, tisp = JB.ISPModel(np.random.default_rng(9)), TB.ISPModel(np.random.default_rng(9))
    for i in range(8):
        img, hr = _smooth(rng, 32, 40), _smooth(rng, 32, 40)
        if i == 4:
            jisp.count = tisp.count = 64
        a, ah = jisp(img, hr)
        b, bh = tisp(img, hr)
        assert jisp.rng.bit_generator.state == tisp.rng.bit_generator.state
        np.testing.assert_allclose(b, a, atol=FLOAT_ATOL)
        np.testing.assert_allclose(bh, ah, atol=FLOAT_ATOL)


class JpegGate:
    """The gate of JPEG-terminated outputs (see JPEG_PSNR_DB): `check` each
    output, then `finish` the pooled share.  `finish` prints each output's
    PSNR, max difference (in 1/255) and share within 1/255 (`pytest -s`)."""

    def __init__(self):
        self.n = self.within = 0
        self.readings = []

    def check(self, got, want, what=""):
        assert got.shape == want.shape and got.dtype == want.dtype, what
        d = np.abs(got.astype(np.float64) - want)
        mse = max((d ** 2).mean(), 1e-20)
        within = int((d <= 1 / 255 + 1e-6).sum())
        self.readings.append((what, 10 * np.log10(1 / mse), d.max() * 255, within / d.size))
        assert 10 * np.log10(1 / mse) >= JPEG_PSNR_DB, (what, mse)
        assert d.max() <= MAX_DIFF + 1e-6, (what, d.max() * 255)
        self.n += d.size
        self.within += within

    def finish(self):
        for what, db, top, share in self.readings:
            print(f"JPEG gate {what}: PSNR {db:.2f} dB, max {top:.2f}/255, "
                  f"within 1/255 {100 * share:.3f}%")
        print(f"JPEG gate pooled: {self.within} of {self.n} values within 1/255 "
              f"({100 * self.within / self.n:.3f}%)")
        assert self.within >= WITHIN_1_SHARE * self.n, self.within / self.n


def test_degradation_sr2_matches_grlir():
    """Eight seeds: the generators' states after the call, the HR output
    (ISP colour only) within FLOAT_ATOL, the LQ through the JPEG gate."""
    gate = JpegGate()
    for seed in SEEDS:
        img = _smooth(np.random.default_rng(100 + seed), 96, 112)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        isp1 = JB.ISPModel(np.random.default_rng(50 + seed))
        isp2 = TB.ISPModel(np.random.default_rng(50 + seed))
        lq1, hr1 = JB.degradation_sr2(img.copy(), 4, isp1, r1)
        lq2, hr2 = TB.degradation_sr2(img.copy(), 4, isp2, r2)
        assert r1.bit_generator.state == r2.bit_generator.state
        assert isp1.rng.bit_generator.state == isp2.rng.bit_generator.state
        gate.check(lq2, lq1, f"lq {seed}")
        np.testing.assert_allclose(hr2, hr1, atol=FLOAT_ATOL)
    gate.finish()


@pytest.fixture
def bsr_root(tmp_path, monkeypatch):
    """OST train images (two of them under 400 pixels, so the reflect
    padding runs) and a RealSR-named val set, written by the port."""
    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    items = []
    (root / "OST" / "train").mkdir(parents=True)
    (root / "test_set" / "RealSRSetPlus5images").mkdir(parents=True)
    for i, (h, w) in enumerate([(420, 410), (300, 430), (120, 96)]):
        imwrite(str(root / "OST" / "train" / f"{i}.png"),
                (_smooth(rng, h, w) * 255).round().astype(np.uint8))
        items.append({"path": f"train/{i}.png"})
    val = []
    for i in range(2):
        imwrite(str(root / "test_set" / "RealSRSetPlus5images" / f"r{i}.png"),
                (_smooth(rng, 64, 72) * 255).round().astype(np.uint8))
        val.append({"path": f"RealSRSetPlus5images/r{i}.png"})
    for name, entries in (("OST/train.json", items),
                          ("RealSRSetPlus5images/test.json", val)):
        path = root / "image_info" / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(entries))
    monkeypatch.setenv("GRLIR_DATA_ROOT", str(root))
    monkeypatch.setenv("GRLIR_CACHE_DIR", str(tmp_path / "cache"))
    return root


def _pair(stage, **kw):
    cfg = dict(name="bsr", dataset="ost" if stage == TRAIN else "realsr", scale=4,
               patch_size=32, **kw)
    jds = JBSRDataset(JTaskConfig(**cfg, use_cache=False), stage)
    tds = TBSRDataset(TTaskConfig(**cfg), stage)
    return jds, tds


def test_bsr_dataset_items_match_grlir(bsr_root):
    """Train items (crop, augment, jitter, USM, degradation, patch) after
    per-worker reseeds, and the synthetic-pair and GT-free val items.  The
    USM'd target passes USM's threshold: where a mask pixel flips (see
    assert_usm_close) it may move by USM_NEAR."""
    gate = JpegGate()
    # the twelve reseeds the JPEG gate was set from: seeds 0 and 5 each
    # flip one block of their LQ patch, the others match bit for bit
    for seed in range(12):
        jds, tds = _pair(TRAIN)
        jds.seed(seed)
        tds.seed(seed)
        for i in range(len(tds.img_info)):
            a, b = jds[i], tds[i]
            assert jds.rng.bit_generator.state == tds.rng.bit_generator.state
            assert (jds.ispmodel.rng.bit_generator.state
                    == tds.ispmodel.rng.bit_generator.state)
            assert sorted(a) == sorted(b) and a["filenames"] == b["filenames"]
            assert b["img_lq"].shape == (32, 32, 3) and b["img_gt"].shape == (128, 128, 3)
            gate.check(b["img_lq"], a["img_lq"], f"train lq {seed} {i}")
            np.testing.assert_allclose(b["img_gt"], a["img_gt"], atol=FLOAT_ATOL)
            np.testing.assert_allclose(b["img_gt_usm"], a["img_gt_usm"], atol=USM_NEAR)
    for with_gt in (True, False):
        jds, tds = _pair(VAL, with_gt=with_gt)
        for i in range(2):
            a, b = jds[i], tds[i]
            assert sorted(a) == sorted(b)
            if with_gt:
                gate.check(b["img_lq"], a["img_lq"], f"val lq {i}")
            else:
                np.testing.assert_array_equal(b["img_lq"], a["img_lq"])
            np.testing.assert_allclose(b["img_gt"], a["img_gt"], atol=FLOAT_ATOL)
    gate.finish()
