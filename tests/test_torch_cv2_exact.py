"""`grlir_torch.utils.cv2_ops` bit-equal to cv2 on float32 (filter2D,
GaussianBlur, the three resizes, both HSV conversions), the exact float32
FMA under them, and the port's degradation_sr2 equal to grlir's to the
bit: its LQ and HR and both generators' states, over test_torch_bsr's
seeds and over the five dataset draws on which the BSR data used to differ
(ROADMAP C11).

cv2 picks its code by CPU (IPP's kernels, OpenCV's AVX2 body): the models
in cv2_ops follow one dispatch, named in their docstring.  A failure prints
cv2's version, IPP's and the CPU's flags, so that a host with another
dispatch shows as such."""

import numpy as np
import pytest
import cv2

from grlir.data import bsr_utils as JB
from grlir.data.module import IRDataModule as JModule
from grlir_torch.data import bsr_utils as TB
from grlir_torch.data.module import IRDataModule as TModule
from grlir_torch.utils import cv2_ops as O
from test_torch_bsr import SEEDS, SIZES, _smooth
from test_torch_data import SEED, data_root  # noqa: F401  (fixture)

# abs(hash("train")) % 2**31 under PYTHONHASHSEED 4, 11, 15, 17 and 34: the
# stage generators of the BSR draws that used to fail
# test_torch_data.py::test_jpeg_and_bsr_raise
C11_STAGE_SEEDS = {4: 498174393, 11: 833564222, 15: 1676508475, 17: 1623378150,
                   34: 1798361025}
BSR_SIDES = (400, 291, 200, 100)       # the 400^2 crop and shrinks of it


def _dispatch() -> str:
    flags = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            words = next((line for line in f if line.startswith("flags")), "").split()
        flags = " ".join(w for w in ("avx2", "avx512f", "fma") if w in words) or "none of avx2/avx512f/fma"
    except OSError:
        pass
    return f"cv2 {cv2.__version__}, IPP {cv2.ipp.getIppVersion()}, CPU flags: {flags}"


def assert_bit_equal(got, want, what):
    want = np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        pytest.fail(f"{what}: {got.shape} {got.dtype} vs cv2 {want.shape} {want.dtype}")
    if not np.array_equal(got, want):
        d = np.abs(got.astype(np.float64) - want)
        pytest.fail(f"{what}: {100 * (got != want).mean():.3f} % of values unequal to cv2's, "
                    f"max |diff| {d.max():.3g}; {_dispatch()}")


def _round32(x) -> np.float32:
    """float32 nearest to a Fraction x, ties to even."""
    from fractions import Fraction
    lo = np.float32(float(x))
    if Fraction(float(lo)) > x:
        lo = np.nextafter(lo, np.float32(-np.inf))
    hi = np.nextafter(lo, np.float32(np.inf))
    dlo, dhi = x - Fraction(float(lo)), Fraction(float(hi)) - x
    if dlo != dhi:
        return lo if dlo < dhi else hi
    return lo if int(lo.view(np.uint32)) % 2 == 0 else hi


def test_fma32_rounds_once():
    """a*b + c lands in float64 on a float32 midpoint it is not at: one
    rounding goes down where two (float64, then float32) go up; random
    operands, and sums under float32's normal range, equal the exactly
    rounded value."""
    from fractions import Fraction
    a = np.float32(2.0 ** -12 * (1 + 2.0 ** -23))
    b = np.float32(2.0 ** -12 * (1 - 2.0 ** -23))
    c = np.float32(1 + 2.0 ** -23)
    twice = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert twice == np.float32(1 + 2.0 ** -22)
    assert O.fma32(a, b, c) == c
    assert O.fma32(-a, b, -c) == -c
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    x[:, :1000] *= np.float32(2.0 ** -70)             # products and sums near 2**-140
    got = O.fma32(x[0], x[1], x[2])
    for i in range(0, 4000, 7):
        want = _round32(Fraction(float(x[0, i])) * Fraction(float(x[1, i])) + Fraction(float(x[2, i])))
        assert got[i] == want, (i, x[:, i], got[i], want)


def _bsr_kernels(rng, sides):
    """filter2D kernels of the BSR degradation's kinds for each odd side:
    isotropic and anisotropic Gaussians (flipped, as its _conv2_mirror
    passes them) and a random one."""
    from grlir_torch.data.degradations import _fspecial_gaussian
    out = []
    for k in sides:
        aniso = TB.anisotropic_gaussian(k, rng.random() * np.pi, 6 * rng.random(), 6 * rng.random())
        rand = rng.random((k, k))
        for ker in (_fspecial_gaussian(k, 0.2 + 2.5 * rng.random()), aniso, rand / rand.sum()):
            out.append(np.ascontiguousarray(ker[::-1, ::-1]))
    return out


@pytest.mark.parametrize("cn", [1, 3])
def test_filter2d_bit_equal(cn):
    """Widths 56-71 (every residue of W*cn mod 8, so every length of the
    AVX2 body's tail), 3-11 taps on the direct path, 13-25 on the DFT."""
    rng = np.random.default_rng(cn)
    kernels = _bsr_kernels(rng, range(3, 26, 2))
    for w in range(56, 72):
        img = rng.random((9, w, cn) if cn == 3 else (9, w)).astype(np.float32)
        for ker in kernels:
            assert_bit_equal(O.filter2d(img, ker),
                             cv2.filter2D(img, -1, ker.astype(np.float32),
                                          borderType=cv2.BORDER_REFLECT_101),
                             f"filter2D {ker.shape} on {img.shape}")


def test_filter2d_bit_equal_at_bsr_sizes():
    """The direct path (7-11 taps) and the DFT (13-25) at the 400^2 crop
    and its shrinks, three channels and one; the ISP's float64 demosaic."""
    rng = np.random.default_rng(7)
    kernels = _bsr_kernels(rng, (7, 11, 13, 19, 25))
    for side in BSR_SIDES:
        img = rng.random((side, side, 3)).astype(np.float32)
        for k, ker in enumerate(kernels):
            x = img if k % 2 else img[..., k % 3].copy()
            assert_bit_equal(O.filter2d(x, ker),
                             cv2.filter2D(x, -1, ker.astype(np.float32),
                                          borderType=cv2.BORDER_REFLECT_101),
                             f"filter2D {ker.shape} on {x.shape}")
    cfa = np.clip(rng.random((400, 400)) + rng.normal(0, 0.05, (400, 400)), 0, 1)
    for ker in TB._malvar_kernels():
        ker = ker.astype(np.float64)
        assert_bit_equal(O.filter2d(cfa, ker),
                         cv2.filter2D(cfa, -1, ker, borderType=cv2.BORDER_REFLECT_101),
                         "float64 demosaic filter2D")


def test_gaussian_blur_bit_equal():
    """ksize 3-11 (test_torch_bsr's) and 51 (USM's) on its sizes, on widths
    of every residue mod 8, and at the USM's 400^2 crop and mask."""
    rng = np.random.default_rng(3)
    shapes = [s + (c,) for s in SIZES + [(12, w) for w in range(56, 64)] for c in (1, 3)]
    for shape in shapes:
        img = rng.random(shape).astype(np.float32)
        if shape[-1] == 1:
            img = img[..., 0]
        for k in (3, 5, 7, 9, 11, 51):
            assert_bit_equal(O.gaussian_blur(img, k), cv2.GaussianBlur(img, (k, k), 0),
                             f"GaussianBlur {k} on {img.shape}")
    img = _smooth(rng, 400, 400)
    mask = (np.abs(img - cv2.GaussianBlur(img, (51, 51), 0)) * 255 > 10).astype(np.float32)
    for x in (img, mask):
        assert_bit_equal(O.gaussian_blur(x, 51), cv2.GaussianBlur(x, (51, 51), 0),
                         "GaussianBlur 51 at 400^2")


@pytest.mark.parametrize("interp", [O.INTER_LINEAR, O.INTER_CUBIC, O.INTER_AREA])
def test_resize_bit_equal(interp):
    """400^2 to int(400/sf1) for sf1 in [1, 8) (the exact 2x shrink among
    them), enlargements (the second downsample up to the final size), and
    test_torch_bsr's sizes with their mixed scales."""
    rng = np.random.default_rng(interp)
    img = rng.random((400, 400, 3)).astype(np.float32)
    for sf1 in (1.03, 1.37, 1.9, 2.0, 2.6, 3.3, 4.0, 5.2, 7.9):
        side = int(400 / sf1)
        for x in (img, img[..., 1].copy()):
            assert_bit_equal(O.resize(x, (side, side), interp),
                             cv2.resize(x, (side, side), interpolation=interp),
                             f"resize {interp} {x.shape} -> {side}")
    small = rng.random((63, 63, 3)).astype(np.float32)
    for x, size in ((small, (100, 100)), (img, (560, 560)), (small, (100, 63))):
        assert_bit_equal(O.resize(x, size, interp), cv2.resize(x, size, interpolation=interp),
                         f"resize {interp} {x.shape} -> {size}")
    for h, w in SIZES:
        for c in (1, 3):
            x = rng.random((h, w, c) if c == 3 else (h, w)).astype(np.float32)
            for size in [(max(1, w // 2), max(1, h // 2)), (max(1, int(w / 1.37)), max(1, int(h / 2.9))),
                         (w * 2 + 3, h * 3 + 1), (int(w * 1.6) or 1, max(1, h // 3)),
                         (max(1, w // 4), h * 2), (w, h)]:
                assert_bit_equal(O.resize(x, size, interp), cv2.resize(x, size, interpolation=interp),
                                 f"resize {interp} {x.shape} -> {size}")


def test_hsv_bit_equal():
    """Both conversions on grays (s = 0), red hues either side of 0/360,
    and random colours, at widths of every residue mod 8 (the 8-lane body
    and its tail) and at 400^2."""
    rng = np.random.default_rng(5)
    for h, w in [(400, 400)] + [(5, w) for w in range(1, 17)]:
        img = rng.random((h, w, 3)).astype(np.float32)
        img[: h // 3 + 1] = img[: h // 3 + 1, :, :1]                          # grays
        red = img[h // 2:]
        red[..., 0] = np.maximum(red[..., 0], red[..., 1:].max(-1) + np.float32(0.05))
        red[..., 2] = red[..., 1] + rng.normal(0, 1e-3, red.shape[:2]).astype(np.float32)
        img = np.clip(img, 0, 1)
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        assert_bit_equal(O.rgb_to_hsv(img), hsv, f"RGB2HSV {img.shape}")
        if h == 400:
            assert (hsv[..., 0] > 359.9).any() and (hsv[..., 0] < 0.1).any()
        hsv[..., 0] = (hsv[..., 0] + 17.3) % 360.0
        assert_bit_equal(O.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
                         f"HSV2RGB {img.shape}")


def _assert_degradation_equal(a, b, what):
    (lq1, hr1, r1, i1), (lq2, hr2, r2, i2) = a, b
    assert r1 == r2, f"{what}: generator states differ"
    assert i1 == i2, f"{what}: ISP generator states differ"
    assert_bit_equal(lq2, lq1, f"{what} LQ")
    assert_bit_equal(hr2, hr1, f"{what} HR")


def test_degradation_sr2_bit_equal_to_grlir():
    """test_torch_bsr's eight seeds: LQ, HR and both generators' states."""
    for seed in SEEDS:
        img = _smooth(np.random.default_rng(100 + seed), 96, 112)
        out = []
        for B in (JB, TB):
            rng, isp = np.random.default_rng(seed), B.ISPModel(np.random.default_rng(50 + seed))
            lq, hr = B.degradation_sr2(img.copy(), 4, isp, rng)
            out.append((lq, hr, rng.bit_generator.state, isp.rng.bit_generator.state))
        _assert_degradation_equal(*out, f"seed {seed}")


@pytest.mark.parametrize("hash_seed", sorted(C11_STAGE_SEEDS))
def test_c11_draws_bit_equal_to_grlir(data_root, tmp_path, monkeypatch, hash_seed):  # noqa: F811
    """The BSR train items of test_jpeg_and_bsr_raise's first two batches
    under this hash seed's stage generator: every degradation_sr2 call's
    LQ, HR and generator states, and the items, equal grlir's."""
    monkeypatch.setenv("GRLIR_CACHE_DIR", str(tmp_path / "cache"))
    cfg = {"name": "bsr", "scale": 4, "patch_size": 8, "worker_mode": "thread",
           "train": {"dataset": "div2k"}}
    calls, items = {}, {}
    for side, module, B, c in (("grlir", JModule, JB, dict(cfg, use_cache=False)),
                               ("port", TModule, TB, cfg)):
        dm = module(c, seed=SEED)
        ds = dm.train_dataset
        ds.rng = np.random.default_rng(np.random.SeedSequence([C11_STAGE_SEEDS[hash_seed]]))
        loader = dm.train_loader(2, num_workers=1)
        loader.set_epoch(0)
        order = [i for batch in loader._index_batches()[:2] for i in batch]
        record = calls.setdefault(side, [])

        def traced(img, sf, isp, rng, _f=B.degradation_sr2, _record=record):
            lq, hr = _f(img, sf, isp, rng)
            _record.append((lq, hr, rng.bit_generator.state, isp.rng.bit_generator.state))
            return lq, hr

        monkeypatch.setattr(B, "degradation_sr2", traced)
        items[side] = [ds[i] for i in order]
    assert len(calls["port"]) == len(calls["grlir"]) == 4
    for k, (a, b) in enumerate(zip(calls["grlir"], calls["port"])):
        _assert_degradation_equal(a, b, f"hash seed {hash_seed} item {k}")
    for a, b in zip(items["grlir"], items["port"]):
        for key in ("img_lq", "img_gt", "img_gt_usm"):
            assert_bit_equal(b[key], a[key], f"hash seed {hash_seed} {key}")


def test_bsr_ops_fixture_matches_cv2_and_port():
    """The committed fixture of the card's check (grlir_torch.bsr_ops_cells)
    is what cv2 and grlir give now, and the port passes it here."""
    import json

    from grlir_torch import bsr_ops_cells as bc
    from torch_bsr_ops_fixtures import derive

    meta, kernels = bc.load()
    want_meta, want_kernels = derive()
    assert sorted(kernels) == sorted(want_kernels)
    for k, v in want_kernels.items():
        np.testing.assert_array_equal(kernels[k], v)
    assert json.dumps({k: meta[k] for k in ("cases", "draw")}, sort_keys=True) == \
        json.dumps({k: want_meta[k] for k in ("cases", "draw")}, sort_keys=True), \
        f"fixture written under cv2 {meta['cv2']}, IPP {meta['ipp']}; {_dispatch()}"
    bad = [r["name"] for r in bc.check() if not r["ok"]]
    assert not bad, f"{bad}; {_dispatch()}"
