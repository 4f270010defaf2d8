"""grlir_torch's validation loop against grlir's, end to end on the CPU: the
same weights (tests/torch_parity.py's small GRL-S trunk) and the same numpy
validation sets through grlir's `validate` with its JAX `Restorer` and the
port's `validate` with the port's `Restorer`, for the tasks sr (shaved),
dn, dm, db and a GT-free blind SR set scored by NIQE, and LPIPS beside
PSNR on the sr set."""

import csv
import importlib

import numpy as np
import pytest

from grlir.data import degradations as JD
from grlir.engines.inference import Restorer as JRestorer
from grlir.metrics import lpips as JL
from grlir.utils.matlab import imresize
from grlir_torch.engines import validate as TV
from grlir_torch.engines.inference import Restorer
from torch_parity import model_pair

# grlir.engines re-exports the function `validate` under the module's name
JV = importlib.import_module("grlir.engines.validate")

DB_TOL = 1e-3     # dB: fp32 restorations a few 1e-6 apart, rounded to 1/255
UNIT_TOL = 1e-5   # SSIM
NIQE_TOL = 1e-3   # NIQE (unitless, ~5-20) of the same rounded restorations
LPIPS_TOL = 1e-5  # LPIPS (unitless, ~0.1-1) of the same rounded restorations
PRINT_TOL = 1e-4  # one unit of the 4 decimals the table and the CSV print
FULL = ("psnr", "psnr_y", "ssim", "ssim_y", "psnrb", "psnrb_y")


def _tol(name):
    return {"ssim": UNIT_TOL, "ssim_y": UNIT_TOL, "niqe": NIQE_TOL}.get(name, DB_TOL)


def _gt(seed, n, h, w):
    """n structured RGB images in [0, 1] on the 1/255 grid."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = 0.5 + 0.3 * np.sin(x / (5.0 + i)) * np.cos(y / (9.0 - i))
        img = base[..., None] + 0.04 * rng.standard_normal((h, w, 3))
        out.append(np.round(np.clip(img, 0, 1) * 255) / 255)
    return np.stack(out).astype(np.float32)


def _batches(lq, gt):
    """Two batches of 2, the second repeating the first's last index."""
    return [{"img_lq": lq[s], "img_gt": gt[s], "indices": np.array(i),
             "filenames": [f"img{j}.png" for j in i]}
            for s, i in ((slice(0, 2), [0, 1]), (slice(1, 3), [1, 2]))]


def _case(task):
    """(upsampler, scale, loader, metric names, blur kernel) of one task."""
    rng = np.random.default_rng(11)
    if task == "bsr":       # GT-free: a (1,)-shaped placeholder per sample
        gt = _gt(1, 3, 192, 192)
        lq = np.stack([imresize(g, 0.5) for g in gt])
        return "pixelshuffle", 2, _batches(lq, np.zeros((3, 1), np.float32)), ("niqe",), None
    gt = _gt(2, 3, 32, 32)
    if task == "sr":
        lq = np.stack([imresize(g, 0.5) for g in gt])
        return "pixelshuffle", 2, _batches(lq, gt), FULL, None
    if task == "dn":
        lq = gt + rng.normal(0, 15 / 255, gt.shape).astype(np.float32)
        return "", 1, _batches(lq, gt), FULL, None
    if task == "dm":         # packed RGGB mosaic of the target
        lq = np.stack([gt[:, 0::2, 0::2, 0], gt[:, 0::2, 1::2, 1],
                       gt[:, 1::2, 0::2, 1], gt[:, 1::2, 1::2, 2]], -1)
        return "", 1, _batches(lq, gt), FULL, None
    noise = rng.normal(0, 2 / 255, gt.shape).astype(np.float32)
    return "", 1, _batches(noise, gt), FULL, JD.get_blur_kernel("gaussian")


def _numbers(line):
    return [float(c) for c in line.split("\t")[1:]]


def _assert_table_close(got, want, names):
    """The same layout, names and rows; numbers within their tolerance plus
    one printed unit."""
    g, w = got.splitlines(), want.splitlines()
    assert g[0] == w[0] and len(g) == len(w)
    for lg, lw in zip(g[1:], w[1:]):
        assert lg.split("\t")[0] == lw.split("\t")[0]
        for n, a, b in zip(names, _numbers(lg), _numbers(lw)):
            assert abs(a - b) <= _tol(n) + PRINT_TOL, (n, lg, lw)


@pytest.mark.parametrize("task", ["sr", "dn", "dm", "db", "bsr"])
def test_validate_matches_grlir(task, tmp_path):
    upsampler, scale, loader, names, kernel = _case(task)
    jmodel, params, tmodel, _ = model_pair(upsampler, scale, seed=20)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    want = JV.validate(JRestorer(jmodel.apply, params, scale=scale), loader, names,
                       task=task, scale=scale, blur_kernel=kernel, save_dir=str(jdir), step=7)
    got = TV.validate(Restorer(tmodel, "cpu", scale=scale), loader, names, task=task,
                      scale=scale, blur_kernel=kernel, save_dir=str(tdir), step=7)
    assert list(got) == list(want) == list(names)
    for n in names:
        assert np.isfinite(got[n])
        assert abs(got[n] - want[n]) <= _tol(n), (n, got[n], want[n])

    for f in ("per_image_metrics_7.txt", "per_image_metrics.txt"):
        _assert_table_close((tdir / f).read_text(), (jdir / f).read_text(), names)
    for sub in ("LQ", "HQ", "GT"):
        assert (sorted(p.name for p in (tdir / sub).iterdir())
                == sorted(p.name for p in (jdir / sub).iterdir()))

    for mod, d, res in ((JV, jdir, want), (TV, tdir, got)):
        mod.write_results_csv(str(d / "results.csv"), "run", task, res, 7)
        mod.write_results_csv(str(d / "results.csv"), "run", task, res, 8)
    rows = [list(csv.reader(open(d / "results.csv"))) for d in (tdir, jdir)]
    assert rows[0][0] == rows[1][0] == ["tag", "val_set", "step", *names]
    assert len(rows[0]) == len(rows[1]) == 3
    for rg, rw in zip(rows[0][1:], rows[1][1:]):
        assert rg[:3] == rw[:3]
        for n, a, b in zip(names, rg[3:], rw[3:]):
            assert abs(float(a) - float(b)) <= _tol(n) + PRINT_TOL


def test_validate_refuses_what_grlir_refuses(monkeypatch):
    """Reference metrics on a GT-free set, lpips without $GRLIR_LPIPS_NPZ
    (both packages raise naming it) and an unknown metric."""
    upsampler, scale, loader, _, _ = _case("bsr")
    jmodel, params, tmodel, _ = model_pair(upsampler, scale, seed=20)
    restorer = Restorer(tmodel, "cpu", scale=scale)
    with pytest.raises(ValueError, match="GT-free"):
        TV.validate(restorer, loader, ("psnr", "niqe"), task="bsr", scale=scale)
    _, _, loader, _, _ = _case("sr")
    monkeypatch.delenv("GRLIR_LPIPS_NPZ", raising=False)
    monkeypatch.setattr(JL, "_LPIPS_STATE", None)
    for mod, r in ((JV, JRestorer(jmodel.apply, params, scale=scale)), (TV, restorer)):
        with pytest.raises(RuntimeError, match="GRLIR_LPIPS_NPZ"):
            mod.validate(r, loader, ("lpips",), task="sr", scale=scale)
    with pytest.raises(ValueError, match="unknown validation metric"):
        TV.validate(restorer, loader, ("psnr_x",), task="sr", scale=scale)


def test_validate_lpips_matches_grlir(tmp_path, monkeypatch):
    """LPIPS (random VGG16 and calibration weights, one npz file for both
    packages through $GRLIR_LPIPS_NPZ) beside PSNR on the sr set."""
    rng = np.random.default_rng(3)
    params = {}
    cin = 3
    for name in JL.VGG16_NAMES:
        if name.startswith("conv"):
            cout = {"conv1": 64, "conv2": 128, "conv3": 256}.get(name[:5], 512)
            bound = 1 / np.sqrt(9 * cin)
            params[name] = {
                "kernel": rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
                "bias": rng.normal(0, 0.05, cout).astype(np.float32)}
            cin = cout
    for i, c in enumerate(JL.LPIPS_TAP_CH):
        params[f"lin{i}"] = rng.uniform(0, 1, c).astype(np.float32)
    path = tmp_path / "lpips.npz"
    JL.save_lpips_params({"params": params}, str(path))
    monkeypatch.setenv("GRLIR_LPIPS_NPZ", str(path))
    monkeypatch.setattr(JL, "_LPIPS_STATE", None)

    upsampler, scale, loader, _, _ = _case("sr")
    jmodel, jparams, tmodel, _ = model_pair(upsampler, scale, seed=20)
    names = ("psnr", "lpips")
    want = JV.validate(JRestorer(jmodel.apply, jparams, scale=scale), loader, names,
                       task="sr", scale=scale)
    got = TV.validate(Restorer(tmodel, "cpu", scale=scale), loader, names, task="sr",
                      scale=scale)
    assert list(got) == list(want) == list(names)
    assert np.isfinite(got["lpips"]) and got["lpips"] > 0
    assert abs(got["psnr"] - want["psnr"]) <= DB_TOL
    assert abs(got["lpips"] - want["lpips"]) <= LPIPS_TOL, (got, want)
