"""The port's training preprocessing against grlir's on the CPU: MixUp and
the progressive re-crop on the draws grlir makes (injected), the task
physics of dm, db and paired_dual, the MixUp start gate, and the
progressive stages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.data import degradations as JD
from grlir.engines import preprocess as JP
from grlir_torch.engines import preprocess as TP
from torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_mixup_matches_grlir_on_its_draws():
    rng = np.random.default_rng(0)
    lq = rng.random((4, 8, 8, 3)).astype(np.float32)
    gt = rng.random((4, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_lq, want_gt = JP.mixup(jnp.asarray(lq), jnp.asarray(gt), key)
    k1, k2 = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k1, 4))
    lam = np.asarray(jax.random.beta(k2, 1.2, 1.2, (4, 1, 1, 1)))
    got_lq, got_gt = TP.mixup(_t(lq), _t(gt), perm, lam.reshape(-1))
    np.testing.assert_allclose(got_lq.numpy(), want_lq, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_gt.numpy(), want_gt, atol=TOL, rtol=0)
    # the port's own draws: a permutation and Beta(1.2, 1.2) weights in (0, 1)
    perm, lam = TP.draw_mixup(np.random.default_rng(1), 64)
    assert sorted(perm) == list(range(64)) and lam.dtype == np.float32
    assert 0 < lam.min() and lam.max() < 1 and 0.35 < lam.mean() < 0.65


@pytest.mark.parametrize("scale", [1, 2])
def test_crop_matches_grlir_on_its_draws(scale):
    rng = np.random.default_rng(1)
    lq = rng.random((2, 20, 24, 3)).astype(np.float32)
    gt = rng.random((2, 20 * scale, 24 * scale, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = JP.random_crop_pair(jnp.asarray(lq), jnp.asarray(gt), 12, scale, key)
    kx, ky = jax.random.split(key)
    x0 = int(jax.random.randint(kx, (), 0, 20 - 12 + 1))
    y0 = int(jax.random.randint(ky, (), 0, 24 - 12 + 1))
    got = TP.crop_pair(_t(lq), _t(gt), 12, scale, x0, y0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x0, y0 = TP.draw_crop(np.random.default_rng(2), 20, 24, 12)
    assert 0 <= x0 <= 8 and 0 <= y0 <= 12


def _batch(task, rng):
    if task == "dm":
        gt = rng.random((2, 16, 16, 3)).astype(np.float32)
        lq = np.stack([gt[:, 0::2, 0::2, 0], gt[:, 0::2, 1::2, 1],
                       gt[:, 1::2, 0::2, 1], gt[:, 1::2, 1::2, 2]], -1)
        return {"img_lq": lq, "img_gt": gt}
    if task == "db":
        return {"img_lq": (rng.standard_normal((2, 40, 40, 3)) * 0.01).astype(np.float32),
                "img_gt": rng.random((2, 40, 40, 3)).astype(np.float32)}
    return {"img_lq_l": rng.random((2, 12, 12, 3)).astype(np.float32),
            "img_lq_r": rng.random((2, 12, 12, 3)).astype(np.float32),
            "img_gt": rng.random((2, 12, 12, 3)).astype(np.float32)}


@pytest.mark.parametrize("task", ["dm", "db", "paired_dual"])
def test_task_physics_match_grlir(task):
    batch = _batch(task, np.random.default_rng(4))
    kernel = JD.get_blur_kernel("gaussian") if task == "db" else None
    want = JP.make_train_preprocess(task, kernel)(
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    got = TP.make_train_preprocess(task, kernel)(
        {k: _t(v) for k, v in batch.items()}, np.random.default_rng(0), 0)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def test_mixup_start_gate_and_crop():
    """Before mixup_start_step the batch passes unmixed, as in grlir; from
    it on the port mixes with the draws of its numpy generator, after the
    progressive crop."""
    rng = np.random.default_rng(5)
    batch = {"img_lq": rng.random((4, 16, 16, 3)).astype(np.float32),
             "img_gt": rng.random((4, 32, 32, 3)).astype(np.float32)}
    jpre = JP.make_train_preprocess("sr", None, True, 2, mixup_start_step=5)
    tpre = TP.make_train_preprocess("sr", None, True, 2, crop_patch=8,
                                    mixup_start_step=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    for step in (0, 4):
        jl, jg = jpre(jb, jax.random.PRNGKey(step), jnp.asarray(step))
        np.testing.assert_array_equal(np.asarray(jl), batch["img_lq"])
        rng_t = np.random.default_rng(step)
        tl, tg = tpre(tb, rng_t, step)
        x0, y0 = TP.draw_crop(np.random.default_rng(step), 16, 16, 8)
        np.testing.assert_array_equal(tl.numpy(), batch["img_lq"][:, x0:x0 + 8, y0:y0 + 8])
        np.testing.assert_array_equal(tg.numpy(),
                                      batch["img_gt"][:, 2 * x0:2 * x0 + 16, 2 * y0:2 * y0 + 16])
    jl, _ = jpre(jb, jax.random.PRNGKey(1), jnp.asarray(5))
    assert not np.array_equal(np.asarray(jl), batch["img_lq"])
    draws = np.random.default_rng(9)
    x0, y0 = TP.draw_crop(draws, 16, 16, 8)
    perm, lam = TP.draw_mixup(draws, 4)
    want = TP.mixup(*TP.crop_pair(tb["img_lq"], tb["img_gt"], 8, 2, x0, y0), perm, lam)
    got = tpre(tb, np.random.default_rng(9), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_progressive_stage_matches_grlir():
    for steps in ([], [3], [2, 5, 9]):
        for s in range(12):
            assert TP.progressive_stage(s, steps) == JP.progressive_stage(s, steps)
