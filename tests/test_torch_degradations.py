"""The device-side validation degradations of grlir_torch (demosaicking and
kernel deblurring) against grlir's, on the CPU: the same numpy inputs
through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.data import degradations as JD
from grlir_torch.data import degradations as TD

ATOL = 1e-5    # fp32 convolutions summed in another order


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 12, 10, 4), (1, 7, 9, 4)])
def test_dm_matlab_matches_grlir(shape):
    cfa4 = _rand(1, *shape)
    want = np.asarray(JD.dm_matlab(jnp.asarray(cfa4)))
    got = TD.dm_matlab(torch.from_numpy(cfa4)).numpy()
    assert got.shape == want.shape == (shape[0], 2 * shape[1], 2 * shape[2], 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["gaussian", "real_1", "real_4", "real_8"])
def test_blur_kernel_matches_grlir(kind):
    np.testing.assert_array_equal(TD.get_blur_kernel(kind), JD.get_blur_kernel(kind))


@pytest.mark.parametrize("kind", ["gaussian", "real_1"])
@pytest.mark.parametrize("training", [False, True])
def test_db_forward_matches_grlir(kind, training):
    k = JD.get_blur_kernel(kind)
    gt = _rand(2, 2, 40, 36, 3)
    noise = (np.random.default_rng(3).standard_normal(gt.shape) * 0.01).astype(np.float32)
    want_lq, want_gt = JD.db_forward(jnp.asarray(noise), jnp.asarray(gt), k, training)
    got_lq, got_gt = TD.db_forward(torch.from_numpy(noise), torch.from_numpy(gt), k, training)
    assert got_lq.shape == want_lq.shape and got_gt.shape == want_gt.shape
    np.testing.assert_allclose(got_lq.numpy(), np.asarray(want_lq), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(want_gt))
    np.testing.assert_allclose(TD.apply_blur(torch.from_numpy(gt), k).numpy(),
                               np.asarray(JD.apply_blur(jnp.asarray(gt), k)),
                               rtol=0, atol=ATOL)
