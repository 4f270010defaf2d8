"""grlir_torch's metrics and imaging utilities against grlir's, on the CPU:
the same numpy images, on the 1/255 grid, through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.metrics import basic as JB
from grlir.utils import image as JI
from grlir_torch.metrics import basic as TB
from grlir_torch.utils import image as TI

DB_TOL = 1e-4      # PSNR, PSNR-Y, PSNR-B in dB: fp32 sums in another order
SSIM_TOL = 1e-5    # SSIM: the same

METRICS = [("psnr", DB_TOL), ("psnr_y", DB_TOL), ("psnrb", DB_TOL),
           ("psnrb_y", DB_TOL), ("ssim", SSIM_TOL), ("ssim_y", SSIM_TOL)]


def _pair(seed, shape):
    """A target on the 1/255 grid and a noisy restoration of it, also on
    the grid: (B, H, W, C) float32 each."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 256, shape).astype(np.float32) / 255
    noisy = target + rng.normal(0, 12 / 255, shape).astype(np.float32)
    pred = np.round(np.clip(noisy, 0, 1) * 255).astype(np.float32) / 255
    return pred, target


@pytest.mark.parametrize("hw", [(48, 40), (45, 37)])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name,tol", METRICS)
def test_metric_matches_grlir(name, tol, channels, hw):
    seed = 100 * [n for n, _ in METRICS].index(name) + 10 * channels + hw[0]
    pred, target = _pair(seed, (2, *hw, channels))
    want = np.asarray(getattr(JB, name)(jnp.asarray(pred), jnp.asarray(target)))
    got = getattr(TB, name)(torch.from_numpy(pred), torch.from_numpy(target))
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("only_y", [True, False])
def test_rgb2ycbcr_matches_grlir(only_y):
    img = np.random.default_rng(5).integers(0, 256, (2, 31, 27, 3)).astype(np.float32) / 255
    want = np.asarray(JI.rgb2ycbcr(jnp.asarray(img), only_y=only_y))
    got = TI.rgb2ycbcr(torch.from_numpy(img), only_y=only_y).numpy()
    np.testing.assert_array_equal(got, want)


def test_tensor_round_shave_modcrop_to_uint8_match_grlir():
    rng = np.random.default_rng(6)
    img = rng.uniform(-0.2, 1.2, (2, 21, 19, 3)).astype(np.float32)
    np.testing.assert_array_equal(TI.tensor_round(torch.from_numpy(img)).numpy(),
                                  np.asarray(JI.tensor_round(jnp.asarray(img))))
    np.testing.assert_array_equal(TI.shave(torch.from_numpy(img), 3).numpy(),
                                  np.asarray(JI.shave(jnp.asarray(img), 3)))
    np.testing.assert_array_equal(TI.modcrop(img[0], 4), JI.modcrop(img[0], 4))
    np.testing.assert_array_equal(TI.to_uint8(img), JI.to_uint8(img))


def test_ssim_of_an_image_with_itself_is_one():
    img = torch.from_numpy(_pair(7, (1, 40, 40, 3))[1])
    assert torch.allclose(TB.ssim(img, img), torch.ones(1), atol=1e-6)
