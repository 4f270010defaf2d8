"""NIQE, the Natural Image Quality Evaluator (host-side numpy/scipy): the
port's copy of `grlir.metrics.niqe`.

MATLAB-equivalent: AGGD fits over a dense gamma grid, 7x7 Gaussian MSCN
normalization, 96x96 blocks at two scales (the downscale between them is
the MATLAB bicubic `imresize`), Mahalanobis distance to the pristine MVG
parameters of `grlir_torch/assets/niqe_pris_params.npz` (a byte copy of
grlir's asset).  Used GT-free, for blind SR validation.
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma

from grlir_torch.utils.matlab import imresize

ASSET = os.path.join(os.path.dirname(__file__), "..", "assets",
                     "niqe_pris_params.npz")

_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.square(gamma(2.0 / _GAM)) / (gamma(1.0 / _GAM) * gamma(3.0 / _GAM))


def estimate_aggd_param(block: np.ndarray):
    """AGGD parameter fit (niqe.py:340-369)."""
    block = block.flatten()
    left_std = np.sqrt(np.mean(block[block < 0] ** 2))
    right_std = np.sqrt(np.mean(block[block > 0] ** 2))
    gammahat = left_std / right_std
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block**2)
    rhatnorm = (rhat * (gammahat**3 + 1) * (gammahat + 1)) / (
        (gammahat**2 + 1) ** 2
    )
    pos = np.argmin((_R_GAM - rhatnorm) ** 2)
    alpha = _GAM[pos]
    beta_l = left_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    beta_r = right_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    return alpha, beta_l, beta_r


def compute_feature(block: np.ndarray):
    """18 AGGD features per block (niqe.py:372-398)."""
    feat = []
    alpha, beta_l, beta_r = estimate_aggd_param(block)
    feat.extend([alpha, (beta_l + beta_r) / 2])
    for shift in ([0, 1], [1, 0], [1, 1], [1, -1]):
        shifted = np.roll(block, shift, axis=(0, 1))
        alpha, beta_l, beta_r = estimate_aggd_param(block * shifted)
        mean = (beta_r - beta_l) * (gamma(2 / alpha) / gamma(1 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def niqe_core(img: np.ndarray, mu_pris, cov_pris, gaussian_window,
              block_size_h: int = 96, block_size_w: int = 96) -> float:
    """NIQE on a gray/Y image in [0,255] float (niqe.py:400-489)."""
    assert img.ndim == 2
    h, w = img.shape
    nbh = math.floor(h / block_size_h)
    nbw = math.floor(w / block_size_w)
    img = img[: nbh * block_size_h, : nbw * block_size_w]

    distparam = []
    for scale in (1, 2):
        mu = convolve(img, gaussian_window, mode="nearest")
        sigma = np.sqrt(np.abs(
            convolve(np.square(img), gaussian_window, mode="nearest")
            - np.square(mu)
        ))
        normalized = (img - mu) / (sigma + 1)

        feat = []
        for idx_w in range(nbw):
            for idx_h in range(nbh):
                block = normalized[
                    idx_h * block_size_h // scale: (idx_h + 1) * block_size_h // scale,
                    idx_w * block_size_w // scale: (idx_w + 1) * block_size_w // scale,
                ]
                feat.append(compute_feature(block))
        distparam.append(np.array(feat))

        if scale == 1:
            img = imresize(img / 255.0, scale=0.5, antialiasing=True) * 255.0

    distparam = np.concatenate(distparam, axis=1)
    mu_dist = np.nanmean(distparam, axis=0)
    no_nan = distparam[~np.isnan(distparam).any(axis=1)]
    cov_dist = np.cov(no_nan, rowvar=False)

    invcov = np.linalg.pinv((cov_pris + cov_dist) / 2)
    diff = np.ravel(mu_pris) - mu_dist  # asset stores mu as (1, 36)
    return float(np.sqrt(diff @ invcov @ diff))


def _rgb_to_y_255(img_rgb_255: np.ndarray) -> np.ndarray:
    """RGB [0,255] -> Y [0,255] float, no rounding (niqe.py:145-157 uses the
    BGR variant; coefficient order adjusted for RGB input)."""
    img = img_rgb_255.astype(np.float32) / 255.0
    y = img @ np.array([65.481, 128.553, 24.966], np.float32) + 16.0
    return y


def calculate_niqe(img_rgb: np.ndarray, crop_border: int = 0,
                   data_range: float = 1.0) -> float:
    """NIQE of an (H,W,3) RGB or (H,W)/(H,W,1) gray image.

    Accepts [0,1] floats (data_range=1.0, the engine's output scale) or
    [0,255].  Matches the reference entry (niqe.py:494-546) incl. the final
    MATLAB-compatibility round().
    """
    pris = np.load(ASSET)
    mu_pris = pris["mu_pris_param"]
    cov_pris = pris["cov_pris_param"]
    gw = pris["gaussian_window"]

    img = np.asarray(img_rgb, np.float32)
    if data_range == 1.0:
        img = img * 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = _rgb_to_y_255(img)
    img = np.squeeze(img)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = img.round()
    return niqe_core(img, mu_pris, cov_pris, gw)


def niqe_batch(preds_nhwc: np.ndarray, crop_border: int = 0) -> np.ndarray:
    """Per-image NIQE over an NHWC batch in [0,1] (metric-class semantics,
    niqe.py:549-582)."""
    return np.array([
        calculate_niqe(p, crop_border, data_range=1.0) for p in preds_nhwc
    ])
