"""PSNR / SSIM / PSNR-B on NHWC batches (counterpart of
`grlir.metrics.basic`).

Per-image values, shape (B,), on the tensor's own device (the averaging
with exactly-once dedup is `grlir_torch.metrics.collect`'s); SSIM with the
6-decimal-rounded Gaussian window and a zero-padded SAME convolution;
PSNR-B with the 8-pixel blocking-effect factor of the restored image.
SSIM filters in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from grlir_torch.utils.image import depthwise_conv, rgb2ycbcr


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B,): -10 log10(mse)."""
    mse = torch.mean((pred - target) ** 2, dim=(1, 2, 3))
    return -10.0 * torch.log10(mse)


def _to_y(img: torch.Tensor, data_range: float) -> torch.Tensor:
    """RGB -> rounded Y; a 1-channel input passes through unchanged, so the
    *_y metrics are their plain variants on grayscale images."""
    if img.shape[-1] == 1:
        return img
    return rgb2ycbcr(img, data_range)


def psnr_y(pred, target, data_range: float = 1.0) -> torch.Tensor:
    return psnr(_to_y(pred, data_range), _to_y(target, data_range))


def _gaussian_taps(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The 1-D Gaussian of grlir's window, each tap rounded to 6 decimals
    before normalizing; the window is its outer product with itself."""
    k = np.array([round(math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2)), 6)
                  for x in range(window_size)])
    return k / k.sum()


def ssim(pred: torch.Tensor, target: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """(B, H, W, C) -> (B,), grlir's `ssim`, in pred's type.  The window's
    zero-padded SAME filter runs as its two 1-D passes, in float64: in
    float32 the variances E[x^2] - mu^2 of smooth regions cancel to a few
    1e-6 of SSIM, summed in another order than grlir's, and float64 keeps
    the filter's two passes within 1e-12 of the 2-D window."""
    dtype = pred.dtype
    pred, target = pred.double(), target.double()
    k = _gaussian_taps(window_size)
    r = window_size // 2

    def filt(t):
        return depthwise_conv(depthwise_conv(t, k[None, :], (0, r)), k[:, None], (r, 0))

    mu1, mu2 = filt(pred), filt(target)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(pred * pred) - mu1_sq
    sigma2_sq = filt(target * target) - mu2_sq
    sigma12 = filt(pred * target) - mu1_mu2

    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map, dim=(1, 2, 3)).to(dtype)


def ssim_y(pred, target, data_range: float = 1.0) -> torch.Tensor:
    return ssim(_to_y(pred, data_range), _to_y(target, data_range))


def _blocking_effect_factor(im: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) -> (B,), block size 8."""
    _, H, W, _ = im.shape
    block = 8
    hb = np.arange(7, W - 1, 8)
    vb = np.arange(7, H - 1, 8)
    hn = np.setdiff1d(np.arange(0, W - 1), hb)
    vn = np.setdiff1d(np.arange(0, H - 1), vb)

    def diff2(positions, dim):
        i = torch.as_tensor(positions, dtype=torch.long, device=im.device)
        d = im.index_select(dim, i) - im.index_select(dim, i + 1)
        return torch.sum(d ** 2, dim=(1, 2, 3))

    h_block, v_block = diff2(hb, 2), diff2(vb, 1)
    h_non, v_non = diff2(hn, 2), diff2(vn, 1)

    n_bh = H * (W // block - 1)
    n_bv = W * (H // block - 1)
    boundary = (h_block + v_block) / (n_bh + n_bv)
    n_nh = H * (W - 1) - n_bh
    n_nv = W * (H - 1) - n_bv
    nonboundary = (h_non + v_non) / (n_nh + n_nv)

    scaler = float(np.log2(block) / np.log2(min(H, W)))
    bef = scaler * (boundary - nonboundary)
    return torch.where(boundary <= nonboundary, torch.zeros_like(bef), bef)


def psnrb(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B,): the mean over channels of 10 log10(1 / (mse +
    bef)), bef the blocking-effect factor of the restored image (`pred`),
    as grlir's."""
    total = 0.0
    C = pred.shape[-1]
    for c in range(C):
        p = pred[..., c:c + 1]
        t = target[..., c:c + 1]
        mse = torch.mean((p - t) ** 2, dim=(1, 2, 3))
        bef = _blocking_effect_factor(p)
        total = total + 10.0 * torch.log10(1.0 / (mse + bef))
    return total / C


def psnrb_y(pred, target, data_range: float = 1.0) -> torch.Tensor:
    return psnrb(_to_y(pred, data_range), _to_y(target, data_range))
