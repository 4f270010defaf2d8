"""BSRGAN-style degradation synthesis and the camera ISP simulator, on the
host in numpy (the port's copy of `grlir.data.bsr_utils`).

`degradation_sr2` is the second-order degradation, `ISPModel` the
forward/reverse camera pipeline with the public camera profiles (copied
under grlir_torch/assets/cameraprofile/), `usm_sharp` the unsharp mask,
`color_jitter` torchvision's ColorJitter, with the DND/SIDD raw-noise
models and the colour science beside them.  Every draw comes from an
explicit np.random.Generator in grlir's order, so that one generator state
gives grlir's result; OpenCV's calls are `grlir_torch.utils.cv2_ops` and
`grlir_torch.utils.jpeg`.
"""

from __future__ import annotations

import math
import os.path as osp
from typing import Optional

import numpy as np
from scipy.interpolate import RectBivariateSpline, interp1d
from scipy.linalg import orth
from scipy.stats import multivariate_normal

from grlir_torch.data.degradations import _fspecial_gaussian
from grlir_torch.utils import cv2_ops
from grlir_torch.utils.jpeg import jpeg_float
from grlir_torch.utils.matlab import imresize

CAMERA_PROFILE_DIR = osp.join(osp.dirname(__file__), "..", "assets",
                              "cameraprofile")

# ------------------------------------------------------------------ USM

def usm_sharp(img: np.ndarray, weight: float = 0.5, radius: int = 50,
              threshold: int = 10) -> np.ndarray:
    """Unsharp masking with soft mask (utils_usm.py:34-60). img: HWC [0,1]."""
    if radius % 2 == 0:
        radius += 1
    blur = cv2_ops.gaussian_blur(img, radius)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = cv2_ops.gaussian_blur(mask, radius)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


# ------------------------------------------------------------------ kernels

def anisotropic_gaussian(ksize: int, theta: float, l1: float, l2: float):
    """Rotated anisotropic gaussian kernel (utils_sisr.py:39-74)."""
    v = np.array([math.cos(theta), math.sin(theta)])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    D = np.array([[l1, 0.0], [0.0, l2]])
    sigma = V @ D @ np.linalg.inv(V)

    center = ksize / 2.0 + 0.5
    yy, xx = np.mgrid[0:ksize, 0:ksize]
    coords = np.stack([xx - center + 1, yy - center + 1], -1)
    k = multivariate_normal.pdf(coords, mean=[0, 0], cov=sigma)
    return k / k.sum()


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True) -> np.ndarray:
    """Sub-pixel shift by (sf-1)/2 via bilinear resampling (utils_sisr.py:77-103)."""
    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    xv, yv = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    x1 = np.clip(xv + (shift if upper_left else -shift), 0, w - 1)
    y1 = np.clip(yv + (shift if upper_left else -shift), 0, h - 1)
    if x.ndim == 2:
        return RectBivariateSpline(yv, xv, x, kx=1, ky=1)(y1, x1)
    out = x.copy()
    for c in range(x.shape[-1]):
        out[:, :, c] = RectBivariateSpline(yv, xv, x[:, :, c], kx=1, ky=1)(y1, x1)
    return out


# ------------------------------------------------------------------ color science

_D50 = np.array([0.96422, 1.0, 0.82521])
_D65 = np.array([0.95047, 1.0, 1.08883])
_BRADFORD = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296],
])
_XYZ2SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])


def _bradford_adaptation(src=_D50, dst=_D65) -> np.ndarray:
    """Chromatic adaptation matrix (utils_color.py:77-110, Bradford)."""
    crd_s = _BRADFORD @ src
    crd_d = _BRADFORD @ dst
    gain = np.diag(crd_d / crd_s)
    return np.linalg.inv(_BRADFORD) @ gain @ _BRADFORD


def xyz2linearrgb_weight() -> np.ndarray:
    """XYZ(D50) -> linear sRGB(D65) (utils_color.py:25-41)."""
    return _XYZ2SRGB @ _bradford_adaptation()


def linear2gamma_srgb(x: np.ndarray, forward: bool = True) -> np.ndarray:
    """sRGB gamma curve incl. the reference's odd reverse formula
    (utils_color.py:170-180)."""
    x = x.copy()
    if forward:
        idx = x > 0.0031308
        x[idx] = 1.055 * np.power(x[idx], 1.0 / 2.4) - 0.055
        x[~idx] = 12.92 * x[~idx]
    else:
        idx = x > 0.04045
        x[~idx] = np.clip(x[~idx], 1e-8, None) / 12.92
        x[idx] = np.power((200.0 * x[idx] + 11.0) / 211.0, 2.4)
    return x


# ------------------------------------------------------------------ raw noise

def random_noise_levels_dnd(rng: np.random.Generator):
    """Log-log linear shot/read noise sampling, DND profile
    (utils_noise.py:60-74)."""
    log_shot = rng.uniform(math.log10(0.0001), math.log10(0.006))
    read = np.clip(rng.normal(0.0, 0.25), -1.5, 1.5)
    log_read = 2.275 * log_shot + 1.47 + read
    return 10**log_shot, 10**log_read


def random_noise_levels_sidd(rng: np.random.Generator):
    """SIDD profile (utils_noise.py:78-92)."""
    log_shot = rng.uniform(math.log10(0.0001), math.log10(0.010))
    read = np.clip(rng.normal(0.0, 0.25), -1.5, 1.5)
    log_read = 2.18 * log_shot + 1.20 + read
    return 10**log_shot, 10**log_read


def add_raw_noise(image: np.ndarray, shot: float, read: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Shot (signal-proportional) + read noise (utils_noise.py:95-103)."""
    variance = image * shot + read
    return image + rng.normal(0.0, 1.0, image.shape) * np.sqrt(variance)


# ------------------------------------------------------------------ demosaic (numpy)

def _malvar_kernels():
    kgrb = np.array([[0, 0, -1, 0, 0], [0, 0, 2, 0, 0], [-1, 2, 4, 2, -1],
                     [0, 0, 2, 0, 0], [0, 0, -1, 0, 0]], np.float32) / 8
    krbg0 = np.array([[0, 0, 0.5, 0, 0], [0, -1, 0, -1, 0], [-1, 4, 5, 4, -1],
                      [0, -1, 0, -1, 0], [0, 0, 0.5, 0, 0]], np.float32) / 8
    krbg1 = krbg0.T
    krbbr = np.array([[0, 0, -1.5, 0, 0], [0, 2, 0, 2, 0], [-1.5, 0, 6, 0, -1.5],
                      [0, 2, 0, 2, 0], [0, 0, -1.5, 0, 0]], np.float32) / 8
    return kgrb, krbg0, krbg1, krbbr


def _conv2_mirror(img: np.ndarray, k: np.ndarray, flip: bool = True):
    """``ndimage.convolve(img, k[..., None], mode="mirror")`` on HWC (or
    ``correlate`` on HW with ``flip=False``): grlir's cv2.filter2D with
    BORDER_REFLECT_101 on the flipped kernel, through `cv2_ops.filter2d`.
    Odd kernel sizes only."""
    return cv2_ops.filter2d(img, k[::-1, ::-1] if flip else k)


def demosaic_malvar(cfa: np.ndarray) -> np.ndarray:
    """RGGB CFA (H,W) -> RGB (H,W,3), MATLAB/Malvar (utils_isp.py:215-290)."""
    kgrb, krbg0, krbg1, krbbr = _malvar_kernels()
    conv = [_conv2_mirror(cfa, k, flip=False)
            for k in (kgrb, krbg0, krbg1, krbbr)]
    r = cfa.copy(); g = cfa.copy(); b = cfa.copy()
    g[0::2, 0::2] = conv[0][0::2, 0::2]
    g[1::2, 1::2] = conv[0][1::2, 1::2]
    r[0::2, 1::2] = conv[1][0::2, 1::2]
    r[1::2, 0::2] = conv[2][1::2, 0::2]
    r[1::2, 1::2] = conv[3][1::2, 1::2]
    b[0::2, 1::2] = conv[2][0::2, 1::2]
    b[1::2, 0::2] = conv[1][1::2, 0::2]
    b[0::2, 0::2] = conv[3][0::2, 0::2]
    return np.clip(np.stack([r, g, b], -1), 0, 1)


def mosaic_rggb(rgb: np.ndarray) -> np.ndarray:
    """RGB (H,W,3) -> RGGB CFA (H,W) (Demosaic.reverse, utils_isp.py:292-300)."""
    cfa = np.zeros(rgb.shape[:2], rgb.dtype)
    cfa[0::2, 0::2] = rgb[0::2, 0::2, 0]
    cfa[0::2, 1::2] = rgb[0::2, 1::2, 1]
    cfa[1::2, 0::2] = rgb[1::2, 0::2, 1]
    cfa[1::2, 1::2] = rgb[1::2, 1::2, 2]
    return np.clip(cfa, 0, 1)


# ------------------------------------------------------------------ ISP chain

class ISPNet:
    """Forward/reverse camera pipeline (utils_isp.py:407-454):
    demosaic <-> exposure <-> raw2XYZ <-> XYZ2linearRGB <-> tone-map <-> gamma,
    raw-domain noise injected on the reverse path."""

    DELTA = 1e-6

    def __init__(self, cam2xyz: np.ndarray, tone_x: np.ndarray,
                 tone_y: np.ndarray, exposure_offset: float = 0.0,
                 luts=None):
        self.m_raw2xyz = cam2xyz.astype(np.float64)
        self.m_raw2xyz_inv = np.linalg.inv(self.m_raw2xyz)
        self.m_xyz2rgb = xyz2linearrgb_weight()
        self.m_xyz2rgb_inv = np.linalg.inv(self.m_xyz2rgb)
        self.exposure = float(exposure_offset)

        if luts is not None:
            # precomputed (tone, tone_inv) pair — the LUTs are a pure
            # function of the tone curve, so ISPModel caches them per curve
            # index (the two 1e6-point cubic splines cost ~0.4 s per build)
            self.tone, self.tone_inv = luts
        else:
            xi = np.linspace(0, 1, int(1 / self.DELTA + 1))
            yi = interp1d(tone_x, tone_y, kind="cubic")(xi)
            self.tone = yi.astype(np.float32)
            self.tone_inv = interp1d(yi, xi,
                                     kind="cubic")(xi).astype(np.float32)

    def _lut(self, x, table):
        idx = np.round(np.clip(x, 0, 1) / self.DELTA).astype(np.int64)
        return np.clip(table[idx], 0, 1)

    def forward(self, x: np.ndarray, for_noisy: bool = True) -> np.ndarray:
        if for_noisy:
            x = demosaic_malvar(x)
        x = np.clip(x * 2**self.exposure, 0, 1)
        x = x @ self.m_raw2xyz.T
        x = x @ self.m_xyz2rgb.T
        x = self._lut(x, self.tone)
        return np.clip(linear2gamma_srgb(np.clip(x, 0, 1), True), 0, 1)

    def reverse(self, x: np.ndarray, for_noisy: bool = True,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
        x = np.clip(linear2gamma_srgb(np.clip(x, 0, 1), False), 0, 1)
        x = self._lut(x, self.tone_inv)
        x = x @ self.m_xyz2rgb_inv.T
        x = x @ self.m_raw2xyz_inv.T
        x = np.clip(x / 2**self.exposure, 0, 1)
        if for_noisy:
            x = mosaic_rggb(x)
            shot, read = random_noise_levels_dnd(rng or np.random.default_rng())
            x = np.clip(add_raw_noise(x, shot, read,
                                      rng or np.random.default_rng()), 0, 1)
        return x


CAMERA_TYPES = [
    "canon_eos_1d_mark_ii", "canon_eos_5d_mark_iii", "canon",
    "canon_eos_6d_v1", "huawei_p20", "huawei_p30", "huawei_v8",
    "nikon_d500", "nikon_d810", "nikon_d5600", "olympus_em1",
]
TONE_CURVE_IDXS = [0, 1, 2, 66, 126, 115, 127, 128, 132, 133, 74]


class ISPModel:
    """Random camera simulator: profile + tone curve resampled every 64 calls
    (utils_isp.py:457-547)."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        import scipy.io as spio

        self.rng = rng or np.random.default_rng()
        self._tone_curves = spio.loadmat(
            osp.join(CAMERA_PROFILE_DIR, "tonecurves.mat"), squeeze_me=True
        )["ToneCurves"]
        self.count = 0
        self.isp: Optional[ISPNet] = None
        self._lut_cache = {}

    def _resample(self):
        import scipy.io as spio

        cam = CAMERA_TYPES[self.rng.integers(len(CAMERA_TYPES))]
        profile = spio.loadmat(
            osp.join(CAMERA_PROFILE_DIR, cam + ".mat"), squeeze_me=True
        )
        ti = TONE_CURVE_IDXS[self.rng.integers(len(TONE_CURVE_IDXS))]
        tone = np.reshape(self._tone_curves[ti], (2, -1), "F")
        fm1 = np.asarray(profile["ForwardMatrix1"], np.float64).reshape(3, 3)
        fm2 = np.asarray(profile["ForwardMatrix2"], np.float64).reshape(3, 3)
        fw = self.rng.random()
        d = np.diag([1.2 + 1.2 * self.rng.random(), 1.0,
                     1.2 + 1.2 * self.rng.random()])
        cam2xyz = (fw * fm1 + (1 - fw) * fm2) @ d
        offset = 0.2 * self.rng.random() - 0.1
        self.isp = ISPNet(cam2xyz, tone[0], tone[1], offset,
                          luts=self._lut_cache.get(ti))
        self._lut_cache.setdefault(ti, (self.isp.tone, self.isp.tone_inv))

    def __call__(self, img: np.ndarray, hr: np.ndarray):
        """Round-trip both images through the camera; noise only on `img`."""
        if self.count % 64 == 0:
            self._resample()
        self.count += 1
        raw = self.isp.reverse(img, True, self.rng)
        img = self.isp.forward(raw, True)
        raw_hr = self.isp.reverse(hr, False)
        hr = self.isp.forward(raw_hr, False)
        return img.astype(np.float32), hr.astype(np.float32)


# ------------------------------------------------------------------ color jitter

def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05):
    """torchvision-equivalent ColorJitter on HWC float [0,1], the
    reference's T.ColorJitter(0.2, 0.2, 0.2, 0.05)."""
    def gray(x):
        return x @ np.array([0.2989, 0.587, 0.114], np.float32)

    ops = list(rng.permutation(4))
    for op in ops:
        if op == 0 and brightness:
            f = rng.uniform(1 - brightness, 1 + brightness)
            img = np.clip(img * f, 0, 1)
        elif op == 1 and contrast:
            f = rng.uniform(1 - contrast, 1 + contrast)
            mean = gray(img).mean()
            img = np.clip(img * f + (1 - f) * mean, 0, 1)
        elif op == 2 and saturation:
            f = rng.uniform(1 - saturation, 1 + saturation)
            g = gray(img)[..., None]
            img = np.clip(img * f + (1 - f) * g, 0, 1)
        elif op == 3 and hue:
            f = rng.uniform(-hue, hue)
            hsv = cv2_ops.rgb_to_hsv(img.astype(np.float32))
            hsv[..., 0] = (hsv[..., 0] + f * 360.0) % 360.0
            img = np.clip(cv2_ops.hsv_to_rgb(hsv), 0, 1)
    return img.astype(np.float32)


# ------------------------------------------------------------------ degradation

def _cv2_resize(img, w, h, rng):
    interp = int(rng.choice([1, 2, 3]))  # linear / cubic / area
    return cv2_ops.resize(img, (w, h), interp)


def degradation_sr2(img: np.ndarray, sf: int, ispmodel: Optional[ISPModel],
                    rng: np.random.Generator):
    """Second-order BSRGAN degradation.

    img: HWC float32 [0,1] (usually already USM-sharpened).  Returns
    (img_lq ~ HWC/sf, img_hr) where img_hr may be color-transformed by the
    camera pipeline.  Op order is a random permutation of 9 ops with the
    constraint idx(downsample1) < idx(downsample2).
    """
    hr = img.copy()

    if sf == 4 and rng.random() < 0.1:
        if rng.random() < 0.5:
            img = _cv2_resize(img, img.shape[1] // 2, img.shape[0] // 2, rng)
        else:
            img = imresize(img, 0.5)
        img = np.clip(img, 0, 1)
        sf = 2

    order = list(rng.permutation(9))
    i1, i6 = order.index(1), order.index(6)
    if i1 > i6:
        order[i1], order[i6] = order[i6], order[i1]

    wd2 = 4.0 + sf
    wd = 2.0 + 0.2 * sf
    a = b = None

    for op in order:
        if op == 0:  # blur 1
            if rng.random() < 0.5:
                k = anisotropic_gaussian(
                    ksize=2 * int(rng.integers(2, 12)) + 3,
                    theta=rng.random() * np.pi,
                    l1=wd2 * rng.random(),
                    l2=wd2 * rng.random(),
                )
            else:
                k = _fspecial_gaussian(2 * int(rng.integers(2, 12)) + 3,
                                       wd * rng.random())
            img = _conv2_mirror(img, k)
        elif op == 1:  # downsample 1 (captures reference dims for op 6)
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.5:
                sf1 = rng.uniform(1, 2 * sf)
                img = _cv2_resize(img, int(img.shape[1] / sf1),
                                  int(img.shape[0] / sf1), rng)
            else:
                k = _fspecial_gaussian(25, rng.uniform(0.1, 0.4 * sf))
                k = shift_pixel(k, sf)
                k = k / k.sum()
                img = _conv2_mirror(img, k)
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0, 1)
        elif op == 2:  # camera ISP noise (25%)
            if rng.random() > 0.75 and ispmodel is not None:
                img, hr = ispmodel(np.ascontiguousarray(img), hr)
        elif op == 3:  # gaussian noise (full / gray / multivariate)
            level = int(rng.integers(2, 26))
            r = rng.random()
            if r > 0.5:
                img = img + rng.normal(0, level / 255.0, img.shape).astype(np.float32)
            elif r < 0.4:
                img = img + rng.normal(
                    0, level / 255.0, (*img.shape[:2], 1)).astype(np.float32)
            else:
                L = 25 / 255.0
                D = np.diag(rng.random(3))
                U = orth(rng.random((3, 3)))
                conv = U.T @ D @ U
                img = img + rng.multivariate_normal(
                    [0, 0, 0], np.abs(L**2 * conv), img.shape[:2]
                ).astype(np.float32)
            img = np.clip(img, 0, 1)
        elif op == 4:  # JPEG (90%)
            if rng.random() < 0.9:
                img = jpeg_float(img, int(rng.integers(20, 96)))
        elif op == 5:  # blur 2
            k = _fspecial_gaussian(2 * int(rng.integers(2, 12)) + 3,
                                   wd * rng.random())
            img = _conv2_mirror(img, k)
        elif op == 6:  # downsample 2 to final size
            img = _cv2_resize(img, int(a / sf), int(b / sf), rng)
            img = np.clip(img, 0, 1)
        elif op == 7:  # speckle
            level = int(rng.integers(2, 25))
            if rng.random() > 0.5:
                img = np.clip(img, 0, 1)
                r = rng.random()
                if r > 0.6:
                    img = img + img * rng.normal(
                        0, level / 255.0, img.shape).astype(np.float32)
                elif r < 0.4:
                    img = img + img * rng.normal(
                        0, level / 255.0, (*img.shape[:2], 1)).astype(np.float32)
                else:
                    L = 25 / 255.0
                    D = np.diag(rng.random(3))
                    U = orth(rng.random((3, 3)))
                    conv = U.T @ D @ U
                    img = img + img * rng.multivariate_normal(
                        [0, 0, 0], np.abs(L**2 * conv), img.shape[:2]
                    ).astype(np.float32)
                img = np.clip(img, 0, 1)
        elif op == 8:  # poisson
            if rng.random() > 0.5:
                img = np.clip(img, 0, 1)
                vals = 10 ** (2 * rng.random() + 2.0)
                img = rng.poisson(img * vals).astype(np.float32) / vals
                img = np.clip(img, 0, 1)

    img = jpeg_float(img, int(rng.integers(20, 96)))  # final JPEG
    return img.astype(np.float32), hr.astype(np.float32)
