"""The committed fixture of the BSR ops check
(`grlir_torch/assets/bsr_ops/bsr_ops.npz`, see `grlir_torch.bsr_ops_cells`),
derived from cv2 and grlir's degradation_sr2.  Run

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_bsr_ops_fixtures.py

to write it again; tests/test_torch_cv2_exact.py derives it again and holds
the committed file to what it derives."""

import json
import os

import cv2
import numpy as np

from grlir.data import bsr_utils as JB
from grlir_torch import bsr_ops_cells as bc
from grlir_torch.data.degradations import _fspecial_gaussian
from grlir_torch.data.bsr_utils import shift_pixel


class Cv2Ops:
    """cv2's calls under cv2_ops' names."""

    @staticmethod
    def gaussian_blur(img, k):
        return cv2.GaussianBlur(img, (k, k), 0)

    @staticmethod
    def filter2d(img, kernel):
        k = np.ascontiguousarray(kernel, np.float64 if img.dtype == np.float64 else np.float32)
        return cv2.filter2D(img, -1, k, borderType=cv2.BORDER_REFLECT_101)

    @staticmethod
    def resize(img, dsize, interpolation):
        return cv2.resize(img, dsize, interpolation=interpolation)

    @staticmethod
    def rgb_to_hsv(img):
        return cv2.cvtColor(img, cv2.COLOR_RGB2HSV)

    @staticmethod
    def hsv_to_rgb(img):
        return cv2.cvtColor(img, cv2.COLOR_HSV2RGB)


def kernels() -> dict:
    """The cases' float32 kernels, flipped as the BSR data's _conv2_mirror
    passes them: isotropic Gaussians and the first downsample's shifted
    25x25 Gaussian."""
    def flip(k):
        return np.ascontiguousarray(k[::-1, ::-1], np.float32)
    shifted = shift_pixel(_fspecial_gaussian(25, 1.1), 4)
    return {"iso11": flip(_fspecial_gaussian(11, 1.6)), "iso7": flip(_fspecial_gaussian(7, 0.9)),
            "iso15": flip(_fspecial_gaussian(15, 2.3)), "shift25": flip(shifted / shifted.sum())}


def plain_draw_seed() -> int:
    """The first generator seed whose degradation_sr2 draw takes no
    anisotropic kernel and no multivariate noise (LAPACK's paths), and
    runs a resize and a blur."""
    for seed in range(1000):
        seen = set()

        def mark(name, f):
            def g(*a, **k):
                seen.add(name)
                return f(*a, **k)
            return g

        saved = {n: getattr(JB, n) for n in ("anisotropic_gaussian", "orth", "_cv2_resize",
                                             "_conv2_mirror")}
        for n, f in saved.items():
            setattr(JB, n, mark(n, f))
        try:
            bc.draw(JB.degradation_sr2, seed)
        finally:
            for n, f in saved.items():
                setattr(JB, n, f)
        if seen == {"_cv2_resize", "_conv2_mirror"}:
            return seed
    raise RuntimeError("no plain draw")


def derive() -> tuple:
    """The fixture's metadata and kernels, from cv2 and grlir."""
    ks = kernels()
    cases = {name: bc.digest(bc.run_case(name, Cv2Ops, ks)) for name in bc.CASES}
    seed = plain_draw_seed()
    lq, hr, state = bc.draw(JB.degradation_sr2, seed)
    meta = {"cases": cases,
            "draw": {"seed": seed, "lq": bc.digest(lq), "hr": bc.digest(hr),
                     "state": json.dumps(state, sort_keys=True)},
            "cv2": cv2.__version__, "ipp": cv2.ipp.getIppVersion()}
    return meta, ks


def main():
    meta, ks = derive()
    os.makedirs(os.path.dirname(bc.FIXTURE), exist_ok=True)
    np.savez(bc.FIXTURE, meta=np.array(json.dumps(meta, sort_keys=True)),
             **{f"kernel_{k}": v for k, v in ks.items()})
    print(f"wrote {bc.FIXTURE}: {len(meta['cases'])} cases, draw seed {meta['draw']['seed']}")


if __name__ == "__main__":
    main()
