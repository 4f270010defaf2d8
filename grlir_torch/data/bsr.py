"""Real-world (blind) SR dataset (the port's copy of `grlir.data.bsr`).

Train: 400-pixel crop (reflect-101 padding below and right of a smaller
image) -> dihedral augment -> ColorJitter -> USM sharpening -> second-order
BSRGAN degradation with a random camera ISP (host numpy,
`grlir_torch.data.bsr_utils`) -> aligned LR/HR patch, zero-padded to the
patch size where the LR is smaller.  Emits `img_gt_usm` for the GAN
engine's per-loss target choice.  Val: synthetic pairs (`with_gt`) or the
GT-free mode (img_lq is the real-world image, for NIQE).
"""

from __future__ import annotations

import numpy as np

from grlir_torch.data import bsr_utils as B
from grlir_torch.data.base import (TRAIN, ImageBaseDataset, get_test_file,
                                   get_train_file, to_float)
from grlir_torch.data.tasks import TaskConfig
from grlir_torch.utils.cv2_ops import copy_make_border_reflect101

CROP = 400      # GT crop before the degradation


def get_train_file_bsr(dataset: str):
    """BSR corpus resolver; 'all' = LSDIR-x4-extended + OST +
    SCUT-CTW1500[200:] + FFHQ."""
    dataset = dataset.lower()
    if dataset == "all":
        return (get_train_file("lsdir_x4_extended") + get_train_file("ost")
                + get_train_file("scut_ctw1500")[200:] + get_train_file("ffhq"))
    return get_train_file(dataset)


class BSRDataset(ImageBaseDataset):
    def __init__(self, cfg: TaskConfig, stage: str, num_train_samples: int = 0):
        self.sf = cfg.scale or 4
        if stage == TRAIN:
            self.patch_size = cfg.patch_size  # LR patch
            self.use_usm = True
            self.img_info = get_train_file_bsr(cfg.dataset)
        else:
            self.img_info = get_test_file(cfg.dataset)
        self.with_gt = cfg.with_gt
        super().__init__(cfg, stage, num_train_samples)
        self.ispmodel = B.ISPModel(rng=np.random.default_rng(12345))

    def seed(self, seed: int):
        """Per-worker reseed of the crop/augment generator and the ISP's
        (process workers start from one pickled state)."""
        super().seed(seed)
        self.ispmodel.rng = np.random.default_rng(seed + 1)
        self.ispmodel.count = 0
        self.ispmodel.isp = None

    def __getitem__(self, index: int):
        index = self._get_index(index)
        img_gt = self._augment(self._load_item(index))

        if self.stage == TRAIN:
            h, w = img_gt.shape[:2]
            if h < CROP or w < CROP:
                img_gt = copy_make_border_reflect101(
                    img_gt, 0, max(0, CROP - h), 0, max(0, CROP - w))
            h, w = img_gt.shape[:2]
            x = int(self.rng.integers(0, max(0, h - CROP) + 1))
            y = int(self.rng.integers(0, max(0, w - CROP) + 1))
            img_gt = img_gt[x: x + CROP, y: y + CROP]

            img_gt = B.color_jitter(to_float(img_gt), self.rng)
            img_gt_usm = B.usm_sharp(img_gt) if self.use_usm else img_gt
            img_lq, img_gt_usm = B.degradation_sr2(img_gt_usm, self.sf,
                                                   self.ispmodel, self.rng)
            (img_gt, img_gt_usm), img_lq = self._sample_patch(
                [img_gt, img_gt_usm], img_lq, self.sf)
            return {
                "indices": index,
                "img_lq": np.ascontiguousarray(img_lq),
                "img_gt": np.ascontiguousarray(img_gt),
                "img_gt_usm": np.ascontiguousarray(img_gt_usm),
                "filenames": self.img_info[index][0],
            }

        img_gt = to_float(img_gt)
        if self.with_gt:
            img_lq, img_gt = B.degradation_sr2(img_gt, self.sf, self.ispmodel,
                                               np.random.default_rng(index))
            return {
                "indices": index,
                "img_lq": np.ascontiguousarray(img_lq),
                "img_gt": np.ascontiguousarray(img_gt),
                "filenames": self.img_info[index][0],
            }
        # GT-free validation (NIQE): lq is the real-world image itself
        return {
            "indices": index,
            "img_lq": img_gt,
            "img_gt": np.zeros((1,), np.float32),
            "filenames": self.img_info[index][0],
        }
