"""Per-task datasets: dn / sr / jpeg / dm / db / paired (the port's copy
of `grlir.data.tasks`), on HWC float32 numpy.

Samples are dicts: indices, img_lq, img_gt, filenames (+ img_lq_l/r for
dual-pixel).  The draws and the deterministic validation noise are
grlir's, so one seed gives the same samples.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from grlir_torch.data import degradations as D
from grlir_torch.data.base import (
    TRAIN,
    VAL,
    ImageBaseDataset,
    data_dir,
    get_div2k,
    get_flickr2k,
    get_imagenet,
    get_lsdir,
    get_test_file,
    get_train_file,
    load_img_info,
    load_json,
    to_float,
)
from grlir_torch.utils import cv2_ops
from grlir_torch.utils.image import modcrop
from grlir_torch.utils.matlab import imresize


@dataclass
class TaskConfig:
    """Dataset knobs; mirrors the config/data_module/*.yaml group fields."""

    name: str = "sr"           # task name
    dataset: str = "div2k"
    num_channels: int = 3
    patch_size: int = 64       # HR patch for dn/jpeg/dm/db; LR patch for sr
    num_patches: int = 1       # virtual length multiplier
    scale: int = 1
    load_lr: bool = True
    use_usm: bool = False
    with_gt: bool = True       # bsr val: False -> GT-free (NIQE) validation
    modulo: int = 8
    use_cache: bool = True
    # dn / db
    noise_sigma: float = 0.0
    noise_sigma_range: Sequence[float] = field(default_factory=tuple)
    noise_level_map: bool = False
    kernel_type: str = "gaussian"
    # jpeg
    quality_factor: Optional[int] = None
    quality_factor_range: Sequence[int] = field(default_factory=tuple)
    patchwise: bool = False
    # paired
    dual_pixel: bool = False


class DnDataset(ImageBaseDataset):
    """Gaussian denoising."""

    def __init__(self, cfg: TaskConfig, stage: str, num_train_samples: int = 0):
        if stage == TRAIN:
            self.patch_size = cfg.patch_size
            self.img_info = get_train_file(cfg.dataset)
        else:
            self.img_info = get_test_file(cfg.dataset)
        super().__init__(cfg, stage, num_train_samples)

    def __getitem__(self, index: int):
        index = self._get_index(index)
        img_gt = self._load_item(index)
        img_gt = self._sample_patch(img_gt)
        img_gt = to_float(self._augment(img_gt))

        if self.stage == TRAIN:
            noise, sigma = D.train_noise(
                self.rng, img_gt.shape, self.cfg.noise_sigma,
                self.cfg.noise_sigma_range,
            )
        else:
            sigma = self.cfg.noise_sigma / 255.0
            noise = D.val_noise(self.img_info[index][0], img_gt.shape,
                                self.cfg.noise_sigma)
        img_lq = img_gt + noise
        if self.cfg.noise_level_map:
            img_lq = np.concatenate(
                [img_lq, D.noise_level_map(img_gt.shape[:2], sigma)], axis=-1
            )
        return {
            "indices": index,
            "img_lq": img_lq.astype(np.float32),
            "img_gt": img_gt,
            "filenames": self.img_info[index][0],
        }


class SRDataset(ImageBaseDataset):
    """Classical SR: paired _X{scale} manifests, or
    on-the-fly MATLAB-bicubic LR when load_lr is False."""

    def __init__(self, cfg: TaskConfig, stage: str, num_train_samples: int = 0):
        self.scale = cfg.scale
        self.load_lr = cfg.load_lr
        if stage == TRAIN:
            self.patch_size = cfg.patch_size  # LR patch size
            self.img_info = _sr_train_file(cfg.dataset, cfg.scale)
        else:
            self.img_info = _sr_test_file(cfg.dataset, cfg.scale)
        super().__init__(cfg, stage, num_train_samples)

    def _load_pair(self, index: int):
        if self.stage == VAL or self.load_lr:
            img_gt = self._cache_image(self.img_info[index][0:2])
            img_lq = self._cache_image(self.img_info[index][2:])
            return img_lq, img_gt
        img_gt = self._cache_image(self.img_info[index][0:2])
        img_gt = modcrop(img_gt, self.scale)
        h, w = img_gt.shape[:2]
        gt_patch = self.patch_size * self.scale
        # grlir enlarges an image smaller than the GT patch with cv2's
        # bilinear resize (in BGR order, which a per-channel resize does not
        # see), then makes the MATLAB-bicubic LR
        img_gt = cv2_ops.resize(img_gt, (max(w, gt_patch), max(h, gt_patch)))
        return imresize(img_gt / 255.0, 1 / self.scale), img_gt

    def __getitem__(self, index: int):
        index = self._get_index(index)
        img_lq, img_gt = self._load_pair(index)
        img_gt, img_lq = self._sample_patch(img_gt, img_lq, self.scale)
        img_lq, img_gt = self._augment([img_lq, img_gt])

        if self.stage == VAL and self.cfg.use_usm:
            from grlir_torch.data.bsr_utils import usm_sharp

            img_gt = (np.clip(usm_sharp(to_float(img_gt)), 0, 1)
                      * 255.0).round().astype(np.uint8)

        # float LR (on-the-fly path) stays float; uint8 scales by 255
        lq = img_lq.astype(np.float32) if img_lq.dtype != np.uint8 else to_float(img_lq)
        return {
            "indices": index,
            "img_lq": np.ascontiguousarray(lq),
            "img_gt": np.ascontiguousarray(to_float(img_gt)),
            "filenames": self.img_info[index][0],
        }


def _sr_train_file(dataset: str, scale: int):
    dataset = dataset.lower()
    if dataset == "div2k" or "df2k" in dataset:
        info = get_div2k(True, scale)
        if "df2k" in dataset:
            info += get_flickr2k(scale)
        if "3550" in dataset:
            info += get_div2k(False, scale)
    elif "lsdir" in dataset:
        info = get_lsdir(dataset, "train", scale)
        if "extended" in dataset:
            info += get_div2k(True, scale) + get_flickr2k(scale)
    elif "imagenet" in dataset:
        info = get_imagenet()
    else:
        raise NotImplementedError(f"SR train dataset {dataset}")
    return info


def _sr_test_file(dataset: str, scale: int):
    dataset = dataset.lower()
    mapping = {"set5": "Set5", "set14": "Set14", "bsd100": "B100", "b100": "B100",
               "urban100": "Urban100", "manga109": "Manga109"}
    if "div2k" in dataset:
        return get_div2k(False, scale)
    if "lsdir" in dataset:
        return get_lsdir(dataset, "val" if "val" in dataset else "test", scale)
    if dataset in mapping:
        name = mapping[dataset]
        return load_img_info(name, data_dir()["TEST"],
                             load_json(f"{name}/test_X{scale}.json"))
    raise NotImplementedError(f"SR test dataset {dataset}")


class JPEGDataset(ImageBaseDataset):
    """JPEG artifact removal: lq is gt's JPEG round trip at the configured
    quality factor, or in training one drawn from quality_factor_range;
    patchwise crops and augments before compressing, else after; with
    noise_level_map, lq gains a 1 - qf/100 channel."""

    def __init__(self, cfg: TaskConfig, stage: str, num_train_samples: int = 0):
        if stage == TRAIN:
            self.patch_size = cfg.patch_size
            self.img_info = get_train_file(cfg.dataset)
        else:
            self.img_info = get_test_file(cfg.dataset)
        super().__init__(cfg, stage, num_train_samples)

    def _compress(self, img_gt: np.ndarray):
        qf = self.cfg.quality_factor
        if self.stage == TRAIN and len(self.cfg.quality_factor_range) > 0:
            lo, hi = self.cfg.quality_factor_range
            qf = int(self.rng.integers(lo, hi + 1))
        return D.jpeg_compress(img_gt, qf), qf

    def __getitem__(self, index: int):
        index = self._get_index(index)
        img_gt = self._load_item(index)
        if self.stage == TRAIN and self.cfg.patchwise:
            img_gt = self._sample_patch(img_gt)
            img_gt = self._augment(img_gt)
            img_lq, qf = self._compress(img_gt)
        else:
            img_lq, qf = self._compress(img_gt)
            img_gt, img_lq = self._sample_patch(img_gt, img_lq)
            img_lq, img_gt = self._augment([img_lq, img_gt])

        img_lq = to_float(np.ascontiguousarray(img_lq))
        img_gt = to_float(np.ascontiguousarray(img_gt))
        if self.cfg.noise_level_map:
            img_lq = np.concatenate(
                [img_lq, D.noise_level_map(img_lq.shape[:2], 1 - qf / 100.0)], -1)
        return {
            "indices": index,
            "img_lq": img_lq,
            "img_gt": img_gt,
            "filenames": self.img_info[index][0],
        }


class DemosaicDataset(ImageBaseDataset):
    """Demosaicking: lq is the packed 4-channel CFA;
    the MATLAB-demosaic init runs on device in the engine preprocess."""

    def __init__(self, cfg: TaskConfig, stage: str, num_train_samples: int = 0):
        if stage == TRAIN:
            self.patch_size = cfg.patch_size
            self.img_info = get_train_file(cfg.dataset)
        else:
            self.img_info = get_test_file(cfg.dataset)
        super().__init__(cfg, stage, num_train_samples)

    def __getitem__(self, index: int):
        index = self._get_index(index)
        img_gt = self._load_item(index)
        img_gt = self._sample_patch(img_gt)
        img_gt = self._augment(img_gt)
        _, cfa4 = D.mosaic_cfa_bayer(np.ascontiguousarray(img_gt))
        return {
            "indices": index,
            "img_lq": to_float(cfa4),
            "img_gt": to_float(np.ascontiguousarray(img_gt)),
            "filenames": self.img_info[index][0],
        }


class DeblurDataset(ImageBaseDataset):
    """Kernel deblurring: lq carries ONLY the AWGN;
    blur(gt)+noise is synthesized on device.  Train
    patches are oversized by the kernel support."""

    def __init__(self, cfg: TaskConfig, stage: str, num_train_samples: int = 0):
        if stage == TRAIN:
            kernel = D.get_blur_kernel(cfg.kernel_type)
            self.patch_size = cfg.patch_size + kernel.shape[0] - 1
            self.img_info = get_train_file(cfg.dataset)
        else:
            self.img_info = get_test_file(cfg.dataset)
        self.noise_sigma = cfg.noise_sigma / 255.0
        super().__init__(cfg, stage, num_train_samples)

    def __getitem__(self, index: int):
        index = self._get_index(index)
        img_gt = self._load_item(index)
        img_gt = self._sample_patch(img_gt)
        img_gt = to_float(np.ascontiguousarray(self._augment(img_gt)))

        if self.stage != TRAIN:
            # the stream of np.random.seed(0) for every item, CHW order, as
            # grlir draws it (without touching numpy's global state)
            noise = np.random.RandomState(0).normal(
                0, self.noise_sigma, (img_gt.shape[2], *img_gt.shape[:2])
            ).transpose(1, 2, 0)
        else:
            noise = self.rng.normal(0, self.noise_sigma, img_gt.shape)
        return {
            "indices": index,
            "img_lq": noise.astype(np.float32),
            "img_gt": img_gt,
            "filenames": self.img_info[index][0],
        }


class PairedDataset(ImageBaseDataset):
    """Pre-captured LQ/GT pairs: GoPro/HIDE/RealBlur motion, DPDD defocus
   ."""

    def __init__(self, cfg: TaskConfig, stage: str, num_train_samples: int = 0):
        if stage == TRAIN:
            self.patch_size = cfg.patch_size
            self.img_info = _paired_train_file(cfg.dataset)
        else:
            self.img_info = _paired_test_file(cfg.dataset)
        self.dual_pixel = cfg.dual_pixel
        super().__init__(cfg, stage, num_train_samples)
        self.use_hdf5 = bool(getattr(cfg, "use_cache", True))

    def __getitem__(self, index: int):
        index = self._get_index(index)
        entry = self.img_info[index]
        img_gt = self._cache_image(entry[0:2])
        if self.dual_pixel:
            lq_l = self._cache_image(entry[2:4])
            lq_r = self._cache_image(entry[4:6])
            img_gt, (lq_l, lq_r) = self._sample_patch(img_gt, [lq_l, lq_r])
            lq_l, lq_r, img_gt = self._augment([lq_l, lq_r, img_gt])
            return {
                "indices": index,
                "img_lq_l": to_float(np.ascontiguousarray(lq_l)),
                "img_lq_r": to_float(np.ascontiguousarray(lq_r)),
                "img_gt": to_float(np.ascontiguousarray(img_gt)),
                "filenames": entry[0],
            }
        img_lq = self._cache_image(entry[2:4])
        img_gt, img_lq = self._sample_patch(img_gt, img_lq)
        img_lq, img_gt = self._augment([img_lq, img_gt])
        return {
            "indices": index,
            "img_lq": to_float(np.ascontiguousarray(img_lq)),
            "img_gt": to_float(np.ascontiguousarray(img_gt)),
            "filenames": entry[0],
        }


def _paired_json(dataset_key: str, filename: str):
    return load_img_info(dataset_key, data_dir()[dataset_key],
                         load_json(f"{dataset_key}/{filename}"))


def _paired_train_file(dataset: str):
    dataset = dataset.lower()
    if dataset == "gopro":
        return _paired_json("GOPRO", "train.json")
    if dataset in ("dpdd", "dpdd_dual"):
        f = "train_dual.json" if "dual" in dataset else "train.json"
        return _paired_json("DPDD", f)
    if "realblur" in dataset:
        return _paired_json("RealBlur", f"train_{dataset[-1]}.json")
    if dataset == "hide":
        return _paired_json("HIDE", "train.json")
    raise NotImplementedError(f"paired train dataset {dataset}")


def _paired_test_file(dataset: str):
    dataset = dataset.lower()
    if "realblur" in dataset:
        return _paired_json("RealBlur", f"test_{dataset[-1]}.json")
    if "hide" in dataset:
        return _paired_json("HIDE", "test.json")
    if dataset == "gopro":
        return _paired_json("GOPRO", "test.json")
    if "dpdd" in dataset:
        split = "test" if "test" in dataset else "val"
        f = f"{split}_dual.json" if "dual" in dataset else f"{split}.json"
        return _paired_json("DPDD", f)
    raise NotImplementedError(f"paired test dataset {dataset}")
