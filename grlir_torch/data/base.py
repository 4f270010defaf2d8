"""Dataset registry, manifests, decode cache and base dataset (the port's
copy of `grlir.data.base`).

The same JSON-manifest corpus registry, virtual length, patch sampling and
dihedral augmentation as grlir, as plain __getitem__/__len__ objects
consumed by `grlir_torch.data.loader`.  Images are read by
`grlir_torch.utils.imageio` (PNG), and the decode cache is one `.npy` file
an image at the paths of grlir's LZF-HDF5 cache (h5py is not on the GPU
machine), written under a temporary name and moved into place.  The two
caches cannot share a directory.

The data root is $GRLIR_DATA_ROOT, the cache $GRLIR_CACHE_DIR.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import threading
from abc import ABC, abstractmethod
from typing import Dict, List, Tuple

import numpy as np

from grlir_torch.utils.image import modcrop
from grlir_torch.utils.imageio import imread

TRAIN = "train"
VAL = "val"


def data_root() -> str:
    return os.environ.get(
        "GRLIR_DATA_ROOT", osp.expanduser("~/projects/data/LightningIR")
    )


def data_dir() -> Dict[str, str]:
    root = data_root()
    home = osp.expanduser("~/")
    return {
        "CACHE": os.environ.get("GRLIR_CACHE_DIR",
                                osp.join(home, ".grlir/cache")),
        "JSON": osp.join(root, "image_info"),
        "TEST": osp.join(root, "test_set"),
        "DIV2K": osp.join(root, "DIV2K"),
        "Flickr2K": osp.join(root, "Flickr2K"),
        "LSDIR": osp.join(root, "LSDIR"),
        "OST": osp.join(root, "OST"),
        "SCUT-CTW1500": osp.join(root, "SCUT-CTW1500"),
        "FFHQ": osp.join(root, "FFHQ"),
        "BSD400": osp.join(root, "BSD400"),
        "WED": osp.join(root, "WED"),
        "imagenet": osp.join(root, "imagenet"),
        "GOPRO": osp.join(root, "GOPRO"),
        "DPDD": osp.join(root, "DPDD/dd_dp_dataset_png"),
        "HIDE": osp.join(root, "HIDE_dataset"),
        "RealBlur": osp.join(root, "RealBlur"),
    }


def load_json(path: str):
    with open(osp.join(data_dir()["JSON"], path), "r") as f:
        return json.load(f)


def load_img_info(dataset: str, dataset_dir: str, img_list) -> List[Tuple[str, ...]]:
    """Manifest entries -> [(rel_name, abs_path, ...)] keeping every *path* key
   : 1 pair for single-frame, 2/3 for paired/dual-pixel."""
    img_info = []
    for img in img_list:
        out = []
        for k, v in img.items():
            if "path" in k:
                out.append(osp.join(dataset, v))
                out.append(osp.join(dataset_dir, v))
        img_info.append(tuple(out))
    return img_info


def _suffix(scale: int) -> str:
    return f"_X{scale}" if scale else ""


def get_div2k(train: bool, scale: int = 0):
    split = "train" if train else "val"
    return load_img_info(
        "DIV2K", data_dir()["DIV2K"],
        load_json(f"DIV2K/{split}{_suffix(scale)}.json"),
    )


def get_flickr2k(scale: int = 0):
    return load_img_info(
        "Flickr2K", data_dir()["Flickr2K"],
        load_json(f"Flickr2K/train{_suffix(scale)}.json"),
    )


def get_lsdir(dataset: str, split: str = "train", scale: int = 0):
    """LSDIR with part/percent selection."""
    dataset = dataset.lower()
    key = "LSDIR"
    if "lsdir_x2" in dataset:
        key = "LSDIR_X2"
    elif "lsdir_x4" in dataset:
        key = "LSDIR_X4"
    img_list = load_json(f"LSDIR/{split}{_suffix(scale)}.json")
    if "part" in dataset:
        partition_key = f"part{dataset.split('part')[1][0]}_train"
        partition = load_json("LSDIR/train_image_partition.json")
        path_key = "path" if "path" in img_list[0] else "path_gt"
        img_list = [im for im in img_list if im[path_key] in partition[partition_key]]
    if "percent" in dataset:
        percent = float(dataset.split("percent")[1]) / 100.0
        img_list = img_list[: int(len(img_list) * percent)]
    return load_img_info("LSDIR", data_dir()[key.split("_")[0]], img_list)


def _simple_corpus(name: str, manifest: str):
    return load_img_info(name, data_dir()[name], load_json(manifest))


def get_ost():
    return _simple_corpus("OST", "OST/train.json")


def get_scut_ctw1500():
    return _simple_corpus("SCUT-CTW1500", "SCUT-CTW1500/train.json")


def get_ffhq():
    return _simple_corpus("FFHQ", "FFHQ/train.json")


def get_bsd400():
    return _simple_corpus("BSD400", "BSD400/train.json")


def get_wed():
    return _simple_corpus("WED", "WED/train.json")


def get_imagenet():
    return load_img_info("imagenet", data_dir()["imagenet"],
                         load_json("imagenet/train.json"))


def get_test_set(name: str):
    return load_img_info(name, data_dir()["TEST"],
                         load_json(f"{name}/test.json"))


# test-set display-name mapping
TEST_SET_MAPPING = {
    "set5": "Set5", "set14": "Set14", "b100": "B100", "urban100": "Urban100",
    "manga109": "Manga109",
    "set12": "Set12", "bsd68": "BSD68", "cbsd68": "CBSD68",
    "kodak24": "Kodak24", "mcmaster": "McMaster",
    "classic5": "Classic5", "live1": "LIVE1", "bsds500": "BSDS500",
    "icb_gray": "ICB_Gray", "icb_rgb": "ICB_RGB",
    "realsr": "RealSRSetPlus5images",
}


def get_train_file(dataset: str):
    """Shared train-corpus resolver."""
    dataset = dataset.lower()
    if dataset == "div2k" or "df2k" in dataset:
        info = get_div2k(True)
        if "df2k" in dataset:
            info += get_flickr2k()
        if "3550" in dataset:
            info += get_div2k(False)
        if dataset == "div2k_extended":
            info += get_flickr2k() + get_bsd400() + get_wed()
    elif "lsdir" in dataset:
        info = get_lsdir(dataset, "train")
        if "extended" in dataset:
            info += get_div2k(True) + get_flickr2k() + get_bsd400() + get_wed()
    elif "imagenet" in dataset:
        info = get_imagenet()
    elif dataset == "ost":
        info = get_ost()
    elif dataset == "scut_ctw1500":
        info = get_scut_ctw1500()
    elif dataset == "ffhq":
        info = get_ffhq()
    else:
        raise NotImplementedError(f"train dataset {dataset}")
    return info


def get_test_file(dataset: str):
    """Shared test-corpus resolver."""
    dataset = dataset.lower()
    if "div2k" in dataset:
        return get_div2k(False)
    if "lsdir" in dataset:
        return get_lsdir(dataset, "val" if "val" in dataset else "test")
    if dataset in TEST_SET_MAPPING:
        return get_test_set(TEST_SET_MAPPING[dataset])
    raise NotImplementedError(f"test dataset {dataset}")


class ImageBaseDataset(ABC):
    """Base dataset: decode cache + virtual length + augmentation + patch crops.

    Subclasses set `img_info` before calling super().__init__ and implement
    __getitem__ returning a dict with img_lq/img_gt (HWC float32), indices,
    filenames.
    """

    img_info: List[Tuple[str, ...]]

    def __init__(self, cfg, stage: str, num_train_samples: int = 0):
        self.cfg = cfg
        self.stage = stage
        self.num_train_samples = num_train_samples
        if num_train_samples != 0:
            self.train_size = len(self.img_info)
        self.use_cache = stage == TRAIN and bool(getattr(cfg, "use_cache", True))
        self.rng = np.random.default_rng(
            np.random.SeedSequence([abs(hash(stage)) % (2**31)])
        )

    def seed(self, seed: int):
        """Re-seed (per-epoch / per-worker)."""
        self.rng = np.random.default_rng(seed)

    def _get_index(self, index: int) -> int:
        if self.stage == TRAIN:
            if self.num_train_samples == 0:
                return index // self.cfg.num_patches
            return index % self.train_size
        return index

    def __len__(self) -> int:
        if self.stage == TRAIN:
            if self.num_train_samples == 0:
                return len(self.img_info) * self.cfg.num_patches
            return self.num_train_samples
        return len(self.img_info)

    @abstractmethod
    def __getitem__(self, index: int) -> dict:
        ...

    # -------------------------------------------------- io & cache

    def _imread(self, path: str) -> np.ndarray:
        jpeg_gray = (
            getattr(self.cfg, "quality_factor", None) is not None
            and str(getattr(self.cfg, "dataset", "")).lower()
            in ("live1", "bsds500", "urban100")
        )
        return imread(path, getattr(self.cfg, "num_channels", 3), jpeg_gray)

    def _cache_image(self, entry: Tuple[str, str]) -> np.ndarray:
        """The decoded image, from the .npy cache, written atomically on
        its first read (a temporary name per process and thread, then
        os.replace)."""
        name, path = entry[0], entry[1]
        if not self.use_cache:
            return self._imread(path)
        cache = osp.join(osp.expanduser(data_dir()["CACHE"]), name)
        if not osp.exists(cache):
            os.makedirs(osp.dirname(cache), exist_ok=True)
            image = self._imread(path)
            tmp = cache + f".cache_tmp{os.getpid()}_{threading.get_ident()}"
            with open(tmp, "wb") as f:
                np.save(f, image, allow_pickle=False)
            os.replace(tmp, cache)
        return np.load(cache, allow_pickle=False)

    def _load_item(self, index: int) -> np.ndarray:
        return self._cache_image(self.img_info[index])

    # -------------------------------------------------- sampling & augment

    def _augment(self, images):
        """Random dihedral flips/transpose at train time."""
        single = not isinstance(images, list)
        if single:
            images = [images]
        if self.stage == TRAIN:
            if self.rng.random() < 0.5:
                images = [x[::-1] for x in images]
            if self.rng.random() < 0.5:
                images = [x[:, ::-1] for x in images]
            if self.rng.random() < 0.5:
                images = [np.swapaxes(x, 0, 1) for x in images]
        return images[0] if single else images

    def _pad(self, imgs, patch, scale):
        h, w = imgs[0].shape[:2]
        if h < patch * scale or w < patch * scale:
            hp = max(0, patch * scale - h)
            wp = max(0, patch * scale - w)
            imgs = [np.pad(im, ((0, hp), (0, wp), (0, 0)), "constant") for im in imgs]
        return imgs

    def _sample_patch(self, imgs_H, imgs_L=None, scale: int = 1):
        """Paired/single random crop (train) or modcrop/modulo crop (val)."""
        patch = getattr(self, "patch_size", 0)
        if imgs_L is not None:
            lH = imgs_H if isinstance(imgs_H, (list, tuple)) else [imgs_H]
            lL = imgs_L if isinstance(imgs_L, (list, tuple)) else [imgs_L]
            if self.stage == TRAIN:
                lL = self._pad(lL, patch, 1)
                lH = self._pad(lH, patch, scale)
                h, w = lL[0].shape[:2]
                x = int(self.rng.integers(0, h - patch + 1))
                y = int(self.rng.integers(0, w - patch + 1))
                lL = [im[x: x + patch, y: y + patch] for im in lL]
                lH = [im[x * scale: (x + patch) * scale,
                         y * scale: (y + patch) * scale] for im in lH]
            else:
                lH = [modcrop(im, scale) for im in lH]
            out_H = lH[0] if len(lH) == 1 else lH
            out_L = lL[0] if len(lL) == 1 else lL
            return out_H, out_L

        lH = imgs_H if isinstance(imgs_H, list) else [imgs_H]
        if self.stage == TRAIN:
            lH = self._pad(lH, patch, 1)
            h, w = lH[0].shape[:2]
            x = int(self.rng.integers(0, h - patch + 1))
            y = int(self.rng.integers(0, w - patch + 1))
            lH = [im[x: x + patch, y: y + patch] for im in lH]
        else:
            modulo = getattr(self.cfg, "modulo", 8)
            h = lH[0].shape[0] // modulo * modulo
            w = lH[0].shape[1] // modulo * modulo
            lH = [im[:h, :w] for im in lH]
        return lH[0] if len(lH) == 1 else lH


def to_float(img_uint8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0,1] (torchvision to_tensor semantics,
    minus the CHW transpose — grlir stays HWC)."""
    return img_uint8.astype(np.float32) / 255.0
