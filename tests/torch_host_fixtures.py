"""The committed fixtures of the port's host_io phase
(`grlir_torch/assets/host_io/`, listed in `grlir_torch.host_io_cells`),
derived from cv2, PIL and grlir's orbax CheckpointManager.  Run

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_host_fixtures.py

to write them again; tests/test_torch_imageio_formats.py and
tests/test_torch_orbax.py derive them again and hold the committed files
to what they derive."""

import io
import os
import os.path as osp

import cv2
import numpy as np
from PIL import Image

from grlir_torch import host_io_cells as hc

HW = 256


def source_image() -> np.ndarray:
    """The 256^2 RGB image every format fixture encodes."""
    return hc._images(17, 1, (HW, HW))[0]


def encode(name: str, rgb: np.ndarray) -> bytes:
    """The bytes of one image fixture."""
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    buf = io.BytesIO()
    if name == "jpeg_baseline.jpg":
        return cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
    if name == "jpeg_progressive.jpg":
        return cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                          cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    if name == "jpeg_exif6.jpg":
        exif = Image.Exif()
        exif[0x0112] = 6
        Image.fromarray(rgb).save(buf, "JPEG", quality=90, exif=exif.tobytes())
    elif name == "bmp_palette8.bmp":
        Image.fromarray(rgb).quantize(256, dither=Image.Dither.NONE).save(buf, "BMP")
    elif name == "bmp_24.bmp":
        return cv2.imencode(".bmp", bgr)[1].tobytes()
    elif name == "tiff_lzw.tif":
        Image.fromarray(rgb).save(buf, "TIFF", compression="tiff_lzw",
                                  tiffinfo={317: 2})
    elif name == "ppm.ppm":
        return cv2.imencode(".ppm", bgr)[1].tobytes()
    else:
        raise KeyError(name)
    return buf.getvalue()


def cv2_rgb(path: str) -> np.ndarray:
    """grlir's colour read: cv2.imread converted to RGB."""
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def write_images(out: str) -> None:
    rgb = source_image()
    for name in hc.IMAGES:
        path = osp.join(out, name)
        with open(path, "wb") as f:
            f.write(encode(name, rgb))
        cv2.imwrite(path + ".png", cv2.cvtColor(cv2_rgb(path), cv2.COLOR_RGB2BGR))


def orbax_params():
    """The narrow GRL's flax params ({'params': ...}): the tree of grlir's
    model.init, values drawn from numpy (torch_parity.random_params)."""
    from dataclasses import replace

    from grlir.models import zoo
    from grlir.models.grl import GRL
    from torch_parity import random_params

    cfg = replace(zoo.make_config("tiny", task="sr", upscale=4), **hc.ORBAX_CONFIG)
    x = np.zeros((1, 16, 16, 3), np.float32)
    return random_params(GRL(cfg), np.random.default_rng(3), x)


def write_orbax(out: str) -> None:
    import optax
    from flax import serialization

    from grlir.engines.train import create_state
    from grlir.utils.checkpoint import CheckpointManager

    params = orbax_params()
    mgr = CheckpointManager(osp.join(out, hc.ORBAX_DIR))
    mgr.save(hc.ORBAX_STEP, create_state(params, optax.adamw(1e-4)), {"val_psnr": 0.0})
    mgr.close()
    with open(osp.join(out, hc.ORBAX_MSGPACK), "wb") as f:
        f.write(serialization.to_bytes(params))


if __name__ == "__main__":
    import jax
    import shutil

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(hc.ASSETS, exist_ok=True)
    shutil.rmtree(osp.join(hc.ASSETS, hc.ORBAX_DIR), ignore_errors=True)
    write_images(hc.ASSETS)
    write_orbax(hc.ASSETS)
