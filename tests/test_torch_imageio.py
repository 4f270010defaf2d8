"""The port's PNG reader and writer (`grlir_torch.utils.imageio`) against
cv2, bit for bit: every colour type at 8 and 16 bits, all five row
filters, colour and gray reads; and `serve --device cpu` on a directory of
PNG files."""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from grlir.data.base import imread as jimread
from grlir_torch import serve
from grlir_torch.engines.inference import Restorer
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL, init_weights
from grlir_torch.utils.imageio import imread, imwrite
from torch_parity import one_torch_thread  # noqa: F401

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ftype, cur, prior, bpp):
    """PNG row filter `ftype` of the raw bytes `cur` (prior: the row above)."""
    out = bytearray(len(cur))
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][ftype]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _write_png(path, samples, ctype, depth, palette=None):
    """A PNG of (H, W, C) samples with row filter y % 5 on row y."""
    h, w, c = samples.shape
    dt = ">u2" if depth == 16 else np.uint8
    rows = samples.astype(dt).reshape(h, w * c)
    bpp = max(1, c * depth // 8)
    raw, prior = bytearray(), bytes(rows.shape[1] * rows.itemsize)
    for y in range(h):
        cur = rows[y].tobytes()
        raw += bytes([y % 5]) + _filter_row(y % 5, cur, prior, bpp)
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


CASES = [(ctype, depth) for ctype in (0, 2, 4, 6) for depth in (8, 16)] + [(3, 8)]


@pytest.mark.parametrize("ctype,depth", CASES)
def test_read_equals_cv2(tmp_path, ctype, depth):
    """Every colour type, 8 and 16 bits, rows through all five filters:
    colour and gray reads equal cv2's, and grlir's imread."""
    rng = np.random.default_rng(ctype * 100 + depth)
    h, w = 13, 17
    path = tmp_path / f"t{ctype}_{depth}.png"
    if ctype == 3:
        palette = rng.integers(0, 256, (256, 3))
        _write_png(path, rng.integers(0, 256, (h, w, 1)), 3, 8, palette)
    else:
        top = 65536 if depth == 16 else 256
        samples = rng.integers(0, top, (h, w, CHANNELS[ctype]))
        samples[0, :3] = samples[0, :1]      # gray-looking colour pixels too
        _write_png(path, samples, ctype, depth)
    got = imread(str(path))
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _cv2_rgb(path))
    gray = imread(str(path), num_channels=1)
    assert gray.shape == (h, w, 1)
    np.testing.assert_array_equal(gray[..., 0], cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(gray, jimread(str(path), 1))
    np.testing.assert_array_equal(imread(str(path), 1, jpeg_gray_y=True),
                                  jimread(str(path), 1, jpeg_gray_y=True))


@pytest.mark.parametrize("writer", ["cv2", "pil"])
def test_reads_files_of_other_writers(tmp_path, writer):
    """cv2's own PNG files (its adaptive filters, 8 and 16 bits, BGRA) and
    PIL's (gray + alpha, palette): colour and gray equal cv2's reads."""
    rng = np.random.default_rng(7)
    paths = []
    if writer == "cv2":
        for name, img in (("c8.png", rng.integers(0, 256, (31, 45, 3), np.uint8)),
                          ("c16.png", rng.integers(0, 65536, (20, 33, 3)).astype(np.uint16)),
                          ("a8.png", rng.integers(0, 256, (18, 22, 4), np.uint8)),
                          ("g8.png", rng.integers(0, 256, (19, 23), np.uint8)),
                          ("g16.png", rng.integers(0, 65536, (19, 23)).astype(np.uint16))):
            cv2.imwrite(str(tmp_path / name), img)
            paths.append(tmp_path / name)
    else:
        la = rng.integers(0, 256, (21, 30, 2), np.uint8)
        Image.fromarray(la, "LA").save(tmp_path / "la.png")
        p = Image.fromarray(rng.integers(0, 256, (21, 30), np.uint8), "P")
        p.putpalette(rng.integers(0, 256, 768, np.uint8).tolist())
        p.save(tmp_path / "p.png")
        paths += [tmp_path / "la.png", tmp_path / "p.png"]
    for path in paths:
        np.testing.assert_array_equal(imread(str(path)), _cv2_rgb(path), err_msg=str(path))
        np.testing.assert_array_equal(imread(str(path), 1)[..., 0],
                                      cv2.imread(str(path), cv2.IMREAD_GRAYSCALE),
                                      err_msg=str(path))


@pytest.mark.parametrize("shape", [(23, 31, 3), (23, 31, 1), (9, 14), (8, 6, 4)])
def test_written_png_reads_back_in_cv2(tmp_path, shape):
    img = np.random.default_rng(3).integers(0, 256, shape, np.uint8)
    path = str(tmp_path / "w.png")
    imwrite(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[-1] == 3:
        got = cv2.cvtColor(got, cv2.COLOR_BGR2RGB)
    elif img.ndim == 3 and img.shape[-1] == 4:
        got = cv2.cvtColor(got, cv2.COLOR_BGRA2RGBA)
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    np.testing.assert_array_equal(imread(path), _cv2_rgb(path))


def test_unsupported_formats_raise(tmp_path):
    """JPEG, BMP and Adam7 PNG are read now, bit-equal to cv2
    (tests/test_torch_imageio_formats.py covers every variant); a format
    the port has no reader for (WebP), a 4-bit PNG and writing anything
    but PNG raise."""
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    cv2.imwrite(str(tmp_path / "a.bmp"), img)
    for name in ("a.jpg", "a.bmp"):
        np.testing.assert_array_equal(imread(str(tmp_path / name)),
                                      _cv2_rgb(str(tmp_path / name)))
    _write_png(tmp_path / "i.png", img, 2, 8)       # set the IHDR's Adam7 flag
    data = bytearray((tmp_path / "i.png").read_bytes())
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    (tmp_path / "i.png").write_bytes(bytes(data))
    with pytest.raises(ValueError):             # rows written non-interlaced
        imread(str(tmp_path / "i.png"))
    cv2.imwrite(str(tmp_path / "a.webp"), img)
    with pytest.raises(NotImplementedError, match="not read"):
        imread(str(tmp_path / "a.webp"))
    _write_png(tmp_path / "d4.png", img[..., :1], 0, 8)     # claim 4-bit gray
    data = bytearray((tmp_path / "d4.png").read_bytes())
    data[24] = 4
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    (tmp_path / "d4.png").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="bit depth 4"):
        imread(str(tmp_path / "d4.png"))
    with pytest.raises(NotImplementedError, match="PNG only"):
        imwrite(str(tmp_path / "o.jpg"), img)


def test_serve_cpu_on_a_directory_of_pngs(tmp_path):
    """serve --device cpu reads a folder of PNG files with the port's reader
    and writes what the Restorer restores, read back by cv2."""
    model = init_weights(GRL(zoo.make_config("tiny", upscale=2)),
                         torch.Generator().manual_seed(2)).eval()
    ckpt = tmp_path / "m.pth"
    torch.save(model.state_dict(), ckpt)
    src, dst = tmp_path / "lr", tmp_path / "sr"
    src.mkdir()
    rng = np.random.default_rng(5)
    imgs = {"a.png": rng.integers(0, 256, (20, 28, 3), np.uint8),
            "b.png": rng.integers(0, 256, (16, 24, 3), np.uint8)}
    for name, im in imgs.items():
        imwrite(str(src / name), im)
    serve.main(["--input", str(src), "--output", str(dst), "--checkpoint", str(ckpt),
                "--model", "tiny", "--scale", "2", "--device", "cpu",
                "--shape-bucket", "16"])
    restorer = Restorer(model, "cpu", scale=2, shape_bucket=16)
    for name, im in imgs.items():
        want = serve.to_uint8(restorer(im[None].astype(np.float32) / 255.0)[0])
        np.testing.assert_array_equal(_cv2_rgb(dst / name), want)
        np.testing.assert_array_equal(imread(str(dst / name)), want)
