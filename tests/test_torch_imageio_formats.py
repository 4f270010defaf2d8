"""`grlir_torch.utils.imageio.imread` bit-equal to `grlir.data.base.imread`
(cv2.imread, converted to RGB) for every format and variant the port
reads, under each of grlir's three reads: colour, gray (IMREAD_GRAYSCALE,
which each codec converts its own way) and the Y channel of the colour
image (jpeg_gray_y).  Includes the JPEG traps (EXIF orientations, gray =
the Y plane, progressive refinement, h2v1 / h1v2 / h4v1 sampling, restart
markers, CMYK and YCCK), and holds the committed fixtures of the host_io
phase to what cv2 and PIL derive again."""

import functools
import io
import os.path as osp

import cv2
import numpy as np
import pytest
from PIL import Image

import torch_image_writers as W
from grlir.data.base import imread as grlir_imread
from grlir_torch import host_io_cells as hc
from grlir_torch.utils.imageio import imread
from torch_host_fixtures import cv2_rgb, encode, source_image

READS = {"color": (3, False), "gray": (1, False), "y": (1, True)}


def _smooth(rng, h, w, c=3):
    """Structured content with noise (JPEG-friendly, every value used)."""
    x = rng.random((h // 4 + 2, w // 4 + 2, c)) * 255
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC) + rng.normal(0, 12, (h, w, c))
    return np.clip(x, 0, 255).astype(np.uint8)


def _pil(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _exif(orientation):
    e = Image.Exif()
    e[0x0112] = orientation
    return e.tobytes()


def _jpeg_cases():
    rng = np.random.default_rng(1)
    img = _smooth(rng, 37, 53)
    bgr = img[..., ::-1]
    sf = {"h2v1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
          "h1v2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
          "h4v1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    cases = {f"q{q}": (".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, q]) for q in (10, 75, 95)}
    cases["progressive"] = (".jpg", bgr, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cases["restart3"] = (".jpg", bgr, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    cases["gray"] = (".jpg", bgr[..., 1], [])
    for name, f in sf.items():
        cases[name] = (".jpg", bgr, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, f])
        cases[name + "_progressive"] = (".jpg", bgr, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, f,
                                                      cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    out = {f"jpeg_{k}": cv2.imencode(ext, a, p)[1].tobytes() for k, (ext, a, p) in cases.items()}
    pil = Image.fromarray(img)
    out["jpeg_h1v1_pil"] = _pil(pil, "JPEG", quality=80, subsampling=0)
    out["jpeg_progressive_pil"] = _pil(pil, "JPEG", quality=80, progressive=True)
    cmyk = _pil(pil.convert("CMYK"), "JPEG", quality=90)
    out["jpeg_cmyk"] = cmyk
    i = cmyk.find(b"Adobe") + 11            # the APP14 transform byte: 2 = YCCK
    out["jpeg_ycck"] = cmyk[:i] + b"\x02" + cmyk[i + 1:]
    small = Image.fromarray(_smooth(rng, 16, 32))
    for o in (1, 3, 6, 8):
        out[f"jpeg_exif{o}"] = _pil(small, "JPEG", exif=_exif(o))
    return out


def _bmp_cases():
    rng = np.random.default_rng(2)
    h, w = 21, 27
    out = {}
    for bits in (1, 4, 8):
        pal = rng.integers(0, 256, (1 << bits, 3))
        idx = rng.integers(0, 1 << bits, (h, w))
        out[f"bmp{bits}"] = W.bmp(idx, bits, pal)
        out[f"bmp{bits}_top_down"] = W.bmp(idx, bits, pal, top_down=True)
        out[f"bmp{bits}_short_palette"] = W.bmp(idx % 2, bits, pal[:2])
    px = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    px4 = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    v16 = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    out["bmp24"] = W.bmp(px, 24)
    out["bmp24_top_down"] = W.bmp(px, 24, top_down=True)
    out["bmp24_v5_header"] = W.bmp(px, 24, header=124)
    out["bmp32"] = W.bmp(px4, 32)
    out["bmp32_bitfields"] = W.bmp(px4, 32, comp=3, masks=(0xFF0000, 0xFF00, 0xFF))
    out["bmp16_555"] = W.bmp(v16 & 0x7FFF, 16)
    out["bmp16_565_bitfields"] = W.bmp(v16, 16, comp=3, masks=(0xF800, 0x7E0, 0x1F))
    idx = np.repeat(rng.integers(0, 256, (h, w // 3 + 1)), 3, axis=1)[:, :w]
    idx[:, 5:9] = rng.integers(0, 256, (h, 4))
    out["bmp_rle8"] = W.bmp(idx, 8, rng.integers(0, 256, (256, 3)), comp=1, rle=W.rle8(idx))
    idx4 = np.repeat(rng.integers(0, 16, (h, w // 4 + 1)), 4, axis=1)[:, :w]
    idx4[:, 3:10] = rng.integers(0, 16, (h, 7))
    out["bmp_rle4"] = W.bmp(idx4, 4, rng.integers(0, 256, (16, 3)), comp=2, rle=W.rle4(idx4))
    out["bmp_cv2"] = cv2.imencode(".bmp", px)[1].tobytes()
    out["bmp_pil_palette"] = _pil(Image.fromarray(px).quantize(64), "BMP")
    return out


def _tiff_cases():
    rng = np.random.default_rng(3)
    h, w = 21, 27

    def px(spp, bits):
        a = rng.integers(0, 1 << bits, (h, w, spp)).astype(np.uint8 if bits == 8 else np.uint16)
        return a[..., 0] if spp == 1 else a

    out = {
        "tiff_gray8_raw": W.tiff(px(1, 8), "<", 1),
        "tiff_gray16_lzw_be": W.tiff(px(1, 16), ">", 5, rps=4),
        "tiff_rgb8_lzw_be": W.tiff(px(3, 8), ">", 5, rps=4),
        "tiff_rgb8_lzw_predictor": W.tiff(px(3, 8), "<", 5, predictor=2),
        "tiff_rgb16_lzw_predictor_be": W.tiff(px(3, 16), ">", 5, predictor=2, rps=7),
        "tiff_rgb16_deflate": W.tiff(px(3, 16), "<", 8, rps=5),
        "tiff_rgb8_packbits_be": W.tiff(px(3, 8), ">", 32773, rps=3),
        "tiff_rgba8_unassociated": W.tiff(px(4, 8), "<", 1, extra=2),
        "tiff_rgba8_associated": W.tiff(px(4, 8), "<", 8, extra=1),
        "tiff_rgba8_unspecified": W.tiff(px(4, 8), ">", 1, extra=0),
        "tiff_rgba16_unassociated_lzw": W.tiff(px(4, 16), "<", 5, extra=2, rps=6),
        "tiff_rgb8_tiles_deflate": W.tiff(px(3, 8), "<", 8, tile=(16, 16)),
        "tiff_rgb8_tiles_lzw_be": W.tiff(px(3, 8), ">", 5, predictor=2, tile=(16, 16)),
        "tiff_cv2": cv2.imencode(".tif", px(3, 8))[1].tobytes(),
        "tiff_cv2_16": cv2.imencode(".tif", px(3, 16))[1].tobytes(),
    }
    rgb = Image.fromarray(px(3, 8))
    for c in ("raw", "tiff_lzw", "packbits", "tiff_deflate"):
        out[f"tiff_pil_{c}"] = _pil(rgb, "TIFF", compression=c)
    out["tiff_pil_rgba_lzw"] = _pil(Image.fromarray(px(4, 8)), "TIFF", compression="tiff_lzw")
    return out


def _pnm_cases():
    rng = np.random.default_rng(4)
    h, w = 13, 17
    out = {}
    for mv in (255, 100, 1000, 65535):
        g, c3 = rng.integers(0, mv + 1, (h, w)), rng.integers(0, mv + 1, (h, w, 3))
        dt = ">u2" if mv > 255 else "u1"
        for kind, a in (("P2", g), ("P3", c3)):
            head = f"{kind}\n# comment\n{w} {h}\n{mv}\n".encode()
            out[f"pnm_{kind}_{mv}"] = head + " ".join(map(str, a.ravel())).encode() + b"\n"
        for kind, a in (("P5", g), ("P6", c3)):
            out[f"pnm_{kind}_{mv}"] = f"{kind}\n{w} {h}\n{mv}\n".encode() + a.astype(dt).tobytes()
    return out


def _png_cases():
    rng = np.random.default_rng(5)
    out = {}
    for c in (1, 2, 3, 4):
        for bits in (8, 16):
            a = rng.integers(0, 1 << bits, (21, 27, c)).astype(np.uint8 if bits == 8 else np.uint16)
            out[f"png_adam7_c{c}_{bits}"] = W.png(a)
    for hw in ((1, 1), (3, 5), (8, 8)):
        out[f"png_adam7_{hw[0]}x{hw[1]}"] = W.png(rng.integers(0, 256, (*hw, 3)).astype(np.uint8))
    return out


@functools.lru_cache(maxsize=None)
def _cases():
    out = {}
    for build in (_jpeg_cases, _bmp_cases, _tiff_cases, _pnm_cases, _png_cases):
        out.update(build())
    return out


CASES = sorted(_cases())
EXT = {"jpeg": ".jpg", "bmp": ".bmp", "tiff": ".tif", "pnm": ".pnm", "png": ".png"}


@pytest.mark.parametrize("read", sorted(READS))
@pytest.mark.parametrize("case", CASES)
def test_imread_equals_grlir(case, read, tmp_path):
    path = str(tmp_path / ("f" + next(e for k, e in EXT.items() if case.startswith(k))))
    with open(path, "wb") as f:
        f.write(_cases()[case])
    nc, y = READS[read]
    want = grlir_imread(path, nc, y)
    got = imread(path, nc, y)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_dispatch_by_magic_not_extension(tmp_path):
    """A JPEG named .png and a BMP named .jpg read as cv2 reads them."""
    for case, name in (("jpeg_q75", "a.png"), ("bmp24", "b.jpg"), ("tiff_cv2", "c.bmp")):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(_cases()[case])
        np.testing.assert_array_equal(imread(path), grlir_imread(path))


def test_exif6_transposes():
    """A 16x32 JPEG with orientation 6 reads as 32x16, as cv2 reads it."""
    data = _cases()["jpeg_exif6"]
    assert Image.open(io.BytesIO(data)).size == (32, 16)


def test_gray_jpeg_read_is_the_y_plane(tmp_path):
    """cv2's gray read of a colour JPEG is libjpeg's Y plane, not the gray
    of its colour read: the two differ, and the port follows the first."""
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(_cases()["jpeg_q95"])
    gray = imread(path, 1)[..., 0].astype(int)
    of_color = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY).astype(int)
    assert np.abs(gray - of_color).max() > 0
    np.testing.assert_array_equal(gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("what,patch", [
    ("arithmetic", lambda d: d.replace(b"\xff\xc0", b"\xff\xc9", 1)),
    ("lossless", lambda d: d.replace(b"\xff\xc0", b"\xff\xc3", 1)),
    ("12-bit", lambda d: d[:d.find(b"\xff\xc0") + 4] + b"\x0c" + d[d.find(b"\xff\xc0") + 5:]),
])
def test_jpeg_refused_frames_raise(what, patch, tmp_path):
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(patch(_cases()["jpeg_q75"]))
    with pytest.raises(NotImplementedError):
        imread(path)


def test_jpeg_in_tiff_raises(tmp_path):
    path = str(tmp_path / "a.tif")
    with open(path, "wb") as f:
        f.write(_pil(Image.fromarray(_smooth(np.random.default_rng(6), 16, 16)), "TIFF",
                     compression="jpeg"))
    with pytest.raises(NotImplementedError, match="JPEG"):
        imread(path)


@pytest.mark.parametrize("name", sorted(hc.IMAGES))
def test_committed_fixtures_rederive(name, tmp_path):
    """Each committed fixture decodes (cv2) as the file cv2 / PIL write
    again from the source image decodes (bytes may differ: libtiff leaves a
    pad byte unset), its committed decoding is cv2's, and the port reads
    the fixture equal to it."""
    path = osp.join(hc.ASSETS, name)
    fresh = str(tmp_path / name)
    with open(fresh, "wb") as f:
        f.write(encode(name, source_image()))
    decoded = cv2_rgb(path)
    np.testing.assert_array_equal(cv2_rgb(fresh), decoded)
    np.testing.assert_array_equal(imread(path + ".png"), decoded)
    np.testing.assert_array_equal(imread(path), decoded)
