"""The port's frame readers (``data/frames.py``) against the JAX scripts'
readers, on the CPU, byte for byte.

* ``load_image`` against ``scripts/compute_multiview_features.py``'s, on
  PNG and JPEG colour frames: ScanNet's 1296 x 968 colour to 328 x 256,
  640 x 480, small, odd and portrait frames (the crop then reaches past the
  image, and Pillow fills with zeros); grey, grey with alpha, RGBA and
  palette PNGs; PNGs whose rows use each of the five row filters.
* ``load_depth`` against ``scripts/project_multiview_features.py``'s, on
  16-bit and 8-bit depth: 640 x 480 to 41 x 32 and odd sizes.
* ``load_pose`` against the JAX script's.
* Without Pillow every frame reader stops with an error that names it.

Equality is exact.
"""

import importlib.util
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from scan2cap_torch.data import frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _smooth(rs, h, w, c):
    y, x = np.mgrid[:h, :w]
    base = (np.sin(x / 7.0) * 60 + np.cos(y / 5.0) * 60 + 128)[..., None]
    return np.clip(base + rs.randn(h, w, c) * 8, 0, 255).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_rgb_png(image, filters):
    """An 8-bit RGB PNG of ``image`` whose row r is filtered with
    ``filters[r % len(filters)]``: the encoder written out, byte by byte."""
    raw = image.reshape(image.shape[0], -1)
    out = bytearray()
    prev = [0] * raw.shape[1]
    for r, row in enumerate(raw.tolist()):
        kind = filters[r % len(filters)]
        line = []
        for i, x in enumerate(row):
            a = row[i - 3] if i >= 3 else 0
            b = prev[i]
            c = prev[i - 3] if i >= 3 else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            line.append((x - pred) % 256)
        out += bytes([kind] + line)
        prev = row

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    h, w = image.shape[:2]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


def _same_image(path):
    got = frames.load_image(str(path))
    want = _script("compute_multiview_features").load_image(str(path))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (256, 328, 3)
    np.testing.assert_array_equal(got, want)


COLOUR_SIZES = [(968, 1296), (480, 640), (256, 328), (64, 80), (65, 81),
                (81, 65), (300, 200)]


@pytest.mark.parametrize("size", COLOUR_SIZES)
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_load_image_matches_the_jax_script(tmp_path, fmt, size):
    h, w = size
    path = tmp_path / f"{h}x{w}.{fmt}"
    Image.fromarray(_smooth(np.random.RandomState(h * w), h, w, 3)).save(path)
    _same_image(path)


@pytest.mark.parametrize("size", [(97, 130), (33, 40)])
@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "P"])
def test_load_image_of_other_png_modes_matches_the_jax_script(tmp_path, mode,
                                                              size):
    h, w = size
    c = {"L": 1, "LA": 2, "RGBA": 4, "P": 3}[mode]
    img = _smooth(np.random.RandomState(h + c), h, w, c)
    pil = Image.fromarray(img[..., 0] if c == 1 else img,
                          "RGB" if mode == "P" else mode)
    if mode == "P":
        pil = pil.convert("P")
    path = tmp_path / f"{mode}.png"
    pil.save(path)
    _same_image(path)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
def test_load_image_of_every_row_filter_matches_the_jax_script(tmp_path,
                                                               filters):
    rs = np.random.RandomState(len(filters) * 7 + filters[0])
    path = tmp_path / "filtered.png"
    path.write_bytes(encode_rgb_png(rs.randint(0, 256, (17, 23, 3)).astype(
        np.uint8), filters))
    _same_image(path)


@pytest.mark.parametrize("size", [(480, 640), (32, 41), (33, 40), (97, 130)])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_load_depth_matches_the_jax_script(tmp_path, dtype, size):
    h, w = size
    rs = np.random.RandomState(h * w)
    top = 65536 if dtype == np.uint16 else 256
    path = tmp_path / f"{h}x{w}.png"
    Image.fromarray(rs.randint(0, top, (h, w)).astype(dtype)).save(path)
    got = frames.load_depth(str(path))
    want = _script("project_multiview_features").load_depth(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape == (32, 41)
    np.testing.assert_array_equal(got, want)


def test_load_pose_matches_the_jax_script(tmp_path):
    np.savetxt(tmp_path / "pose.txt", np.random.RandomState(5).randn(4, 4))
    np.testing.assert_array_equal(
        frames.load_pose(tmp_path / "pose.txt"),
        _script("project_multiview_features").load_pose(tmp_path / "pose.txt"))


@pytest.mark.parametrize("reader, name", [
    ("load_image", "a.png"), ("load_image", "a.jpg"), ("load_depth", "d.png")])
def test_without_pillow_the_frame_readers_stop_and_name_it(
        tmp_path, monkeypatch, reader, name):
    rs = np.random.RandomState(6)
    Image.fromarray(_smooth(rs, 64, 80, 3)).save(tmp_path / "a.jpg")
    Image.fromarray(_smooth(rs, 64, 80, 3)).save(tmp_path / "a.png")
    Image.fromarray(rs.randint(0, 4000, (32, 41)).astype(np.uint16)).save(
        tmp_path / "d.png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        getattr(frames, reader)(str(tmp_path / name))
