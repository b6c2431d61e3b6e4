"""RGB-D frames of a ScanNet scan: colour, depth and camera pose
(the readers of ``scripts/compute_multiview_features.py:33-51`` and
``scripts/project_multiview_features.py:36-44``).

Frames are decoded with Pillow, as the JAX scripts decode them, imported at
the call; without it the readers stop with an error that names it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# ScanNet's colour statistics (the reference's _load_image)
IMAGE_MEAN = np.array([0.496342, 0.466664, 0.440796], np.float32)
IMAGE_STD = np.array([0.277856, 0.28623, 0.291129], np.float32)


def _pillow_image():
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("reading RGB-D frames needs Pillow, which is not "
                           "installed") from None
    return Image


def load_image(path, size: Tuple[int, int] = (328, 256)) -> np.ndarray:
    """A colour frame -> (H, W, 3) float32 normalised with ScanNet's
    statistics: aspect-preserving NEAREST resize to the height of ``size``
    (width, height), then a centre crop to its width (the reference's
    _resize_crop_image / _load_image)."""
    Image = _pillow_image()
    with Image.open(path) as im:
        img = im.convert("RGB")
    w, h = img.size
    new_w, new_h = size
    if (w, h) != (new_w, new_h):
        resize_width = int(math.floor(new_h * float(w) / float(h)))
        img = img.resize((resize_width, new_h), Image.NEAREST)
        left = (resize_width - new_w) // 2
        img = img.crop((left, 0, left + new_w, new_h))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGE_MEAN) / IMAGE_STD


def load_depth(path, dims: Tuple[int, int] = (41, 32)) -> np.ndarray:
    """A depth PNG in millimetres -> (H, W) float32 metres, NEAREST-resized
    to ``dims`` (width, height)."""
    Image = _pillow_image()
    with Image.open(path) as im:
        img = im.resize(dims, Image.NEAREST)
    return np.asarray(img, np.float32) / 1000.0


def load_pose(path) -> np.ndarray:
    """A camera-to-world pose: 16 numbers in a text file -> (4, 4)."""
    return np.loadtxt(path).reshape(4, 4)
