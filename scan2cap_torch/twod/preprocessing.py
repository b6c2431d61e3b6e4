"""2D feature extraction (counterpart of ``scan2cap_tpu/twod/preprocessing.py``;
reference Scan2Cap-2D/preprocessing/model.py + utils.py).

Builds the feature store the 2D datasets read: a 2048-d global feature per
rendered viewpoint and 2052-d (feature + 4 normalized box coordinates) per
target and context box, one group of keys per sample
(``"{sample_id}/g_feat"``, ``/t_feat``, ``/c_feats``) and the file
attribute ``extractor_backend`` (``data/feature_store.py``).

``make_resnet_extractor`` takes its routes in the JAX package's order: a
torchvision ``.pth`` (``pth``, or ``$SCAN2CAP_RESNET_PTH``) through
``twod/resnet.py`` on ``device``; then ``transformers``' ResNet where it
imports and its weights load (on ``device``); else the random projection
of 8x8 patch means, with its warning and its backend tag, which keeps the
pipeline runnable where no weights exist and whose metrics mean nothing.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, List, Optional, Sequence

import numpy as np


def make_resnet_extractor(model_name: str = "microsoft/resnet-101",
                          pth: Optional[str] = None, device="cuda"):
    """fn(images (B, H, W, 3) float in [0, 1]) -> (B, 2048) numpy float32,
    carrying ``.backend`` ("resnet:pth", "resnet:<model>" or
    "random-projection-fallback"), which ``build_database`` records in the
    store."""
    pth = pth or os.environ.get("SCAN2CAP_RESNET_PTH")
    if pth:
        from scan2cap_torch.twod.resnet import make_pth_extractor
        return make_pth_extractor(pth, device=device)
    try:
        import torch
        from transformers import AutoModel

        from scan2cap_torch.device import resolve_device
        from scan2cap_torch.twod.resnet import MEAN, STD

        dev = resolve_device(device)
        # the local cache first (fails fast where the weights are not
        # cached), then a download unless the environment says offline
        try:
            model = AutoModel.from_pretrained(model_name,
                                              local_files_only=True)
        except Exception:
            if (os.environ.get("HF_HUB_OFFLINE")
                    or os.environ.get("TRANSFORMERS_OFFLINE")):
                raise
            model = AutoModel.from_pretrained(model_name)
        model = model.to(dev).eval()

        def extract(images: np.ndarray) -> np.ndarray:
            x = (images - MEAN) / STD
            x = torch.from_numpy(np.ascontiguousarray(
                np.transpose(x, (0, 3, 1, 2)), np.float32)).to(dev)
            with torch.no_grad():
                out = model(x).pooler_output  # (B, 2048, 1, 1)
            return out.reshape(len(images), -1).cpu().numpy()

        extract.backend = f"resnet:{model_name}"
        return extract
    except Exception:
        # a fixed random projection of 8x8 patch means: the pipeline runs
        # without pretrained weights, and its features carry no meaning
        print("[twod.preprocessing] WARNING: no pretrained ResNet available "
              "— using the random-projection fallback extractor; resulting "
              "2D baseline metrics are NOT meaningful", file=sys.stderr)
        rs = np.random.RandomState(0)
        proj = rs.randn(8 * 8 * 3, 2048).astype(np.float32) / np.sqrt(192)

        def extract(images: np.ndarray) -> np.ndarray:
            B, H, W, _ = images.shape
            ph, pw = H // 8, W // 8
            pooled = images[:, :ph * 8, :pw * 8].reshape(
                B, 8, ph, 8, pw, 3).mean((2, 4))
            return pooled.reshape(B, -1) @ proj

        extract.backend = "random-projection-fallback"
        return extract


def box_feature(crop_feat: np.ndarray, box: Sequence[float],
                width: int, height: int) -> np.ndarray:
    """2052-d: the 2048-d crop feature and the normalized (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = box
    coords = np.asarray([x1 / width, y1 / height, x2 / width, y2 / height],
                        np.float32)
    return np.concatenate([crop_feat.astype(np.float32), coords])


def crop_64(img: np.ndarray, box: Sequence[float]) -> np.ndarray:
    """The box's crop of ``img`` (H, W, 3), resized to 64 x 64 by nearest
    sampling.  The box is clamped into the image before slicing (a negative
    end would otherwise slice nearly the whole frame); a box that is empty
    or outside the image takes the whole frame."""
    x1, y1, x2, y2 = [int(v) for v in box]
    h, w = img.shape[:2]
    y1c, y2c = np.clip([y1, y2], 0, h)
    x1c, x2c = np.clip([x1, x2], 0, w)
    if y2c <= y1c or x2c <= x1c:
        crop = img
    else:
        crop = img[y1c:y2c, x1c:x2c]
    yy = (np.linspace(0, crop.shape[0] - 1, 64)).astype(int)
    xx = (np.linspace(0, crop.shape[1] - 1, 64)).astype(int)
    return crop[yy][:, xx]


def build_database(
    out_path: str,
    samples: Sequence[dict],
    load_image: Callable[[dict], np.ndarray],
    load_boxes: Callable[[dict], List[dict]],
    extractor: Optional[Callable] = None,
    width: int = 320,
    height: int = 240,
    device="cuda",
):
    """Write the feature store at ``out_path``.

    samples: ScanRefer-style entries; load_image(entry) -> (H, W, 3) float;
    load_boxes(entry) -> [{"box": (4,), "is_target": bool}, ...].  Without
    ``extractor``, ``make_resnet_extractor(device=device)``."""
    from scan2cap_torch.data.feature_store import FeatureStoreWriter
    from scan2cap_torch.twod.dataset import sample_id_of

    extract = extractor or make_resnet_extractor(device=device)
    written = set()
    with FeatureStoreWriter(out_path) as db:
        # which extractor produced these features is part of the artifact
        db.set_attr("extractor_backend", getattr(extract, "backend",
                                                 "custom"))
        for entry in samples:
            sid = sample_id_of(entry)
            if sid in written:
                continue
            img = load_image(entry)
            g_feat = extract(img[None])[0]
            t_feat = None
            c_feats = []
            for b in load_boxes(entry):
                feat = box_feature(extract(crop_64(img, b["box"])[None])[0],
                                   b["box"], width, height)
                if b.get("is_target"):
                    t_feat = feat
                else:
                    c_feats.append(feat)
            db[f"{sid}/g_feat"] = g_feat
            db[f"{sid}/t_feat"] = (t_feat if t_feat is not None
                                   else np.zeros(2052, np.float32))
            db[f"{sid}/c_feats"] = (np.stack(c_feats) if c_feats
                                    else np.zeros((0, 2052), np.float32))
            written.add(sid)
    return out_path
