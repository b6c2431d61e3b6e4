"""Per-frame ENet features:
``python -m scan2cap_torch.scripts.compute_multiview_features``
(counterpart of ``scripts/compute_multiview_features.py``).

Runs the ENet trunk (``models/enet.py``, eval mode, batch by batch on
``--device``, the card unless the caller asks for the CPU) over every frame
of ``<frames_root>/<scene_id>/color/`` (resized and centre-cropped to 328 x
256, ``data/frames.load_image``) and writes one (128, 32, 41) float32
``.npy`` per frame, channels first, under ``<out_root>/<scene_id>/``: the
input of ``project_multiview_features``.  ``--enet_pth`` converts the
reference's ``scannetv2_enet.pth`` (``convert.convert_enet_checkpoint``);
``--ckpt`` is a ``torch.save`` state dict of the port's ``ENetEncoder``;
with neither, the trunk has seeded random weights.  The last line is a JSON
object of counts and times.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--frames_root", type=str, required=True,
                   help="<root>/<scene_id>/color/<frame> layout")
    p.add_argument("--out_root", type=str, required=True)
    p.add_argument("--ckpt", type=str, default=None,
                   help="torch.save state dict of a trained ENetEncoder")
    p.add_argument("--enet_pth", type=str, default=None,
                   help="the reference's scannetv2_enet.pth")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def main(argv=None) -> int:
    import numpy as np
    import torch

    from scan2cap_torch.convert import convert_enet_checkpoint
    from scan2cap_torch.data.frames import load_image
    from scan2cap_torch.models.enet import ENetEncoder

    args = build_parser().parse_args(argv)
    model = ENetEncoder(device=args.device)
    if args.enet_pth:
        model.load_state_dict(convert_enet_checkpoint(args.enet_pth),
                              strict=True)
    elif args.ckpt:
        model.load_state_dict(torch.load(args.ckpt, map_location="cpu",
                                         weights_only=True), strict=True)
    device = model.device
    frames_done = 0
    load_s = save_s = 0.0
    enet_s = []                     # a batch's forward and copies, each
    t_all = time.perf_counter()
    for scene_id in sorted(os.listdir(args.frames_root)):
        color_dir = os.path.join(args.frames_root, scene_id, "color")
        if not os.path.isdir(color_dir):
            continue
        out_dir = os.path.join(args.out_root, scene_id)
        os.makedirs(out_dir, exist_ok=True)
        frames = sorted(os.listdir(color_dir))
        for i in range(0, len(frames), args.batch_size):
            chunk = frames[i:i + args.batch_size]
            t0 = time.perf_counter()
            imgs = np.stack([load_image(os.path.join(color_dir, f))
                             for f in chunk])               # (B, H, W, 3)
            x = torch.from_numpy(imgs).permute(0, 3, 1, 2).to(device)
            t1 = time.perf_counter()
            with torch.inference_mode():
                # the copy to the host waits for the forward
                feats = model(x).cpu().numpy()               # (B, 128, h, w)
            t2 = time.perf_counter()
            for f, feat in zip(chunk, feats):
                np.save(os.path.join(out_dir, os.path.splitext(f)[0]
                                     + ".npy"), feat)
            save_s += time.perf_counter() - t2
            load_s += t1 - t0
            enet_s.append(t2 - t1)
        frames_done += len(frames)
        print(f"{scene_id}: {len(frames)} frames", flush=True)
    print(json.dumps({"compute_multiview_features": {
        "frames": frames_done, "batches": len(enet_s),
        "batch_size": args.batch_size, "device": str(device),
        "load_s": load_s, "enet_s": sum(enet_s),
        "enet_s_per_batch": enet_s, "save_s": save_s,
        "total_s": time.perf_counter() - t_all}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
