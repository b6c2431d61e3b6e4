"""Profile the host data pipeline at real-epoch scale:
``python -m scan2cap_torch.scripts.profile_host_pipeline`` (counterpart of
``scripts/profile_host_pipeline.py``).

Synthesizes a disk-resident, reference-format dataset (per-scene .npy
quadruples as written by batch_load_scannet_data.py, and the multiview
features as the port's store, ``enet_feats_maxpool.npz``: one
(scene_points, 128) float32 array per scene id; ``data/feature_store.py``)
and runs the port's ScannetReferenceDataset + Loader (thread pool + the
native C++ plane) over it in the canonical full config (multiview + normal
+ height, 40k-point samples, augmentation + vote labels), measuring the
steady-state producer throughput and, with --step_ms, the fetch-vs-step
occupancy against a simulated consumer.

The reference's equivalent is DataLoader(num_workers=4) (its
scripts/train.py:52).  The number that matters for "is training
fetch-bound": CPU-milliseconds per sample against (step_ms / batch) x
num_cpus.  The data lies under --root (default: scan2cap_host_profile in
the temporary directory).

Run:  python -m scan2cap_torch.scripts.profile_host_pipeline --num_scenes 100
      python -m scan2cap_torch.scripts.profile_host_pipeline --step_ms 210
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", type=str, default=os.path.join(
        tempfile.gettempdir(), "scan2cap_host_profile"))
    p.add_argument("--num_scenes", type=int, default=100)
    p.add_argument("--anns_per_scene", type=int, default=12)
    p.add_argument("--scene_points", type=int, default=50000,
                   help="points per stored scene (reference caps at 50k)")
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--measure_batches", type=int, default=40)
    p.add_argument("--warmup_batches", type=int, default=6)
    p.add_argument("--step_ms", type=float, default=0.0,
                   help="simulated consumer (train-step) time per batch; "
                        "0 = pure producer rate")
    p.add_argument("--regen", action="store_true")
    return p.parse_args(argv)


WORDS = ["the", "a", "chair", "table", "sofa", "brown", "white", "large",
         "small", "near", "next", "to", "wall", "door", "window", "desk",
         "left", "right", "corner", "room", "is", "in", "of", "on"]


def synthesize(args):
    """Reference-format files: <scene>_aligned_vert/_ins_label/_sem_label/
    _aligned_bbox .npy (data/scannet/batch_load_scannet_data.py:24-66) and
    one store with a (P, 128) array per scene (enet_feats_maxpool.npz)."""
    from scan2cap_torch.data.feature_store import FeatureStoreWriter

    os.makedirs(os.path.join(args.root, "scannet"), exist_ok=True)
    rng = np.random.RandomState(0)
    scanrefer = []
    mv_path = os.path.join(args.root, "enet_feats_maxpool.npz")
    t0 = time.time()
    with FeatureStoreWriter(mv_path) as mv:
        for s in range(args.num_scenes):
            sid = f"scene{s:04d}_00"
            P = args.scene_points
            xyz = rng.uniform(-4, 4, (P, 3)).astype(np.float32)
            rgb = rng.uniform(0, 255, (P, 3)).astype(np.float32)
            nrm = rng.randn(P, 3).astype(np.float32)
            verts = np.concatenate([xyz, rgb, nrm], 1)
            n_obj = rng.randint(6, 14)
            ins = rng.randint(0, n_obj + 1, P).astype(np.int32)  # 0 = none
            sem = rng.choice([3, 4, 5, 6, 7, 8, 9, 39], P).astype(np.int32)
            bboxes = np.zeros((n_obj, 8), np.float32)
            for o in range(n_obj):
                c = rng.uniform(-3, 3, 3)
                d = rng.uniform(0.3, 1.5, 3)
                bboxes[o] = [*c, *d, float(rng.choice([3, 4, 5, 6, 7, 8])),
                             o + 1]
            base = os.path.join(args.root, "scannet", sid)
            np.save(base + "_aligned_vert.npy", verts)
            np.save(base + "_ins_label.npy", ins)
            np.save(base + "_sem_label.npy", sem)
            np.save(base + "_aligned_bbox.npy", bboxes)
            mv[sid] = rng.randn(P, 128).astype(np.float32)
            for a in range(args.anns_per_scene):
                obj = int(rng.randint(1, n_obj + 1))
                scanrefer.append({
                    "scene_id": sid, "object_id": str(obj),
                    "object_name": "chair", "ann_id": str(a),
                    "token": [WORDS[rng.randint(len(WORDS))]
                              for _ in range(rng.randint(6, 20))],
                })
    with open(os.path.join(args.root, "ScanRefer_filtered_train.json"),
              "w") as f:
        json.dump(scanrefer, f)
    glove = {w: rng.randn(300).astype(np.float32)
             for w in WORDS + ["unk", "sos", "eos"]}
    with open(os.path.join(args.root, "glove.p"), "wb") as f:
        pickle.dump(glove, f)
    print(f"synthesized {args.num_scenes} scenes "
          f"({args.num_scenes * args.anns_per_scene} annotations) "
          f"in {time.time() - t0:.1f}s at {args.root}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    marker = os.path.join(args.root, "ScanRefer_filtered_train.json")
    # regenerate whenever ANY synthesis parameter differs from what is on
    # disk — a stale dataset silently profiled under new labels would make
    # the recorded numbers unattributable
    params_path = os.path.join(args.root, "synth_params.json")
    params = {k: getattr(args, k) for k in
              ("num_scenes", "anns_per_scene", "scene_points")}
    on_disk = None
    if os.path.exists(params_path):
        with open(params_path) as f:
            on_disk = json.load(f)
    if args.regen or not os.path.exists(marker) or on_disk != params:
        synthesize(args)
        with open(params_path, "w") as f:
            json.dump(params, f)

    from scan2cap_torch import native
    from scan2cap_torch.data.dataset import Loader, ScannetReferenceDataset

    with open(marker) as f:
        scanrefer = json.load(f)
    t0 = time.time()
    ds = ScannetReferenceDataset(
        scanrefer, sorted({d["scene_id"] for d in scanrefer}),
        os.path.join(args.root, "scannet"),
        os.path.join(args.root, "glove.p"),
        split="train", num_points=args.num_points,
        use_height=True, use_normal=True, use_multiview=True,
        multiview_path=os.path.join(args.root, "enet_feats_maxpool.npz"),
        augment=True)
    print(f"dataset init (scene .npy preload): {time.time() - t0:.1f}s; "
          f"native plane available: {native.available()}")

    loader = Loader(ds, args.batch_size, shuffle=True,
                    num_workers=args.workers, reuse_buffers=True)
    ncpu = len(os.sched_getaffinity(0))
    n_measure = min(args.measure_batches, len(loader) - args.warmup_batches)
    assert n_measure > 0, "dataset too small for the requested measurement"

    fetch_wait = 0.0
    t_start = time.perf_counter()     # correct when warmup_batches == 0
    it = iter(loader)
    for b in range(args.warmup_batches + n_measure):
        tf0 = time.perf_counter()
        batch = next(it)
        tw = time.perf_counter() - tf0
        if b == args.warmup_batches - 1:
            t_start = time.perf_counter()
        elif b >= args.warmup_batches:
            fetch_wait += tw
        if args.step_ms:
            time.sleep(args.step_ms / 1e3)   # simulated consumer step
    assert batch["point_clouds"].shape == (
        args.batch_size, args.num_points, 3 + 128 + 3 + 1)
    elapsed = time.perf_counter() - t_start
    n_samples = n_measure * args.batch_size

    out = {
        "metric": "host_pipeline_samples_per_sec",
        "value": round(n_samples / elapsed, 2),
        "unit": "samples/s",
        "ms_per_sample_wall": round(elapsed / n_samples * 1e3, 3),
        "cpu_ms_per_sample_upper_bound": round(
            elapsed / n_samples * 1e3 * ncpu, 3),
        "num_cpus": ncpu,
        "workers": args.workers,
        "batch_size": args.batch_size,
        "num_scenes": args.num_scenes,
        "native_plane": native.available(),
    }
    if args.step_ms:
        out["step_ms_simulated"] = args.step_ms
        out["fetch_wait_ms_per_batch"] = round(fetch_wait / n_measure * 1e3, 2)
        out["fetch_occupancy_pct"] = round(
            100 * fetch_wait / elapsed, 2)
    loader.close()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
