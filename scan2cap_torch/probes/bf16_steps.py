"""The flagship's train step in float32 and in both bfloat16 modes:
``python -m scan2cap_torch.probes.bf16_steps``.

For each batch size (``--batch_sizes``, default 2 and 8) and each mode
(float32; ``compute_dtype`` bfloat16, the ``--bf16`` flag; ``storage_dtype``
bfloat16, ``--bf16_storage``) it builds the trajectory's flagship CapNet
(``scripts/quality_trajectory.make_config``: 40,000 points, 256 proposals,
top-down decoder, 2 graph steps, relation and orientation heads) from one
seed, takes ``--warmup`` steps on a synthetic batch, then times
``--steps`` back-to-back steps with CUDA events and profiles
``--profiled`` more: device ms per step (every kernel), the share of the
step the device is busy, and the device ms of FPS, the first-k and the
gather.  One JSON line per (batch size, mode), then the card's name and
power limit.

Run on the card:  python -m scan2cap_torch.probes.bf16_steps
On the CPU (a smoke of the script only, no times): add ``--tiny --device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

MODES = {"float32": {}, "compute": dict(compute_dtype="bfloat16"),
         "storage": dict(storage_dtype="bfloat16")}
KERNELS = {"fps": "fps_", "first_k": "bq_", "gather": "gather_rows_kernel"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_sizes", type=str, default="2,8")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--profiled", type=int, default=3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p


def measure(args, cfg, B: int, device) -> dict:
    from scan2cap_torch.data.synthetic import (make_scene_batch, make_vocab,
                                               to_device)
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.probes.timing import (device_ms, event_ms,
                                              profile_calls)
    from scan2cap_torch.scripts.quality_trajectory import NUM_VOCABS
    from scan2cap_torch.train.step import create_train_state, make_train_step

    vocab = make_vocab(num_vocabs=NUM_VOCABS, emb_size=cfg.emb_size)
    batch = to_device(make_scene_batch(cfg, batch_size=B, num_objects=6,
                                       vocab=vocab, seed=0), device)
    model = CapNet(cfg, num_vocabs=NUM_VOCABS, device=device, seed=args.seed)
    step = make_train_step(cfg, create_train_state(cfg, model),
                           detection=True, caption=True, orientation=True)
    losses = [float(step(batch, 1e-3, 0.1)["loss"])
              for _ in range(args.warmup)]
    row = dict(batch_size=B, compute_dtype=cfg.compute_dtype,
               storage_dtype=cfg.storage_dtype, losses=losses)
    if device.type != "cuda":
        return row

    def one():
        return step(batch, 1e-3, 0.1)

    row["ms_per_step"] = event_ms(one, args.steps, warmup=0)
    dev = device_ms(one, args.profiled, warmup=0)
    row["device_ms_per_step"] = dev["ms"]
    row["busy_share"] = dev["ms"] / row["ms_per_step"]
    rows = profile_calls(one, calls=1)["rows"]
    row["kernel_ms"] = {k: sum(r[0] for r in rows if pat in r[1])
                        for k, pat in KERNELS.items()}
    row["loss_after"] = float(one()["loss"])
    return row


def main(argv=None) -> int:
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.scripts import quality_trajectory as qt

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    base = qt.make_config(qt.build_parser().parse_args(
        ["--tiny"] if args.tiny else []))
    for B in (int(b) for b in args.batch_sizes.split(",")):
        for mode, dtypes in MODES.items():
            cfg = dataclasses.replace(base, **dtypes)
            row = dict(mode=mode, **measure(args, cfg, B, device))
            print(json.dumps(row), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    print(qt.card_line(device), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
