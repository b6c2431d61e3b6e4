"""Paired analysis of a two-arm quality-trajectory study:
``python -m scan2cap_torch.scripts.analyze_quality_study`` (a copy of
``scripts/analyze_quality_study.py``, numpy only).

Reads ``qt_seed{S}_{arm}.json`` pairs produced by
``scan2cap_torch.scripts.quality_trajectory`` for arms ``f32`` and
``bf16s`` and computes, per seed, the TAIL quality (mean over curve points
with step >= --tail_from) of mAP@0.25, AR@0.25 and train-CiDEr, then the
paired per-seed deltas (bf16s - f32) with a bootstrap 95% CI over seeds.

Decision rule (pre-registered in the JAX package, unchanged here):

  FLIP the storage_dtype default to bfloat16 iff ALL of
    (a) no collapse: every bf16s seed tail mAP >= 0.1 whenever its
        paired f32 tail is >= 0.2 (the compute-bf16 failure mode scored
        0.001-0.058);
    (b) paired mean tail-mAP delta >= -0.02;
    (c) at least 3 of the seeds favor bf16s (delta > 0);
    (d) caption memorization is intact: final cap_acc >= 0.9 in every
        bf16s run.
  Otherwise storage bf16 STAYS OPT-IN.

Writes ``<dir>/paired_summary.json``.

Run: python -m scan2cap_torch.scripts.analyze_quality_study --dir <dir>
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np


def tail_mean(curve, key, tail_from):
    steps = np.asarray(curve["step"])
    vals = np.asarray([v if v is not None else np.nan for v in curve[key]],
                      dtype=np.float64)
    sel = steps >= tail_from
    return float(np.nanmean(vals[sel]))


def load_runs(dirpath):
    runs = {}
    for path in glob.glob(os.path.join(dirpath, "qt_seed*_*.json")):
        m = re.match(r"qt_seed(\d+)_(\w+)\.json", os.path.basename(path))
        if not m:
            continue
        seed, arm = int(m.group(1)), m.group(2)
        with open(path) as f:
            runs[(seed, arm)] = json.load(f)
    return runs


def bootstrap_ci(deltas, iters=20000, seed=0):
    rng = np.random.default_rng(seed)
    deltas = np.asarray(deltas, dtype=np.float64)
    idx = rng.integers(0, len(deltas), size=(iters, len(deltas)))
    means = deltas[idx].mean(axis=1)
    return float(np.percentile(means, 2.5)), float(np.percentile(means, 97.5))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True)
    p.add_argument("--tail_from", type=int, default=450)
    p.add_argument("--arms", nargs=2, default=["f32", "bf16s"])
    args = p.parse_args(argv)

    runs = load_runs(args.dir)
    base_arm, test_arm = args.arms
    seeds = sorted({s for (s, a) in runs if a == base_arm
                    and (s, test_arm) in runs})
    if not seeds:
        raise SystemExit(f"no paired {base_arm}/{test_arm} runs in {args.dir}")

    rows, deltas = [], {"map25": [], "ar25": [], "cider_train": []}
    collapse = False
    cap_acc_ok = True
    for s in seeds:
        row = {"seed": s}
        for arm in (base_arm, test_arm):
            curve = runs[(s, arm)]["curve"]
            for k in deltas:
                row[f"{arm}_{k}"] = tail_mean(curve, k, args.tail_from)
            finals = [v for v in curve["cap_acc"] if v is not None]
            row[f"{arm}_cap_acc_final"] = finals[-1] if finals else float("nan")
        for k in deltas:
            deltas[k].append(row[f"{test_arm}_{k}"] - row[f"{base_arm}_{k}"])
        if (row[f"{base_arm}_map25"] >= 0.2
                and row[f"{test_arm}_map25"] < 0.1):
            collapse = True
        if row[f"{test_arm}_cap_acc_final"] < 0.9:
            cap_acc_ok = False
        rows.append(row)

    hdr = (f"{'seed':>6} | {base_arm+' mAP':>9} {test_arm+' mAP':>9} "
           f"{'Δ mAP':>8} | {'Δ AR':>8} | {'Δ CiDEr':>8}")
    print(hdr)
    print("-" * len(hdr))
    for row, dm, da, dc in zip(rows, deltas["map25"], deltas["ar25"],
                               deltas["cider_train"]):
        print(f"{row['seed']:>6} | {row[f'{base_arm}_map25']:>9.4f} "
              f"{row[f'{test_arm}_map25']:>9.4f} {dm:>+8.4f} | {da:>+8.4f} "
              f"| {dc:>+8.4f}")

    summary = {"seeds": seeds, "tail_from": args.tail_from,
               "arms": [base_arm, test_arm]}
    for k, d in deltas.items():
        lo, hi = bootstrap_ci(d)
        summary[f"delta_{k}"] = {
            "mean": float(np.mean(d)), "per_seed": [float(x) for x in d],
            "ci95": [lo, hi], "favoring": int(sum(x > 0 for x in d))}
        print(f"paired Δ{k}: mean {np.mean(d):+.4f}  "
              f"95% CI [{lo:+.4f}, {hi:+.4f}]  "
              f"{summary[f'delta_{k}']['favoring']}/{len(d)} favor {test_arm}")

    dm = summary["delta_map25"]
    verdict_flip = (not collapse and dm["mean"] >= -0.02
                    and dm["favoring"] >= 3 and cap_acc_ok)
    summary["rule"] = {"collapse": collapse, "cap_acc_ok": cap_acc_ok,
                       "mean_ok": dm["mean"] >= -0.02,
                       "favoring_ok": dm["favoring"] >= 3}
    summary["verdict"] = "FLIP-DEFAULT" if verdict_flip else "STAY-OPT-IN"
    print(f"verdict: {summary['verdict']}  (rule: {summary['rule']})")
    out = os.path.join(args.dir, "paired_summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {out}")
    return summary


if __name__ == "__main__":
    main()
