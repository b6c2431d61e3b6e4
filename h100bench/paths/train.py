"""The training path: the port's train step (``make_train_step`` for
CapNet with its detection, caption and orientation losses,
``make_mask_votenet_step`` for MaskVoteNet) in a closed loop, each step on
the next batch of the pool.

Set-up builds one train state and drives it through its first steps on
batches that all differ; that same state then runs the window.  The
window's rate is every scene trained over its whole length, ending in a
synchronise.

The check: the reference, from the same weights, takes the same first
steps.  ``compare`` works out every number of the check: each step's
relative loss gap (``first_loss_gap``, ``loss_gap_2``, ...);
``grad_gap``, the worst leaf's gap between the norms of the first
gradient as the optimizer got it (the program's read back from Adam's
first moment after step 1: m / (1 - beta1)); ``change_gap`` and
``worst_change_gap``, the median and the worst leaf's gap between the
norms of the parameters' and BN statistics' change over those steps.  A
leaf's gap is over the reference's norm of that leaf or of the median
leaf, whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's (nought to rounding, moved by round-off
alone under Adam) are left out of the leaf numbers.  The cell's
``limits/<cell>.json`` names the numbers compared; the rest are printed
beside them on standard error.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from h100bench import flops, harness, kinds, weights
from h100bench.reference import ops as ref_ops
from h100bench.reference.step import follow

BETA1 = 0.9


def build(cell: harness.Cell, seed: int, device: torch.device):
    from scan2cap_torch.train.step import create_train_state
    cfg, traffic = cell.config, cell.traffic
    kind = kinds.of(cfg)
    s = harness.seeds(seed)
    mcfg = harness.program_config(cfg)
    model = kind.program(mcfg, cfg, device)
    model.load_state_dict(weights.make(cfg, s["weights"], device))
    state = create_train_state(mcfg, model, traffic["weight_decay"])
    step = kind.train_step(mcfg, state, traffic)
    pool = kind.batches(s["scenes"], cfg, traffic, device)
    return model, state, step, pool


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def first_steps(model, state, step, pool, traffic) -> Dict:
    """The compared steps, through the window's own call: their losses,
    the first gradient's norms and the change's norms by leaf."""
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    out = dict(losses=[])
    for i in range(traffic["checked_steps"]):
        m = step(pool[i], traffic["lr"], traffic["bn_momentum"])
        out["losses"].append(float(m["loss"]))
        print(f"step {i + 1}: " + ", ".join(
            f"{k} {float(v):.6g}" for k, v in m.items()), file=sys.stderr)
        if i == 0:
            opt = state.optimizer.state
            out["grad"] = norms({k: opt[p]["exp_avg"] / (1 - BETA1)
                                 for k, p in params.items()})
    now = model.state_dict()
    out["change"] = norms({k: now[k] - start[k] for k in start})
    return out


def reference_steps(cell, seed, pool, device, precision="float32") -> Dict:
    cfg, traffic = cell.config, cell.traffic
    kind = kinds.of(cfg)
    ref = kind.reference(cfg).to(device)
    ref.load_state_dict(weights.make(cfg, harness.seeds(seed)["weights"],
                                     device))
    start = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    with ref_ops.precision(precision):
        r = follow(ref, kind.reference_loss, pool[:traffic["checked_steps"]],
                   traffic["lr"],
                   traffic["bn_momentum"], traffic["weight_decay"])
    now = ref.state_dict()
    print(f"reference ({precision}) losses: {r['losses']}", file=sys.stderr)
    return dict(losses=r["losses"], grad=norms(r["grad"]),
                raw_grad=norms(r["raw_grad"]),
                change=norms({k: now[k] - start[k] for k in start}))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves: List[str]) -> List[float]:
    """Each leaf's gap between the two norms, over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    median = statistics.median(want[k] for k in leaves)
    return [abs(got[k] - want[k]) / max(want[k], median, 1e-30)
            for k in leaves]


def compare(got: Dict, want: Dict,
            raw: Optional[Dict] = None) -> Dict[str, float]:
    """Every number of the check; ``want`` is the reference's, ``raw``
    the reference's gradients that pick the leaves (``want``'s own by
    default)."""
    raw = raw or want["raw_grad"]
    median = statistics.median(raw.values())
    moved = [k for k in raw if raw[k] >= 1e-3 * median]
    still = set(raw) - set(moved)
    print(f"leaves left out: {sorted(still)}", file=sys.stderr)
    changed = [k for k in want["change"] if k not in still]
    change = leaf_gaps(got["change"], want["change"], changed)
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  want["losses"])]
    out = dict(first_loss_gap=losses[0])
    out.update((f"loss_gap_{i}", g) for i, g in enumerate(losses[1:], 2))
    out.update(grad_gap=max(leaf_gaps(got["grad"], want["grad"], moved)),
               change_gap=statistics.median(change),
               worst_change_gap=max(change))
    return out


def readings(cell: harness.Cell, seed: int, device: torch.device) -> Dict:
    """The numbers of the check for the program, for the control (the
    reference with TF32 products in its place) and for a fault planted in
    the reference in its place (half of each batch left out, the mean
    taken over the rest)."""
    model, state, step, pool = build(cell, seed, device)
    got = first_steps(model, state, step, pool, cell.traffic)
    del model, state, step
    kept = pool[:cell.traffic["checked_steps"]]
    del pool
    torch.cuda.empty_cache()
    want = reference_steps(cell, seed, kept, device)
    low = reference_steps(cell, seed, kept, device, "tf32")
    half = [kinds.half_batch(cell.config, b) for b in kept]
    return dict(program=compare(got, want), control=compare(low, want),
                half_batch=compare(reference_steps(cell, seed, half, device),
                                   want))


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, start: float) -> Dict:
    traffic = cell.traffic
    harness.set_precision(cell.config)
    model, state, step, pool = build(cell, seed, device)
    P, B = len(pool), traffic["batch"]
    lr, bnm = traffic["lr"], traffic["bn_momentum"]
    got = first_steps(model, state, step, pool, traffic)
    harness.sync(device)

    losses = []

    def train_next():
        i = (traffic["checked_steps"] + len(losses)) % P
        losses.append(step(pool[i], lr, bnm)["loss"])

    t0 = rest_t0 = time.perf_counter()
    setup_s = t0 - start
    rest_n = 0
    if trace:
        profile = harness.profiled(
            lambda: [train_next() for _ in range(traffic["profiled_steps"])],
            model, device)
    # the untraced rest of the window, which the rate-based readers read
    rest_t0, rest_n = time.perf_counter(), len(losses)
    while time.perf_counter() - t0 < seconds:
        train_next()
    harness.sync(device)
    end = time.perf_counter()
    window_s, rest_s = end - t0, end - rest_t0
    device_desc = harness.device_info(device, 1)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    steps = len(losses)

    del model, state, step, losses
    kept = pool[:traffic["checked_steps"]]
    pool = None
    torch.cuda.empty_cache()
    values = compare(got, reference_steps(cell, seed, kept, device))
    print("not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in values.items() if k not in cell.limits),
        file=sys.stderr)
    checks = harness.checks_of(values, cell.limits)
    result = dict(correct=harness.passes(checks) and failed == 0,
                  attempted=steps, failed=failed)
    if trace:
        prof, sites, wall = profile
        reading = harness.TraceReading(
            trace=harness.read_trace(prof), sites=sites, steps=traffic["profiled_steps"],
            wall_s=wall, window_s=rest_s, window_steps=steps - rest_n,
            flops_per_step=flops.per_step(cell.config, traffic), batch=B)
        result["metrics"] = harness.per_layer(cell, reading)
        result["device"] = dict(device_desc, **harness.busy(reading))
        result["breakdown"] = harness.breakdown(reading)
    else:
        result["metrics"] = harness.end_to_end(cell, dict(
            train_scenes_per_s=steps * B / window_s, setup_s=setup_s))
        result["device"] = device_desc
    result["checks"] = checks
    return result
