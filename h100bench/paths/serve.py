"""The serving path: ``make_eval_step(cfg, model)(batch)`` in a closed loop
with one client.

Each request takes the next batch of the pool and is answered when its
outputs (captions, box corners, objectness and class scores) are on the
host; the next one is sent then.  The window closes with the first
answer at or past ``seconds``.  Throughput counts every scene answered
over the whole window, the tail every request.

The check: a sample of the finished requests, drawn from the seed, each
answered again by the reference with the decode fed the served tokens.
``answer_gap`` is the wider of two gaps of the served answers: the widest
by which a served token's logit lies below the reference's best at its
step (greedy decoding serves the best: 0), and the largest difference of
the box corners, objectness and class scores, each over its tensor's
largest value.  The two are one number because the lower-precision
control can pick every token as float32 does while its boxes move: the
token gap alone does not separate it.
"""

from __future__ import annotations

import random
import sys
import time
from typing import Dict

import torch

from h100bench import flops, harness, kinds, weights
from h100bench.reference import ops as ref_ops
from h100bench.reference.step import eval_forced

OUTPUTS = ("lang_cap", "bbox_corner", "objectness_scores", "sem_cls_scores")
BOXES = OUTPUTS[1:]


def build(cell: harness.Cell, seed: int, device: torch.device):
    from scan2cap_torch.train.step import make_eval_step
    cfg = cell.config
    kind = kinds.of(cfg)
    s = harness.seeds(seed)
    mcfg = harness.program_config(cfg)
    model = kind.program(mcfg, cfg, device)
    model.load_state_dict(weights.make(cfg, s["weights"], device))
    pool = kind.batches(s["scenes"], cfg, cell.traffic, device)
    return model, make_eval_step(mcfg, model), pool


def answer(step, batch) -> Dict[str, torch.Tensor]:
    out = step(batch)
    return {k: out[k].to("cpu") for k in OUTPUTS}


def judge(cell: harness.Cell, seed: int, pool, served, device,
          precision: str = "float32") -> Dict[str, float]:
    """The reference over the sampled requests: ``served`` lists (pool
    index, host outputs).  Under ``precision`` "tf32" the reference
    itself is the answer judged (the control): its own tokens at the
    served tokens' positions, its own boxes."""
    cfg = cell.config
    ref = kinds.of(cfg).reference(cfg).to(device)
    ref.load_state_dict(weights.make(cfg, harness.seeds(seed)["weights"],
                                     device))
    token_gap = box_gap = 0.0
    for i, host in served:
        tokens = host["lang_cap"].to(device)
        if precision == "float32":
            got = {k: host[k].to(device) for k in BOXES}
            read = tokens
        else:
            with ref_ops.precision(precision):
                low = eval_forced(ref, pool[i], tokens, tokens)
            got, read = {k: low[k] for k in BOXES}, low["picks"]
        want = eval_forced(ref, pool[i], tokens, read)
        token_gap = max(token_gap, float(want["token_gap"]))
        for k in BOXES:
            scale = max(float(want[k].abs().max()), 1e-6)
            box_gap = max(box_gap, float((got[k] - want[k]).abs().max()) / scale)
    print(f"answer gap parts: tokens {token_gap!r}, boxes and scores "
          f"{box_gap!r}", file=sys.stderr)
    return dict(answer_gap=max(token_gap, box_gap))


def readings(cell: harness.Cell, seed: int, device: torch.device) -> Dict:
    """The numbers of the check for the program, over ``checked_requests``
    requests of distinct batches through the timed entry, and for the
    control (the reference with TF32 products in its place)."""
    model, step, pool = build(cell, seed, device)
    served = [(i, answer(step, pool[i]))
              for i in range(cell.traffic["checked_requests"])]
    del model, step
    torch.cuda.empty_cache()
    return dict(program=judge(cell, seed, pool, served, device),
                control=judge(cell, seed, pool, served, device, "tf32"))


def sample(requests, k: int, seed: int):
    """``k`` finished requests drawn from the seed, of distinct pool
    batches where there are enough."""
    rng = random.Random(harness.seeds(seed)["sample"])
    order = list(range(len(requests)))
    rng.shuffle(order)
    picked, seen = [], set()
    for j in order:
        if requests[j][0] not in seen:
            picked.append(j)
            seen.add(requests[j][0])
        if len(picked) == k:
            break
    return sorted(picked)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, start: float) -> Dict:
    traffic = cell.traffic
    harness.set_precision(cell.config)
    model, step, pool = build(cell, seed, device)
    P, B = len(pool), traffic["batch"]
    for i in range(traffic["warmup"]):
        answer(step, pool[i % P])
    harness.sync(device)

    requests, latency = [], []

    def serve_next():
        i = (traffic["warmup"] + len(requests)) % P
        ts = time.perf_counter()
        requests.append((i, answer(step, pool[i])))
        latency.append(time.perf_counter() - ts)

    t0 = rest_t0 = time.perf_counter()
    setup_s = t0 - start
    rest_n = 0
    if trace:
        profile = harness.profiled(
            lambda: [serve_next() for _ in range(traffic["profiled_steps"])],
            model, device)
    # the untraced rest of the window, which the rate-based readers read
    rest_t0, rest_n = time.perf_counter(), len(requests)
    while time.perf_counter() - t0 < seconds:
        serve_next()
    end = time.perf_counter()
    window_s, rest_s = end - t0, end - rest_t0
    device_desc = harness.device_info(device, 1)

    # a request with a non-finite output failed: over any latency limit
    ok = [all(bool(torch.isfinite(h[k]).all()) for k in BOXES)
          for _, h in requests]
    failed = ok.count(False)
    tail = sorted(t if good else float("inf")
                  for good, t in zip(ok, latency))
    picked = sample(requests, traffic["checked_requests"], seed)
    served = [requests[j] for j in picked]
    del model, step
    requests = None
    torch.cuda.empty_cache()
    checks = harness.checks_of(judge(cell, seed, pool, served, device),
                               cell.limits)
    result = dict(correct=harness.passes(checks) and failed == 0,
                  attempted=len(tail), failed=failed)
    if trace:
        prof, sites, wall = profile
        reading = harness.TraceReading(
            trace=harness.read_trace(prof), sites=sites, steps=traffic["profiled_steps"],
            wall_s=wall, window_s=rest_s, window_steps=len(tail) - rest_n,
            flops_per_step=flops.per_step(cell.config, traffic), batch=B)
        result["metrics"] = harness.per_layer(cell, reading)
        result["device"] = dict(device_desc, **harness.busy(reading))
        result["breakdown"] = harness.breakdown(reading)
    else:
        p95 = tail[max(0, -(-95 * len(tail) // 100) - 1)]
        result["metrics"] = harness.end_to_end(cell, dict(
            serve_scenes_per_s=len(tail) * B / window_s,
            serve_p95_ms=p95 * 1e3, setup_s=setup_s))
        result["device"] = device_desc
    result["checks"] = checks
    return result
