"""The readers of the cell that the Vote2Cap-DETR configuration brought,
over the existing fixture trace (``fixtures/program_spans.json``) with its
spans and kernels renamed, each value worked out by hand; the records'
readers with records made here; the attention's bound; Vote2Cap-DETR's
operation count against ``FlopCounterMode``; a tiny traced run of
``vote2cap-train-b8`` on the CPU."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import flops, harness, kinds, trace, weights
from h100bench.harness import TraceReading
from h100bench.paths import train
from h100bench.tests import tiny
from h100bench.tests.test_h100bench_program_spans import emulated_device
from h100bench.work import attention, bound_s

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "program_spans.json")
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77321
RENAMED = {"scan2cap.caption": "scan2cap.encoder",
           "scan2cap.decode": "scan2cap.detr_decoder",
           "scan2cap.loss": "scan2cap.match"}


def renamed_reading(kernels=None):
    with open(FIXTURE) as f:
        events = json.load(f)["traceEvents"]
    for e in events:
        if e.get("cat") == "user_annotation":
            e["name"] = RENAMED.get(e["name"], e["name"])
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "kernel" and kernels and corr in kernels:
            e["name"] = kernels[corr]
    return TraceReading(trace=trace.Trace(events), sites=None, steps=2,
                        wall_s=300e-6, window_s=1e-3, window_steps=10,
                        flops_per_step=0.0, batch=8)


@pytest.mark.parametrize("metric,want", [
    # the request's caption span held k2 10 and k3 4, the step's k5 10
    ("encoder_ms.vote2cap", 0.012),
    # the decode spans hold the same three kernels
    ("detr_decoder_ms.vote2cap", 0.012),
    # the gaps before k4 (25), the copy (2) and k6 (21), launched in the
    # loss spans, now match spans
    ("match_idle_ms.vote2cap", 0.024),
])
def test_span_readers(metric, want):
    assert harness.reader(metric)(renamed_reading()) == pytest.approx(
        want, rel=1e-12)


def test_match_ms_reads_the_untraced_rest(monkeypatch):
    from scan2cap_torch.utils import profiling
    record = profiling.MATCH_RECORD.__class__(maxlen=8)
    for seconds, traced in ((0.9, True), (0.010, False), (0.030, False),
                            (0.020, False)):
        record.append(profiling.MatchEntry(seconds, traced))
    monkeypatch.setattr(profiling, "MATCH_RECORD", record)
    r = renamed_reading()
    r.window_steps = 3
    assert harness.reader("match_ms.vote2cap")(r) == pytest.approx(20.0)
    r.window_steps = 4
    assert harness.reader("match_ms.vote2cap")(r) == pytest.approx(20.0)
    r.window_steps = 0
    assert harness.reader("match_ms.vote2cap")(r) is None


def entry(**kw):
    from scan2cap_torch.utils.profiling import AttentionEntry
    base = dict(batch=2, heads=4, nq=64, nk=128, head_dim=64, causal=False,
                grad=False, kept=None, mask_bytes=0)
    base.update(kw)
    return AttentionEntry(**base)


def test_attention_bound():
    plain = entry()
    ops = 4 * 64 * 2 * 64 * 128 * 4
    nbytes = 4 * 2 * 4 * 64 * 2 * (64 + 128)
    assert attention.entry_bound_s(plain) == bound_s(nbytes, ops)
    learns = entry(grad=True)
    assert attention.entry_bound_s(learns) == bound_s(nbytes, ops * 3.5)
    causal = entry(nk=64, causal=True)
    assert attention.entry_bound_s(causal) == bound_s(
        4 * 2 * 4 * 64 * 2 * 128, 4 * 64 * 2 * 64 * 65 / 2 * 4)
    kept = entry(kept=torch.tensor(100), mask_bytes=2 * 64 * 128)
    assert attention.entry_bound_s(kept) == bound_s(
        nbytes + 2 * 64 * 128, 4 * 64 * 100 * 4)


def test_attention_roofline_reads_the_record(monkeypatch):
    from scan2cap_torch.utils import profiling
    record = profiling.ATTENTION_RECORD.__class__(maxlen=8)
    record.append(entry(grad=True))
    monkeypatch.setattr(profiling, "ATTENTION_RECORD", record)
    # k1 (10 us) and k2 (10 us) as the attention's kernels
    r = renamed_reading({102: "fmha_cutlassF_f32_aligned_64x64_rf_sm80",
                         103: "fmha_cutlassB_f32_aligned_64x64_k64_sm80"})
    want = 100.0 * attention.entry_bound_s(record[0]) / 20e-6
    assert harness.reader("attention_roofline.vote2cap")(r) == \
        pytest.approx(want)
    assert harness.reader("attention_roofline.vote2cap")(
        renamed_reading()) is None


def test_count_equals_flop_counter():
    c = tiny.cell("vote2cap-train-b8")
    cfg, traffic = c.config, c.traffic
    cfg["described_objects"] = 4
    kind = kinds.of(cfg)
    ref = kind.reference(cfg)
    ref.load_state_dict(weights.make(cfg, 5, "cpu"))
    batch = kind.batches(7, cfg, traffic, "cpu")[0]
    counter = FlopCounterMode(display=False)
    with counter:
        kind.reference_loss(ref, batch, 0.1).backward()
    assert flops.per_step(cfg, traffic) == counter.get_total_flops()


def card_only(cell):
    """The metrics of ``cell`` that read what only the card has: the SA
    kernels' call sites, recorded at their CUDA wrappers."""
    return {m["name"] for m in cell.per_layer
            if m["name"].split(".")[0] in ("fps_roofline", "first_k_roofline")}


def test_a_tiny_traced_vote2cap_run_reads_its_metrics(monkeypatch):
    monkeypatch.setattr(harness, "read_trace", emulated_device)
    c = tiny.cell("vote2cap-train-b8", profiled_steps=1)
    # a profiled step takes seconds on the CPU: the window outlasts it
    r = train.run(c, SEED, 15.0, True, CPU, 0.0)
    assert r["correct"], r["checks"]
    listed = {m["name"] for m in c.per_layer} - card_only(c)
    assert listed and listed <= set(r["metrics"]), (listed, r["metrics"])
