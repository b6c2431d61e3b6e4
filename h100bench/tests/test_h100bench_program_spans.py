"""The readers of the program's own spans and step record.

On a small hand-made Chrome trace (``fixtures/program_spans.json``): a
request (``scan2cap.step`` 100 to 200 us, a decode inside
``scan2cap.caption`` and the benchmark's ``h100bench.caption``, a loss)
and a train step (200 to 400 us: decode, loss, a backward whose kernels
the engine launches from thread 2, an optimizer), each value worked out
by hand.  Then a tiny traced run of each cell on the CPU, with each host
operator standing for one device kernel launched at its start (the CPU
has no device trace): every new metric that the cell lists reads a
number, and a metric reads none in a cell where its span never opens.
"""

import json
import os

import pytest
import torch

from h100bench import harness, trace
from h100bench.harness import TraceReading
from h100bench.paths import serve, train
from h100bench.tests import tiny

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "program_spans.json")
CPU = torch.device("cpu")
SEED = 2 ** 31 + 54321
NEW = ("host_issue_ms", "loss_ms", "optimizer_ms", "decode_ms",
       "decode_idle_ms", "backward_idle_ms", "optimizer_idle_ms")


@pytest.fixture
def reading():
    return TraceReading(trace=trace.Trace.load(FIXTURE), sites=None, steps=2,
                        wall_s=300e-6, window_s=1e-3, window_steps=10,
                        flops_per_step=0.0, batch=8)


@pytest.mark.parametrize("metric,want", [
    # k2 10 + k3 4 + k5 10 us over 2 steps
    ("decode_ms.serve", 0.012),
    ("decode_ms.train", 0.012),
    # k4 10, the copy 4, k6 4
    ("loss_ms.serve", 0.009),
    ("loss_ms.train", 0.009),
    # k10 10 and k11 10, on two streams; not k13, launched from thread 2
    ("optimizer_ms.train", 0.010),
    # the gaps before k2, k3 and k5: 7 + 6 + 29
    ("decode_idle_ms.serve", 0.021),
    ("decode_idle_ms.train", 0.021),
    # before k7 and k8, both launched from the engine's thread: 12 + 23
    ("backward_idle_ms.train", 0.0175),
    # before k10: 25; k11 starts before k10 ends, k13's gap is not its
    ("optimizer_idle_ms.train", 0.0125),
    # the step's own copy: the benchmark's hook span holds k2 and k3
    ("caption_ms.serve", 0.007),
])
def test_readers(reading, metric, want):
    assert harness.reader(metric)(reading) == pytest.approx(want, rel=1e-12)


def test_the_span_gaps_lie_within_the_idle_time(reading):
    ops = reading.trace.in_steps()
    idle_us = 300.0 - trace.busy_us(ops)
    named = sum(harness.reader(m)(reading) for m in (
        "decode_idle_ms.serve", "backward_idle_ms.train",
        "optimizer_idle_ms.train")) * 1e3 * reading.steps
    assert named == pytest.approx(42 + 35 + 25)
    assert named <= idle_us


def test_a_trace_without_the_spans_or_the_device_reads_nothing(reading):
    bare = TraceReading(**dict(vars(reading)))
    bare.trace = trace.Trace.load(os.path.join(
        os.path.dirname(__file__), "fixtures", "two_steps.json"))
    for metric in ("loss_ms.serve", "decode_ms.train", "optimizer_ms.train",
                   "decode_idle_ms.serve", "backward_idle_ms.train",
                   "optimizer_idle_ms.train"):
        assert harness.reader(metric)(bare) is None, metric
    reading.trace.ops = []
    for metric in ("loss_ms.train", "decode_idle_ms.train"):
        assert harness.reader(metric)(reading) is None, metric


def test_host_issue_reads_the_untraced_rest(reading, monkeypatch):
    from scan2cap_torch.utils import profiling
    record = profiling.STEP_RECORD.__class__(maxlen=8)
    for seconds, traced in ((0.5, True), (0.010, False), (0.020, False),
                            (0.030, False), (0.050, False)):
        record.append(profiling.StepEntry(seconds, traced))
    monkeypatch.setattr(profiling, "STEP_RECORD", record)
    read = harness.reader("host_issue_ms.train")
    reading.window_steps = 3
    assert read(reading) == pytest.approx(30.0)
    reading.window_steps = 5           # a traced entry is left out
    assert read(reading) == pytest.approx(25.0)
    reading.window_steps = 0
    assert read(reading) is None
    monkeypatch.delattr(profiling, "STEP_RECORD")
    reading.window_steps = 3
    assert read(reading) is None


def emulated_device(prof):
    """The CPU's trace with one kernel a host ``aten::`` operator, launched
    at its start on its thread and run for 1 us after its end."""
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    extra = []
    for i, e in enumerate(events):
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" \
                and e["name"].startswith("aten::"):
            ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            extra.append(dict(ph="X", cat="cuda_runtime",
                              name="cudaLaunchKernel", ts=ts, dur=0.1,
                              pid=e["pid"], tid=e["tid"],
                              args=dict(correlation=-1 - i)))
            extra.append(dict(ph="X", cat="kernel", name=e["name"],
                              ts=end, dur=1.0, pid=0, tid=7,
                              args=dict(correlation=-1 - i)))
    return trace.Trace(events + extra)


def new_metrics():
    """The new metrics of ``BENCHMARK.json``: name -> the cells that list
    any metric of its base (``<base>.serve``, ``<base>.train``)."""
    bench = harness.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    mine = [m for m in bench["per_layer"] if m["name"].split(".")[0] in NEW]
    return {m["name"]: {w for n in mine
                        if n["name"].split(".")[0] == m["name"].split(".")[0]
                        for w in n["workloads"]} for m in mine}


@pytest.mark.parametrize("cell", ["flagship-serve-b8",
                                  "maskvotenet-train-b16",
                                  "flagship-train-b16"])
def test_a_tiny_traced_run_reads_its_metrics(cell, monkeypatch):
    readings = []
    per_layer = harness.per_layer

    def keep(c, r):
        readings.append(r)
        return per_layer(c, r)

    monkeypatch.setattr(harness, "read_trace", emulated_device)
    monkeypatch.setattr(harness, "per_layer", keep)
    c = tiny.cell(cell, profiled_steps=1)
    path = serve if c.traffic["path"] == "serve" else train
    # the profiler's own exit takes seconds on the CPU: the window outlasts it
    r = path.run(c, SEED, 6.0, True, CPU, 0.0)
    assert r["correct"], r["checks"]
    listed = {m["name"] for m in c.per_layer
              if m["name"].split(".")[0] in NEW}
    assert listed and listed <= set(r["metrics"]), (listed, r["metrics"])
    for name in listed:
        assert r["metrics"][name]["value"] >= 0.0
    for name, cells in new_metrics().items():
        if cell not in cells:
            assert harness.reader(name)(readings[0]) is None, name
