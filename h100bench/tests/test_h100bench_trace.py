"""The trace reader on a small Chrome trace of two profiled steps, kept
as a fixture: which operations the steps launched, their attribution to
the benchmark's spans and to the autograd engine, the device's busy and
idle time, the per-step readers and the idle gaps' labels."""

import os

import pytest

from h100bench import harness, trace
from h100bench.harness import TraceReading

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "two_steps.json")


@pytest.fixture
def reading():
    t = trace.Trace.load(FIXTURE)
    return TraceReading(trace=t, sites=None, steps=2, wall_s=200e-6,
                        window_s=1e-3, window_steps=10, flops_per_step=6.7e9,
                        batch=8)


def test_steps_leave_out_the_guard(reading):
    ops = reading.trace.in_steps()
    assert len(ops) == 6
    assert len(trace.kernels(ops)) == 5
    assert not any("FillFunctor" in o.name for o in ops)


def test_a_kernel_without_a_launch_record_takes_its_predecessor(reading):
    gather = [o for o in reading.trace.ops if "gather_rows" in o.name][0]
    assert gather.launch == 213 and gather.tid == 1


@pytest.mark.parametrize("metric,want", [
    ("kernels_per_step.serve", 2.5),
    ("kernels_per_step.train", 2.5),
    ("backbone_ms.serve", 0.025),      # 20 + 20 + 10 us over 2 steps
    ("backbone_ms.train", 0.025),
    ("caption_ms.serve", 0.007),       # 10 us and a 4 us copy
    ("backward_ms.train", 0.0025),     # the engine's 5 us kernel
    ("device_idle_pct.serve", 65.5),   # 34.5 us busy a step of 100 us
    ("device_idle_pct.train", 65.5),
    ("mfu.serve", 100.0),              # 6.7e9 x 10 / 1 ms / 67e12 = 1
    ("mfu.train", 100.0),
])
def test_readers(reading, metric, want):
    got = harness.reader(metric)(reading)
    assert got == pytest.approx(want, rel=1e-12)


def test_busy_and_window(reading):
    b = harness.busy(reading)
    assert b["busy_s"] == pytest.approx(69e-6)
    assert b["window_s"] == 200e-6


def test_breakdown(reading):
    b = harness.breakdown(reading)
    ops = dict(b["device_ops"])
    assert ops["ampere_sgemm_128x64_nn"] == pytest.approx(20e-6)
    assert len(b["device_ops"]) == 6
    gaps = dict(b["idle_gaps"])
    assert gaps == pytest.approx({
        "backbone_net: aten::mm": 50e-6,
        "caption: aten::addmm": 30e-6,
        "aten::mm": 15e-6,                  # inside the engine function
        "caption: no host operator": 2e-6})
    assert [g[0] for g in b["idle_gaps"]][0] == "backbone_net: aten::mm"


def test_a_trace_without_device_operations_reads_nothing(reading):
    reading.trace.ops = []
    for metric in ("kernels_per_step.serve", "backbone_ms.train",
                   "backward_ms.train", "device_idle_pct.serve", "mfu.train"):
        assert harness.reader(metric)(reading) is None, metric
