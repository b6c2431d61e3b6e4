"""What every path module shares: the cell's files, the program's
configuration, the device's description, spans around the model's stages,
the record of the kernels' call sites, the profiled steps, the per-layer
readers and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# modules that no run may hold, compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "scan2cap_tpu")
PEAK_F32_FLOPS = 67e12          # H100 SXM data sheet, float32 without tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM data sheet, HBM3
GUARD_LAUNCHES = 512            # fills ahead of a profiled region


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(names) -> List[str]:
    """The names among ``names`` whose top-level package (the part before
    the first dot) is one of ``FORBIDDEN``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @classmethod
    def load(cls, bench: Dict, name: str) -> "Cell":
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name} in BENCHMARK.json")
        w = found[0]
        cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]

        def mine(metric):
            return name in metric.get("workloads", [name])

        return cls(name=name, chips=w["chips"],
                   config=load_json(cfg["file"]),
                   traffic=load_json(os.path.join(
                       ROOT, "traffic", f"{w['traffic']}.json")),
                   limits=load_json(os.path.join(ROOT, "limits",
                                                 f"{name}.json")),
                   end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                   per_layer=[m for m in bench["per_layer"] if mine(m)])


def program_config(cfg: Dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from scan2cap_torch.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    kw["sa_npoints"] = tuple(kw["sa_npoints"])
    return ModelConfig(**kw)


def set_precision(cfg: Dict) -> None:
    """float32 products as the configuration states them: no TF32."""
    allow = cfg["matmul_precision"] == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def device_info(device: torch.device, count: int) -> Dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=count,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=count,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """While open, a ``record_function`` span named ``h100bench.<child>``
    around each forward of the model's top-level children."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.handles = []

    def __enter__(self):
        for name, child in self.model.named_children():
            stack = []

            def pre(_m, _a, name=name, stack=stack):
                rf = torch.autograd.profiler.record_function(f"h100bench.{name}")
                rf.__enter__()
                stack.append(rf)

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            self.handles.append(child.register_forward_pre_hook(pre))
            self.handles.append(child.register_forward_hook(post))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []


class CallSites:
    """While open, every call of the program's FPS and first-k kernel
    wrappers is recorded with its inputs, then passed on: ``fps`` holds
    (B, N, npoint), ``first_k`` (xyz, new_xyz, r2, nsample)."""

    def __init__(self):
        from scan2cap_torch.ops import grouping, sampling
        self.grouping, self.sampling = grouping, sampling
        self.fps, self.first_k = [], []

    def __enter__(self):
        s, g = self.sampling, self.grouping
        self.saved = (s.furthest_point_sample_cuda, g.ball_query_cuda)
        fps, bq = self.saved

        def fps_rec(xyz, npoint, **kw):
            self.fps.append((xyz.shape[0], xyz.shape[1], int(npoint)))
            return fps(xyz, npoint, **kw)

        def bq_rec(xyz, new_xyz, r2, nsample, **kw):
            self.first_k.append((xyz, new_xyz, float(r2), int(nsample)))
            return bq(xyz, new_xyz, r2, nsample, **kw)

        s.furthest_point_sample_cuda, g.ball_query_cuda = fps_rec, bq_rec
        return self

    def __exit__(self, *exc):
        self.sampling.furthest_point_sample_cuda = self.saved[0]
        self.grouping.ball_query_cuda = self.saved[1]


def profiled(steps: Callable[[], None], model: torch.nn.Module,
             device: torch.device):
    """Runs ``steps()`` under the profiler, behind ``GUARD_LAUNCHES`` fills
    (a profiler started late loses its first kernels), with the model's
    spans and the kernels' call sites recorded.  Returns the profiler, the
    call sites and the steps' wall seconds; ``read_trace`` parses the
    profile later, outside the measured window."""
    from torch.profiler import ProfilerActivity, profile
    guard = torch.zeros(8, dtype=torch.int16, device=device)
    sites = CallSites()
    sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(GUARD_LAUNCHES):
            guard.fill_(0)
        sync(device)
        with Spans(model), sites:
            t0 = time.perf_counter()
            with torch.autograd.profiler.record_function("h100bench.steps"):
                steps()
                sync(device)
            wall = time.perf_counter() - t0
    return prof, sites, wall


def read_trace(prof):
    """The profile as a parsed ``trace.Trace``, through a Chrome trace in
    the temporary directory, removed after."""
    from h100bench.trace import Trace
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.load(path)
    finally:
        os.unlink(path)


def reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read``; a metric split by the path that
    reports it (``<base>.serve``, ``<base>.train``) without a file of its
    own falls back to ``metrics/<base>.py``."""
    path = os.path.join(ROOT, "metrics", f"{metric}.py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(ROOT, "metrics", f"{metric.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class TraceReading:
    """What a per-layer reader reads: the trace of the profiled steps,
    their call sites and wall time, and the steps and seconds of the
    window's untraced rest, after the profiler closed."""
    trace: object
    sites: CallSites
    steps: int
    wall_s: float
    window_s: float
    window_steps: int
    flops_per_step: float
    batch: int


def per_layer(cell: Cell, reading: TraceReading) -> Dict:
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(cell: Cell, values: Dict[str, float]) -> Dict:
    return {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
            for m in cell.end_to_end}


def checks_of(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    return {k: {"value": float(values[k]), "limit": float(limits[k])}
            for k in limits}


def passes(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def report_checks(checks: Dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def seeds(seed: int) -> Dict[str, int]:
    """The generators' seeds of one run: weights, scenes, the sample of
    checked requests."""
    mask = (1 << 63) - 1
    return dict(weights=seed & mask,
                scenes=(seed * 0x9E3779B1 + 0x7F4A7C15) & mask,
                sample=(seed * 0x85EBCA6B + 0x2545F491) & mask)


def busy(reading: TraceReading) -> Dict[str, float]:
    """Seconds in which an operation ran on the device during the
    profiled steps, and their wall seconds."""
    from h100bench.trace import busy_us
    return dict(busy_s=busy_us(reading.trace.in_steps()) / 1e6,
                window_s=reading.wall_s)


def breakdown(reading: TraceReading) -> Dict:
    """The device operations that took most time in the profiled steps,
    and the longest idle gaps by what the host was doing."""
    from h100bench.trace import idle_gaps, top_ops
    ops = reading.trace.in_steps()
    return dict(device_ops=top_ops(ops), idle_gaps=idle_gaps(reading.trace, ops))
