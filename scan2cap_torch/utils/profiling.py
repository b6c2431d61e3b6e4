"""Tracing, the program's spans and step record, and a numerics guard
(counterpart of ``scan2cap_tpu/utils/profiling.py``).

* ``trace(logdir)``: ``torch.profiler`` around a block (the host, and the
  card where there is one), written to ``<logdir>/trace.json`` as a Chrome
  trace, the file ``scripts/profile_report.py`` reads; ``start`` and
  ``stop`` are its two halves, which the trainers' ``--profile`` calls
  across steps (``train/solver.py``);
* ``annotate(name)``: a named span in that trace (``record_function``)
  while a profiler runs, else one shared null context: with no profiler
  the program pays a flag read a span, no dispatcher call and no
  allocation.  The program's spans, each opened through it:

  - ``scan2cap.step``: one train step or one served batch
    (``train/step.py``, through ``@program_step()``);
  - ``scan2cap.backbone``, ``.vote``, ``.proposal``, ``.graph``,
    ``.caption``: the model's stages (``models/capnet.py``,
    ``models/mask_votenet.py``);
  - ``scan2cap.decode``: a caption decoder's loop over its steps, once a
    loop (``models/caption.py``);
  - ``scan2cap.loss``, ``scan2cap.backward``, ``scan2cap.optimizer``: a
    step's loss call, its ``backward()``, and the fill of unreached
    gradients, their sum over a mesh and the Adam update
    (``train/step.py``);
  - ``scan2cap.encoder``, ``scan2cap.detr_decoder``, ``scan2cap.match``:
    Vote2Cap-DETR's pre-encoder, masked encoder and projection; its vote
    queries and set-prediction decoder; the Hungarian matching's cost
    matrices, their one copy to the host and the assignments
    (``models/vote2cap.py``, ``ops/matching.py``); its caption head's
    teacher-forced pass opens ``scan2cap.decode``;
  - ``scan2cap.collective``: one collective issued over a mesh
    (``parallel/mesh.py``).

  A span's parent is the span around it on the same thread; the autograd
  engine launches the backward's kernels from threads of its own, inside
  the time of ``scan2cap.backward``;
* ``STEP_RECORD``: the last ``RECORD_LEN`` program steps, each the host
  seconds from the step's entry to its return and whether a profiler was
  running, written by ``program_step`` on every call;
* ``DECODE_GRAPH_RECORD``: the last ``RECORD_LEN`` teacher-forced and
  free-running scene decodes of the top-down caption decoder, each how it
  ran (``capture``, ``replay`` or ``eager``) and why eager, written by
  ``models/decode_graph.DecodeGraphs`` and ``SceneDecodeGraphs`` on every
  call;
* ``STAGE_GRAPH_RECORD``: the last ``RECORD_LEN`` calls of CapNet's five
  stages and of the eval step's detection loss, each the stage, how it
  ran (``capture``, ``replay`` or ``eager``) and why eager, written by
  ``models/stage_graph.StageGraphs`` on every call;
* ``MATCH_RECORD``: the last ``RECORD_LEN`` Hungarian matchings, each
  the host seconds of one step's matching (cost matrices, copy and
  assignments), traced or not (``ops/matching.py``);
* ``ATTENTION_RECORD``: the last ``RECORD_LEN`` attention calls made
  while a profiler ran, each its shape, whether it was causal and learns,
  and for a masked call the count of kept pairs as a 0-d device tensor,
  never read inside the step (``models/transformer.attention``);
* ``check_finite(tensors)``: raise on NaN or Inf in a dict or list of
  tensors (one host read per tensor: call it sparingly).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch


def start(device: torch.device) -> torch.profiler.profile:
    """A running profiler of the host, and of the card on a CUDA
    ``device``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def stop(prof: torch.profiler.profile, logdir: str) -> None:
    """Stop ``prof`` once the card's work is done and write
    ``<logdir>/trace.json``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    prof = start(torch.device("cuda" if torch.cuda.is_available()
                              else "cpu"))
    try:
        yield prof
    finally:
        stop(prof, logdir)


_autograd_profiler = torch.autograd.profiler
_NO_SPAN = contextlib.nullcontext()
STEP_SPAN = "scan2cap.step"
RECORD_LEN = 4096


def annotate(name: str):
    """A ``record_function`` span named ``name`` while a profiler runs;
    otherwise a shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StepEntry(NamedTuple):
    seconds: float          # host seconds from the step's entry to its return
    traced: bool            # a profiler was running at its entry


STEP_RECORD: "collections.deque[StepEntry]" = collections.deque(
    maxlen=RECORD_LEN)


class DecodeGraphEntry(NamedTuple):
    kind: str               # "capture", "replay" or "eager"
    reason: Optional[str]   # why eager (None otherwise)


DECODE_GRAPH_RECORD: "collections.deque[DecodeGraphEntry]" = (
    collections.deque(maxlen=RECORD_LEN))


class StageGraphEntry(NamedTuple):
    stage: str              # "backbone_net", "vgen", ..., "loss"
    kind: str               # "capture", "replay" or "eager"
    reason: Optional[str]   # why eager (None otherwise)


STAGE_GRAPH_RECORD: "collections.deque[StageGraphEntry]" = (
    collections.deque(maxlen=RECORD_LEN))


class MatchEntry(NamedTuple):
    seconds: float          # host seconds of one step's matching
    traced: bool            # a profiler was running


MATCH_RECORD: "collections.deque[MatchEntry]" = collections.deque(
    maxlen=RECORD_LEN)


class AttentionEntry(NamedTuple):
    batch: int
    heads: int
    nq: int                 # queries
    nk: int                 # keys
    head_dim: int
    causal: bool
    grad: bool              # a backward will run through the call
    kept: Optional[torch.Tensor]    # masked calls: kept pairs, 0-d, device
    mask_bytes: int         # the mask as passed (0 without one)


ATTENTION_RECORD: "collections.deque[AttentionEntry]" = collections.deque(
    maxlen=RECORD_LEN)


def profiling() -> bool:
    """True while a profiler runs."""
    return _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def program_step():
    """One program step: a ``scan2cap.step`` span, and its entry in
    ``STEP_RECORD`` when it returns.  ``@program_step()`` makes a function
    one."""
    traced = _autograd_profiler._is_profiler_enabled
    t0 = time.perf_counter()
    with annotate(STEP_SPAN):
        yield
    STEP_RECORD.append(StepEntry(time.perf_counter() - t0, traced))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` if a floating tensor or array of
    ``tree`` (nested dicts, lists and tuples) holds a NaN or an Inf."""
    bad = []
    for path, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                bad.append(path)
        elif isinstance(leaf, np.ndarray) and leaf.dtype.kind == "f":
            if not np.isfinite(leaf).all():
                bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")
