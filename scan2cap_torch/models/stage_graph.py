"""The eval forward's stages as CUDA graph segments.

Under ``inference_mode`` or ``no_grad`` on a card, the eval forward of
CapNet's five children (``backbone_net``, ``vgen``, ``proposal``,
``graph``, ``caption``) and the eval step's detection loss are thousands
of small launches, and the device waits for the host that issues them.
``StageGraphs`` replays each such stage from a *tape*, captured at the
first call of a key: CUDA graph segments in a private pool of the
tape's own, and between them the *breaks*, which stay eager calls:

* an FPS or a ball-query launch (``ops/library.py`` cuts the segment
  under capture there): each replay calls the op again on copies of the
  break's buffers, so the launch still goes through the wrappers that
  ``ops.sampling`` and ``ops.grouping`` hold at that moment;
* the scene decode's dispatch (``decode_graph.SceneDecodeGraphs``), which
  replays its own graph, writes its own record entry and opens its
  ``scan2cap.decode`` span.

A break's result is copied into the buffer that the next segment reads.
The kernels, their order and their precision are the eager stage's, so a
replay is the eager stage bit for bit.

A stage runs eager for the scene decode's reasons
(``decode_graph.scene_eager_reason``: grad enabled, a tracer, a mesh, a
CPU, a capture under way), at a new key under a profiler or past
``MAX_CAPTURES`` keys of the stage, and for a probe that has swapped a
kernel wrapper a replay would not call (``probe_reason``).  A key is the
stage, the structure of its arguments with each tensor's shape, dtype
and device and every other argument's value, which arguments are one
tensor, the addresses of what the stage reads in place (parameters,
buffers) and the caller's ``extra``.  Every call appends a
``StageGraphEntry`` to ``utils/profiling.STAGE_GRAPH_RECORD``.

A replay copies each tensor argument into the tape's buffer for it,
unless it is that buffer: an argument that a tape returned (the stage
before, in a forward) is taken as the buffer at capture, and is in place
at every replay.  A break calls its op on fresh copies of its tensor
arguments, so that a wrapper that keeps them (the benchmark's call
sites) keeps that request's.  A replay's outputs are the tape's buffers,
which the next call of the key overwrites: ``kept`` clones what a caller
keeps past it (``train/step.make_eval_step``,
``scripts/export_model.Serve``).  Each tape has a pool of its own: in a
pool that tapes shared, a tape captured later could hold its outputs in
what an earlier one left free, and the earlier one's replay would
overwrite them while a later stage still reads them (a backbone at a new
key, then the voting stage at a key it had).  All the tapes warm up and
capture on one side stream, where each warm-up reuses the memory that
the one before it left cached.  The hand-written kernels launched inside
segments (the gather) are counted at capture and added at every replay,
so ``kernels.launch_counts()`` reads the same for a request graphed or
eager; FPS and the ball query count at their calls.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

from scan2cap_torch import kernels
from scan2cap_torch.models.decode_graph import (_Graphs, _warm_up,
                                                scene_eager_reason)
from scan2cap_torch.ops import grouping, library, sampling
from scan2cap_torch.parallel import mesh as pmesh
from scan2cap_torch.utils.profiling import (STAGE_GRAPH_RECORD,
                                            StageGraphEntry)

STAGES = ("backbone_net", "vgen", "proposal", "graph", "caption")
_EMPTY = "CUDA Graph is empty"      # PyTorch's warning at an empty capture


def _flatten(tree, leaves: list):
    """Append the leaves of nested dicts, lists and tuples to ``leaves``
    and return the tree's structure, which hashes."""
    if type(tree) is dict:
        return dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items())
    if type(tree) in (list, tuple):
        return type(tree), tuple(_flatten(v, leaves) for v in tree)
    leaves.append(tree)
    return None


def _unflatten(struct, leaves: Iterator):
    if struct is None:
        return next(leaves)
    kind, parts = struct
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in parts}
    return kind(_unflatten(s, leaves) for s in parts)


def _describe(leaves: Sequence) -> tuple:
    """The leaves' part of a key: a tensor's shape, dtype, device and the
    first leaf that is the same tensor; any other leaf's value."""
    first = {}
    return tuple(
        (x.shape, x.dtype, x.device, first.setdefault(id(x), i))
        if torch.is_tensor(x) else ("value", x)
        for i, x in enumerate(leaves))


class _Segment:
    """A captured graph and the hand-written kernels' launches in it."""

    def __init__(self, graph: torch.cuda.CUDAGraph, counts: Dict[str, int]):
        self.graph, self.counts = graph, counts

    def run(self) -> None:
        self.graph.replay()
        if self.counts:
            kernels.add_launch_counts(self.counts)


class _Break:
    """An eager call between two segments and the buffers of its result,
    which the next segment reads."""

    def __init__(self, call: Callable, args: tuple, result):
        self.call, self.args = call, args
        self.out: List[torch.Tensor] = []
        _flatten(result, self.out)

    def run(self) -> None:
        got = []
        # fresh arguments: a wrapper that keeps them keeps this request's
        _flatten(self.call(*(a.clone() if torch.is_tensor(a) else a
                             for a in self.args)), got)
        for static, x in zip(self.out, got):
            static.copy_(x)


class _Tape:
    """One key's segments and breaks, the buffers of its arguments and its
    outputs.  Building it runs the stage: ``WARMUP_ITERS`` eager calls on
    the side ``stream``, then the capture there, each segment run as it
    closes so that the break after it reads its results."""

    def __init__(self, fn: Callable, leaves: list, struct,
                 owns: Callable[[torch.Tensor], bool],
                 stream: torch.cuda.Stream):
        counts = kernels.launch_counts()
        buffers = {}
        for x in leaves:
            if torch.is_tensor(x) and not owns(x) and id(x) not in buffers:
                buffers[id(x)] = torch.empty_like(x)
        self.inputs = [buffers.get(id(x), x) for x in leaves]
        self.firsts = []            # each tensor's first leaf
        seen = set()
        for i, x in enumerate(leaves):
            if torch.is_tensor(x) and id(x) not in seen:
                seen.add(id(x))
                self.firsts.append(i)
        self.load(leaves)
        args, kwargs = _unflatten(struct, iter(self.inputs))
        device = stream.device
        _warm_up(lambda: fn(*args, **kwargs), (), device, side=stream)

        self.steps = []
        # every capture, an empty one too, holds the pool: it ends with
        # the last graph that used it
        self.graphs = []
        self.pool = torch.cuda.graph_pool_handle()
        self._graph = None
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            try:
                self._open()
                library.cut = self._cut
                out = fn(*args, **kwargs)
                self._close()
            finally:
                library.cut = None
                if self._graph is not None:     # the capture failed
                    try:
                        self._graph.capture_end()
                    except RuntimeError:
                        pass                    # the first error is raised
        torch.cuda.current_stream(device).wait_stream(stream)
        self.outputs = []
        self.out_struct = _flatten(out, self.outputs)
        # the warm-up and the capture ran the stage: the replay that
        # follows counts this call
        now = kernels.launch_counts()
        kernels.add_launch_counts({k: counts[k] - n for k, n in now.items()})

    def tensors(self) -> List[torch.Tensor]:
        """Every buffer a caller may meet: arguments, outputs, results of
        breaks."""
        return [x for x in (*self.inputs, *self.outputs,
                            *(t for s in self.steps if isinstance(s, _Break)
                              for t in s.out))
                if torch.is_tensor(x)]

    def load(self, leaves: Sequence) -> None:
        """Copy each tensor argument into its buffer, unless it is that
        buffer."""
        for i in self.firsts:
            if leaves[i] is not self.inputs[i]:
                self.inputs[i].copy_(leaves[i])

    def replay(self, leaves: Sequence):
        # in place into buffers that an inference_mode capture made
        with torch.inference_mode():
            self.load(leaves)
            for step in self.steps:
                step.run()
        return _unflatten(self.out_struct, iter(self.outputs))

    def _open(self) -> None:
        self._counts = kernels.launch_counts()
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool)

    def _close(self) -> None:
        """End the segment under capture and run it; an empty one is no
        step."""
        graph, self._graph = self._graph, None
        self.graphs.append(graph)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in caught:
            if _EMPTY in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        if empty:
            return
        graph.replay()
        now = kernels.launch_counts()
        self.steps.append(_Segment(graph, {
            k: n - self._counts[k] for k, n in now.items()
            if n != self._counts[k]}))

    def _cut(self, call: Callable, *args):
        """A break: end the segment, run ``call(*args)`` eager, open the
        next segment; the result is the break's buffers."""
        self._close()
        library.cut = None
        try:
            result = call(*args)
        finally:
            library.cut = self._cut
        self.steps.append(_Break(call, args, result))
        self._open()
        return result


class _Stage(_Graphs):
    """One stage's tapes by key; its calls go to the stage record.  The
    stage's spans are opened around its call, so a replay opens none."""

    SPAN = None

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def _record(self, kind, reason) -> None:
        STAGE_GRAPH_RECORD.append(StageGraphEntry(self.name, kind, reason))


def probe_reason(captured: bool) -> Optional[str]:
    """"probe" where a probe (``probes/held.py``, ``probes/ties.py``) has
    swapped a kernel wrapper that the stage would not call as an eager
    forward does, else None: the gather, which a replay runs inside a
    segment, at any key; FPS or the ball query at a new key
    (``captured`` false), whose capture calls them more than once.  A
    replay calls the FPS and ball-query wrappers swapped in at that
    moment (the benchmark's call sites)."""
    if grouping.group_points_cuda is not kernels.group_points_cuda:
        return "probe"
    if not captured and (
            sampling.furthest_point_sample_cuda
            is not kernels.furthest_point_sample_cuda
            or grouping.ball_query_cuda is not kernels.ball_query_cuda):
        return "probe"
    return None


def kept(model: torch.nn.Module, tree):
    """``tree`` with each tensor that is a buffer of ``model``'s stage
    graphs cloned: what a caller may keep past the model's next
    forward."""
    graphs = getattr(model, "stage_graphs", None)
    if graphs is None:
        return tree
    leaves = []
    struct = _flatten(tree, leaves)
    return _unflatten(struct, iter([x.clone() if graphs.owns(x) else x
                                    for x in leaves]))


class StageGraphs:
    """A model's stage tapes (the module docstring)."""

    def __init__(self):
        self._stages: Dict[str, _Stage] = {}
        self._owned: Dict[int, torch.Tensor] = {}
        self._stream = None     # the tapes' side stream

    def owns(self, x) -> bool:
        """True where ``x`` is a tape's buffer, which the model's next
        forward may overwrite."""
        return self._owned.get(id(x)) is x

    def install(self, name: str, module: torch.nn.Module) -> None:
        """Route ``module``'s forward through ``self(name, ...)``: its
        ``__call__``, with its hooks, still brackets each call."""
        eager = module.forward

        def forward(*args, **kwargs):
            return self(name, eager, args, kwargs,
                        lambda: (*module.parameters(), *module.buffers()))
        module.forward = forward

    def __call__(self, stage: str, fn: Callable, args: tuple,
                 kwargs: Dict = None, tensors: Callable = tuple,
                 extra: tuple = ()):
        """``fn(*args, **kwargs)``, or the replay of its tape where the
        guards allow.  ``tensors()`` are what the stage reads in place
        (parameters, buffers); ``extra`` is what else its key holds."""
        kwargs = kwargs or {}
        leaves = []
        struct = _flatten((args, kwargs), leaves)
        stage_graphs = self._stages.get(stage) or self._stages.setdefault(
            stage, _Stage(stage))
        why = scene_eager_reason([x for x in leaves if torch.is_tensor(x)],
                                 pmesh.current() is not None)
        key = None
        if why is None:
            key = (struct, _describe(leaves),
                   tuple(t.data_ptr() for t in tensors()), extra)
            new = key not in stage_graphs._captures
            # a new key under a profiler is the dispatch's "profiler"
            if not (new and torch.autograd.profiler._is_profiler_enabled):
                why = probe_reason(not new)
        return stage_graphs._dispatch(
            lambda: fn(*args, **kwargs), (), why, lambda: key,
            lambda: self._tape(fn, leaves, struct),
            lambda tape: tape.replay(leaves))

    def _tape(self, fn: Callable, leaves: list, struct) -> _Tape:
        if self._stream is None:
            self._stream = torch.cuda.Stream(next(
                x for x in leaves if torch.is_tensor(x)).device)
        tape = _Tape(fn, leaves, struct, self.owns, self._stream)
        self._owned.update((id(t), t) for t in tape.tensors())
        return tape
