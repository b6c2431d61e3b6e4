"""The top-down decoder's loop as CUDA graphs: the teacher-forced decode,
forward and backward, and the free-running scene decodes, forward only.

``TopDownSceneCaptionModule._decode_loop`` runs ``max_des_len + 1``
teacher-forced steps of some forty small kernels each, and its backward
two to three times as many: launching them is most of a train step's host
time.  ``DecodeGraphs`` captures the loop's forward and backward at the
first call of a key, and from then on replays the two graphs inside one
autograd node (``_Replay``): the same kernels in the same order and
precision, one launch each way.

Both kinds of capture run eager for the same guards (``_guards``): a
tracer, a mesh (its collectives would sit inside the graph, and its eval
decode gathers its weights anew each call), a CPU, a capture under way.
``eager_reason`` adds the teacher-forced decode's grad condition: grad
enabled and something requiring grad.  A key is the decode's length, the
inputs' shapes, dtypes, device and which of them require grad, and the
decoder parameters' addresses and which of them require grad.  A new key
is captured at its first call, outside a profiler, at most
``MAX_CAPTURES`` of them; past that the loop runs eager.  Every call
appends its ``DecodeGraphEntry`` to ``utils/profiling.DECODE_GRAPH_RECORD``.

A replay's outputs are the forward graph's static buffers: the next
decode of the same key overwrites them.  The backward reads the
activations that the latest forward replay of the key saved, so the
backward of an earlier forward raises.  A train step consumes its decode
before it starts the next one.  Gradients come back as tensors of their
own.

``SceneDecodeGraphs`` does the same for the free-running scene decodes
(``max_des_len - 1`` steps, the argmax token fed back through the
embedding table on the device), which run under ``inference_mode`` or
``no_grad``: one forward graph a key (``_ForwardCapture``), no autograd
node.  ``scene_eager_reason`` adds their grad condition: grad disabled.
Its key is the decode's length, the inputs' shapes and dtypes (None for
an absent input), their device and the decoder parameters' addresses; it
keeps captures of its own, so evaluation shapes never take the
teacher-forced decode's.  A replay's outputs are copied out of the
graph's buffers: callers may keep a served caption across requests.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from scan2cap_torch.utils.profiling import (DECODE_GRAPH_RECORD,
                                            DecodeGraphEntry, annotate)

MAX_CAPTURES = 4
WARMUP_ITERS = 3            # PyTorch's own before a capture


def _guards(inputs: Sequence[Optional[torch.Tensor]],
            split: bool) -> Optional[str]:
    """Why either capture runs eager, past its grad condition, or None:
    "tracing" (``torch.export`` or ``torch.compile`` traces the call and
    must see the loop), "mesh" (``split``: under a mesh, whose collectives
    would sit inside the graph and whose eval decode gathers its weights
    anew each call), "cpu" (the first present input is not on a CUDA
    device), "capturing" (a CUDA graph capture is under way)."""
    if torch.compiler.is_compiling():
        return "tracing"
    if split:
        return "mesh"
    if next(x for x in inputs if x is not None).device.type != "cuda":
        return "cpu"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


def eager_reason(inputs: Sequence[torch.Tensor],
                 params: Sequence[torch.Tensor],
                 split: bool) -> Optional[str]:
    """Why a teacher-forced decode of ``inputs`` runs eager, or None where
    it may replay: "no_grad" (grad mode off, as under ``inference_mode``,
    or nothing requires grad), else ``_guards``'s reason."""
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in (*inputs, *params)):
        return "no_grad"
    return _guards(inputs, split)


def scene_eager_reason(inputs: Sequence[Optional[torch.Tensor]],
                       split: bool) -> Optional[str]:
    """Why a scene decode of ``inputs`` runs eager, or None where it may
    replay its forward graph: "grad" (grad mode on: a forward graph keeps
    no autograd history), else ``_guards``'s reason."""
    if torch.is_grad_enabled():
        return "grad"
    return _guards(inputs, split)


def _warm_up(fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
             device: torch.device, backward=None) -> None:
    """``WARMUP_ITERS`` calls of ``fn`` (and ``backward`` of its outputs)
    on a side stream, as PyTorch's own capture recipe warms up."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_ITERS):
            outs = fn(*inputs)
            if backward is not None:
                backward(outs)
        del outs
    torch.cuda.current_stream(device).wait_stream(side)


class _Capture:
    """One key's graphs and their static buffers: the forward, and a
    backward for each set of outputs a gradient may reach (all of them,
    or the first alone: a training loss reads the logits and not the
    attention)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 params: Sequence[torch.Tensor]):
        self.inputs = [x.detach().clone().requires_grad_(x.requires_grad)
                       for x in inputs]
        surface = self.inputs + list(params)
        self.wants = [t.requires_grad for t in surface]
        wrt = [t for t in surface if t.requires_grad]
        _warm_up(fn, self.inputs, inputs[0].device,
                 lambda outs: torch.autograd.grad(
                     outs, wrt, [torch.ones_like(o) for o in outs],
                     allow_unused=True))
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd):
            outputs = fn(*self.inputs)
        n = len(outputs)
        self.grad_outputs = [torch.zeros_like(o) for o in outputs]
        self.bwd = {}
        sets = [(True,) * n, (True,) + (False,) * (n - 1)]
        for present in dict.fromkeys(sets):
            graph = torch.cuda.CUDAGraph()
            # retain_graph: the saved activations stay where the forward
            # graph writes them, out of reach of the next capture
            with torch.cuda.graph(graph, pool=self.fwd.pool()):
                grads = torch.autograd.grad(
                    [o for o, p in zip(outputs, present) if p], wrt,
                    [g for g, p in zip(self.grad_outputs, present) if p],
                    retain_graph=True, allow_unused=True)
            self.bwd[present] = (graph, grads)
        # Drop their autograd graph: the activations stay in the graphs'
        # own pool, which no later allocation draws on, and the
        # parameters' gradient nodes are made anew on the caller's stream
        # (the capture's would sync every backward with its stream).
        self.outputs = [o.detach() for o in outputs]
        self.generation = 0

    def forward(self, inputs: Sequence[torch.Tensor]) -> int:
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.fwd.replay()
        self.generation += 1
        return self.generation

    def backward(self, grads: Sequence[Optional[torch.Tensor]]) -> list:
        present = tuple(g is not None for g in grads)
        if present not in self.bwd:
            present = (True,) * len(grads)      # zeros for the missing
        graph, out = self.bwd[present]
        for g, static, p in zip(grads, self.grad_outputs, present):
            if p and g is None:
                static.zero_()
            elif p:
                static.copy_(g)
        graph.replay()
        out = iter(out)
        result = []
        for wants in self.wants:
            g = next(out) if wants else None
            result.append(None if g is None else g.clone())
        return result


class _Replay(torch.autograd.Function):
    """The forward graph's replay; its backward replays a backward
    graph.  The arguments after the capture are its inputs, then the
    parameters the graphs read in place."""

    @staticmethod
    def forward(ctx, capture: _Capture, *surface: torch.Tensor):
        ctx.set_materialize_grads(False)
        ctx.capture = capture
        ctx.generation = capture.forward(surface[:len(capture.inputs)])
        # tensors of their own over the static buffers: autograd makes
        # each output this node's
        return tuple(o.detach() for o in capture.outputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        capture = ctx.capture
        if ctx.generation != capture.generation:
            raise RuntimeError(
                "the graphed decode ran again before this backward: its "
                "saved activations are those of the later decode")
        return (None, *capture.backward(grads))


class _ForwardCapture:
    """One key's forward graph of a decode under ``no_grad``, and its
    static buffers; an absent (None) input stays None."""

    def __init__(self, fn: Callable,
                 inputs: Sequence[Optional[torch.Tensor]]):
        # plain tensors even under inference_mode: a later call under
        # no_grad copies into them in place
        with torch.inference_mode(False):
            self.inputs = [None if x is None else torch.empty_like(x)
                           for x in inputs]
        self.load(inputs)
        _warm_up(fn, self.inputs, inputs[0].device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def load(self, inputs: Sequence[Optional[torch.Tensor]]) -> None:
        for static, x in zip(self.inputs, inputs):
            if static is not None:
                static.copy_(x)

    def replay(self, inputs: Sequence[Optional[torch.Tensor]]) -> tuple:
        """The outputs of ``fn(*inputs)``, as tensors of their own."""
        self.load(inputs)
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)


class _Graphs:
    """One decoder's captures, by key, and the record of every call."""

    def __init__(self):
        self._captures = {}

    def _dispatch(self, fn: Callable, inputs: Sequence, why: Optional[str],
                  key: Callable, make: Callable, replay: Callable):
        """``fn(*inputs)`` where ``why`` says it runs eager, else
        ``replay(capture)`` of ``key()``'s capture, which ``make()``
        captures at the key's first call."""
        capture, kind = None, "replay"
        if why is None:
            k = key()
            capture = self._captures.get(k)
            if capture is None:
                if torch.autograd.profiler._is_profiler_enabled:
                    why = "profiler"
                elif len(self._captures) >= MAX_CAPTURES:
                    why = "cap"
                else:
                    capture = self._captures[k] = make()
                    kind = "capture"
        if capture is None:
            DECODE_GRAPH_RECORD.append(DecodeGraphEntry("eager", why))
            return fn(*inputs)
        DECODE_GRAPH_RECORD.append(DecodeGraphEntry(kind, None))
        with annotate("scan2cap.decode"):
            return replay(capture)


class DecodeGraphs(_Graphs):
    """The teacher-forced decode's captures (the module docstring)."""

    def __call__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 params: Sequence[torch.Tensor], split: bool, steps: int):
        """``fn(*inputs)``, the eager decode of ``steps`` steps that reads
        ``params``, or the replay of its capture."""
        return self._dispatch(
            fn, inputs, eager_reason(inputs, params, split),
            lambda: (steps, inputs[0].device,
                     tuple((x.shape, x.dtype, x.requires_grad)
                           for x in inputs),
                     tuple((p.data_ptr(), p.requires_grad) for p in params)),
            lambda: _Capture(fn, inputs, params),
            lambda capture: _Replay.apply(capture, *inputs, *params))


class SceneDecodeGraphs(_Graphs):
    """The free-running scene decodes' forward captures (the module
    docstring)."""

    def __call__(self, fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
                 params: Sequence[torch.Tensor], split: bool, steps: int):
        """``fn(*inputs)``, the eager scene decode of ``steps`` steps that
        reads ``params``, or the replay of its capture."""
        return self._dispatch(
            fn, inputs, scene_eager_reason(inputs, split),
            lambda: (steps, next(x for x in inputs if x is not None).device,
                     tuple(None if x is None else (x.shape, x.dtype)
                           for x in inputs),
                     tuple(p.data_ptr() for p in params)),
            lambda: _ForwardCapture(fn, inputs),
            lambda capture: capture.replay(inputs))
