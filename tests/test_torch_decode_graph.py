"""The top-down decoder's teacher-forced decode replayed as CUDA graphs
(``scan2cap_torch/models/decode_graph.py``) against its eager loop.

On the card (marked ``cuda``; they skip without one): at the flagship's
shapes (16 targets, 256 proposals, 31 steps, hidden 512, 3,433 words),
three successive decodes of distinct inputs through the graphs and
through the eager loop (``_decode_loop``): the logits, the attention,
the inputs' gradients and every decoder parameter's gradient agree
within 1e-6 of the largest magnitude, with a loss on the logits alone
and on both outputs; a second batch size captures a graph of its own.
Run them on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_graph.py -q``.

On the CPU: the decode runs the eager loop, bit for bit, and the record
says why; each capture's reasons to run eager, teacher-forced and scene
decodes side by side; the benchmark's reader of the record.
"""

import importlib.util
import os
import types
import warnings

import pytest
import torch

from scan2cap_torch.models import decode_graph
from scan2cap_torch.models.caption import TopDownSceneCaptionModule
from scan2cap_torch.utils.profiling import (DECODE_GRAPH_RECORD,
                                            DecodeGraphEntry)

FLAGSHIP = dict(num_vocabs=3433, emb_size=300, feat_size=128,
                hidden_size=512, num_locals=10)
TINY = dict(num_vocabs=24, emb_size=10, feat_size=16, hidden_size=20,
            num_locals=3)
STEPS = 31


def _module(dims, device, seed=0):
    torch.manual_seed(seed)
    return TopDownSceneCaptionModule(**dims).to(device)


def _inputs(dims, n, k, seed, device):
    """Leaf inputs of one decode: target_feat, obj_feats and mapped_obj
    require grad; the valid masks and the word embeddings do not."""
    g = torch.Generator().manual_seed(seed)
    c, h, e = dims["feat_size"], dims["hidden_size"], dims["emb_size"]
    valid = (torch.rand(n, k, generator=g) > 0.5).float()
    valid[:, 0] = 1
    xs = [torch.randn(n, c, generator=g), torch.randn(n, k, c, generator=g),
          torch.randn(n, k, h, generator=g), valid,
          torch.randn(n, STEPS + 1, e, generator=g)]
    return [x.to(device).requires_grad_(i < 3) for i, x in enumerate(xs)]


def _graphed(module):
    """The teacher-forced decode as the module dispatches it."""
    return lambda *inputs: module._decode(module._teacher_reader,
                                          list(inputs), STEPS, teacher=True)


def _eager(module):
    """The teacher-forced decode's eager loop, which the graphs capture."""
    return lambda *inputs: module._decode_loop(
        module._teacher_reader, *inputs, num_steps=STEPS, teacher=True)


def _run(module, decode, inputs, attn_loss, seed):
    """Outputs and gradients of one decode under a seeded linear loss on
    the logits, and on the attention too with ``attn_loss``."""
    for p in module.parameters():
        p.grad = None
    for x in inputs:
        x.grad = None
    logits, attn = decode(*inputs)
    g = torch.Generator().manual_seed(seed)
    loss = (logits * torch.randn(logits.shape, generator=g).to(
        logits.device)).sum()
    if attn_loss:
        loss = loss + (attn * torch.randn(attn.shape, generator=g).to(
            attn.device)).sum()
    loss.backward()
    out = {"logits": logits.detach().clone(), "attn": attn.detach().clone()}
    out.update((f"grad {i}", x.grad.clone())
               for i, x in enumerate(inputs) if x.requires_grad)
    out.update((f"grad {n}", p.grad.clone())
               for n, p in module.named_parameters() if p.grad is not None)
    return out


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _check_against_eager(module, inputs, attn_loss, seed, kind):
    got = _run(module, _graphed(module), inputs, attn_loss, seed)
    assert DECODE_GRAPH_RECORD[-1] == DecodeGraphEntry(kind, None)
    want = _run(module, _eager(module), inputs, attn_loss, seed)
    assert got.keys() == want.keys()
    decoder = {f"grad {name}.{n}" for name in module.DECODER
               for n, _ in getattr(module, name).named_parameters()}
    assert decoder <= got.keys()
    assert {"grad 0", "grad 1", "grad 2"} <= got.keys()
    gaps = {k: _gap(got[k], want[k]) for k in want}
    assert max(gaps.values()) <= 1e-6, gaps


@pytest.mark.cuda
def test_replays_agree_with_the_eager_loop_at_the_flagship_shapes(card):
    module = _module(FLAGSHIP, card)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for i, attn_loss in enumerate([False, True, False]):
            inputs = _inputs(FLAGSHIP, 16, 256, 10 + i, card)
            _check_against_eager(module, inputs, attn_loss, 20 + i,
                                 "capture" if i == 0 else "replay")
    # the parameters' gradients are accumulated on the stream that
    # produced them, not on the capture's
    assert not [w for w in seen if "stream" in str(w.message)]


@pytest.mark.cuda
def test_a_second_batch_size_captures_its_own_graph(card):
    module = _module(FLAGSHIP, card)
    for i, (n, kind) in enumerate([(16, "capture"), (9, "capture"),
                                   (16, "replay"), (9, "replay")]):
        _check_against_eager(module, _inputs(FLAGSHIP, n, 256, 30 + i, card),
                             True, 40 + i, kind)
    assert len(module._decode_graphs._captures) == 2


@pytest.mark.cuda
def test_a_backward_after_a_later_decode_raises(card):
    module = _module(TINY, card)
    first = _graphed(module)(*_inputs(TINY, 4, 12, 1, card))
    _graphed(module)(*_inputs(TINY, 4, 12, 2, card))
    with pytest.raises(RuntimeError, match="ran again"):
        first[0].sum().backward()


def test_cpu_runs_the_eager_loop_bit_for_bit():
    module = _module(TINY, "cpu")
    for i, attn_loss in enumerate([False, True]):
        inputs = _inputs(TINY, 3, 12, i, "cpu")
        got = _run(module, _graphed(module), inputs, attn_loss, 5 + i)
        assert DECODE_GRAPH_RECORD[-1] == DecodeGraphEntry("eager", "cpu")
        want = _run(module, _eager(module), inputs, attn_loss, 5 + i)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_without_grad_the_record_says_eager(mode):
    module = _module(TINY, "cpu")
    inputs = [x.detach() for x in _inputs(TINY, 2, 12, 3, "cpu")]
    with getattr(torch, mode)():
        logits, attn = _graphed(module)(*inputs)
    assert DECODE_GRAPH_RECORD[-1] == DecodeGraphEntry("eager", "no_grad")
    with torch.no_grad():
        want = _eager(module)(*inputs)
    assert torch.equal(logits, want[0]) and torch.equal(attn, want[1])


# The grad mode of each case; the others take their capture's own (grad
# on teacher-forced, off for the scene decodes) to reach the shared guards.
GRAD_MODE = {"grad_off": False, "absent_first": False, "grad_on": True,
             "nothing_requires_grad": True}


@pytest.mark.parametrize("kind, case, reason", [
    ("teacher", "grad_off", "no_grad"),
    ("teacher", "nothing_requires_grad", "no_grad"),
    ("teacher", "split", "mesh"), ("teacher", "grad_on", "cpu"),
    ("teacher", "tracing", "tracing"),
    ("scene", "grad_on", "grad"), ("scene", "nothing_requires_grad", "grad"),
    ("scene", "tracing", "tracing"),
    ("scene", "split", "mesh"), ("scene", "grad_off", "cpu"),
    ("scene", "absent_first", "cpu")])
def test_eager_reason(kind, case, reason, monkeypatch):
    """Each capture's reason to run eager.  The grad condition is each
    capture's own, and grad off is where the two part: the teacher-forced
    capture records a backward and wants grad, the scene decodes' forward
    capture keeps no autograd history and wants none.  A tracer, a mesh
    and a CPU stop both."""
    module = _module(TINY, "cpu")
    inputs = _inputs(TINY, 2, 12, 4, "cpu")
    params = list(module.parameters())
    if case == "nothing_requires_grad":
        inputs = [x.detach() for x in inputs]
        for p in params:
            p.requires_grad_(False)
    if case == "absent_first":
        inputs = [None] + inputs
    if case == "tracing":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    split = case == "split"
    with torch.set_grad_enabled(GRAD_MODE.get(case, kind == "teacher")):
        got = (decode_graph.eager_reason(inputs, params, split)
               if kind == "teacher"
               else decode_graph.scene_eager_reason(inputs, split))
    assert got == reason


def _reader():
    path = os.path.join(os.path.dirname(__file__), "..", "h100bench",
                        "metrics", "decode_graph_pct.train.py")
    spec = importlib.util.spec_from_file_location("decode_graph_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("kinds, window, want", [
    (["capture"] + ["replay"] * 6, 6, 100.0),
    (["replay", "eager", "replay", "eager"], 4, 50.0),
    (["replay"] * 3 + ["eager"] * 3, 3, 0.0),
    (["replay"] * 3, 0, None)])
def test_the_benchmark_reads_the_window_share_of_replays(kinds, window,
                                                          want):
    saved = list(DECODE_GRAPH_RECORD)
    try:
        DECODE_GRAPH_RECORD.clear()
        DECODE_GRAPH_RECORD.extend(
            DecodeGraphEntry(k, "cpu" if k == "eager" else None)
            for k in kinds)
        assert _reader()(types.SimpleNamespace(window_steps=window)) == want
    finally:
        DECODE_GRAPH_RECORD.clear()
        DECODE_GRAPH_RECORD.extend(saved)
