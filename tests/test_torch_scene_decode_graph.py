"""The top-down decoder's free-running scene decodes replayed as forward
CUDA graphs (``scan2cap_torch/models/decode_graph.SceneDecodeGraphs``)
against their eager loops.

On the card (marked ``cuda``; they skip without one): at the flagship's
shapes (8 scenes of 256 proposals, 10 local slots, 29 steps, hidden 512,
3,433 words), three successive local decodes of distinct inputs under
``inference_mode`` give tokens and attention equal to the eager loop's
(``_decode_loop`` with ``_local_reader``), bit for bit, and a returned
tensor outlives the next replay; the full-K decode (``num_locals`` -1),
with and without relation features, over chunks with a short last one,
equals its eager loop; a second batch size captures a key of its own.
Run them on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scene_decode_graph.py -q``.

On the CPU: the scene decodes run their eager loop, bit for bit, and the
record says why (the reasons to run eager are in
``tests/test_torch_decode_graph.py``); a ``torch.export`` trace sees the
loop; the benchmark's reader of the record.
"""

import importlib.util
import os
import types

import pytest
import torch

from scan2cap_torch.models.caption import TopDownSceneCaptionModule
from scan2cap_torch.utils.profiling import (DECODE_GRAPH_RECORD,
                                            DecodeGraphEntry)

FLAGSHIP = dict(num_vocabs=3433, emb_size=300, feat_size=128,
                hidden_size=512, num_locals=10)
TINY = dict(num_vocabs=24, emb_size=10, feat_size=16, hidden_size=20,
            num_locals=3)
STEPS = 29


def _module(dims, device, seed=0, **kw):
    torch.manual_seed(seed)
    return TopDownSceneCaptionModule(**dims, max_des_len=STEPS + 1,
                                     **kw).to(device)


def _local_inputs(dims, b, k, seed, device):
    """The local decode's inputs: targets (b, k, C), attention bases
    (b, k, L, H), slot contexts (b, k, L, C), the first input expanded
    from one sos embedding a scene, the embedding table."""
    g = torch.Generator().manual_seed(seed)
    c, h, e = dims["feat_size"], dims["hidden_size"], dims["emb_size"]
    L, v = dims["num_locals"], dims["num_vocabs"]
    sos = torch.randn(b, 1, e, generator=g)
    xs = [torch.randn(b, k, c, generator=g),
          torch.randn(b, k, L, h, generator=g),
          torch.randn(b, k, L, c, generator=g), sos,
          torch.randn(v, e, generator=g)]
    xs = [x.to(device) for x in xs]
    xs[3] = xs[3].expand(b, k, e)
    return xs


def _scene_batch(dims, b, k, seed, device, relation=False, nbrs=4):
    """A seeded batch for ``forward_scene_batch``: boxes, masks, proposal
    features, the sos embedding, the table, and with ``relation``
    distinct neighbour lists and their edge features."""
    g = torch.Generator().manual_seed(seed)
    c, e, v = dims["feat_size"], dims["emb_size"], dims["num_vocabs"]
    centers = torch.rand(b, k, 1, 3, generator=g) * 4.0
    offsets = torch.stack(torch.meshgrid(
        *[torch.tensor([0.0, 1.0])] * 3, indexing="ij"), -1).reshape(
            1, 1, 8, 3)
    corners = centers + offsets * (0.3 + torch.rand(b, k, 1, 1, generator=g))
    mask = (torch.rand(b, k, generator=g) > 0.25).float()
    mask[:, 0] = 1
    d = {"lang_feat": torch.randn(b, 3, e, generator=g),
         "bbox_feature": torch.randn(b, k, c, generator=g),
         "bbox_mask": mask, "bbox_corner": corners,
         "glove_emb_table": torch.randn(v, e, generator=g)}
    if relation:
        d["edge_feature"] = torch.randn(b, k, nbrs, c, generator=g)
        d["edge_nbr_idx"] = torch.stack([torch.stack(
            [torch.randperm(k, generator=g)[:nbrs] for _ in range(k)])
            for _ in range(b)]).to(torch.int32)
    return {n: x.to(device) for n, x in d.items()}


def _local_eager(module, inputs):
    """The local decode's eager loop, which its graph captures."""
    return module._decode_loop(module._local_reader, *inputs,
                               num_steps=STEPS)


def _eager_scene(module, d):
    """The scene decode's eager loop: grad enabled keeps it off the
    graphs (reason ``grad``); the loop's kernels are the same."""
    with torch.enable_grad():
        out = module.forward_scene_batch(d)
    assert DECODE_GRAPH_RECORD[-1] == DecodeGraphEntry("eager", "grad")
    return {n: out[n].detach() for n in ("lang_cap", "topdown_attn")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _local_against_eager(module, inputs, kind):
    with torch.inference_mode():
        got = module._decode(module._local_reader, inputs, STEPS)
        assert DECODE_GRAPH_RECORD[-1] == DecodeGraphEntry(kind, None)
        want = _local_eager(module, inputs)
    assert got[0].dtype == torch.int32 and len(torch.unique(got[0])) > 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return got


@pytest.mark.cuda
def test_local_replays_equal_the_eager_loop_at_the_flagship_shapes(card):
    module = _module(FLAGSHIP, card)
    kept = None
    for i in range(3):
        got = _local_against_eager(
            module, _local_inputs(FLAGSHIP, 8, 256, 10 + i, card),
            "capture" if i == 0 else "replay")
        assert got[0].shape == (8, 256, STEPS)
        assert got[1].shape == (8, 256, STEPS, 10)
        if kept is None:
            kept = got, [x.clone() for x in got]
    # the first call's tensors are its own: later replays leave them be
    (first, copies) = kept
    assert all(torch.equal(x, c) for x, c in zip(first, copies))
    assert len(module._scene_graphs._captures) == 1
    assert not module._decode_graphs._captures


@pytest.mark.cuda
@pytest.mark.parametrize("relation", [False, True])
def test_full_scene_replays_equal_the_eager_loop(card, relation):
    module = _module(dict(FLAGSHIP, num_locals=-1), card,
                     use_relation=relation, eval_chunk=32)
    for i in range(2):
        # 80 targets: chunks of 32, 32 and a short last one of 16
        d = _scene_batch(FLAGSHIP, 4, 80, 20 + i, card, relation)
        n = len(DECODE_GRAPH_RECORD)
        with torch.inference_mode():
            got = module.forward_scene_batch(d)
        kinds = [e.kind for e in list(DECODE_GRAPH_RECORD)[n:]]
        assert kinds == (["capture", "replay", "capture"] if i == 0
                         else ["replay"] * 3)
        want = _eager_scene(module, d)
        assert len(torch.unique(got["lang_cap"])) > 1
        assert torch.equal(got["lang_cap"], want["lang_cap"])
        assert torch.equal(got["topdown_attn"], want["topdown_attn"])
    assert len(module._scene_graphs._captures) == 2


@pytest.mark.cuda
def test_a_second_scene_batch_size_captures_its_own_key(card):
    module = _module(FLAGSHIP, card)
    for i, (b, kind) in enumerate([(8, "capture"), (3, "capture"),
                                   (8, "replay"), (3, "replay")]):
        _local_against_eager(
            module, _local_inputs(FLAGSHIP, b, 256, 30 + i, card), kind)
    assert len(module._scene_graphs._captures) == 2


@pytest.mark.parametrize("num_locals, relation", [
    (3, False), (3, True), (-1, False), (-1, True)],
    ids=["local", "local_relation", "full", "full_relation"])
def test_cpu_runs_the_scene_decodes_eager_bit_for_bit(num_locals, relation):
    module = _module(dict(TINY, num_locals=num_locals), "cpu",
                     use_relation=relation, eval_chunk=5)
    d = _scene_batch(TINY, 2, 12, 7, "cpu", relation)
    n = len(DECODE_GRAPH_RECORD)
    with torch.inference_mode():
        got = module.forward_scene_batch(d)
    # one decode a forward; the full-K decode one a chunk of 5, 5 and 2
    assert list(DECODE_GRAPH_RECORD)[n:] == (
        [DecodeGraphEntry("eager", "cpu")] * (1 if num_locals > 0 else 3))
    want = _eager_scene(module, d)
    assert torch.equal(got["lang_cap"], want["lang_cap"])
    assert torch.equal(got["topdown_attn"], want["topdown_attn"])
    assert not module._scene_graphs._captures


class _LocalDecode(torch.nn.Module):
    def __init__(self, caption):
        super().__init__()
        self.caption = caption

    def forward(self, tgt, base, ctx, first, table):
        return self.caption._decode(
            self.caption._local_reader, [tgt, base, ctx, first, table], STEPS)


def test_an_exported_scene_decode_traces_the_eager_loop():
    module = _module(TINY, "cpu")
    inputs = [x.contiguous() for x in _local_inputs(TINY, 1, 4, 5, "cpu")]
    with torch.no_grad():
        program = torch.export.export(_LocalDecode(module), tuple(inputs),
                                      strict=False)
        assert DECODE_GRAPH_RECORD[-1] == DecodeGraphEntry("eager",
                                                           "tracing")
        got = program.module()(*inputs)
        want = _local_eager(module, inputs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _reader():
    path = os.path.join(os.path.dirname(__file__), "..", "h100bench",
                        "metrics", "decode_graph_pct.serve.py")
    spec = importlib.util.spec_from_file_location("decode_graph_pct_serve",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("kinds, window, want", [
    (["capture", "replay", "replay"] + ["replay"] * 8, 8, 100.0),
    (["capture"] + ["replay"] * 3, 4, 75.0),
    (["replay", "eager", "eager", "eager"], 4, 25.0),
    (["eager"] * 5, 5, 0.0),
    ([], 5, None),
    (["replay"] * 3, 0, None)])
def test_the_benchmark_reads_the_window_share_of_scene_replays(kinds, window,
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
