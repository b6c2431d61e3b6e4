"""CapNet's eval stages and the eval step's detection loss replayed as
CUDA graph segments (``scan2cap_torch/models/stage_graph.StageGraphs``)
against the eager stages.

On the card (marked ``cuda``; they skip without one), at the flagship's
shapes (8 rooms of 40,000 points and 135 columns, 256 proposals, the
top-down decoder over 3,433 words): three requests of distinct batches
through the graphed eval step give every kept output equal to the eager
stages', bit for bit, with and without the attention, and the first
request's outputs outlive the later replays; the FPS and ball-query
wrappers, swapped as the benchmark swaps them, see 5 + 5 calls a
replayed request with that request's inputs, which outlive the next
request; ``kernels.launch_counts()`` moves as much a request graphed as
eager; a second batch size captures a key of its own; a new key under a
profiler runs eager; a probe that holds the kernels against their plain
versions runs the stages eager and holds every launch; serving's answers
outlive the next request.  The eager stages are a model of the same
weights whose every call is a new key under a profiler; the card runs
deterministic algorithms (the ``card`` fixture).  Run them on the card
with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stage_graph.py -q``.

On the CPU, at a small configuration on one torch thread: the stages run
eager, bit for bit as the modules' own forwards, with reason ``cpu``; a
train step records ``grad`` and changes nothing; an exported forward
records ``tracing``; which swapped wrappers make a probe's reason;
``kept`` clones the stage graphs' buffers alone; the benchmark's reader
of the record.
"""

import contextlib
import importlib.util
import os
import types

import pytest
import torch

from scan2cap_torch import kernels
from scan2cap_torch.config import ModelConfig, flagship_config
from scan2cap_torch.data import synthetic
from scan2cap_torch.models import CapNet
from scan2cap_torch.models.stage_graph import (STAGES, StageGraphs, kept,
                                               probe_reason)
from scan2cap_torch.ops import grouping, sampling
from scan2cap_torch.probes.held import HeldAgainstPlain
from scan2cap_torch.scripts import export_model
from scan2cap_torch.train.step import (ATTN_KEYS, KEEP_KEYS,
                                       create_train_state, make_eval_step,
                                       make_train_step)
from scan2cap_torch.utils.profiling import (STAGE_GRAPH_RECORD,
                                            StageGraphEntry)

CALLS = STAGES + ("loss",)          # one eval request's stage calls, in order
FLAGSHIP_VOCABS = 3433
V = 20
SMALL = dict(num_points=512, sa_npoints=(64, 32, 16, 16), num_proposals=16,
             max_num_obj=8, hidden_size=32, emb_size=16, num_graph_steps=2,
             num_locals=4, use_topdown=True, use_relation=True,
             use_orientation=True, min_iou=-1.0, max_des_len=6)


@contextlib.contextmanager
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _condition(model):
    """A trained model's range for two layers (as the multi-card dry run
    conditions them): votes near their seeds, so that some proposals are
    positives, and graph messages of moderate size."""
    with torch.no_grad():
        model.vgen.conv3.weight.mul_(0.02)
        for layer in (model.graph.gc_0, model.graph.gc_1,
                      model.graph.edge_layer):
            layer.map_edge_1.weight.mul_(0.1)
    return model


def _batch(cfg, b, seed, vocab, device):
    return synthetic.to_device(synthetic.make_scene_batch(
        cfg, batch_size=b, num_objects=8, vocab=vocab, seed=seed), device)


def _since(n):
    return list(STAGE_GRAPH_RECORD)[n:]


def _eager(cfg, model, keep_attn=False):
    """The eager stages' eval step: every call of ``model`` (which nothing
    graphs) is a new key under a profiler."""
    step = make_eval_step(cfg, model, keep_attn=keep_attn)

    def run(batch):
        n = len(STAGE_GRAPH_RECORD)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = step(batch)
        assert _since(n) == [StageGraphEntry(s, "eager", "profiler")
                             for s in CALLS]
        return out
    return run


@pytest.fixture
def card():
    """The card, with deterministic algorithms: the graph module sums its
    messages with ``index_add_``, in an order that varies from run to run
    on CUDA otherwise, so that two eager forwards of one batch differ in
    their last bits.  Both sides of each comparison take the
    deterministic sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.use_deterministic_algorithms(deterministic[0],
                                       warn_only=deterministic[1])


def _keep_half(cfg, models, vocab, device):
    """Shift the objectness logits of ``models`` (of the same weights) by
    the median margin of a batch, so that about half of each batch's
    proposals are kept boxes (``bbox_mask``) and not none or all.  The
    margin is read from an eager forward with grad on."""
    with torch.enable_grad():
        scores = models[0](_batch(cfg, 8, 39, vocab, device))[
            "objectness_scores"].detach()
    shift = -float((scores[..., 1] - scores[..., 0]).median())
    with torch.no_grad():
        for model in models:
            model.proposal.conv3.bias[1] += shift


@pytest.fixture
def flagship(card):
    """The flagship's configuration, two models of the same weights (the
    graphed and the eager), the vocabulary."""
    cfg = flagship_config()
    vocab = synthetic.make_vocab(num_vocabs=FLAGSHIP_VOCABS,
                                 emb_size=cfg.emb_size)
    graphed, eager = (_condition(CapNet(cfg, num_vocabs=FLAGSHIP_VOCABS,
                                        device=card, seed=0))
                      for _ in range(2))
    _keep_half(cfg, (eager, graphed), vocab, card)
    return cfg, graphed, eager, vocab


def _equal(got, want, keys):
    assert set(got) == set(keys)
    for k in keys:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("keep_attn", [False, True],
                         ids=["outputs", "with_attention"])
def test_graphed_eval_steps_equal_the_eager_stages(flagship, card,
                                                   keep_attn):
    cfg, graphed, eager, vocab = flagship
    step = make_eval_step(cfg, graphed, keep_attn=keep_attn)
    reference = _eager(cfg, eager, keep_attn)
    keys = KEEP_KEYS + (ATTN_KEYS if keep_attn else ())
    kept = None
    for i in range(3):
        batch = _batch(cfg, 8, 40 + i, vocab, card)
        n = len(STAGE_GRAPH_RECORD)
        got = step(batch)
        assert _since(n) == [StageGraphEntry(s, "capture" if i == 0
                                             else "replay", None)
                             for s in CALLS]
        _equal(got, reference(batch), keys)
        assert got["bbox_mask"].any() and not got["bbox_mask"].all()
        assert len(got["lang_cap"].unique()) > 1
        if kept is None:
            kept = got, {k: v.clone() for k, v in got.items()}
    # the first request's answers are its own: later replays leave them be
    _equal(*kept, keys)


class _Sites:
    """The FPS and first-k wrappers swapped as the benchmark's call sites
    swap them, each call's inputs kept as they are, not copied."""

    def __enter__(self):
        self.saved = (sampling.furthest_point_sample_cuda,
                      grouping.ball_query_cuda)
        fps, bq = self.saved
        self.fps, self.first_k = [], []

        def fps_rec(xyz, npoint, **kw):
            self.fps.append((xyz, int(npoint)))
            return fps(xyz, npoint, **kw)

        def bq_rec(xyz, new_xyz, r2, nsample, **kw):
            self.first_k.append((xyz, new_xyz, float(r2), int(nsample)))
            return bq(xyz, new_xyz, r2, nsample, **kw)

        sampling.furthest_point_sample_cuda = fps_rec
        grouping.ball_query_cuda = bq_rec
        return self

    def __exit__(self, *exc):
        (sampling.furthest_point_sample_cuda,
         grouping.ball_query_cuda) = self.saved


def _same_calls(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert all(torch.equal(u, v) if torch.is_tensor(u) else u == v
                   for u, v in zip(x, y))


@pytest.mark.cuda
def test_replays_call_the_swapped_wrappers_with_their_inputs(flagship, card):
    cfg, graphed, eager, vocab = flagship
    step = make_eval_step(cfg, graphed)
    reference = _eager(cfg, eager)
    step(_batch(cfg, 8, 50, vocab, card))                   # the capture
    batches = [_batch(cfg, 8, seed, vocab, card) for seed in (51, 52)]
    # both requests' calls are read after the second: each kept its own
    with _Sites() as got:
        for batch in batches:
            step(batch)
    with _Sites() as want:
        for batch in batches:
            reference(batch)
    assert len(got.fps) == 10 and len(got.first_k) == 10
    for i, batch in enumerate(batches):
        assert torch.equal(got.fps[5 * i][0], batch["point_clouds"][..., :3])
    _same_calls(got.fps, want.fps)
    _same_calls(got.first_k, want.first_k)


def _launches(step, batch):
    before = kernels.launch_counts()
    step(batch)
    return {k: n - before[k] for k, n in kernels.launch_counts().items()}


@pytest.mark.cuda
def test_a_request_counts_the_same_launches_graphed_or_eager(flagship, card):
    cfg, graphed, eager, vocab = flagship
    step, reference = make_eval_step(cfg, graphed), _eager(cfg, eager)
    batches = [_batch(cfg, 8, 60 + i, vocab, card) for i in range(3)]
    want = _launches(reference, batches[0])
    assert want["furthest_point_sample_cuda"] == 5
    assert want["ball_query_cuda"] == 5
    assert want["group_points_cuda"] == 5
    # the capture, then two replays
    assert [_launches(step, b) for b in batches] == [want] * 3


@pytest.mark.cuda
def test_a_second_batch_size_captures_its_own_key(flagship, card):
    cfg, graphed, eager, vocab = flagship
    step, reference = make_eval_step(cfg, graphed), _eager(cfg, eager)
    for i, (b, kind) in enumerate([(8, "capture"), (3, "capture"),
                                   (8, "replay"), (3, "replay")]):
        batch = _batch(cfg, b, 70 + i, vocab, card)
        n = len(STAGE_GRAPH_RECORD)
        got = step(batch)
        assert _since(n) == [StageGraphEntry(s, kind, None) for s in CALLS]
        _equal(got, reference(batch), KEEP_KEYS)
    assert all(len(graphed.stage_graphs._stages[s]._captures) == 2
               for s in CALLS)


@pytest.mark.cuda
def test_a_new_key_under_a_profiler_runs_eager(flagship, card):
    cfg, graphed, _, vocab = flagship
    step = make_eval_step(cfg, graphed)
    batch = _batch(cfg, 8, 80, vocab, card)
    n = len(STAGE_GRAPH_RECORD)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(batch)
    step(batch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(batch)
    assert _since(n) == (
        [StageGraphEntry(s, "eager", "profiler") for s in CALLS]
        + [StageGraphEntry(s, "capture", None) for s in CALLS]
        + [StageGraphEntry(s, "replay", None) for s in CALLS])


@pytest.mark.cuda
def test_a_probe_runs_the_stages_eager_and_holds_every_launch(flagship,
                                                              card):
    cfg, graphed, eager, vocab = flagship
    step, reference = make_eval_step(cfg, graphed), _eager(cfg, eager)
    # a new key under the probe, the key's capture, a replay's key
    for i, kind in enumerate(["eager", "capture", "eager"]):
        batch = _batch(cfg, 8, 90 + i, vocab, card)
        n = len(STAGE_GRAPH_RECORD)
        if kind == "capture":
            step(batch)
        else:
            with HeldAgainstPlain() as held:
                got = step(batch)
            assert held.counts() == dict(furthest_point_sample_cuda=5,
                                         ball_query_cuda=5,
                                         group_points_cuda=5)
        assert _since(n) == [StageGraphEntry(
            s, kind, "probe" if kind == "eager" else None) for s in CALLS]
        if kind == "eager":
            _equal(got, reference(batch), KEEP_KEYS)


@pytest.mark.cuda
def test_serving_answers_outlive_the_next_request(flagship, card):
    cfg, graphed, _, vocab = flagship
    table = torch.as_tensor(vocab["emb_table"]).to(card)
    serve = export_model.Serve(graphed, table, table[2].clone()).eval()
    clouds = [_batch(cfg, 8, 100 + i, vocab, card)["point_clouds"]
              for i in range(3)]
    n = len(STAGE_GRAPH_RECORD)
    with torch.inference_mode():
        first = serve(clouds[0])                        # the capture
        saved = {k: v.clone() for k, v in first.items()}
        for c in clouds[1:]:
            serve(c)
    assert _since(n) == [StageGraphEntry(s, kind, None)
                         for kind in ("capture", "replay", "replay")
                         for s in STAGES]
    _equal(first, saved, saved.keys())


# --- on the CPU -------------------------------------------------------------
@pytest.fixture
def small():
    """The small configuration, two models of its weights (the second with
    its children's own forwards, past the stage graphs), a batch."""
    with one_torch_thread():
        cfg = ModelConfig(**SMALL)
        vocab = synthetic.make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
        batch = _batch(cfg, 2, 5, vocab, "cpu")
        routed, plain = (_condition(CapNet(cfg, num_vocabs=V, device="cpu"))
                         for _ in range(2))
        for name in STAGES:
            del getattr(plain, name).forward
        yield cfg, routed, plain, batch, vocab


def test_cpu_runs_the_stages_eager_bit_for_bit(small):
    cfg, routed, plain, batch, _ = small
    n = len(STAGE_GRAPH_RECORD)
    got = make_eval_step(cfg, routed, keep_attn=True)(batch)
    assert _since(n) == [StageGraphEntry(s, "eager", "cpu") for s in CALLS]
    want = make_eval_step(cfg, plain, keep_attn=True)(batch)
    _equal(got, want, KEEP_KEYS + ATTN_KEYS)
    with torch.inference_mode():
        got, want = (m(batch, use_tf=False, is_eval=True, train=False)
                     for m in (routed, plain))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got
               if torch.is_tensor(got[k]))
    assert not any(s._captures for s in routed.stage_graphs._stages.values())


def test_a_train_step_records_grad_and_changes_nothing(small):
    cfg, routed, plain, batch, _ = small
    metrics = []
    for model in (routed, plain):
        step = make_train_step(cfg, create_train_state(cfg, model),
                               detection=True, caption=True,
                               orientation=True)
        n = len(STAGE_GRAPH_RECORD)
        metrics.append(step(batch, 1e-3, 0.1))
        if model is routed:
            # the training forward's children; its loss is not a stage
            assert _since(n) == [StageGraphEntry(s, "eager", "grad")
                                 for s in STAGES]
    _equal(*metrics, metrics[1].keys())
    got, want = routed.state_dict(), plain.state_dict()
    _equal(got, want, want.keys())


def test_an_exported_forward_records_tracing(small):
    cfg, routed, plain, _, vocab = small
    table = torch.as_tensor(vocab["emb_table"])
    serve = export_model.Serve(routed, table, table[2].clone()).eval()
    n = len(STAGE_GRAPH_RECORD)
    program = export_model.export(serve, 1)
    assert _since(n) == [StageGraphEntry(s, "eager", "tracing")
                         for s in STAGES]
    clouds = _batch(cfg, 1, 9, vocab, "cpu")["point_clouds"]
    with torch.no_grad():
        got = program.module()(clouds)
        want = export_model.Serve(plain, table, table[2].clone()).eval()(
            clouds)
    _equal(got, want, want.keys())


@pytest.mark.parametrize("swapped, captured, want", [
    ((), False, None), ((), True, None),
    (("gather",), True, "probe"), (("gather",), False, "probe"),
    (("fps",), False, "probe"), (("fps", "first_k"), True, None),
    (("first_k",), False, "probe")],
    ids=["none_new", "none_captured", "gather_captured", "gather_new",
         "fps_new", "call_sites_captured", "first_k_new"])
def test_probe_reason(monkeypatch, swapped, captured, want):
    sites = dict(fps=(sampling, "furthest_point_sample_cuda"),
                 first_k=(grouping, "ball_query_cuda"),
                 gather=(grouping, "group_points_cuda"))
    for name in swapped:
        module, attr = sites[name]
        monkeypatch.setattr(module, attr, lambda *a, **k: None)
    assert probe_reason(captured) == want


def test_kept_clones_the_stage_graphs_buffers_alone():
    graphs = StageGraphs()
    buffer, own = torch.arange(4.0), torch.ones(3)
    graphs._owned[id(buffer)] = buffer
    model = types.SimpleNamespace(stage_graphs=graphs)
    out = kept(model, {"a": buffer, "b": own, "c": [buffer, 2]})
    assert out["b"] is own and out["c"][1] == 2
    for x in (out["a"], out["c"][0]):
        assert x is not buffer and torch.equal(x, buffer)
    tree = {"a": buffer}
    assert kept(torch.nn.Linear(1, 1), tree) is tree


def _reader():
    path = os.path.join(os.path.dirname(__file__), "..", "h100bench",
                        "metrics", "stage_graph_pct.serve.py")
    spec = importlib.util.spec_from_file_location("stage_graph_pct_serve",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _requests(*kinds):
    """One entry a stage for each request's kind."""
    return [StageGraphEntry(s, k, "profiler" if k == "eager" else None)
            for k in kinds for s in CALLS]


@pytest.mark.parametrize("entries, window, want", [
    (_requests("capture", "replay", "replay", "replay", "replay"), 3,
     100.0),
    (_requests("capture", "replay", "replay"), 3, 200.0 / 3.0),
    (_requests("eager", "eager", "replay", "eager"), 2, 50.0),
    (_requests("eager") * 4, 4, 0.0),
    (_requests("capture", "replay")
     + [StageGraphEntry("loss", "eager", "cap")], 1, 500.0 / 6.0),
    ([], 5, None),
    (_requests("replay") * 3, 0, None)],
    ids=["all", "with_the_capture", "half", "none", "cut_short", "empty",
         "no_window"])
def test_the_benchmark_reads_the_window_share_of_stage_replays(entries,
                                                                window, want):
    saved = list(STAGE_GRAPH_RECORD)
    try:
        STAGE_GRAPH_RECORD.clear()
        STAGE_GRAPH_RECORD.extend(entries)
        got = _reader()(types.SimpleNamespace(window_steps=window))
        assert got == pytest.approx(want) if want is not None else got is None
    finally:
        STAGE_GRAPH_RECORD.clear()
        STAGE_GRAPH_RECORD.extend(saved)
