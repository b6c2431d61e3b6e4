"""The program's spans and step record (``utils/profiling.py``), on the CPU.

* A CapNet eval step, a CapNet train step and a MaskVoteNet train step
  under ``profiling.trace``: the trace holds the ``scan2cap.*`` spans of
  each, every one inside that step's ``scan2cap.step`` on its thread,
  ``scan2cap.decode`` inside ``scan2cap.caption``; MaskVoteNet has no
  graph, caption or decode span.
* With no profiler running a step enters no ``record_function`` but
  the two that torch's ``Optimizer`` opens around ``zero_grad`` and
  ``step`` itself, and ``annotate`` hands out one shared null context;
  each step adds one
  entry to ``STEP_RECORD``, flagged traced under a profiler and untraced
  without one.  The record is bounded.
* The ``torch.export`` serving program (``scripts/export_model.py``)
  holds no profiler op.

Each tiny model is built once for the module.
"""

import json

import pytest
import torch

from scan2cap_torch.config import ModelConfig
from scan2cap_torch.data import synthetic
from scan2cap_torch.models import CapNet
from scan2cap_torch.models.mask_votenet import MaskVoteNet
from scan2cap_torch.scripts import export_model
from scan2cap_torch.train.step import (create_train_state, make_eval_step,
                                       make_mask_votenet_step,
                                       make_train_step)
from scan2cap_torch.utils import profiling

V = 20
CAPNET = dict(num_points=512, sa_npoints=(64, 32, 16, 16), num_proposals=16,
              max_num_obj=8, hidden_size=32, emb_size=16, num_graph_steps=2,
              num_locals=4, use_topdown=True, use_relation=True,
              use_orientation=True, min_iou=-1.0, max_des_len=6)
MVN = dict(num_points=512, sa_npoints=(64, 32, 16, 8), num_proposals=1,
           max_num_obj=1, use_normal=True, use_multiview=True,
           no_caption=True)
STAGES = ("scan2cap.backbone", "scan2cap.vote", "scan2cap.proposal")
CAPTION = ("scan2cap.graph", "scan2cap.caption", "scan2cap.decode")
TRAIN = ("scan2cap.loss", "scan2cap.backward", "scan2cap.optimizer")
# opened by torch.optim.Optimizer itself, with or without a profiler
TORCH_OPTIMIZER = ("Optimizer.zero_grad#Adam.zero_grad",
                   "Optimizer.step#Adam.step")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def steps():
    """name -> (the step's one call, the spans it must open)."""
    cfg = ModelConfig(**CAPNET)
    vocab = synthetic.make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    batch = synthetic.to_device(synthetic.make_scene_batch(
        cfg, batch_size=2, num_objects=3, vocab=vocab, seed=5), "cpu")
    model = CapNet(cfg, num_vocabs=V, device="cpu")
    evaluate = make_eval_step(cfg, model)
    train = make_train_step(cfg, create_train_state(cfg, model),
                            detection=True, caption=True, orientation=True)
    mcfg = ModelConfig(**MVN)
    mbatch = synthetic.to_device(
        synthetic.make_mask_votenet_batch(mcfg, 2, num_objects=3, seed=5),
        "cpu")
    mvn = make_mask_votenet_step(
        mcfg, create_train_state(mcfg, MaskVoteNet(mcfg, device="cpu")))
    return {
        "capnet-eval": (lambda: evaluate(batch),
                        STAGES + CAPTION + ("scan2cap.loss",)),
        "capnet-train": (lambda: train(batch, 1e-3, 0.1),
                         STAGES + CAPTION + TRAIN),
        "mvn-train": (lambda: mvn(mbatch, 1e-3, 0.1), STAGES + TRAIN),
        "model": (model, cfg),
    }


def spans_of(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("scan2cap.")]


def inside(inner, outer):
    return (inner[3] == outer[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


@pytest.mark.parametrize("name", ["capnet-eval", "capnet-train",
                                  "mvn-train"])
def test_a_step_opens_its_spans_nested(steps, name, tmp_path):
    call, want = steps[name]
    before = len(profiling.STEP_RECORD)
    with profiling.trace(str(tmp_path)):
        call()
    spans = spans_of(tmp_path / "trace.json")
    names = {s[0] for s in spans}
    assert names == {profiling.STEP_SPAN, *want}, names
    step = [s for s in spans if s[0] == profiling.STEP_SPAN]
    assert len(step) == 1
    for s in spans:
        assert s is step[0] or inside(s, step[0]), s
    captions = [s for s in spans if s[0] == "scan2cap.caption"]
    for s in spans:
        if s[0] == "scan2cap.decode":
            assert any(inside(s, c) for c in captions), s
    # the train steps decode once (teacher forcing); the eval step's
    # top-down decode over local slots once too
    assert sum(s[0] == "scan2cap.decode" for s in spans) == (
        0 if name == "mvn-train" else 1)
    assert len(profiling.STEP_RECORD) == before + 1
    assert profiling.STEP_RECORD[-1].traced
    assert profiling.STEP_RECORD[-1].seconds > 0.0


def test_no_profiler_no_record_function(steps, monkeypatch):
    entered = []
    cls = torch.autograd.profiler.record_function
    enter = cls.__enter__

    def counted(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(cls, "__enter__", counted)
    assert torch.profiler.record_function is cls
    assert profiling.annotate("a") is profiling.annotate("b")
    before = len(profiling.STEP_RECORD)
    for name in ("capnet-eval", "capnet-train", "mvn-train"):
        steps[name][0]()
    assert set(entered) <= set(TORCH_OPTIMIZER), entered
    new = list(profiling.STEP_RECORD)[before:]
    assert len(new) == 3 and not any(e.traced for e in new)
    assert all(e.seconds > 0.0 for e in new)
    # the counting reaches a span once a profiler runs
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("scan2cap.x"):
            pass
    assert entered[-1] == "scan2cap.x"


def test_the_step_record_is_bounded():
    saved = list(profiling.STEP_RECORD)
    try:
        assert profiling.RECORD_LEN >= 4096
        assert profiling.STEP_RECORD.maxlen == profiling.RECORD_LEN
        for _ in range(profiling.RECORD_LEN + 10):
            with profiling.program_step():
                pass
        assert len(profiling.STEP_RECORD) == profiling.RECORD_LEN
        assert not any(e.traced for e in profiling.STEP_RECORD)
    finally:
        profiling.STEP_RECORD.clear()
        profiling.STEP_RECORD.extend(saved)


def test_the_exported_serving_program_holds_no_profiler_op(steps):
    model, cfg = steps["model"]
    table = torch.as_tensor(synthetic.make_vocab(
        num_vocabs=V, emb_size=cfg.emb_size)["emb_table"])
    serve = export_model.Serve(model, table, table[2].clone()).eval()
    program = export_model.export(serve, 1)
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert targets and not any("profiler" in t for t in targets), targets
