"""Whole runs of each path at a tiny size on the CPU, past the harness's
look for a card: the frozen reference equals the port's served answers
and train steps; the lower-precision control and each fault that a cell
can have, planted under the timed path, make ``correct`` false."""

import pytest
import torch

from h100bench.paths import serve, train
from h100bench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
CELLS = ["flagship-serve-b8", "maskvotenet-train-b16", "flagship-train-b16"]


def run(cell):
    c = tiny.cell(cell)
    path = serve if c.traffic["path"] == "serve" else train
    return path.run(c, SEED, 0.5, False, CPU, 0.0)


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_equals_the_reference(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    for check in r["checks"].values():
        assert check["value"] <= check["limit"] / 10


def test_serving_control_fails():
    c = tiny.cell("flagship-serve-b8")
    model, step, pool = serve.build(c, SEED, CPU)
    served = [(i, serve.answer(step, pool[i])) for i in range(2)]
    got = serve.judge(c, SEED, pool, served, CPU, "tf32")
    assert any(got[k] > c.limits[k] for k in got), got


@pytest.mark.parametrize("cell", CELLS[1:])
def test_training_control_fails(cell):
    c = tiny.cell(cell)
    _, _, _, pool = train.build(c, SEED, CPU)
    kept = pool[:c.traffic["checked_steps"]]
    want = train.reference_steps(c, SEED, kept, CPU)
    got = train.compare(train.reference_steps(c, SEED, kept, CPU, "tf32"),
                        want)
    assert any(got[k] > c.limits[k] for k in c.limits), got


def altered_token(make_eval_step):
    def make(cfg, model, **kw):
        step = make_eval_step(cfg, model, **kw)

        def faulty(batch):
            out = step(batch)
            cap = out["lang_cap"].clone()
            cap[0, 0, 0] = (cap[0, 0, 0] + 1) % model.caption.num_vocabs
            out["lang_cap"] = cap
            return out
        return faulty
    return make


def half_batch_served(make_eval_step):
    def make(cfg, model, **kw):
        step = make_eval_step(cfg, model, **kw)

        def faulty(batch):
            B = batch["point_clouds"].shape[0]
            half = {k: (v if k == "glove_emb_table" else v[:B // 2])
                    for k, v in batch.items()}
            out = step(half)
            return {k: torch.cat([v, v], 0) for k, v in out.items()}
        return faulty
    return make


def unchanged_state(make):
    def build(cfg, state, *a, **kw):
        step = make(cfg, state, *a, **kw)

        def faulty(batch, lr, m):
            saved = {k: v.clone() for k, v in state.model.state_dict().items()}
            out = step(batch, lr, m)
            state.model.load_state_dict(saved)
            return out
        return faulty
    return build


def half_batch_trained(make):
    def build(cfg, state, *a, **kw):
        step = make(cfg, state, *a, **kw)

        def faulty(batch, lr, m):
            B = batch["point_clouds"].shape[0]
            return step({k: (v if k == "glove_emb_table" else v[:B // 2])
                         for k, v in batch.items()}, lr, m)
        return faulty
    return build


FAULTS = [
    ("flagship-serve-b8", "make_eval_step", altered_token),
    ("flagship-serve-b8", "make_eval_step", half_batch_served),
    ("maskvotenet-train-b16", "make_mask_votenet_step", unchanged_state),
    ("maskvotenet-train-b16", "make_mask_votenet_step", half_batch_trained),
    ("flagship-train-b16", "make_train_step", unchanged_state),
    ("flagship-train-b16", "make_train_step", half_batch_trained),
]


@pytest.mark.parametrize("cell,entry,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_a_fault_under_the_timed_path_fails(monkeypatch, cell, entry, fault):
    import scan2cap_torch.train.step as step_module
    monkeypatch.setattr(step_module, entry,
                        fault(getattr(step_module, entry)))
    r = run(cell)
    assert not r["correct"], r["checks"]
