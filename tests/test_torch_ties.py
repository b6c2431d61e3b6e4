"""The near-tie proof of ``scan2cap_torch.probes.ties`` on the CPU.

The card's run and the CPU's run are both the plain versions here, on two
inputs a few float32 ulps apart, as the card's and the CPU's coordinates
are: the picks part at a crafted near tie, the part is proven, and the
replayed run goes on from the recording side's picks.  A part beyond the
bound fails with the stage and the step named; identical runs replay
nothing.
"""

import math

import numpy as np
import pytest
import torch

from scan2cap_torch.ops import grouping, sampling
from scan2cap_torch.probes import ties
from scan2cap_torch.probes.ties import TieProof

EPS = np.float32(2e-6)
RADIUS = 0.3
NSAMPLE = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fps_scenes():
    """Two candidates 1 from the first pick, each side's one moved out by
    EPS: the card picks point 2 at step 1, the CPU point 1."""
    rs = np.random.RandomState(0)
    base = rs.rand(2, 64, 3).astype(np.float32) * 0.1 + np.float32([0, 0, 1])
    base[:, 0] = [0, 0, 1]
    base[:, 1] = [1, 0, 1]
    base[:, 2] = [-1, 0, 1]
    card, cpu = base.copy(), base.copy()
    card[:, 2, 0] -= EPS
    cpu[:, 1, 0] += EPS
    return torch.from_numpy(card), torch.from_numpy(cpu)


def _pipeline(x):
    """FPS, the first-k around its picks and the gather, through the ops."""
    idx = sampling.furthest_point_sample(x, 8)
    q = sampling.gather_points(x, idx)
    bq = grouping.ball_query(x, q, RADIUS, NSAMPLE)
    return idx, bq, grouping.group_points(x, bq)


def _radius_point():
    """The float32 x of a point (x, 0, 1) whose squared distance from the
    query (0, 0, 1) is the last one below r2, and the next x, above it."""
    r2 = grouping.radius_squared(RADIUS)
    x = np.float32(RADIUS)

    def d2(v):
        t = torch.tensor([v], dtype=torch.float32)
        z = torch.zeros(1)
        return float(grouping.sq_dist_elementwise(t, z, z)[0])

    while d2(x) >= r2:
        x = np.nextafter(x, np.float32(0))
    while d2(np.nextafter(x, np.float32(1))) < r2:
        x = np.nextafter(x, np.float32(1))
    return x, np.nextafter(x, np.float32(1))


def _first_k_scenes():
    """One query at (0, 0, 1); point 1 on the radius: in on the card, out
    on the CPU; points 2 to 5 well inside, so that the cut at nsample 4
    takes point 3 on the card and point 4 on the CPU."""
    inside, outside = _radius_point()
    pts = np.zeros((1, 8, 3), dtype=np.float32)
    pts[0, :, 2] = 1
    pts[0, 2:6, 0] = [0.05, -0.1, 0.02, 0.1]
    pts[0, 6:, 0] = [0.9, -0.8]
    card, cpu = pts.copy(), pts.copy()
    card[0, 1, 0], cpu[0, 1, 0] = inside, outside
    q = torch.tensor([[[0.0, 0.0, 1.0]]])
    return torch.from_numpy(card), torch.from_numpy(cpu), q


def test_slack_grows_with_delta_from_a_floor_of_ulps():
    one_ulp = float(np.spacing(np.float32(1.0)))
    assert ties.slack(1.0, 0.0) == ties.ULPS * one_ulp
    d, delta = 2.25, 1e-6
    assert ties.slack(d, delta) == pytest.approx(
        4 * math.sqrt(3) * delta * 1.5 + 12 * delta ** 2
        + ties.ULPS * float(np.spacing(np.float32(d))), rel=1e-12)
    assert ties.slack(d, 2 * delta) > ties.slack(d, delta)


def test_fps_near_tie_is_proven_and_replayed():
    card_x, cpu_x = _fps_scenes()
    with TieProof() as rec:
        card = _pipeline(card_x)
    own = _pipeline(cpu_x)
    assert not torch.equal(card[0], own[0])          # the picks part
    with TieProof(replay=rec) as rep:
        replayed = _pipeline(cpu_x)
    # the replay follows the card's picks, and its later stages run on the
    # CPU's own coordinates from those picks
    assert torch.equal(replayed[0], card[0])
    q = sampling.gather_points(cpu_x, card[0])
    bq = grouping.ball_query_plain(cpu_x, q, RADIUS, NSAMPLE)
    assert torch.equal(replayed[1], bq)
    assert torch.equal(replayed[2], grouping.group_points_plain(cpu_x, bq))
    assert [(t["stage"], t["scene"], t["step"], t["cpu_pick"],
             t["card_pick"]) for t in rep.ties] == [
        ("sa1 fps", 0, 1, 1, 2), ("sa1 fps", 1, 1, 1, 2)]
    for t in rep.ties:
        assert t["cpu_value"] > t["card_value"]
        assert t["cpu_value"] - t["card_value"] <= t["bound"]
        assert t["delta"] == pytest.approx(float(EPS), rel=0.1)
    assert {k: len(v) for k, v in rep.by_stage().items()} == {"sa1 fps": 2}


def test_first_k_point_on_the_radius_is_proven_and_replayed():
    card_x, cpu_x, q = _first_k_scenes()
    with TieProof() as rec:
        card = grouping.ball_query(card_x, q, RADIUS, NSAMPLE)
        grouping.group_points(card_x, card)
    own = grouping.ball_query(cpu_x, q, RADIUS, NSAMPLE)
    assert card[0, 0].tolist() == [0, 1, 2, 3]
    assert own[0, 0].tolist() == [0, 2, 3, 4]
    with TieProof(replay=rec) as rep:
        replayed = grouping.ball_query(cpu_x, q, RADIUS, NSAMPLE)
        rows = grouping.group_points(cpu_x, replayed)
    assert torch.equal(replayed, card)
    assert torch.equal(rows, grouping.group_points_plain(cpu_x, card))
    (t,) = rep.ties
    assert (t["stage"], t["step"], t["point"], t["card_has"]) == (
        "sa1 first_k", 0, 1, True)
    assert t["cpu_value"] >= t["card_value"] == grouping.radius_squared(
        RADIUS)
    assert t["cpu_value"] - t["card_value"] <= t["bound"]


def test_a_wrong_fps_pick_fails_naming_stage_and_step():
    card_x, cpu_x = _fps_scenes()
    with TieProof() as rec:
        card = _pipeline(card_x)
    far = int(card[0][0, 3])
    near = next(i for i in range(3, 64) if i not in card[0][0].tolist())
    rec.calls[0]["output"][0, 3] = near            # a pick no tie explains
    assert far != near
    with pytest.raises(RuntimeError, match=r"sa1 fps scene 0 step 3: .*"
                                           r"not a tie"):
        with TieProof(replay=rec):
            _pipeline(cpu_x)


def test_a_wrong_first_k_hit_fails_naming_stage_and_query():
    card_x, cpu_x, q = _first_k_scenes()
    with TieProof() as rec:
        grouping.ball_query(card_x, q, RADIUS, NSAMPLE)
    rec.calls[0]["output"][0, 0] = torch.tensor([0, 1, 2, 6])   # 0.9 away
    with pytest.raises(RuntimeError, match=r"sa1 first_k scene 0 query 0: "
                                           r"point \d is .*not a tie"):
        with TieProof(replay=rec):
            grouping.ball_query(cpu_x, q, RADIUS, NSAMPLE)


def test_inputs_beyond_a_rounding_fail():
    card_x, cpu_x = _fps_scenes()
    with TieProof() as rec:
        _pipeline(card_x)
    moved = cpu_x.clone()
    moved[:, 1, 0] += 10 * ties.MAX_DELTA
    with pytest.raises(RuntimeError, match="more than a rounding"):
        with TieProof(replay=rec):
            _pipeline(moved)


def test_identical_runs_replay_nothing():
    card_x, _ = _fps_scenes()
    with TieProof() as rec:
        card = _pipeline(card_x)
    assert [c["kernel"] for c in rec.calls] == ["fps", "first_k", "gather"]
    with TieProof(replay=rec) as rep:
        again = _pipeline(card_x)
    assert all(torch.equal(a, b) for a, b in zip(card, again))
    assert rep.ties == [] and rep.by_stage() == {}


def test_a_replay_must_answer_every_call_of_the_card():
    card_x, _ = _fps_scenes()
    with TieProof() as rec:
        _pipeline(card_x)
    with pytest.raises(RuntimeError, match="the card made 1 calls, the CPU "
                                           "run 0"):
        with TieProof(replay=rec):
            sampling.furthest_point_sample(card_x, 8)


def test_entries_apart_counts_the_parted_calls_by_stage():
    card_x, cpu_x = _fps_scenes()
    with TieProof() as card:
        _pipeline(card_x)
    with TieProof() as cpu:
        _pipeline(cpu_x)
    with TieProof() as same:
        _pipeline(card_x)
    assert card.entries_apart(same) == {}
    apart = card.entries_apart(cpu)
    assert apart["sa1 fps"] == 4                 # steps 1 and 2, two scenes
    assert set(apart) <= {"sa1 fps", "sa1 first_k"}


def test_a_capnet_forward_replays_through_the_ops():
    """A small CapNet's eval forward: every FPS, first-k and gather call of
    the forward is recorded and answered in order (5, 5 and 6), an
    identical run replays nothing, and a run on coordinates a rounding
    apart follows the recorded picks at every stage, parts proven."""
    from scan2cap_torch.config import ModelConfig
    from scan2cap_torch.data import synthetic
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.train.step import make_eval_step

    cfg = ModelConfig(num_points=512, num_proposals=16,
                      sa_npoints=(64, 32, 16, 16), max_num_obj=8,
                      num_locals=4, num_graph_steps=2, use_topdown=True,
                      use_relation=True, use_orientation=True, min_iou=-1.0)
    vocab = synthetic.make_vocab(num_vocabs=32)
    host = synthetic.make_scene_batch(cfg, batch_size=2, num_objects=3,
                                      vocab=vocab, seed=3)
    step = make_eval_step(cfg, CapNet(cfg, num_vocabs=32, device="cpu"),
                          detection_loss=False)
    with TieProof() as rec:
        card = step(synthetic.to_device(host, "cpu"))
    assert [sum(c["kernel"] == k for c in rec.calls)
            for k in ("fps", "first_k", "gather")] == [5, 5, 6]
    with TieProof(replay=rec) as rep:
        again = step(synthetic.to_device(host, "cpu"))
    assert rep.ties == [] and all(torch.equal(card[k], again[k])
                                  for k in card)
    moved = dict(host)
    pc = host["point_clouds"].copy()
    pc[..., :3] = np.nextafter(pc[..., :3], np.float32(np.inf))
    moved["point_clouds"] = pc
    with TieProof(replay=rec) as rep:
        step(synthetic.to_device(moved, "cpu"))
    assert rep.calls == []                          # a replay records nothing
    for t in rep.ties:
        assert t["delta"] <= ties.MAX_DELTA
