"""The port's train step against the jitted JAX train step, on the CPU.

The flagship flags at the small size of ``tests/test_torch_capnet.py``
(2048 points, SA counts (256, 128, 64, 32), 32 proposals, hidden 64,
embedding 32, vocabulary 40), B=2, with ``detection``, ``caption`` and
``orientation`` losses on.  ``min_iou`` is lowered to -1 so that the
randomly initialised model's target boxes count as good and the caption
loss reaches the decoder; the voting head's last layer is shrunk so that
some proposals lie near an object, and the graph's message layers so that
the proposal features stay of order one.  The JAX weights are carried into
the port with ``convert.state_dict_from_flax``; both sides take one step
on one batch.

Tolerances: loss and every reported metric 1e-4 relative (1e-5 absolute
for a term below 0.1); BN statistics
after the step 1e-5.  Gradients: every parameter's gradient within
``1e-2 * max|g| + 1e-6`` of the JAX gradient, and the median over the
tensors of ``max|diff| / max|g|`` at most 1e-3.  The gradient of this
function is not smooth in float32: moving every weight of the port by half
an ulp moves the port's own gradients by 4e-3 * max|g| on this batch and by
up to 2e-1 on others (a max-pool or ReLU switch reroutes the gradient of
the one or two positive proposals), and the JAX-versus-port differences are
of that size on every batch tried, tensor for tensor.  So 1e-4 * max|g| is
below what float32 repeats; a wrong formula shows as a difference of order
one.  Each loss function's gradient is held to 1e-5 on its own in
``tests/test_torch_losses.py``.  Parameters
after an Adam step are NOT a gate: a near-zero gradient that flips sign
moves its parameter by 2*lr.  The optimizer is tested on its own, fed the
same gradients on both sides.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scan2cap_tpu import losses as jlosses
from scan2cap_tpu.config import Config
from scan2cap_tpu.config import ModelConfig as JModelConfig
from scan2cap_tpu.models import CapNet as JCapNet
from scan2cap_tpu.models import backbone as jbackbone
from scan2cap_tpu.train import schedules as jschedules
from scan2cap_tpu.train import step as jstep

from scan2cap_torch.config import ModelConfig
from scan2cap_torch.convert import (adam_state_from_optax, named_from_flax,
                                    state_dict_from_flax)
from scan2cap_torch.data import synthetic
from scan2cap_torch.models import CapNet
from scan2cap_torch.models import backbone
from scan2cap_torch.ops import grouping
from scan2cap_torch.train import schedules
from scan2cap_torch.train.step import (REPORT_KEYS, create_train_state,
                                       make_eval_step, make_optimizer,
                                       make_train_step)

V = 40
CFG = dict(num_points=2048, sa_npoints=(256, 128, 64, 32), num_proposals=32,
           hidden_size=64, emb_size=32, num_graph_steps=2, num_locals=10,
           use_topdown=True, use_relation=True, use_orientation=True,
           use_normal=True, use_multiview=True, min_iou=-1.0)
LOSSES = dict(detection=True, caption=True, orientation=True, distance=False)
LR, BN_MOMENTUM = 1e-3, 0.1


def _batch(cfg, vocab):
    b = synthetic.make_scene_batch(cfg, batch_size=2, num_objects=4,
                                   vocab=vocab, seed=7)
    rs = np.random.RandomState(1)
    b["point_clouds"][..., 3:3 + 131] = (
        rs.randn(2, cfg.num_points, 131).astype(np.float32) * 0.1)
    return b


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg = JModelConfig(**CFG), ModelConfig(**CFG)
    vocab = synthetic.make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    batch = _batch(cfg, vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JCapNet(jcfg, num_vocabs=V)
    config = Config(model=jcfg)
    state = jstep.create_train_state(config, jmodel, jbatch,
                                     jax.random.PRNGKey(0))
    # a freshly initialised voting head throws its votes metres away, and
    # no proposal lands within 0.3 m of an object: shrink its last layer so
    # that the batch has positive and negative proposals
    params = jax.tree.map(lambda x: x, state.params)
    params["vgen"]["conv3"]["kernel"] = params["vgen"]["conv3"]["kernel"] * 0.02
    # and its sum-aggregated graph messages reach the hundreds, where a
    # float32 ulp is 1e-5: shrink the message layers to a trained model's range
    for layer in ("gc_0", "gc_1", "edge_layer"):
        k = params["graph"][layer]["map_edge_1"]["kernel"]
        params["graph"][layer]["map_edge_1"]["kernel"] = k * 0.1
    state = state.replace(params=params)

    def loss_fn(params, batch_stats, data):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, data,
            use_tf=True, is_eval=False, train=True, bn_momentum=BN_MOMENTUM,
            mutable=["batch_stats"])
        out = jlosses.get_scene_cap_loss(
            out, num_bins=jcfg.num_bins, num_heading_bin=jcfg.num_heading_bin,
            num_size_cluster=jcfg.num_size_cluster, **LOSSES)
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params, state.batch_stats, jbatch)
    jtrain = jstep.make_train_step(config, jmodel, donate=False, **LOSSES)
    jstate, jmetrics = jtrain(state, jbatch, jnp.float32(LR),
                              jnp.float32(BN_MOMENTUM))
    jeval = jstep.make_eval_step(config, jmodel)(state, jbatch)

    model = CapNet(cfg, num_vocabs=V, device="cpu")
    model.load_state_dict(
        state_dict_from_flax(state.params, state.batch_stats), strict=True)
    tbatch = synthetic.to_device(batch, "cpu")
    teval = make_eval_step(cfg, model)(tbatch)
    tstate = create_train_state(cfg, model)
    train_step = make_train_step(cfg, tstate, **LOSSES)
    tmetrics = train_step(tbatch, LR, BN_MOMENTUM)
    tgrads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return dict(
        jmetrics=as_np(jmetrics), tmetrics={k: v.numpy()
                                            for k, v in tmetrics.items()},
        jgrads=named_from_flax(jgrads), tgrads=tgrads,
        jstats=state_dict_from_flax({}, jstate.batch_stats),
        jstats_before=state_dict_from_flax({}, state.batch_stats),
        tstats={k: v.clone() for k, v in model.state_dict().items()
                if "running_" in k},
        jout={k: np.asarray(v) for k, v in jout.items()
              if k in ("lang_cap", "valid_masks", "good_bbox_masks",
                       "pred_ious", "edge_nbr_idx", "objectness_label")},
        jeval=as_np(jeval), teval={k: v.numpy() for k, v in teval.items()},
        tstate=tstate, model=model, cfg=cfg, jcfg=jcfg,
        batch=batch, params=state.params, batch_stats=state.batch_stats)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert abs(got - want) <= rel * max(abs(want), 0.1), (got, want)


@pytest.mark.parametrize("key", REPORT_KEYS)
def test_train_step_metric_matches_jax(runs, key):
    # 1e-4 relative, and 1e-5 absolute for a term below 0.1 (one positive
    # proposal's residual carries the forward's float32 noise undivided)
    assert runs["tmetrics"][key].shape == ()
    _close(runs["tmetrics"][key], runs["jmetrics"][key], 1e-4)


def test_train_step_reports_the_jax_keys(runs):
    assert set(runs["tmetrics"]) == set(runs["jmetrics"]) == set(REPORT_KEYS)


def test_train_step_is_not_degenerate(runs):
    # positives and negatives among the proposals, a caption loss that
    # reaches the decoder, and an orientation loss over real edges
    m = runs["tmetrics"]
    assert 0 < m["pos_ratio"] < 1 and m["neg_ratio"] > 0
    assert m["cap_loss"] > 0 and m["ori_loss"] > 0 and m["vote_loss"] > 0
    assert m["box_loss"] > 0 and np.isfinite(m["loss"])
    assert runs["tstate"].step == 1


def test_every_gradient_matches_jax(runs):
    jg, tg = runs["jgrads"], runs["tgrads"]
    assert set(jg) == set(tg)
    worst, rel = [], []
    for name in sorted(jg):
        want, got = jg[name].numpy(), tg[name].numpy()
        assert got.shape == want.shape, name
        tol = 1e-2 * np.abs(want).max() + 1e-6
        err = np.abs(got - want).max()
        if err > tol:
            worst.append((name, float(err), float(tol)))
        if np.abs(want).max() > 1e-5:
            rel.append(err / np.abs(want).max())
    assert not worst, worst
    assert np.median(rel) <= 1e-3, np.median(rel)
    # the gradient reaches every part of the model
    for part in ("backbone_net.sa1", "backbone_net.sa4", "vgen", "proposal",
                 "graph.gc_0", "graph.edge_predict", "caption.classifier",
                 "caption.map_feat"):
        assert any(n.startswith(part) and np.abs(g.numpy()).max() > 0
                   for n, g in tg.items()), part


def test_batch_stats_after_step_match_jax(runs):
    assert set(runs["jstats"]) == set(runs["tstats"])
    moved = 0
    for k, want in runs["jstats"].items():
        np.testing.assert_allclose(runs["tstats"][k].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        moved += int(not np.array_equal(want.numpy(),
                                        runs["jstats_before"][k].numpy()))
    assert moved == len(runs["jstats"])


def test_teacher_forced_decode_matches_jax(runs):
    # the train forward (batch statistics) on a fresh copy of the weights
    cfg = runs["cfg"]
    model = CapNet(cfg, num_vocabs=V, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        runs["params"], runs["batch_stats"]), strict=True)
    with torch.no_grad():
        out = model(synthetic.to_device(runs["batch"], "cpu"), use_tf=True,
                    is_eval=False, train=True, bn_momentum=BN_MOMENTUM)
    want = runs["jout"]
    assert out["lang_cap"].shape == (2, cfg.max_des_len + 1, V)
    np.testing.assert_allclose(out["lang_cap"].numpy(), want["lang_cap"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out["valid_masks"].numpy(),
                                  want["valid_masks"])
    np.testing.assert_array_equal(out["good_bbox_masks"].numpy(),
                                  want["good_bbox_masks"])
    np.testing.assert_allclose(out["pred_ious"].numpy(), want["pred_ious"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out["edge_nbr_idx"].numpy(),
                                  want["edge_nbr_idx"])
    # each target attends to its num_locals locals, itself among them
    assert (out["valid_masks"].sum(-1) == cfg.num_locals).all()
    # no neighbour id repeats within a row, so the relation scatter and the
    # local-mask scatter never write one slot twice (on either side)
    nbr = np.sort(want["edge_nbr_idx"], axis=-1)
    assert (np.diff(nbr, axis=-1) > 0).all()


def test_eval_step_detection_loss_matches_jax(runs):
    # detection_loss=True is the default on both sides
    got, want = runs["teval"], runs["jeval"]
    assert set(got) == set(want)
    assert {"object_assignment", "objectness_label",
            "objectness_mask"} <= set(got)
    for k in got:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_optimizer_matches_optax():
    # the same gradients to both Adams for 3 steps with a changing lr;
    # parameters within 1e-6
    rs = np.random.RandomState(0)
    shapes = {"a": {"kernel": (5, 7), "bias": (7,)}, "b": {"scale": (4,)}}
    params = {m: {k: rs.randn(*s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    tx = jstep.make_optimizer(1e-5)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    named = named_from_flax(params)
    tparams = {k: torch.nn.Parameter(v.clone()) for k, v in named.items()}
    opt = make_optimizer(list(tparams.values()), 1e-5)

    @jax.jit
    def jupdate(p, s, g, lr):
        updates, s = tx.update(g, s, p)
        return jax.tree.map(lambda a, u: a - lr * u, p, updates), s

    for step, lr in enumerate((1e-3, 5e-4, 2e-3)):
        grads = {m: {k: rs.randn(*s).astype(np.float32) * 10.0 ** -step
                     for k, s in d.items()} for m, d in shapes.items()}
        jparams, opt_state = jupdate(jparams, opt_state,
                                     jax.tree.map(jnp.asarray, grads),
                                     jnp.float32(lr))
        for k, g in named_from_flax(grads).items():
            tparams[k].grad = g.clone()
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        want = named_from_flax(jax.tree.map(np.asarray, jparams))
        for k in want:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       want[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"step {step} {k}")


def test_optimizer_state_carries_from_optax(runs):
    # moments after the JAX step, loaded into a fresh torch Adam, continue
    # as the port's own optimizer state does
    tx = jstep.make_optimizer(1e-5)
    params = runs["params"]
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.01, params)
    _, opt_state = tx.update(grads, tx.init(params), params)
    model = runs["model"]
    opt = make_optimizer(model.parameters(), 1e-5)
    adam_state_from_optax(opt_state, model, opt)
    for p in model.parameters():
        st = opt.state[p]
        assert float(st["step"]) == 1.0
        # mu = 0.1 * (g + wd * p); close to 0.1 * 0.01
        assert st["exp_avg"].shape == p.shape
        assert abs(float(st["exp_avg"].mean()) - 1e-3) < 1e-4


def test_unreached_parameters_still_decay():
    # distance off: the distance column of edge_predict gets a zero
    # gradient, and a parameter with no gradient at all must still see the
    # coupled weight decay (optax decays every leaf)
    w = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([w], wd=0.1)
    w.grad = torch.zeros(3)
    opt.step()
    assert (w < 1.0).all()


@pytest.mark.parametrize("epoch", [0, 19, 20, 79, 80, 119, 120, 160, 400])
def test_schedules_match_jax(epoch):
    assert schedules.multistep_lr(1e-3, epoch) == jschedules.multistep_lr(
        1e-3, epoch)
    assert schedules.bn_momentum(epoch) == jschedules.bn_momentum(epoch)


def test_train_step_needs_the_device_it_was_built_for(runs):
    model = runs["model"]
    model.device = torch.device("cuda")      # as if built for the card
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(runs["cfg"], runs["tstate"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_train_state(runs["cfg"], model)
    finally:
        model.device = torch.device("cpu")


# ---------------------------------------------------- leaf gathered projection
def _leaf_inputs(seed=0, B=2, N=300, M=24, S=8, Cin=11, D=6):
    rs = np.random.RandomState(seed)
    cat = rs.randn(B, N, Cin).astype(np.float32)
    ct_in = rs.randn(B, M, Cin).astype(np.float32)
    w0 = rs.randn(Cin, D).astype(np.float32)
    idx = rs.randint(0, N, (B, M, S)).astype(np.int32)
    idx[:, :, S // 2:] = idx[:, :, :1]       # padded rows: repeated indices
    g = rs.randn(B, M, S, D).astype(np.float32)
    return cat, ct_in, w0, idx, g


def test_leaf_gathered_projection_matches_jax():
    cat, ct_in, w0, idx, g = _leaf_inputs()
    jf = jax.jit(jbackbone._leaf_gathered_projection)
    want = np.asarray(jf(cat, ct_in, w0, idx))
    jdw = jax.jit(jax.grad(lambda w: jnp.sum(
        jbackbone._leaf_gathered_projection(cat, ct_in, w, idx) * g)))(
        jnp.asarray(w0))
    tc, tct = torch.from_numpy(cat), torch.from_numpy(ct_in)
    tc.requires_grad_(True)
    tct.requires_grad_(True)
    tw = torch.from_numpy(w0).requires_grad_(True)
    tidx = torch.from_numpy(idx)
    out = backbone.leaf_gathered_projection(tc, tct, tw, tidx)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    scale = np.abs(np.asarray(jdw)).max()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=0,
                               atol=1e-4 * scale)
    # no gradient for the leaves
    assert tc.grad is None and tct.grad is None
    # and the same dW as plain autograd through group_points(cat @ w0)
    tw2 = torch.from_numpy(w0).requires_grad_(True)
    plain = (grouping.group_points(torch.from_numpy(cat) @ tw2, tidx)
             - (torch.from_numpy(ct_in) @ tw2)[:, :, None, :])
    np.testing.assert_allclose(plain.detach().numpy(), out.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    (plain * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), tw2.grad.numpy(), rtol=0,
                               atol=1e-4 * scale)


def test_sa1_sets_leaf_inputs_only(runs):
    net = runs["model"].backbone_net
    assert net.sa1.leaf_inputs and net.sa1.gather_lean
    for name in ("sa2", "sa3", "sa4"):
        assert not getattr(net, name).leaf_inputs
    assert not runs["model"].proposal.vote_aggregation.leaf_inputs


def test_max_over_samples_splits_gradient_among_ties():
    # a ball-query row with fewer hits than nsample repeats its first hit,
    # so the max over samples sees exact ties; jnp.max and torch.amax both
    # split the gradient evenly among them (torch.max(dim=) would not)
    x = np.zeros((1, 2, 4, 3), np.float32)
    x[0, 0] = [[1, 5, 2], [1, 5, 2], [0, 5, 2], [1, 5, 2]]   # padded copies
    x[0, 1] = [[3, 1, 0], [2, 4, 0], [1, 1, 7], [0, 0, 0]]   # no ties
    want = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum(jnp.max(a, axis=2) * jnp.asarray([1., 2., 3.]))))(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    (t.amax(dim=2) * torch.tensor([1., 2., 3.])).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-7)
    assert t.grad[0, 0, :, 0].tolist() == pytest.approx([1 / 3, 1 / 3, 0, 1 / 3])


def test_sa_layer_gradient_with_padded_rows_matches_plain_path():
    # an SA layer whose ball query pads rows (few points in reach): the
    # leaf-input path and the ordinary path give one weight gradient
    rs = np.random.RandomState(4)
    xyz = torch.from_numpy(rs.uniform(-1, 1, (2, 200, 3)).astype(np.float32))
    feats = torch.from_numpy(rs.randn(2, 200, 9).astype(np.float32))
    grads = []
    for leaf in (True, False):
        torch.manual_seed(0)
        sa = backbone.PointnetSAModuleVotes(16, 0.3, 8, 9, (6, 6),
                                            leaf_inputs=leaf)
        idx = grouping.ball_query(xyz, xyz[:, :16], 0.3, 8)
        assert (idx[:, :, 1:] == idx[:, :, :1]).any()        # padded slots
        _, out, _ = sa(xyz, feats, train=True)
        out.sum().backward()
        grads.append(sa.mlp.dense_0.weight.grad.clone())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=0,
                               atol=1e-4 * float(grads[1].abs().max()))
