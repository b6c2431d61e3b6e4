"""The port's bfloat16 backbone against the JAX package's, on the CPU.

Two modes, as in ``scan2cap_tpu/models/layers.py``: ``compute_dtype``
(layers 1 and on of each MLP multiply in bfloat16; layer 0, the sampling,
the grouping and the gather-lean split stay float32) and ``storage_dtype``
(only the activations between layers are stored narrow; every product and
BN is float32).  Both are gated per module by ``bf16_components``.

* Module tests mirroring ``tests/test_models.py:217-340`` on the port: the
  narrowing is real, BN statistics stay float32, a module outside
  ``bf16_components`` is bit-identical to the float32 port.
* The flagship CapNet (the small size of ``tests/test_torch_train.py``)
  against jitted JAX with the same dtypes, weights carried by
  ``state_dict_from_flax``.  Tolerances are in bfloat16 ulps of a tensor's
  largest entry (ulp = 2**(floor(log2 max|x|) - 7)):
  - the eval forward: FPS, ball-query and every other index exact; floats
    within 2 ulps (measured: 0.81 in compute mode, 0.41 in storage mode);
  - the backbone's gradient, BN on its running statistics: 16 ulps in
    compute mode (measured 6.5), 1 in storage mode (measured 0.53); JAX's
    own float32 gradient is 18.4 and 14.2 ulps (median over the tensors)
    from its bfloat16 one, so a port that narrowed elsewhere would fail;
  - one train step (BN on batch statistics): the loss within 2e-2
    relative (measured 7.0e-3 compute, 4.1e-3 storage; bfloat16 itself
    moves it 7% and 13% from float32), the indices and the detection
    labels exact, the seed features within 8 ulps (measured 5.1, 2.9).
    Its gradients are held by cosine similarity, whole and per tensor: at
    least 0.75 and 0.65 (measured 0.81 / 0.74 compute, 0.89 / 0.85
    storage; JAX's float32 gradient scores 0.61 / 0.50 against its own
    bfloat16 one).  A train step's bfloat16 gradient is not smooth: the
    batch statistics' float32 sums are taken in another order in XLA, a
    few of them round to the other bfloat16 neighbour, and the BN and
    proposal layers amplify that (the same effect as in
    ``tests/test_torch_train.py``, 2**16 times larger).
* No bfloat16 tensor reaches FPS, the ball query or the gather: their plain
  versions (the CPU path; the kernels on the card) are patched to assert
  float32 through a train step and an eval forward in each mode.
* A bfloat16 model's checkpoint is all float32 and exports like a float32
  one.
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
from scan2cap_tpu.train import step as jstep

from scan2cap_torch import convert
from scan2cap_torch.config import ModelConfig
from scan2cap_torch.data import synthetic
from scan2cap_torch.models import CapNet, backbone
from scan2cap_torch.ops import grouping, sampling
from scan2cap_torch.train.step import create_train_state, make_train_step

from tests.test_torch_modules import _carry, _randomize_stats
from tests.test_torch_train import CFG, LOSSES, V, _batch

MODES = {"compute": dict(compute_dtype="bfloat16"),
         "storage": dict(storage_dtype="bfloat16")}
BN_MOMENTUM = 0.1
T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: the sums' order, and so the bfloat16 roundings
    of the train step, do not depend on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_ulps(got, want) -> float:
    """max |got - want| in bfloat16 ulps of max |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


# --- modules (tests/test_models.py:217-340 on the port) -------------------
def _sa_inputs(seed=0):
    rs = np.random.RandomState(seed)
    xyz = rs.uniform(-2, 2, (2, 500, 3)).astype(np.float32)
    feats = rs.normal(size=(2, 500, 40)).astype(np.float32)
    return xyz, feats


def _sa_pair(seed=0, **dtypes):
    """The JAX SA module with random BN statistics and the port's with its
    weights, both with ``dtypes``; returns their outputs on one input."""
    xyz, feats = _sa_inputs(seed)
    jm = jbackbone.PointnetSAModuleVotes(64, 0.3, 16, (32, 32, 64), **dtypes)
    args = (jnp.asarray(xyz), jnp.asarray(feats), None, False)
    v = _randomize_stats(jax.jit(jm.init, static_argnums=4)(
        jax.random.PRNGKey(0), *args))
    jout = jax.jit(jm.apply, static_argnums=4)(v, *args)
    tm = _carry(v, backbone.PointnetSAModuleVotes(64, 0.3, 16, 40,
                                                  (32, 32, 64), **dtypes))
    with torch.no_grad():
        tout = tm(T(xyz), T(feats))
    return tm, tout, jout


def test_sa_bf16_compute_keeps_f32_decomposition():
    tm32, (xyz32, f32, inds32), _ = _sa_pair()
    tm, (xyz, fb, inds), (jxyz, jf, jinds) = _sa_pair(
        compute_dtype="bfloat16")
    assert tm.gather_lean and fb.dtype == torch.bfloat16
    for name, buf in tm.named_buffers():
        assert buf.dtype == torch.float32, name
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32, name
    # the float32 geometry: the same sampling and grouping decisions
    assert torch.equal(inds, inds32) and torch.equal(xyz, xyz32)
    ref, got = f32.numpy(), fb.float().numpy()
    np.testing.assert_allclose(got, ref, atol=0.05, rtol=0.05)
    assert np.mean(np.abs(got - ref)) < 5e-3
    assert not np.array_equal(got, ref)
    # and the JAX package's bfloat16 module
    np.testing.assert_array_equal(inds.numpy(), np.asarray(jinds))
    assert bf16_ulps(got, jf) <= 1.0


def test_bf16_components_gate():
    # excluding a module from bf16_components keeps it BIT-identical to the
    # float32 backbone, while included modules narrow
    f32 = _backbone_run(None, None, "sa1,sa2,sa3,sa4,fp")
    part = _backbone_run("bfloat16", None, "sa2,sa3,sa4,fp")
    assert torch.equal(f32["sa1_features"], part["sa1_features"])
    assert part["sa2_features"].dtype == torch.bfloat16
    assert not torch.equal(f32["sa2_features"],
                           part["sa2_features"].float())
    assert not torch.equal(f32["fp2_features"],
                           part["fp2_features"].float())


def test_storage_dtype_narrows_buffers_not_compute():
    tm32, (xyz32, f32, inds32), _ = _sa_pair()
    tm, (xyz, fs, inds), (jxyz, jf, jinds) = _sa_pair(
        storage_dtype="bfloat16")
    for name, t in [*tm.named_buffers(), *tm.named_parameters()]:
        assert t.dtype == torch.float32, name
    assert fs.dtype == torch.float32          # the last layer stays wide
    assert torch.equal(inds, inds32) and torch.equal(xyz, xyz32)
    ref, got = f32.numpy(), fs.numpy()
    assert not np.array_equal(got, ref)       # the narrowing is real
    np.testing.assert_allclose(got, ref, atol=0.02, rtol=0.02)
    assert np.mean(np.abs(got - ref)) < 2e-3
    np.testing.assert_array_equal(inds.numpy(), np.asarray(jinds))
    assert bf16_ulps(got, jf) <= 1.0


def test_storage_dtype_components_gate():
    f32 = _backbone_run(None, None, "sa1,sa2,sa3,sa4,fp")
    part = _backbone_run(None, "bfloat16", "sa2,sa3,sa4,fp")
    assert torch.equal(f32["sa1_features"], part["sa1_features"])
    assert not torch.equal(f32["sa2_features"], part["sa2_features"])
    # the storage casts are internal: every output is float32
    for k in ("sa1_features", "sa2_features", "sa4_features",
              "fp2_features"):
        assert part[k].dtype == torch.float32, k


def _backbone_run(compute, storage, comps):
    rs = np.random.RandomState(0)
    pc = np.concatenate([rs.uniform(-2, 2, (2, 512, 3)),
                         rs.randn(2, 512, 1)], -1).astype(np.float32)
    m = backbone.Pointnet2Backbone(1, (128, 64, 32, 16),
                                   compute_dtype=compute,
                                   storage_dtype=storage,
                                   bf16_components=comps)
    torch.manual_seed(0)
    for p in m.parameters():
        torch.nn.init.normal_(p, 0.0, 0.2)
    with torch.no_grad():
        return m({"point_clouds": T(pc)})


# --- the flagship CapNet against jitted JAX -------------------------------
def _jax_state(jcfg, batch):
    """tests/test_torch_train.py's weights: votes near the seeds, graph
    messages in a trained model's range."""
    jmodel = JCapNet(jcfg, num_vocabs=V)
    state = jstep.create_train_state(
        Config(model=jcfg), jmodel, {k: jnp.asarray(v) for k, v in
                                     batch.items()}, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: x, state.params)
    params["vgen"]["conv3"]["kernel"] = params["vgen"]["conv3"]["kernel"] * 0.02
    for layer in ("gc_0", "gc_1", "edge_layer"):
        k = params["graph"][layer]["map_edge_1"]["kernel"]
        params["graph"][layer]["map_edge_1"]["kernel"] = k * 0.1
    return jmodel, state.replace(params=params)


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request):
    mode = request.param
    jcfg = JModelConfig(**CFG, **MODES[mode])
    cfg = ModelConfig(**CFG, **MODES[mode])
    vocab = synthetic.make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    batch = _batch(cfg, vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel, state = _jax_state(jcfg, batch)

    def forward(params, stats, data):
        return jmodel.apply({"params": params, "batch_stats": stats}, data,
                            use_tf=False, is_eval=True, train=False)

    def loss_fn(params, stats, data):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": stats}, data, use_tf=True,
            is_eval=False, train=True, bn_momentum=BN_MOMENTUM,
            mutable=["batch_stats"])
        out = jlosses.get_scene_cap_loss(
            out, num_bins=jcfg.num_bins, num_heading_bin=jcfg.num_heading_bin,
            num_size_cluster=jcfg.num_size_cluster, **LOSSES)
        return out["loss"], out

    jeval = jax.jit(forward)(state.params, state.batch_stats, jbatch)
    (jloss, jtrain), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params, state.batch_stats, jbatch)

    def make_model():
        model = CapNet(cfg, num_vocabs=V, device="cpu")
        model.load_state_dict(convert.state_dict_from_flax(
            state.params, state.batch_stats), strict=True)
        return model

    tbatch = synthetic.to_device(batch, "cpu")
    model = make_model()
    with torch.no_grad():
        teval = model(tbatch, use_tf=False, is_eval=True, train=False)
    probe = make_model().train()
    with torch.no_grad():
        ttrain = probe(tbatch, use_tf=True, is_eval=False, train=True,
                       bn_momentum=BN_MOMENTUM)
    tmetrics = make_train_step(cfg, create_train_state(cfg, model),
                               **LOSSES)(tbatch, 1e-3, BN_MOMENTUM)
    return dict(
        mode=mode, cfg=cfg, jcfg=jcfg, batch=batch, state=state,
        jeval=jeval, teval=teval, jtrain=jtrain, ttrain=ttrain,
        jloss=float(jloss), tmetrics=tmetrics, model=model,
        jgrads=convert.named_from_flax(jgrads),
        tgrads={n: p.grad.detach().clone()
                for n, p in model.named_parameters()})


INDEX_KEYS = ("sa1_inds", "sa2_inds", "aggregated_vote_inds")
FLOAT_KEYS = ("sa1_features", "sa2_features", "sa3_features", "sa4_features",
              "fp2_features", "vote_xyz", "vote_features",
              "objectness_scores", "center", "sem_cls_scores",
              "bbox_corner", "bbox_feature")


def test_capnet_forward_matches_jax(runs):
    t, j = runs["teval"], runs["jeval"]
    for k in INDEX_KEYS + ("lang_cap",):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    narrow = runs["mode"] == "compute"
    for k in FLOAT_KEYS:
        # compute narrowing hands bfloat16 features on, as JAX does
        assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype), k
        assert bf16_ulps(_np(t[k]), j[k]) <= 2.0, (k, bf16_ulps(_np(t[k]),
                                                                j[k]))
    assert (t["fp2_features"].dtype == torch.bfloat16) == narrow


def test_backbone_gradient_matches_jax(runs):
    # BN on its running statistics: the bfloat16 products and casts alone
    # (forward and backward, the leaf projection's custom backward too)
    cfg, jcfg, state = runs["cfg"], runs["jcfg"], runs["state"]
    pc = runs["batch"]["point_clouds"]
    rs = np.random.RandomState(3)
    w = rs.randn(2, cfg.sa_npoints[1], 256).astype(np.float32)
    jm = jbackbone.Pointnet2Backbone(
        jcfg.input_feature_dim, jcfg.sa_npoints,
        None if jcfg.compute_dtype == "float32" else jcfg.compute_dtype,
        storage_dtype=(None if jcfg.storage_dtype == "float32"
                       else jcfg.storage_dtype))
    bb_params = state.params["backbone_net"]
    bb_stats = state.batch_stats["backbone_net"]

    def loss(params):
        out = jm.apply({"params": params, "batch_stats": bb_stats},
                       {"point_clouds": jnp.asarray(pc)}, train=False)
        return jnp.sum(out["fp2_features"].astype(jnp.float32)
                       * jnp.asarray(w))

    jgrad = convert.named_from_flax(jax.jit(jax.grad(loss))(bb_params))
    tm = backbone.Pointnet2Backbone(
        cfg.input_feature_dim, cfg.sa_npoints,
        compute_dtype=cfg.compute_dtype, storage_dtype=cfg.storage_dtype)
    tm.load_state_dict(convert.state_dict_from_flax(bb_params, bb_stats),
                       strict=True)
    out = tm({"point_clouds": T(pc)}, train=False)
    (out["fp2_features"].float() * T(w)).sum().backward()
    tol = 16.0 if runs["mode"] == "compute" else 1.0
    worst = {n: bf16_ulps(p.grad.numpy(), jgrad[n].numpy())
             for n, p in tm.named_parameters()}
    assert set(worst) == set(jgrad)
    assert max(worst.values()) <= tol, sorted(worst.items(),
                                              key=lambda kv: kv[1])[-3:]


def _cos(a, b):
    a = np.concatenate([x.ravel() for x in a]).astype(np.float64)
    b = np.concatenate([x.ravel() for x in b]).astype(np.float64)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def test_train_step_matches_jax(runs):
    m, j, t = runs["tmetrics"], runs["jtrain"], runs["ttrain"]
    got, want = float(m["loss"]), runs["jloss"]
    assert abs(got - want) <= 2e-2 * abs(want), (got, want)
    for k in INDEX_KEYS:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    from scan2cap_torch.losses import get_scene_cap_loss
    cfg = runs["cfg"]
    with torch.no_grad():
        lt = get_scene_cap_loss(dict(t), num_bins=cfg.num_bins,
                                num_heading_bin=cfg.num_heading_bin,
                                num_size_cluster=cfg.num_size_cluster,
                                **LOSSES)
    for k in ("objectness_label", "objectness_mask", "object_assignment"):
        np.testing.assert_array_equal(lt[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    assert bf16_ulps(_np(t["fp2_features"]), j["fp2_features"]) <= 8.0

    jg, tg = runs["jgrads"], runs["tgrads"]
    assert set(jg) == set(tg)
    names = sorted(n for n in jg if np.abs(jg[n].numpy()).max() > 1e-5)
    for n in tg:
        assert torch.isfinite(tg[n]).all(), n
    whole = _cos([tg[n].numpy() for n in names],
                 [jg[n].numpy() for n in names])
    per = {n: _cos([tg[n].numpy()], [jg[n].numpy()]) for n in names}
    assert whole >= 0.75, whole
    assert min(per.values()) >= 0.65, sorted(per.items(),
                                             key=lambda kv: kv[1])[:3]


def test_no_bf16_reaches_the_kernels(runs, monkeypatch):
    seen = []

    def checked(name, fn, arg):
        def call(*args, **kw):
            assert args[arg].dtype == torch.float32, (name,
                                                      args[arg].dtype)
            seen.append(name)
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(sampling, "furthest_point_sample_plain", checked(
        "fps", sampling.furthest_point_sample_plain, 0))
    for name, arg in (("ball_query_plain", 0), ("group_points_plain", 0)):
        monkeypatch.setattr(grouping, name, checked(
            name, getattr(grouping, name), arg))
    cfg = runs["cfg"]
    model = CapNet(cfg, num_vocabs=V, device="cpu")
    tbatch = synthetic.to_device(runs["batch"], "cpu")
    make_train_step(cfg, create_train_state(cfg, model), **LOSSES)(
        tbatch, 1e-3, BN_MOMENTUM)
    # the flagship's train step: 5 FPS, 5 first-k, 6 gathers (one in
    # sa1's backward)
    assert (seen.count("fps"), seen.count("ball_query_plain"),
            seen.count("group_points_plain")) == (5, 5, 6), seen
    seen.clear()
    with torch.no_grad():
        model(tbatch, use_tf=False, is_eval=True, train=False)
    assert (seen.count("fps"), seen.count("ball_query_plain"),
            seen.count("group_points_plain")) == (5, 5, 5), seen


def test_bf16_checkpoint_exports_like_float32(runs):
    sd = runs["model"].state_dict()
    for k, v in sd.items():
        assert v.dtype in (torch.float32, torch.int64), (k, v.dtype)
    ref = convert.reference_from_state_dict(sd)
    back = convert.state_dict_from_reference(ref)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    # and into a float32 model of the same layout, strictly
    f32 = CapNet(ModelConfig(**CFG), num_vocabs=V, device="cpu")
    f32.load_state_dict(back, strict=True)
