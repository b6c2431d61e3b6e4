"""The port's mesh (``scan2cap_torch.parallel.mesh``) on the CPU: ranks over
gloo, one torch thread each, against the port's single process and the JAX
package (mirrors tests/test_parallel_eval.py and
tests/test_checkpoint_sharded.py on their ``TINY`` config).

One process checks the padding; three spawned meshes then run every
check of their shape at once:

* one process: the padded classifier (32 words padded to 128) keeps the
  unpadded model's logits, log-softmax and tokens (``padded_vocab``).
* (2, 2), the classifier vocab-sharded (32 words padded to 128): the eval
  tokens equal the port's single process and jitted JAX's single device
  exactly; the train-mode loss is within 2e-3 relative of JAX's
  ``value_and_grad`` and every gradient, gathered whole, within 5e-3 of the
  largest; each rank holds a (VP/2, H) classifier shard; the loss falls
  over the steps, whose first matches JAX's own ``mesh_step_fn`` on its
  (4, 2) virtual mesh at 2e-3; a save after step 2, restored, repeats
  steps 3-4 bit for bit; the plain GRU decoder with an odd vocabulary
  (its classifier split over its hidden rows, ``map_feat`` with its bias
  over its output) gives one process's tokens exactly, its loss within
  1e-5 and every gradient within 5e-3 of the largest.
* (4, 1): the eval tokens again; a SharedMLP's train-mode BatchNorm
  output, running statistics and gradients within 1e-6 of one process;
  each batch-ratio loss (scene, MaskVoteNet, pretrained, object) as the
  sum of the ranks' shares within 1e-6 of one process, with a batch whose
  positive proposals all lie on one rank among them; the (2, 2) save
  restores here whole.
* (1, 1): the (2, 2) save restores here whole, and one process's eval
  reads it.
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
from scan2cap_tpu.parallel import make_mesh, mesh_step_fn
from scan2cap_tpu.parallel import padded_vocab as jpadded_vocab
from scan2cap_tpu.parallel import shard_train_state
from scan2cap_tpu.train import create_train_state as jcreate_train_state
from scan2cap_tpu.train import make_eval_step as jmake_eval_step
from scan2cap_tpu.train import make_train_step as jmake_train_step

import torch_mesh_ranks as ranks
from scan2cap_torch.config import ModelConfig
from scan2cap_torch.convert import named_from_flax, state_dict_from_flax
from scan2cap_torch.data import synthetic
from scan2cap_torch.losses.mask_votenet import get_mask_votenet_loss
from scan2cap_torch.losses.pretrained import get_pretrained_loss
from scan2cap_torch.losses.total import get_object_cap_loss
from scan2cap_torch.models import CapNet
from scan2cap_torch.models.layers import SharedMLP, seeded_init
from scan2cap_torch.parallel import mesh as pmesh
from scan2cap_torch.train.step import (MVN_REPORT_KEYS,
                                       PRETRAINED_REPORT_KEYS, REPORT_KEYS,
                                       make_eval_step)

TINY = dict(num_points=256, num_proposals=16, sa_npoints=(64, 32, 16, 16),
            max_num_obj=8, num_locals=4, num_graph_steps=2, use_topdown=True,
            use_relation=True, use_orientation=True, min_iou=-1.0)
V = 32
VP = 128                                   # padded_vocab(32, 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loss_terms(jcfg):
    return dict(num_bins=jcfg.num_bins, num_heading_bin=jcfg.num_heading_bin,
                num_size_cluster=jcfg.num_size_cluster)


@pytest.fixture(scope="module")
def ref():
    """JAX's TINY model (the vocab padded as test_parallel_eval's), its
    eval tokens, loss and gradients on one device, and its first
    ``mesh_step_fn`` step on the (4, 2) virtual mesh."""
    jcfg = JModelConfig(**TINY)
    config = Config(model=jcfg)
    vocab = synthetic.make_vocab(num_vocabs=V)
    batch = synthetic.make_scene_batch(ModelConfig(**TINY), batch_size=4,
                                       num_objects=3, vocab=vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JCapNet(jcfg, num_vocabs=V, num_vocabs_padded=VP)
    state = jcreate_train_state(config, jmodel, jbatch, jax.random.PRNGKey(1))
    tokens = np.asarray(jmake_eval_step(config, jmodel)(state, jbatch)[
        "lang_cap"])

    def loss_of(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats}, jbatch,
            use_tf=True, is_eval=False, train=True, bn_momentum=0.1,
            mutable=["batch_stats"])
        return jlosses.get_scene_cap_loss(
            out, **_loss_terms(jcfg), **ranks.LOSSES)["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(state.params)
    mesh = make_mesh(n_data=4, n_model=2)
    step = mesh_step_fn(jmake_train_step(config, jmodel, donate=False,
                                         **ranks.LOSSES), mesh)
    _, metrics = step(shard_train_state(state, mesh), jbatch,
                      jnp.asarray(1e-3), jnp.asarray(0.1))
    return dict(batch=batch, tokens=tokens, loss=float(loss),
                grads=named_from_flax(grads),
                mesh_metrics={k: float(v) for k, v in metrics.items()},
                sd=state_dict_from_flax(state.params, state.batch_stats))


# the plain GRU decoder with an odd vocabulary: its classifier splits over
# its hidden rows, map_feat over its output
PLAIN = dict(TINY, use_topdown=False, emb_size=32)
V_ODD = 33


@pytest.fixture(scope="module")
def plain_batch():
    vocab = synthetic.make_vocab(num_vocabs=V_ODD, emb_size=32)
    return synthetic.make_scene_batch(ModelConfig(**PLAIN), batch_size=4,
                                      num_objects=3, vocab=vocab)


@pytest.fixture(scope="module")
def mesh22(ref, plain_batch, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("mesh22"))
    res = pmesh.launch(pmesh.MeshSpec(2, 2), "cpu", ranks.capnet_2x2, TINY,
                       V, VP, ref["sd"], ref["batch"], workdir,
                       (PLAIN, V_ODD, plain_batch))
    return dict(res, workdir=workdir)


def _single(ref):
    model = CapNet(ModelConfig(**TINY), num_vocabs=V, num_vocabs_padded=VP,
                   device="cpu")
    model.load_state_dict(ref["sd"])
    return model


def test_padded_vocab_keeps_the_jax_rules():
    for args, want in (((3433, 2), 3456), ((3433, 1), 3456),
                       ((3456, 2), 3456), ((3433, 3), 3456)):
        assert pmesh.padded_vocab(*args) == want == jpadded_vocab(*args)
    assert pmesh.padded_vocab(1, 8, multiple=1) == 8
    for nm in (1, 2, 4, 8):
        p = pmesh.padded_vocab(3433, nm)
        assert p >= 3433 and p % nm == 0 and p % 128 == 0
        assert p == jpadded_vocab(3433, nm)
    assert pmesh.padded_vocab(V, 2) == VP


def test_vocab_padded_model_bit_exact(ref):
    """The padded classifier against the unpadded one (its first V rows):
    teacher-forced logits and log-softmax on the real columns to the
    gemm's rounding, the pad columns exactly -1e30, eval tokens exact."""
    cfg = ModelConfig(**TINY)
    padded = _single(ref)
    sd = dict(ref["sd"])
    for k in ("caption.classifier.weight", "caption.classifier.bias"):
        sd[k] = sd[k][:V].clone()
    plain = CapNet(cfg, num_vocabs=V, device="cpu")
    plain.load_state_dict(sd, strict=True)
    tb = synthetic.to_device(ref["batch"], "cpu")
    with torch.no_grad():
        got = padded(tb, use_tf=True, is_eval=False)["lang_cap"]
        want = plain(tb, use_tf=True, is_eval=False)["lang_cap"]
    assert got.shape[-1] == VP
    torch.testing.assert_close(got[..., :V], want, rtol=2e-6, atol=1e-7)
    assert bool((got[..., V:] == -1e30).all())
    torch.testing.assert_close(torch.log_softmax(got, -1)[..., :V],
                               torch.log_softmax(want, -1), rtol=2e-6,
                               atol=1e-6)
    tokens = [make_eval_step(cfg, m)(tb)["lang_cap"] for m in (padded, plain)]
    assert torch.equal(*tokens)


def test_eval_tokens_at_2x2_equal_one_process_and_jax(ref, mesh22):
    single = make_eval_step(ModelConfig(**TINY), _single(ref))(
        synthetic.to_device(ref["batch"], "cpu"))["lang_cap"].numpy()
    np.testing.assert_array_equal(single, ref["tokens"])
    np.testing.assert_array_equal(mesh22["tokens"], ref["tokens"])


def test_loss_and_gradients_at_2x2_match_jax(ref, mesh22):
    want = ref["loss"]
    assert abs(mesh22["loss"] - want) <= 2e-3 * abs(want), (mesh22["loss"],
                                                           want)
    jg, tg = ref["grads"], mesh22["grads"]
    assert set(jg) == set(tg)
    gmax = max(float(g.abs().max()) for g in jg.values())
    for name in sorted(jg):
        assert tg[name].shape == jg[name].shape, name
        d = float((tg[name] - jg[name]).abs().max())
        assert d <= 5e-3 * gmax, (name, d, gmax)
    assert float(tg["caption.classifier.weight"].abs().max()) > 0


def test_plain_decoder_splits_at_2x2_match_one_process(mesh22,
                                                      plain_batch):
    got = mesh22["plain"]
    assert got["tp"] == {"classifier": 1, "map_feat": 0}
    cfg = ModelConfig(**PLAIN)
    model = CapNet(cfg, num_vocabs=V_ODD, device="cpu", seed=3)
    tb = synthetic.to_device(plain_batch, "cpu")
    tokens = make_eval_step(cfg, model)(tb)["lang_cap"].numpy()
    np.testing.assert_array_equal(got["tokens"], tokens)
    model.train()
    out = ranks.get_scene_cap_loss(
        model(tb, use_tf=True, is_eval=False, train=True, bn_momentum=0.1),
        **_loss_terms(JModelConfig(**PLAIN)), **ranks.LOSSES)
    out["loss"].backward()
    want = float(out["loss"].detach())
    assert abs(got["loss"] - want) <= 1e-5 * abs(want), (got["loss"], want)
    grads = {n: p.grad for n, p in model.named_parameters()}
    gmax = max(float(g.abs().max()) for g in grads.values())
    for n, g in grads.items():
        d = float((got["grads"][n] - g).abs().max())
        assert d <= 5e-3 * gmax, (n, d, gmax)
    assert float(grads["caption.classifier.weight"].abs().max()) > 0


def test_classifier_is_vocab_sharded_at_2x2(mesh22):
    H = TINY.get("hidden_size", 512)
    assert mesh22["shard_shapes"] == [(VP // 2, H)] * 4


def test_mesh_steps_lower_the_loss_and_match_jax_mesh_step(ref, mesh22):
    losses = [m["loss"] for m in mesh22["metrics"]]
    assert losses[2] < losses[0], losses
    want = ref["mesh_metrics"]["loss"]
    assert abs(losses[0] - want) <= 2e-3 * abs(want), (losses[0], want)


def _assert_bundles_equal(a, b):
    assert a["step"] == b["step"]
    assert set(a["model"]) == set(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert set(sa) == set(sb)
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]),
                               torch.as_tensor(sb[i][k])), (i, k)


def test_save_restore_continue_is_bitwise_at_2x2(mesh22):
    assert mesh22["metrics"][2:] == mesh22["metrics_again"]
    _assert_bundles_equal(mesh22["after"], mesh22["after_again"])
    # the save holds whole tensors
    saved = torch.load(f"{mesh22['workdir']}/resume_2x2.pt",
                       weights_only=True)
    assert saved["model"]["caption.classifier.weight"].shape[0] == VP


def _loss_cases(out, B):
    """Loss inputs: the scene loss on the model's own outputs, the same
    with every positive proposal on scene 0 (rank 0 of (4, 1)), and random
    inputs of the MaskVoteNet, pretrained and object losses."""
    per_scene = {k: v.detach() for k, v in out.items()
                 if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == B}
    skewed = dict(per_scene)
    agg = per_scene["aggregated_vote_xyz"].clone()
    agg[1:] += 100.0
    agg[0, :3] = per_scene["center_label"][0, :3, :3]
    skewed["aggregated_vote_xyz"] = agg
    rs = np.random.RandomState(5)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    ti = lambda hi, *s: torch.from_numpy(rs.randint(0, hi, s))
    S, N, T, Vl, K, L = 32, 64, 12, 20, 6, 3
    mvn = {"seed_xyz": t(B, S, 3), "vote_xyz": t(B, S, 3),
           "seed_inds": ti(N, B, S).int(),
           "vote_label_mask": ti(2, B, N), "vote_label": t(B, N, 9),
           "center": t(B, 1, 3), "center_label": t(B, 1, 3),
           "size_class_label": ti(18, B, 1), "size_scores": t(B, 1, 18),
           "size_residuals_normalized": t(B, 1, 18, 3),
           "size_residuals": t(B, 1, 18, 3) * 0.1,
           "size_residual_label": t(B, 1, 3) * 0.1,
           "sem_cls_label": ti(18, B, 1), "sem_cls_scores": t(B, 1, 18),
           "bbox_corner_label": t(B, 8, 3)}
    lang_len = torch.from_numpy(np.array([4, 9, 6, 11][:B]))
    ids = ti(Vl, B, T + 2)
    ids[torch.arange(T + 2)[None] >= lang_len[:, None]] = 0
    cap = {"lang_cap": t(B, T, Vl), "lang_len": lang_len, "lang_ids": ids,
           "good_bbox_masks": torch.tensor([True, False, True, True][:B]),
           "object_assignment": ti(K, B, K).int(),
           "edge_nbr_idx": ti(K, B, K, L).int(),
           "edge_mask": ti(2, B, K, L).float(), "edge_distances": t(B, K, L),
           "center_label": t(B, K, 3)}
    obj = {**cap, "enc_preds": t(B, 18), "object_cat": ti(18, B)}
    scene_keys = tuple(k for k in REPORT_KEYS if k != "pred_ious")
    return {"scene": ("scene", per_scene, scene_keys),
            "scene_positives_on_rank0": ("scene", skewed, scene_keys),
            "mask_votenet": ("mask_votenet", mvn, MVN_REPORT_KEYS),
            "pretrained_gt": ("pretrained_gt", cap, ("loss", "cap_loss",
                                                     "cap_acc")),
            "pretrained_votenet": ("pretrained_votenet", cap,
                                   PRETRAINED_REPORT_KEYS),
            "object": ("object", obj, ("loss", "cls_loss", "cls_acc",
                                       "cap_loss", "cap_acc"))}


@pytest.fixture(scope="module")
def mesh41(ref, mesh22):
    model = _single(ref)
    tb = synthetic.to_device(ref["batch"], "cpu")
    with torch.no_grad():
        out = model(tb, use_tf=True, is_eval=False, train=False)
    cases = _loss_cases(out, 4)
    bn_input = torch.from_numpy(
        np.random.RandomState(2).randn(8, 10, 16).astype(np.float32) + 3.0)
    res = pmesh.launch(pmesh.MeshSpec(4, 1), "cpu", ranks.data_4x1, TINY, V,
                       VP, ref["sd"], ref["batch"], bn_input, cases)
    restored = pmesh.launch(pmesh.MeshSpec(4, 1), "cpu",
                            ranks.restore_elsewhere, TINY, V, VP,
                            f"{mesh22['workdir']}/resume_2x2.pt")
    return dict(res, cases=cases, bn_input=bn_input, restored=restored)


def test_eval_tokens_at_4x1_equal_jax(ref, mesh41):
    np.testing.assert_array_equal(mesh41["tokens"], ref["tokens"])


def test_global_batchnorm_at_4x1_matches_one_process(mesh41):
    mlp = SharedMLP(16, (32, 32))
    seeded_init(mlp, 3)
    x = mesh41["bn_input"]
    y = mlp(x, train=True, bn_momentum=0.1)
    w = torch.linspace(-1.0, 1.0, y.shape[-1])
    (torch.sum(y * w) / y.numel()).backward()
    got = mesh41["bn"]
    torch.testing.assert_close(got["y"], y.detach(), rtol=1e-6, atol=1e-6)
    for k, v in mlp.state_dict().items():
        if "running_" in k:
            torch.testing.assert_close(got["stats"][k], v, rtol=1e-6,
                                       atol=1e-6)
    for n, p in mlp.named_parameters():
        torch.testing.assert_close(got["grads"][n], p.grad, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["scene", "scene_positives_on_rank0",
                                  "mask_votenet", "pretrained_gt",
                                  "pretrained_votenet", "object"])
def test_batch_ratio_losses_at_4x1_match_one_process(mesh41, case):
    fns = {"scene": lambda d: ranks.get_scene_cap_loss(
               d, **_loss_terms(JModelConfig(**TINY)), **ranks.LOSSES),
           "mask_votenet": get_mask_votenet_loss,
           "pretrained_gt": lambda d: get_pretrained_loss(d, mode="gt"),
           "pretrained_votenet": lambda d: get_pretrained_loss(
               d, mode="votenet", distance=True),
           "object": lambda d: get_object_cap_loss(d)}
    fn_name, data, keys = mesh41["cases"][case]
    want = fns[fn_name](data)
    got = mesh41["losses"][case]
    for k in keys:
        w = float(want[k])
        assert abs(got[k] - w) <= 1e-6 * max(abs(w), 1.0), (k, got[k], w)
    if case == "scene_positives_on_rank0":
        label = want["objectness_label"]
        assert label[0].sum() > 0 and label[1:].sum() == 0


@pytest.fixture(scope="module")
def mesh11(mesh22):
    return pmesh.launch(pmesh.MeshSpec(1, 1), "cpu", ranks.restore_elsewhere,
                        TINY, V, VP, f"{mesh22['workdir']}/resume_2x2.pt")


@pytest.mark.parametrize("shape", ["4x1", "1x1"])
def test_2x2_save_restores_into_other_shapes(mesh22, mesh41, mesh11, ref,
                                            shape):
    res = mesh41["restored"] if shape == "4x1" else mesh11
    saved = torch.load(f"{mesh22['workdir']}/resume_2x2.pt",
                       weights_only=True)
    _assert_bundles_equal(res["bundle"], saved)
    assert np.isfinite(res["loss"])
    # one process's eval reads the save
    model = CapNet(ModelConfig(**TINY), num_vocabs=V, num_vocabs_padded=VP,
                   device="cpu")
    model.load_state_dict(saved["model"], strict=True)
    tokens = make_eval_step(ModelConfig(**TINY), model)(
        synthetic.to_device(ref["batch"], "cpu"))["lang_cap"]
    assert tokens.shape[:2] == (4, TINY["num_proposals"])


@pytest.fixture(scope="module")
def mesh21(ref):
    """(2, 1) on the first three scenes: one rank pads its share."""
    odd = {k: v if k in pmesh.REPLICATED_KEYS else v[:3]
           for k, v in ref["batch"].items()}
    res = pmesh.launch(pmesh.MeshSpec(2, 1), "cpu", ranks.eval_outputs_2x1,
                       TINY, V, VP, ref["sd"], odd)
    return dict(res, batch=odd)


def test_mesh_eval_fn_named_outputs_equal_the_gather_by_shape(ref, mesh21):
    """Every output of the eval step is named per scene and comes back as
    the gather by shape gave it, cut to the three scenes; the tokens are
    one process's."""
    named, by_shape = mesh21["named"], mesh21["by_shape"]
    assert sorted(named) == sorted(by_shape)
    for k in named:
        assert named[k].shape[0] == 3, k
        np.testing.assert_array_equal(named[k], by_shape[k], err_msg=k)
    np.testing.assert_array_equal(named["lang_cap"], ref["tokens"][:3])


def test_mesh_eval_fn_passes_a_replicated_output_untouched(mesh21):
    toy, pc = mesh21["toy"], mesh21["batch"]["point_clouds"]
    np.testing.assert_array_equal(
        toy["scene_sum"], torch.from_numpy(pc).sum((1, 2)).numpy())
    # the rank's own (2, 2): not gathered, not cut to the 3 scenes
    np.testing.assert_array_equal(toy["table"], np.full((2, 2), 7.0))
    assert int(toy["count"]) == 2


def test_mesh_eval_fn_refuses_an_undeclared_output_of_a_ranks_length(
        mesh21):
    msgs = mesh21["undeclared"]
    assert msgs is not None and len(msgs) == 2
    for msg in msgs:
        assert "'table'" in msg and "neither per scene nor replicated" in msg


def test_mesh_eval_fn_needs_the_per_scene_outputs_named():
    with pytest.raises(TypeError, match="names no per_scene_outputs"):
        pmesh.mesh_eval_fn(lambda batch: batch)
    step = make_eval_step(ModelConfig(**TINY), CapNet(
        ModelConfig(**TINY), num_vocabs=V, device="cpu"))
    assert "lang_cap" in step.per_scene_outputs
