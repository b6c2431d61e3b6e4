"""The port's two remaining caption decoders against the JAX package, on
the CPU: ``SceneCaptionModule`` (the plain GRU decoder) and the full-K
scene decode of ``TopDownSceneCaptionModule`` (``num_locals=-1``).

Each module is initialised in Flax on a seeded batch, its weights are
carried into the port with ``convert.state_dict_from_flax`` +
``load_state_dict(strict=True)``, and both sides decode the same inputs
(jitted JAX).  Eval token ids must be equal; teacher-forced logits, the
caption loss and the attention within 1e-4.  CapNet with the CLI's default
caption heads (``use_topdown`` off; ``use_topdown`` with ``num_locals=-1``)
is held end to end at a small size.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scan2cap_tpu.config import Config
from scan2cap_tpu.config import ModelConfig as JModelConfig
from scan2cap_tpu.data import synthetic as jsynthetic
from scan2cap_tpu.losses.caption import compute_cap_loss as jcap_loss
from scan2cap_tpu.models import CapNet as JCapNet
from scan2cap_tpu.models import caption as jcaption
from scan2cap_tpu.train import step as jstep

from scan2cap_torch.config import ModelConfig
from scan2cap_torch.convert import state_dict_from_flax
from scan2cap_torch.data import synthetic
from scan2cap_torch.losses.caption import compute_cap_loss
from scan2cap_torch.models import CapNet
from scan2cap_torch.models.caption import (SceneCaptionModule,
                                           TopDownSceneCaptionModule)

B, K, C, E, H, V, T = 2, 12, 16, 10, 20, 24, 6


def _inputs(seed, relation=False, L=3):
    """A seeded decoder input dict (numpy): word embeddings, proposal
    features, boxes, masks, labels for the caption loss, and with
    ``relation`` distinct neighbour lists and edge features."""
    rs = np.random.RandomState(seed)
    centers = rs.rand(B, K, 1, 3).astype(np.float32) * 4.0
    offsets = (np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                        -1).reshape(1, 1, 8, 3).astype(np.float32))
    corners = centers + offsets * (0.3 + rs.rand(B, K, 1, 1).astype(np.float32))
    mask = (rs.rand(B, K) > 0.25).astype(np.float32)
    mask[:, 0] = 1
    lang_len = rs.randint(3, T + 2, B).astype(np.int32)
    lang_ids = np.zeros((B, T + 2), np.int32)
    for b in range(B):
        lang_ids[b, :lang_len[b]] = rs.randint(1, V, lang_len[b])
    d = {
        "lang_feat": rs.randn(B, T + 2, E).astype(np.float32),
        "lang_ids": lang_ids,
        "lang_len": lang_len,
        "bbox_feature": rs.randn(B, K, C).astype(np.float32),
        "bbox_mask": mask,
        "bbox_corner": corners,
        "ref_box_corner_label": corners[:, 3] + 0.05,
        "glove_emb_table": rs.randn(V, E).astype(np.float32),
    }
    if relation:
        d["edge_feature"] = rs.randn(B, K, L, C).astype(np.float32)
        d["edge_nbr_idx"] = np.stack([np.stack(
            [rs.permutation(K)[:L] for _ in range(K)]) for _ in range(B)]
        ).astype(np.int32)
    return d


def _carry(jmodule, port, d):
    """Init the Flax module on ``d`` and load its weights into ``port``;
    returns the Flax variables."""
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    variables = jax.jit(jmodule.init, static_argnames=("use_tf", "is_eval"))(
        jax.random.PRNGKey(3), jd, use_tf=True, is_eval=False)
    load = port.load_state_dict(state_dict_from_flax(variables["params"]),
                                strict=True)
    assert not load.missing_keys and not load.unexpected_keys
    return variables


def _run_both(jmodule, port, variables, d, is_eval):
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    jout = jax.jit(jmodule.apply, static_argnames=("use_tf", "is_eval"))(
        variables, jd, use_tf=not is_eval, is_eval=is_eval)
    with torch.inference_mode():
        tout = port({k: torch.from_numpy(v) for k, v in d.items()},
                    use_tf=not is_eval, is_eval=is_eval)
    return jout, tout


@pytest.fixture(scope="module")
def scene_cap():
    d = _inputs(0)
    jmodule = jcaption.SceneCaptionModule(
        num_vocabs=V, emb_size=E, feat_size=C, hidden_size=H,
        num_proposals=K, max_des_len=T, min_iou=-1.0, eval_chunk=5)
    port = SceneCaptionModule(V, emb_size=E, feat_size=C, max_des_len=T,
                              min_iou=-1.0, eval_chunk=5)
    return jmodule, port, _carry(jmodule, port, d), d


def test_scene_caption_eval_tokens_exact(scene_cap):
    jmodule, port, variables, d = scene_cap
    jout, tout = _run_both(jmodule, port, variables, d, is_eval=True)
    want = np.asarray(jout["lang_cap"])
    assert want.shape == (B, K, T - 1)
    assert len(np.unique(want)) > 1
    got = tout["lang_cap"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_scene_caption_tokens_do_not_depend_on_chunking(scene_cap):
    _, port, _, d = scene_cap
    td = {k: torch.from_numpy(v) for k, v in d.items()}
    with torch.inference_mode():
        chunked = port(td, is_eval=True)["lang_cap"]
        port.eval_chunk = K
        try:
            whole = port(td, is_eval=True)["lang_cap"]
        finally:
            port.eval_chunk = 5
    assert torch.equal(chunked, whole)


def test_scene_caption_teacher_forced_and_loss(scene_cap):
    jmodule, port, variables, d = scene_cap
    jout, tout = _run_both(jmodule, port, variables, d, is_eval=False)
    want = np.asarray(jout["lang_cap"])
    assert want.shape == (B, T + 1, V)
    np.testing.assert_allclose(tout["lang_cap"].numpy(), want,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tout["good_bbox_masks"].numpy(),
                                  np.asarray(jout["good_bbox_masks"]))
    np.testing.assert_allclose(float(tout["pred_ious"]),
                               float(jout["pred_ious"]), rtol=1e-6)
    jl, ja = jax.jit(jcap_loss)(jout)
    tl, ta = compute_cap_loss(tout)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-4, atol=1e-4)
    assert float(jl) > 0


@pytest.mark.parametrize("relation", [False, True])
def test_full_k_topdown_scene_decode(relation):
    d = _inputs(1, relation=relation)
    kw = dict(emb_size=E, feat_size=C, hidden_size=H, num_locals=-1,
              use_relation=relation, max_des_len=T, min_iou=-1.0,
              eval_chunk=5)                     # chunks of 5, 5 and 2
    jmodule = jcaption.TopDownSceneCaptionModule(num_vocabs=V,
                                                 num_proposals=K, **kw)
    port = TopDownSceneCaptionModule(V, **kw)
    variables = _carry(jmodule, port, d)
    jout, tout = _run_both(jmodule, port, variables, d, is_eval=True)
    want = np.asarray(jout["lang_cap"])
    assert want.shape == (B, K, T - 1) and len(np.unique(want)) > 1
    np.testing.assert_array_equal(tout["lang_cap"].numpy(), want)
    attn = np.asarray(jout["topdown_attn"])
    assert attn.shape == (B, K, T - 1, K)
    np.testing.assert_allclose(tout["topdown_attn"].numpy(), attn,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tout["valid_masks"].numpy(),
                                  np.asarray(jout["valid_masks"]))
    assert "topdown_attn_slots" not in tout
    # invalid proposals get no attention; token ids do not depend on the
    # chunking
    att = tout["topdown_attn"].numpy()
    for b in range(B):
        assert att[b][..., d["bbox_mask"][b] == 0].max(initial=0.0) == 0.0
    port.eval_chunk = K
    with torch.inference_mode():
        whole = port({k: torch.from_numpy(v) for k, v in d.items()},
                     use_tf=False, is_eval=True)
    assert torch.equal(whole["lang_cap"], tout["lang_cap"])


SMALL = dict(num_points=512, sa_npoints=(64, 32, 16, 16), num_proposals=16,
             max_num_obj=8, hidden_size=32, emb_size=16, num_locals=-1)


@pytest.mark.parametrize("use_topdown", [False, True],
                         ids=["scene_caption", "topdown_full_k"])
def test_capnet_cli_default_heads_match_jax(use_topdown):
    """CapNet builds with the CLI's default caption heads, and its eval
    forward (keep_attn) equals the jitted JAX model's."""
    kw = dict(SMALL, use_topdown=use_topdown)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    vocab = synthetic.make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    batch = synthetic.make_scene_batch(cfg, batch_size=2, num_objects=3,
                                       vocab=vocab, seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in jsynthetic.make_scene_batch(
        jcfg, batch_size=2, num_objects=3, vocab=vocab, seed=4).items()}
    jmodel = JCapNet(jcfg, num_vocabs=V)
    state = jstep.create_train_state(Config(model=jcfg), jmodel, jbatch,
                                     jax.random.PRNGKey(0))
    jeval = jstep.make_eval_step(Config(model=jcfg), jmodel,
                                 keep_attn=True)(state, jbatch)
    model = CapNet(cfg, num_vocabs=V, device="cpu")
    assert isinstance(model.caption, TopDownSceneCaptionModule if use_topdown
                      else SceneCaptionModule)
    model.load_state_dict(state_dict_from_flax(state.params,
                                               state.batch_stats), strict=True)
    from scan2cap_torch.train.step import make_eval_step
    teval = make_eval_step(cfg, model, keep_attn=True)(
        synthetic.to_device(batch, "cpu"))
    assert set(teval) == set(jeval)
    assert ("topdown_attn" in teval) == use_topdown
    for k, v in teval.items():
        want = np.asarray(jeval[k])
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


def test_graph_refuses_full_k_neighbours():
    # the JAX package's top_k refuses num_locals=-1 for the graph; the
    # port must not build a K-1-neighbour graph instead
    with pytest.raises(ValueError, match="num_locals"):
        CapNet(ModelConfig(**dict(SMALL, num_graph_steps=2, use_topdown=True,
                                  use_relation=True)), num_vocabs=V,
               device="cpu")
