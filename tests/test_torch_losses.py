"""The port's loss functions against the jitted JAX loss functions, on the CPU.

A seeded data dict stands in for the network: the labels come from the
synthetic batch, the "predictions" are random arrays placed so that some
proposals are positives, some negatives and some in between.  Every
returned scalar must agree within 1e-5 relative; labels, masks and
assignments exactly; and the gradient of each loss with respect to every
prediction it reads within 1e-5 of the largest gradient entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scan2cap_tpu import losses as jlosses
from scan2cap_tpu.losses import caption as jcaption
from scan2cap_tpu.losses import detection as jdetection

from scan2cap_torch import losses
from scan2cap_torch.config import ModelConfig
from scan2cap_torch.data import synthetic
from scan2cap_torch.losses import caption, detection

B, K, L, S, V = 2, 24, 5, 40, 30
CFG = ModelConfig(num_points=256, num_proposals=K, num_locals=L)
PREDICTIONS = ("vote_xyz", "objectness_scores", "center", "heading_scores",
               "heading_residuals_normalized", "size_scores",
               "size_residuals_normalized", "sem_cls_scores", "lang_cap",
               "edge_orientations", "edge_distances")


def _data(seed=0):
    rs = np.random.RandomState(seed)
    vocab = synthetic.make_vocab(num_vocabs=V, emb_size=CFG.emb_size)
    d = synthetic.make_scene_batch(CFG, batch_size=B, num_objects=4,
                                   vocab=vocab, seed=seed)
    f = lambda *shape: rs.randn(*shape).astype(np.float32)
    d["seed_inds"] = np.stack([rs.permutation(CFG.num_points)[:S]
                               for _ in range(B)]).astype(np.int32)
    d["seed_xyz"] = np.take_along_axis(
        d["point_clouds"][..., :3], d["seed_inds"][..., None], 1)
    d["vote_xyz"] = d["seed_xyz"] + 0.2 * f(B, S, 3)
    # proposals: a third on a GT centre (positives), a third a little off
    # (the grey zone between the thresholds), a third far away
    gt = d["center_label"][:, :4]
    which = rs.randint(0, 4, (B, K))
    base = np.take_along_axis(gt, which[..., None], 1)
    spread = np.repeat(np.array([0.1, 0.45, 2.0], np.float32), K // 3)
    agg = base + spread[None, :, None] * f(B, K, 3) / np.sqrt(3)
    d["aggregated_vote_xyz"] = agg.astype(np.float32)
    d["center"] = d["aggregated_vote_xyz"] + 0.1 * f(B, K, 3)
    d["objectness_scores"] = f(B, K, 2)
    d["heading_scores"] = f(B, K, 1)
    d["heading_residuals_normalized"] = f(B, K, 1)
    d["size_scores"] = f(B, K, 18)
    d["size_residuals_normalized"] = f(B, K, 18, 3)
    d["sem_cls_scores"] = f(B, K, 18)
    d["lang_cap"] = f(B, CFG.max_des_len + 1, V)
    d["good_bbox_masks"] = np.array([True, False])
    d["pred_ious"] = np.float32(0.3)
    d["edge_nbr_idx"] = np.stack([np.stack([
        np.sort(rs.permutation(K)[:L]) for _ in range(K)])
        for _ in range(B)]).astype(np.int32)
    d["edge_mask"] = (rs.rand(B, K, L) < 0.7).astype(np.float32)
    d["edge_orientations"] = f(B, K, L, CFG.num_bins)
    d["edge_distances"] = np.abs(f(B, K, L))
    return d


def _both(d, requires_grad=()):
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    for k in requires_grad:
        td[k].requires_grad_(True)
    return jd, td


def _scalar_close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= 1e-5 * max(abs(want), 1e-2), (got, want)


def _with_assignment(jd, td):
    """Add the objectness outputs the later losses read."""
    _, lab, mask, ind = jax.jit(jdetection.compute_objectness_loss)(jd)
    jd = dict(jd, objectness_label=lab, objectness_mask=mask,
              object_assignment=ind)
    _, lab, mask, ind = detection.compute_objectness_loss(td)
    td = dict(td, objectness_label=lab, objectness_mask=mask,
              object_assignment=ind)
    return jd, td


def _grad_check(jfn, tfn, d, keys, prepare=None):
    """Scalars of jfn/tfn agree, and d(sum of scalars)/d(keys) agree."""
    jd, td = _both(d, keys)
    if prepare is not None:
        jd, td = prepare(jd, td)

    def jtotal(preds):
        out = jfn({**jd, **preds})
        out = out if isinstance(out, tuple) else (out,)
        return sum((i + 1.0) * o for i, o in enumerate(out)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        {k: jd[k] for k in keys})
    tout = tfn(td)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(tout) == len(jout)
    for g, w in zip(tout, jout):
        _scalar_close(g, w)
    sum((i + 1.0) * o for i, o in enumerate(tout)).backward()
    for k in keys:
        want = np.asarray(jgrads[k])
        # (a one-bin heading softmax has no gradient to give)
        assert np.abs(want).max() > 0 or want.shape[-1] == 1, k
        np.testing.assert_allclose(td[k].grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_vote_loss_matches_jax():
    _grad_check(jdetection.compute_vote_loss, detection.compute_vote_loss,
                _data(), ["vote_xyz"])


def test_objectness_loss_matches_jax():
    d = _data()
    jd, td = _both(d)
    want = jax.jit(jdetection.compute_objectness_loss)(jd)
    got = detection.compute_objectness_loss(td)
    _scalar_close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    label, mask = got[1].numpy(), got[2].numpy()
    # positives, negatives and grey-zone proposals all occur
    assert label.sum() > 0 and (mask == 0).sum() > 0
    assert ((mask == 1) & (label == 0)).sum() > 0
    _grad_check(lambda x: jdetection.compute_objectness_loss(x)[0],
                lambda x: detection.compute_objectness_loss(x)[0], d,
                ["objectness_scores"])


def test_box_and_sem_cls_loss_matches_jax():
    _grad_check(jdetection.compute_box_and_sem_cls_loss,
                detection.compute_box_and_sem_cls_loss, _data(),
                ["center", "heading_scores", "heading_residuals_normalized",
                 "size_scores", "size_residuals_normalized",
                 "sem_cls_scores"], prepare=_with_assignment)


def test_size_residual_gather_broadcasts_its_index():
    # the (B, K) assignment indexes rows of the (B, M, 3) label table with
    # an expanded view, not a repeated index
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    idx = torch.tensor([[4, 0, 0], [1, 1, 3]], dtype=torch.int32)
    got = detection._take(x, idx)
    assert got.shape == (2, 3, 3)
    assert torch.equal(got[0, 0], x[0, 4]) and torch.equal(got[1, 2], x[1, 3])
    assert torch.equal(detection._take(x[..., 0], idx), got[..., 0])


def test_cap_loss_matches_jax():
    _grad_check(jcaption.compute_cap_loss, caption.compute_cap_loss, _data(),
                ["lang_cap"])


def test_cap_loss_without_a_good_box_is_zero():
    d = _data()
    d["good_bbox_masks"] = np.array([False, False])
    jd, td = _both(d)
    want = jax.jit(jcaption.compute_cap_loss)(jd)
    got = caption.compute_cap_loss(td)
    assert float(got[0]) == float(want[0]) == 0.0
    assert float(got[1]) == float(want[1]) == 0.0


def test_orientation_loss_matches_jax():
    _grad_check(jcaption.compute_node_orientation_loss,
                caption.compute_node_orientation_loss, _data(),
                ["edge_orientations"], prepare=_with_assignment)


def test_distance_loss_matches_jax():
    _grad_check(jcaption.compute_node_distance_loss,
                caption.compute_node_distance_loss, _data(),
                ["edge_distances"], prepare=_with_assignment)


def test_radian_to_label_matches_jax():
    rs = np.random.RandomState(1)
    edges = (np.arange(0, 7) * np.float32(np.pi / 6)).astype(np.float32)
    near = np.concatenate([np.nextafter(edges, np.float32(10)),
                           np.nextafter(edges, np.float32(-10))])
    x = np.concatenate([edges, near, rs.uniform(0, np.pi, 200)]).astype(
        np.float32)
    want = np.asarray(jax.jit(jcaption.radian_to_label)(jnp.asarray(x)))
    got = caption.radian_to_label(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == 0 and got.max() == 5
    # side='left': an angle exactly on the edge k*pi/6 belongs to class k-1's
    # upper neighbour only past the edge
    b = np.asarray(jnp.arange(jnp.pi / 6, jnp.pi - 1e-8, jnp.pi / 6))
    np.testing.assert_array_equal(
        caption.radian_to_label(torch.from_numpy(b)).numpy(), np.arange(5))


def test_edge_endpoint_gather_matches_jax():
    d = _data()
    rs = np.random.RandomState(2)
    assignment = rs.randint(0, 8, (B, K)).astype(np.int32)
    x = rs.randn(B, 8, 3, 3).astype(np.float32)
    want = jcaption._edge_endpoint_gather(
        jnp.asarray(x), jnp.asarray(assignment), jnp.asarray(d["edge_nbr_idx"]))
    got = caption._edge_endpoint_gather(
        torch.from_numpy(x), torch.from_numpy(assignment),
        torch.from_numpy(d["edge_nbr_idx"]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("flags", [
    dict(detection=True, caption=True, orientation=True, distance=False),
    dict(detection=True, caption=True, orientation=True, distance=True),
    dict(detection=True, caption=False, orientation=False, distance=False),
    dict(detection=False, caption=True, orientation=True, distance=True),
])
def test_scene_cap_loss_matches_jax(flags):
    d = _data(seed=3)
    jd, td = _both(d, PREDICTIONS)
    keys = ("loss", "vote_loss", "objectness_loss", "box_loss", "center_loss",
            "heading_cls_loss", "heading_reg_loss", "size_cls_loss",
            "size_reg_loss", "sem_cls_loss", "cap_loss", "ori_loss",
            "dist_loss", "cap_acc", "ori_acc", "obj_acc", "pred_ious",
            "pos_ratio", "neg_ratio")

    def jtotal(preds):
        out = jlosses.get_scene_cap_loss({**jd, **preds}, **flags)
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        {k: jd[k] for k in PREDICTIONS})
    tout = losses.get_scene_cap_loss(td, **flags)
    for k in keys:
        _scalar_close(tout[k], jout[k])
    for k in ("objectness_label", "objectness_mask", "object_assignment"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    tout["loss"].backward()
    for k in PREDICTIONS:
        want = np.asarray(jgrads[k])
        got = td[k].grad
        if got is None:                      # the loss does not read it
            assert not want.any(), k
            continue
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-6),
                                   err_msg=k)
