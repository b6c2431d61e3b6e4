"""The port's object-centric track against the JAX package's, on the CPU:
``ScannetObjectDataset`` (one object, captions, whole scenes),
``PointnetEncoder`` (per object and whole-scene) and the object losses
(``compute_object_cls_loss``, ``get_object_cap_loss``).

Tolerances: dataset items and Loader batches exact; the encoder's outputs
within 1e-4 of their largest magnitude, with
JAX's initial weights carried by ``convert.state_dict_from_flax``; each
loss and its gradient 1e-5.  The encoder runs 256-point crops with SA
counts above and below the crop size: (512, 256, 128, 64) samples more
points than a crop holds at sa1 and sa2, as the default (2048, 1024, 512,
256) does on the reference's 1,024-point crops.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_dataset import make_fixture_glove, make_fixture_scene

from scan2cap_tpu.data import dataset as jdataset
from scan2cap_tpu.data.dataset_object import (
    ScannetObjectDataset as JScannetObjectDataset)
from scan2cap_tpu.losses import total as jtotal
from scan2cap_tpu.models.encoder import PointnetEncoder as JPointnetEncoder

from scan2cap_torch.convert import named_from_flax, state_dict_from_flax
from scan2cap_torch.data import dataset
from scan2cap_torch.data.dataset_object import ScannetObjectDataset
from scan2cap_torch.data.synthetic import to_device
from scan2cap_torch.losses import total
from scan2cap_torch.models.encoder import PointnetEncoder

SCENES = ["scene0000_00", "scene0001_00"]
WORDS = ["a", "red", "chair", "table"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = tmp_path_factory.mktemp("object_scannet")
    rng = np.random.RandomState(0)
    for s in SCENES:
        make_fixture_scene(str(path), s, rng, n_points=1200, n_obj=3)
    scanrefer = [{"scene_id": s, "object_id": str(o), "object_name": "chair",
                  "ann_id": str(a), "token": list(rng.choice(WORDS, 4))}
                 for s in SCENES for o in range(3) for a in range(2)]
    return str(path), scanrefer, make_fixture_glove(WORDS)


MODES = {
    "single": dict(),
    "caption": dict(is_caption=True),
    "whole_scene": dict(whole_scene=True, is_eval=True),
    "whole_scene_train": dict(whole_scene=True),
}


def _pair(scenes, mode, **kw):
    path, scanrefer, glove = scenes
    args = dict(scannet_data_dir=path, glove_path="", glove=glove,
                num_points=256, max_num_obj=4, use_height=True,
                **MODES[mode])
    args.update(kw)
    return (JScannetObjectDataset(scanrefer, SCENES, **args),
            ScannetObjectDataset(scanrefer, SCENES, **args))


def _equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        if k == "load_time":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


LENGTHS = {"single": 6, "caption": 12, "whole_scene": 2,
           "whole_scene_train": 6}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("augment", [False, True])
def test_object_items_match_jax(scenes, mode, augment):
    jds, ds = _pair(scenes, mode, augment=augment, use_color=augment,
                    use_normal=augment)
    assert len(ds) == len(jds) == LENGTHS[mode]
    for i in range(len(ds)):
        want = jds.__getitem__(i, np.random.RandomState(i))
        got = ds.__getitem__(i, np.random.RandomState(i))
        _equal(want, got, f"{mode} item {i}")
        pc = got["point_clouds"]
        if mode.startswith("whole_scene"):
            assert pc.shape[:2] == (4, 256) and got["target_masks"].sum() == 3
            assert (pc[3] == 0).all()                   # the padded crop
            assert (pc[:3, :, -1].sum(-1) > 0).all()    # each crop's mask
        else:
            assert pc.shape[0] == 256 and pc[:, -1].max() == 1.0
            assert got["object_cat"] == 2               # chair (nyu40 5)


@pytest.mark.parametrize("mode", ["single", "whole_scene"])
def test_object_loader_batches_match_jax(scenes, mode):
    jds, ds = _pair(scenes, mode, augment=True)
    jl = jdataset.Loader(jds, batch_size=2, shuffle=True, seed=5,
                         num_workers=4)
    tl = dataset.Loader(ds, batch_size=2, shuffle=True, seed=5,
                        num_workers=4)
    for epoch in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) > 0
        for b, (x, y) in enumerate(zip(want, got)):
            _equal(x, y, f"{mode} epoch {epoch} batch {b}")
    jl.close()
    tl.close()


# --- the encoder ------------------------------------------------------------
SA = (512, 256, 128, 64)


def _encoder_pair(whole_scene, batch):
    jmodel = JPointnetEncoder(input_feature_dim=2, whole_scene=whole_scene,
                              sa_npoints=SA)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jbatch, train=False)
    model = PointnetEncoder(input_feature_dim=2, whole_scene=whole_scene,
                            sa_npoints=SA, device="cpu", seed=4)
    model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    return jmodel, jbatch, variables, model


def _crops(rs, shape):
    pc = rs.rand(*shape, 5).astype(np.float32) * 2 - 1
    pc[..., 4] = rs.rand(*shape) < 0.3                  # the target's mask
    return pc


def _close_to_scale(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


@pytest.mark.parametrize("train", [False, True])
def test_encoder_per_object_matches_jax(train):
    batch = {"point_clouds": _crops(np.random.RandomState(1), (3, 256))}
    jmodel, jbatch, variables, model = _encoder_pair(False, batch)
    if train:
        want, _ = jax.jit(lambda v, b: jmodel.apply(
            v, b, train=True, mutable=["batch_stats"]))(variables, jbatch)
    else:
        want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jbatch)
    with torch.no_grad():
        got = model(to_device(batch, "cpu"), train=train)
    assert got["enc_features"].shape == (3, 128)
    assert got["enc_preds"].shape == (3, 18)
    for k in ("enc_features", "enc_preds"):
        _close_to_scale(got[k].numpy(), np.asarray(want[k]), 1e-4, k)
    # sa1 samples 512 of a crop's 256 points: each point, then repeats
    assert model.sa1.npoint > 256 and not model.sa1.gather_lean


def test_encoder_whole_scene_matches_jax_and_masks_invalid_crops():
    rs = np.random.RandomState(2)
    batch = {"point_clouds": _crops(rs, (2, 4, 256)),
             "target_masks": np.array([[1, 1, 0, 1], [1, 0, 0, 0]],
                                      np.int32)}
    jmodel, jbatch, variables, model = _encoder_pair(True, batch)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    with torch.no_grad():
        got = model(to_device(batch, "cpu"), train=False)
    for k in ("enc_features", "enc_preds"):
        assert got[k].shape[:2] == (2, 4)
        _close_to_scale(got[k].numpy(), np.asarray(want[k]), 1e-4, k)
        invalid = batch["target_masks"] == 0
        assert (got[k].numpy()[invalid] == 0).all()
        assert (np.abs(got[k].numpy()[~invalid]).max(-1) > 0).all()
    # each valid crop encodes as it does alone
    single = PointnetEncoder(input_feature_dim=2, sa_npoints=SA,
                             device="cpu")
    single.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        alone = single({"point_clouds": torch.from_numpy(
            batch["point_clouds"][0, 3:4])}, train=False)
    np.testing.assert_allclose(alone["enc_features"][0].numpy(),
                               got["enc_features"][0, 3].numpy(),
                               rtol=0, atol=1e-6)


def test_encoder_whole_scene_refuses_training():
    model = PointnetEncoder(input_feature_dim=2, whole_scene=True,
                            sa_npoints=SA, device="cpu")
    batch = {"point_clouds": torch.zeros(1, 2, 256, 5),
             "target_masks": torch.ones(1, 2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="eval/extraction-only"):
        model(batch, train=True)


def test_encoder_gradient_through_the_object_loss_matches_jax():
    # with the running BN statistics: train-mode BN over four crops
    # renormalises float32's rounding differences of each layer's sums,
    # which grow to 2.3e-2 of a gradient's largest entry (sa1 to sa3,
    # measured), while the same backward with fixed statistics agrees to
    # 1e-5
    rs = np.random.RandomState(3)
    batch = {"point_clouds": _crops(rs, (4, 256)),
             "object_cat": np.array([2, 5, 17, 2], np.int32)}
    jmodel, jbatch, variables, model = _encoder_pair(False, batch)

    def loss_fn(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           jbatch, train=False)
        out = jtotal.get_object_cap_loss(out, caption=False)
        return out["loss"], out["cls_acc"]

    (jloss, jacc), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    out = total.get_object_cap_loss(model(to_device(batch, "cpu"),
                                          train=False), caption=False)
    out["loss"].backward()
    loss = float(out["loss"].detach())
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(out["cls_acc"]) == float(jacc)
    want = named_from_flax(jgrads)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def _worst_rel(got, want):
    """max over tensors of max|got - want| / max|want|, and its tensor."""
    rel = {n: float(np.abs(got[n] - want[n]).max() / np.abs(want[n]).max())
           for n in want}
    name = max(rel, key=rel.get)
    return rel[name], name


def test_encoder_train_mode_gradient_matches_jax():
    """Train-mode BN over four 256-point crops, on the batch of the test
    above.  Float32 rounding, not a formula, sets the gap here.  Measured on
    this batch: the port is 2.31e-2 of a tensor's largest entry from jitted
    JAX (sa3.mlp.bn_1.bias); op-by-op JAX is 8.78e-2 from jitted JAX
    (sa3.mlp.dense_1.weight); and the port's own float64 run of the same
    step, which picks the same points (the distances stay float32 FMAs),
    is 2.31e-2 from jitted JAX and 8.0e-4 from the port's float32 run.  So
    the port lies inside the spread of the JAX package's two float32
    evaluations, and is the closer of the two to float64.  Held: 2.5e-2 of
    each tensor's max against jitted JAX, and 1e-3 against the port's
    float64 run.  A wrong formula moves a gradient by its own order."""
    rs = np.random.RandomState(3)
    batch = {"point_clouds": _crops(rs, (4, 256)),
             "object_cat": np.array([2, 5, 17, 2], np.int32)}
    jmodel, jbatch, variables, model = _encoder_pair(False, batch)

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              jbatch, train=True, mutable=["batch_stats"])
        return jtotal.get_object_cap_loss(out, caption=False)["loss"]

    want = {k: v.numpy() for k, v in named_from_flax(
        jax.jit(jax.grad(loss_fn))(variables["params"])).items()}
    wide = PointnetEncoder(input_feature_dim=2, sa_npoints=SA, device="cpu")
    wide.load_state_dict(model.state_dict(), strict=True)
    wide.double()
    grads = {}
    for m, cast in ((model, torch.float32), (wide, torch.float64)):
        b = {"point_clouds": torch.from_numpy(batch["point_clouds"]).to(cast),
             "object_cat": torch.from_numpy(batch["object_cat"])}
        total.get_object_cap_loss(m(b, train=True),
                                  caption=False)["loss"].backward()
        grads[cast] = {n: p.grad.double().numpy()
                       for n, p in m.named_parameters()}
    assert set(want) == set(grads[torch.float32])
    assert all(np.abs(w).max() > 0 for w in want.values())
    gap, name = _worst_rel(grads[torch.float32], want)
    assert gap <= 2.5e-2, (gap, name)
    gap, name = _worst_rel(grads[torch.float32], grads[torch.float64])
    assert gap <= 1e-3, (gap, name)


# --- the object losses ------------------------------------------------------
def _loss_data(seed=0):
    rs = np.random.RandomState(seed)
    B, T, V = 4, 9, 12
    lang_ids = np.zeros((B, T + 1), np.int32)
    lang_len = np.array([4, 7, 10, 3], np.int32)
    for b in range(B):
        lang_ids[b, :lang_len[b]] = rs.randint(1, V, lang_len[b])
    return {
        "enc_preds": rs.randn(B, 18).astype(np.float32),
        "object_cat": np.array([2, 5, 17, 2], np.int32),
        "lang_cap": rs.randn(B, T, V).astype(np.float32),
        "lang_ids": lang_ids, "lang_len": lang_len,
        "good_bbox_masks": np.array([True, True, False, True]),
    }


KEYS = ("loss", "cls_loss", "cap_loss")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("classify,caption", [(True, True), (True, False),
                                              (False, True)])
def test_object_cap_loss_matches_jax(weighted, classify, caption):
    d = _loss_data()
    weights = (np.random.RandomState(9).rand(18) + 0.5) if weighted else None
    kw = dict(weights=weights, classify=classify, caption=caption)
    preds = [k for k, on in (("enc_preds", classify), ("lang_cap", caption))
             if on]
    jd = {k: jnp.asarray(v) for k, v in d.items()}

    def jfn(p):
        out = jtotal.get_object_cap_loss({**jd, **p}, **kw)
        return sum((i + 1.0) * out[k] for i, k in enumerate(KEYS)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        {k: jd[k] for k in preds})
    td = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    for k in preds:
        td[k].requires_grad_(True)
    out = total.get_object_cap_loss(td, **kw)
    for k in KEYS + ("cls_acc", "cap_acc"):
        g, w = float(out[k].detach()), float(jout[k])
        assert abs(g - w) <= 1e-5 * max(abs(w), 1e-2), (k, g, w)
    sum((i + 1.0) * out[k] for i, k in enumerate(KEYS)).backward()
    for k in preds:
        want = np.asarray(jgrads[k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(td[k].grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
