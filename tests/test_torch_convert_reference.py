"""The reference's ``.pth`` layout into the port and back, against the JAX
package's converter.

A seeded reference-layout state dict (the keys and shapes the reference's
modules have, values drawn from a seed) goes through both packages: the JAX
``convert_capnet_checkpoint`` followed by the port's ``state_dict_from_flax``,
and the port's ``state_dict_from_reference``.  The port's tensors must be
equal bit for bit, for the top-down head with graph and orientation, the
scene head, detection-only weights, both GCN layouts and a vocabulary pad.
The way back must equal the JAX ``export_capnet_checkpoint`` key for key and
bit for bit, and reload with ``load_state_dict(strict=True)``.  A small
CapNet with the converted weights gives the JAX CapNet's detection indices,
corners and eval tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scan2cap_tpu import convert as jconvert
from scan2cap_tpu.config import ModelConfig as JModelConfig
from scan2cap_tpu.models import CapNet as JCapNet

from scan2cap_torch import convert
from scan2cap_torch.config import ModelConfig
from scan2cap_torch.data import synthetic
from scan2cap_torch.models import CapNet
from scan2cap_torch.train.step import make_eval_step

V = 40
SMALL = dict(num_points=256, sa_npoints=(64, 32, 16, 8), num_proposals=16,
             emb_size=12, hidden_size=24, max_des_len=6)
CONFIGS = {
    "topdown_graph_orientation": dict(
        use_topdown=True, num_graph_steps=2, num_locals=4, use_relation=True,
        use_orientation=True, use_normal=True),
    "scene": dict(),
    "detection_only": dict(no_caption=True),
    "gcn": dict(num_graph_steps=2, graph_mode="graph_conv", use_topdown=True,
                num_locals=4),
    "legacy_gcn": dict(num_graph_steps=1, graph_mode="graph_conv"),
    "vocab_pad": dict(use_topdown=True, num_locals=4),
}
PADDED = {"vocab_pad": 48}


def _cfg(name):
    return ModelConfig(**SMALL, **CONFIGS[name])


def _model(name, device="cpu"):
    return CapNet(_cfg(name), num_vocabs=V, device=device, seed=0)


def reference_state(name, seed=0):
    """A seeded reference-layout state dict (numpy) with the modules of
    configuration ``name``: the JAX exporter's keys and shapes for such a
    model, every value drawn anew (running variances positive)."""
    params, stats = convert.flax_from_state_dict(_model(name).state_dict())
    sd = {k: v.numpy() for k, v in
          jconvert.export_capnet_checkpoint(params, stats).items()}
    rs = np.random.RandomState(seed)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        sd[k] = (rs.uniform(0.5, 1.5, v.shape) if k.endswith("running_var")
                 else rs.randn(*v.shape) * 0.1).astype(np.float32)
    if name == "legacy_gcn":      # torch_geometric <= 1.6: (in, out) weight
        for k in [k for k in sd if k.endswith(".lin.weight")]:
            sd[k.replace(".lin.weight", ".weight")] = np.ascontiguousarray(
                sd.pop(k).T)
    return sd


def _via_jax(sd, name):
    params, stats = jconvert.convert_capnet_checkpoint(
        {k: v for k, v in sd.items()
         if not k.endswith("num_batches_tracked")}, PADDED.get(name))
    return convert.state_dict_from_flax(params, stats)


def _equal(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:5]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_to_port_matches_jax_bitwise(name):
    sd = reference_state(name)
    got = convert.state_dict_from_reference(
        {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in sd.items()}, PADDED.get(name))
    _equal(got, _via_jax(sd, name))
    model = CapNet(_cfg(name), num_vocabs=V,
                   num_vocabs_padded=PADDED.get(name, 0), device="cpu")
    model.load_state_dict(got, strict=True)
    if name in ("gcn", "legacy_gcn"):       # PyG's lin has no bias
        for i in range(_cfg(name).num_graph_steps):
            assert not got[f"graph.gc_{i}.lin.bias"].any()
    if name == "vocab_pad":
        w = got["caption.classifier.weight"]
        assert w.shape[0] == 48 and not w[V:].any()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_to_reference_matches_jax_export(name, tmp_path):
    sd = reference_state(name)
    port = convert.state_dict_from_reference(sd, PADDED.get(name))
    back = convert.reference_from_state_dict(
        port, num_vocabs=V if name in PADDED else None)
    params, stats = jconvert.convert_capnet_checkpoint(
        dict(sd), PADDED.get(name))
    want = jconvert.export_capnet_checkpoint(
        params, stats, num_vocabs=V if name in PADDED else None)
    _equal(back, want)
    # the file the reference would load, read back under weights_only
    path = tmp_path / "model.pth"
    torch.save(back, path)
    again = convert.state_dict_from_reference(str(path), PADDED.get(name))
    _equal(again, port)
    assert all(back[k].dtype == torch.long and back[k].item() == 0
               for k in back if k.endswith("num_batches_tracked"))


def test_export_then_load_strict_is_bit_equal():
    model = _model("topdown_graph_orientation")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():          # statistics and biases away from 0 and 1
        for p in model.state_dict().values():
            p.add_(torch.rand(p.shape, generator=g))
    ref = convert.reference_from_state_dict(model.state_dict())
    fresh = _model("topdown_graph_orientation")
    fresh.load_state_dict(convert.state_dict_from_reference(ref), strict=True)
    _equal(fresh.state_dict(), model.state_dict())


def test_gcn_lin_bias_is_refused_on_export():
    model = _model("gcn")
    with torch.no_grad():
        model.graph.gc_0.lin.bias.fill_(0.5)
    with pytest.raises(ValueError, match="nonzero bias"):
        convert.reference_from_state_dict(model.state_dict())


def test_detection_mount_leaves_the_rest():
    sd = reference_state("detection_only", seed=4)
    model = _model("topdown_graph_orientation")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # the detection modules of a detection-only model have the same shapes
    # at the same input width: widen the reference's sa1 to normals
    wide = reference_state("topdown_graph_orientation", seed=4)
    det = {k: v for k, v in wide.items()
           if k.split(".")[0] in convert.DETECTION_MODULES}
    assert convert.is_detection_only(det) and not convert.is_detection_only(wide)
    convert.mount_detection_weights(model, det)
    want = convert.state_dict_from_reference(wide)
    for k, v in model.state_dict().items():
        if k.split(".")[0] in convert.DETECTION_MODULES:
            assert torch.equal(v, want[k]), k
        else:
            assert torch.equal(v, before[k]), k
    with pytest.raises(RuntimeError, match="size mismatch"):
        convert.mount_detection_weights(model, sd)     # sa1 is narrower


def test_converted_capnet_matches_jax():
    """A small top-down CapNet with graph and orientation, loaded from one
    reference-layout dict each way: the detection chain's indices and
    corners and the eval tokens equal the JAX CapNet's."""
    name = "topdown_graph_orientation"
    cfg = _cfg(name)
    sd = reference_state(name, seed=1)
    for k in [k for k in sd if k.startswith("vgen.conv3")]:
        sd[k] = sd[k] * 0.1            # votes near their seeds
    params, stats = jconvert.convert_capnet_checkpoint(dict(sd))
    model = CapNet(cfg, num_vocabs=V, device="cpu")
    model.load_state_dict(convert.state_dict_from_reference(sd), strict=True)

    vocab = synthetic.make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    batch = synthetic.make_scene_batch(cfg, batch_size=2, num_objects=4,
                                       vocab=vocab, seed=2)
    rs = np.random.RandomState(5)
    batch["point_clouds"][..., 3:6] = rs.randn(2, cfg.num_points, 3) * 0.1
    jmodel = JCapNet(JModelConfig(**SMALL, **CONFIGS[name]), num_vocabs=V)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda v, d: jmodel.apply(
        v, d, use_tf=False, is_eval=True, train=False))(
        {"params": params, "batch_stats": stats}, jbatch)
    got = make_eval_step(cfg, model, detection_loss=False)(
        synthetic.to_device(batch, "cpu"))
    with torch.inference_mode():
        full = model(synthetic.to_device(batch, "cpu"))
    for k in ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds",
              "bbox_mask"):
        np.testing.assert_array_equal(full[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["bbox_corner"].numpy(),
                               np.asarray(want["bbox_corner"]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(got["lang_cap"].numpy(),
                                  np.asarray(want["lang_cap"]))
