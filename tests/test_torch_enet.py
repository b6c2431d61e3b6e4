"""The port's ENet (``models/enet.py``) and its converters against the JAX
package's, on the CPU.

* The trunk and the classifier against ``scan2cap_tpu.models.enet`` on the
  same weights (the JAX model's initial draw, with its BN statistics and
  every parameter moved by seeded noise, carried by
  ``convert.state_dict_from_flax``), on 64 x 80 frames: in eval, and in
  training with BN's batch statistics (dropout off on both sides: its
  masks are each package's own random draw), the running statistics after
  the step too.  Tolerance: 1e-4 of the largest absolute value.
* Dropout: element-wise, kept with probability 1 - rate and scaled, from
  the caller's generator; off in eval.
* ``convert.convert_enet_checkpoint`` against the JAX converter through
  ``state_dict_from_flax``, bitwise, on a torch ENet with the reference's
  ``scannetv2_enet.pth`` layout and random weights
  (``tests/test_convert_enet.py``'s ``build_reference_enet``); the converted port model against that
  torch model's activations (1e-4 of the largest value).
* ``flax_from_state_dict`` gives the JAX tree back bitwise (4-D kernels,
  PReLU alphas); a 3-D kernel is refused.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from tests.test_convert_enet import _randomize, build_reference_enet

from scan2cap_tpu.convert import (
    convert_enet_checkpoint as jconvert_enet_checkpoint)
from scan2cap_tpu.models.enet import ENetClassifier as JENetClassifier
from scan2cap_tpu.models.enet import ENetEncoder as JENetEncoder

from scan2cap_torch.convert import (convert_enet_checkpoint,
                                    flax_from_state_dict, named_from_flax,
                                    state_dict_from_flax)
from scan2cap_torch.models import enet
from scan2cap_torch.models.enet import (ENetClassifier, ENetEncoder,
                                        create_enet_for_3d)

TOL = 1e-4


def _close(got, want, what):
    scale = np.abs(want).max()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _frames(seed=1, shape=(2, 64, 80)):
    return np.random.RandomState(seed).randn(*shape, 3).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 1)


def _jax_variables(module, x, seed=3):
    """The JAX module's initial variables with every parameter and
    statistic moved by seeded noise (variances kept positive)."""
    v = jax.jit(module.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + rs.randn(
        *a.shape).astype(np.float32) * 0.05, v["params"])
    stats = jax.tree.map(lambda a: np.abs(np.asarray(a) + rs.randn(
        *a.shape).astype(np.float32) * 0.1) + 0.1, v["batch_stats"])
    return params, stats


@pytest.fixture(scope="module")
def encoder_pair():
    x = _frames()
    params, stats = _jax_variables(JENetEncoder(), x)
    model = ENetEncoder(device="cpu")
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return x, params, stats, model


def test_trunk_and_classifier_shapes():
    trunk, clf = create_enet_for_3d(41, device="cpu")
    with torch.no_grad():
        assert trunk(torch.zeros(1, 3, 256, 328)).shape == (1, 128, 32, 41)
        feat, logits = clf(torch.zeros(1, 3, 32, 40))
    assert feat.shape == (1, 128, 4, 5) and logits.shape == (1, 41, 4, 5)
    assert trunk.device.type == clf.device.type == clf.encoder.device.type


def test_trunk_eval_matches_jax(encoder_pair):
    x, params, stats, model = encoder_pair
    want = jax.jit(lambda v, x: JENetEncoder().apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = model(_nchw(x))
    _close(_nhwc(got), np.asarray(want), "eval features")


def test_trunk_train_mode_matches_jax(encoder_pair, monkeypatch):
    x, params, stats, model = encoder_pair
    # dropout off on both sides: each package draws its own masks
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    want, mutated = jax.jit(lambda v, x: JENetEncoder().apply(
        v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    rates = {m: m.dropout_rate for m in model.modules()
             if isinstance(m, enet.Bottleneck)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        for m in rates:
            m.dropout_rate = 0.0
        with torch.no_grad():
            got = model(_nchw(x), train=True)
        after = {k: v.clone() for k, v in model.state_dict().items()}
    finally:
        for m, rate in rates.items():
            m.dropout_rate = rate
        model.load_state_dict(before)
    _close(_nhwc(got), np.asarray(want), "train-mode features")
    # the running statistics after the step: Flax's momentum 0.9, the
    # biased batch variance
    _, new_stats = flax_from_state_dict(after)
    flat = jax.tree_util.tree_flatten_with_path(mutated["batch_stats"])[0]
    for path, value in flat:
        node = new_stats
        for k in path:
            node = node[k.key]
        _close(node, np.asarray(value), jax.tree_util.keystr(path))


def test_classifier_matches_jax():
    x = _frames(seed=2, shape=(1, 32, 40))
    params, stats = _jax_variables(JENetClassifier(41), x, seed=4)
    model = ENetClassifier(41, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    feat, logits = jax.jit(lambda v, x: JENetClassifier(41).apply(
        v, x, train=False))({"params": params, "batch_stats": stats},
                            jnp.asarray(x))
    with torch.no_grad():
        tfeat, tlogits = model(_nchw(x))
    _close(_nhwc(tfeat), np.asarray(feat), "classifier features")
    _close(_nhwc(tlogits), np.asarray(logits), "logits")


def test_dropout_is_elementwise_from_the_callers_generator():
    x = torch.ones(4, 8, 16, 16)
    assert enet.dropout(x, 0.1, False, None) is x
    assert enet.dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        enet.dropout(x, 0.1, True, None)
    a = enet.dropout(x, 0.25, True, torch.Generator().manual_seed(5))
    b = enet.dropout(x, 0.25, True, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    # element-wise: a channel is neither all kept nor all dropped
    per_channel = kept.float().mean(dim=(2, 3))
    assert ((per_channel > 0) & (per_channel < 1)).all()
    model = ENetEncoder(device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(1, 3, 32, 40), train=True)


@pytest.fixture(scope="module")
def reference_enet(tmp_path_factory):
    model = build_reference_enet()
    _randomize(model)
    model.eval()
    path = tmp_path_factory.mktemp("enet") / "scannetv2_enet.pth"
    torch.save(model.state_dict(), str(path))
    return model, str(path)


@pytest.mark.parametrize("include_classifier", [False, True])
def test_convert_enet_checkpoint_matches_jax_bitwise(reference_enet,
                                                     include_classifier):
    _, path = reference_enet
    want = state_dict_from_flax(*jconvert_enet_checkpoint(
        path, include_classifier=include_classifier))
    got = convert_enet_checkpoint(path, include_classifier)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # from the state dict itself, as from the file
    sd = torch.load(path, weights_only=True)
    again = convert_enet_checkpoint(sd, include_classifier)
    assert all(torch.equal(again[k], want[k]) for k in want)
    model = (ENetClassifier(device="cpu") if include_classifier
             else ENetEncoder(device="cpu"))
    model.load_state_dict(got, strict=True)


def test_converted_enet_matches_the_reference_model(reference_enet):
    ref, path = reference_enet
    x = _nchw(_frames(seed=6))
    model = ENetClassifier(device="cpu")
    model.load_state_dict(convert_enet_checkpoint(path, True), strict=True)
    with torch.no_grad():
        want_feat, want_logits = ref[:26](x).numpy(), ref(x).numpy()
        feat, logits = model(x)
    _close(feat.numpy(), want_feat, "trunk")
    _close(logits.numpy(), want_logits, "logits")


def test_flax_tree_round_trips_conv_kernels_and_alphas(encoder_pair):
    _, params, stats, model = encoder_pair
    back_params, back_stats = flax_from_state_dict(model.state_dict())
    for want, got in ((params, back_params), (stats, back_stats)):
        assert (jax.tree.structure(jax.tree.map(np.asarray, want))
                == jax.tree.structure(got))
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert back_params["b2_3"]["conv_a"]["kernel"].shape == (1, 5, 32, 32)
    assert back_params["initial"]["prelu"]["alpha"].shape == (16,)
    with pytest.raises(ValueError, match="4-D Conv2D"):
        named_from_flax({"conv": {"kernel": np.zeros((3, 4, 5), np.float32)}})


def test_flax_export_keys_alphas_on_prelu_modules():
    one = torch.ones(4)
    params, _ = flax_from_state_dict({"blk.prelu_out.weight": one,
                                      "blk.bn.weight": one,
                                      "blk.bn.bias": one})
    assert set(params["blk"]["prelu_out"]) == {"alpha"}
    assert set(params["blk"]["bn"]) == {"scale", "bias"}
    # a bias-free 1-D weight outside a prelu* module is not taken for one
    with pytest.raises(KeyError, match="needs its bias"):
        flax_from_state_dict({"blk.norm.weight": one})
