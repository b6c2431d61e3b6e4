"""The port's ResNet extractor (``scan2cap_torch/twod/resnet.py``) against
the JAX package's and torch's own torchvision-layout model; mirrors
``tests/test_convert_resnet.py``.

A torch ResNet in torchvision's ``resnet101`` layout at reduced depth and
width (``tests/test_convert_resnet.py``'s ``TinyResNet``, random weights
and running statistics) is converted by both packages:
* the trees bitwise (kernels, folded scale and shift, strides), block
  counts and downsamples inferred from the keys;
* activations of the port's ``ResNet`` (cuDNN-style ``conv2d`` with its
  folded BatchNorm, the -inf padded max-pool) within 1e-4 relative of
  JAX's ``resnet_apply`` (``conv_general_dilated``) and of the torch model;
* ``make_pth_extractor``'s backend tag and normalization against JAX's
  extractor, ``$SCAN2CAP_RESNET_PTH`` routing, the random-projection tag;
* the seeded torchvision-layout state dict that stands in for a released
  ``resnet101.pth`` loads into torch's model and converts at full depth.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_convert_resnet import TinyResNet, _randomized

from scan2cap_tpu.twod import resnet as jresnet

from scan2cap_torch.twod import resnet
from scan2cap_torch.twod.preprocessing import make_resnet_extractor

RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: idle threads spinning on cores that other test
    workers share make the file many times dearer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    model = _randomized(TinyResNet())
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, sd, resnet.convert_resnet_checkpoint(sd)


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, int):
        assert a == b, path
    else:
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


def test_converter_matches_jax_bitwise(tiny):
    _, sd, params = tiny
    _same_tree(params, jresnet.convert_resnet_checkpoint(sd))


def test_structure_inference(tiny):
    _, _, params = tiny
    assert [len(params[f"layer{i}"]) for i in (1, 2, 3, 4)] == [2, 2, 1, 1]
    assert "downsample" in params["layer1"][0]       # channel-widening, s=1
    assert params["layer1"][0]["stride"] == 1
    assert "downsample" not in params["layer1"][1]
    assert params["layer2"][0]["stride"] == 2
    model = resnet.resnet_from_params(params, device="cpu")
    assert [len(getattr(model, f"layer{i}")) for i in (1, 2, 3, 4)] == \
        [2, 2, 1, 1]
    assert model.layer2[0].conv2.stride == 2
    assert model.layer1[0].downsample is not None
    assert model.layer1[1].downsample is None


@pytest.mark.parametrize("shape", [(2, 64, 96, 3), (1, 37, 53, 3)])
def test_activation_parity(tiny, shape):
    torch_model, _, params = tiny
    model = resnet.resnet_from_params(params, device="cpu")
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        got = model(nchw).numpy()
        want_torch = torch_model(nchw).numpy()
    want_jax = np.asarray(jresnet.resnet_apply(params, jnp.asarray(x)))
    for want in (want_jax, want_torch):
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_max_pool_pads_with_minus_infinity():
    """A stem whose outputs are all negative: -inf padding keeps the
    border's own maximum where zero padding would give 0."""
    model = resnet.ResNet((1, 1, 1, 1), width=4).eval()
    x = -torch.rand(1, 4, 5, 5) - 1.0
    pooled = torch.nn.functional.max_pool2d(x, 3, 2, 1)
    assert (pooled < 0).all()
    assert model.stem.padding == 3 and model.stem.stride == 2


def test_pth_extractor_backend_and_normalization(tiny, tmp_path):
    torch_model, _, _ = tiny
    pth = tmp_path / "resnet_tiny.pth"
    torch.save(torch_model.state_dict(), pth)
    extract = resnet.make_pth_extractor(str(pth), device="cpu")
    jextract = jresnet.make_pth_extractor(str(pth))
    assert extract.backend == jextract.backend == "resnet:pth"
    imgs = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    feats = extract(imgs)
    assert feats.shape == (2, 8 * 8 * 4) and feats.dtype == np.float32
    want = jextract(imgs)
    np.testing.assert_allclose(feats, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # normalization applied: features differ from the raw input's
    with torch.no_grad():
        raw = extract.model(torch.from_numpy(
            np.ascontiguousarray(imgs.transpose(0, 3, 1, 2)))).numpy()
    assert not np.allclose(feats, raw)


def test_make_resnet_extractor_routes(tiny, tmp_path, monkeypatch):
    torch_model, _, _ = tiny
    pth = tmp_path / "resnet_tiny.pth"
    torch.save(torch_model.state_dict(), pth)
    monkeypatch.setenv("SCAN2CAP_RESNET_PTH", str(pth))
    assert make_resnet_extractor(device="cpu").backend == "resnet:pth"
    monkeypatch.delenv("SCAN2CAP_RESNET_PTH")
    assert make_resnet_extractor(pth=str(pth),
                                 device="cpu").backend == "resnet:pth"
    # no weights anywhere (offline): the random projection, tagged
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    extract = make_resnet_extractor(device="cpu")
    assert extract.backend == "random-projection-fallback"
    from scan2cap_tpu.twod.preprocessing import (
        make_resnet_extractor as jmake)
    imgs = np.random.RandomState(4).rand(2, 48, 40, 3).astype(np.float32)
    assert extract(imgs).tobytes() == jmake()(imgs).tobytes()


def test_entry_point_needs_cuda_unless_asked(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    torch_model, _, _ = tiny
    pth = tmp_path / "resnet_tiny.pth"
    torch.save(torch_model.state_dict(), pth)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet.make_pth_extractor(str(pth))


def test_random_torchvision_state_dict_is_torchvisions_layout():
    sd = resnet.random_torchvision_state_dict((2, 2, 1, 1), width=8, seed=3)
    want = TinyResNet().state_dict()
    fc = {"fc.weight", "fc.bias"}
    assert set(sd) - fc == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape and sd[k].dtype == v.dtype, k
    again = resnet.random_torchvision_state_dict((2, 2, 1, 1), width=8,
                                                 seed=3)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    full = resnet.random_torchvision_state_dict(seed=0)
    params = resnet.convert_resnet_checkpoint(full)
    assert [len(params[f"layer{i}"]) for i in (1, 2, 3, 4)] == [3, 4, 23, 3]
    model = resnet.resnet_from_params(params, device="cpu")
    with torch.no_grad():
        out = model(torch.rand(1, 3, 64, 64))
    # pooled features of a trained network's order, not grown by depth
    assert out.shape == (1, 2048) and torch.isfinite(out).all()
    assert 0.0 < float(out.abs().max()) < 100.0
