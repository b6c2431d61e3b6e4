"""Point-axis sharding of the port (``scan2cap_torch.parallel.spatial``,
``ModelConfig.spatial_axis``) on the CPU: ranks over gloo, one torch thread
each (mirrors tests/test_parallel_spatial.py).

The sharded ball query and query-and-group equal the unsharded port op
and jitted JAX index for index at (2, 4), issue no collective on the data
group, and stay exact with the query axis over the data group.  The
backbone with ``spatial_axis="model"`` at (2, 2) and (1, 4) gives the
unsharded backbone's indices exactly and its features within 1e-5; its
train-mode loss is within 1e-4 relative and every gradient within 5e-4 of
the largest (the JAX test's bounds).  Without a mesh the sharded ops stop.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scan2cap_tpu.ops import grouping as jgrouping

import torch_mesh_ranks as ranks
from scan2cap_torch.models.backbone import Pointnet2Backbone
from scan2cap_torch.models.layers import seeded_init
from scan2cap_torch.ops import grouping
from scan2cap_torch.parallel import mesh as pmesh
from scan2cap_torch.parallel import spatial

SA = (64, 32, 16, 16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ops():
    rs = np.random.RandomState(0)
    xyz = torch.from_numpy(rs.rand(2, 600, 3).astype(np.float32) * 3)
    feats = torch.from_numpy(rs.randn(2, 600, 6).astype(np.float32))
    new_xyz = xyz[:, :64].contiguous()
    args = (xyz, new_xyz, feats, 0.5, 8)
    res = {axis: pmesh.launch(pmesh.MeshSpec(2, 4), "cpu",
                              ranks.spatial_ops, *args, axis)
           for axis in ("model", "data")}
    return dict(res, args=args)


def test_ball_query_sharded_exact(ops):
    xyz, new_xyz, _, r, ns = ops["args"]
    want = grouping.ball_query(xyz, new_xyz, r, ns)
    jwant = np.asarray(jax.jit(
        lambda a, b: jgrouping.ball_query(a, b, r, ns))(
            jnp.asarray(xyz.numpy()), jnp.asarray(new_xyz.numpy())))
    np.testing.assert_array_equal(want.numpy(), jwant)
    np.testing.assert_array_equal(ops["model"]["idx"].numpy(), jwant)


def test_query_and_group_sharded_exact(ops):
    xyz, new_xyz, feats, r, ns = ops["args"]
    want = grouping.query_and_group(xyz, new_xyz, feats, r, ns,
                                    use_xyz=True, normalize_xyz=True)
    jwant = np.asarray(jax.jit(lambda a, b, f: jgrouping.query_and_group(
        a, b, f, radius=r, nsample=ns, use_xyz=True, normalize_xyz=True))(
            jnp.asarray(xyz.numpy()), jnp.asarray(new_xyz.numpy()),
            jnp.asarray(feats.numpy())))
    got = ops["model"]["grouped"].numpy()
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_allclose(got, jwant, atol=1e-6)


def test_spatial_at_2x4_has_no_data_collectives(ops):
    res = ops["model"]
    assert res["bq_collectives"] == {"model": 1}
    for counts in res["ranks"]:
        assert counts.get("data", 0) == 0 and counts["model"] > 0, counts


def test_query_axis_named_data_stays_exact(ops):
    xyz, new_xyz, _, r, ns = ops["args"]
    want = grouping.ball_query(xyz, new_xyz, r, ns)
    np.testing.assert_array_equal(ops["data"]["idx"].numpy(), want.numpy())
    for counts in ops["data"]["ranks"]:
        assert counts.get("model", 0) == 0 and counts["data"] > 0, counts


def test_spatial_ops_need_a_mesh():
    xyz = torch.zeros((1, 64, 3))
    with pytest.raises(ValueError, match="spatial"):
        spatial.ball_query_sharded(xyz, xyz[:, :8], 0.3, 4, axis="model")


@pytest.fixture(scope="module")
def backbone():
    rs = np.random.RandomState(2)
    B, N = 4, 512
    pc = torch.from_numpy(np.concatenate(
        [rs.rand(B, N, 3) * 4 - 2, rs.randn(B, N, 2) * 0.1],
        axis=-1).astype(np.float32))
    net = Pointnet2Backbone(2, SA)
    seeded_init(net, 1)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        want = net({"point_clouds": pc}, train=False)
    out = net({"point_clouds": pc}, train=True, bn_momentum=0.1)
    loss = torch.sum(out["fp2_features"] ** 2) * 1e-3
    loss.backward()
    res = {shape: pmesh.launch(pmesh.MeshSpec(*shape), "cpu",
                               ranks.spatial_backbone, SA, pc, sd)
           for shape in ((2, 2), (1, 4))}
    return dict(res, want=want, loss=float(loss.detach()),
                grads={n: p.grad.clone() for n, p in net.named_parameters()})


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_backbone_spatial_axis_exact(backbone, shape):
    got, want = backbone[shape]["eval"], backbone["want"]
    for k in ("sa1_inds", "sa2_inds", "fp2_inds"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    for k in ("sa1_features", "sa4_features", "fp2_features"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_backbone_spatial_axis_grads_match(backbone, shape):
    got = backbone[shape]
    want_l = backbone["loss"]
    assert abs(got["loss"] - want_l) <= 1e-4 * abs(want_l)
    gmax = max(float(g.abs().max()) for g in backbone["grads"].values())
    for n, g in backbone["grads"].items():
        d = float((got["grads"][n] - g).abs().max())
        # a dropped sum over the model group would be of order one
        assert d <= 5e-4 * gmax, (n, d, gmax)
    # every rank ends with the same gradients
    assert len(set(got["grad_sums"])) == 1, got["grad_sums"]
