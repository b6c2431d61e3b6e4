"""Port point ops (scan2cap_torch.ops) against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through the JAX op and the
port's plain PyTorch version.  Indices must be equal; floats within 1e-6
(gathers and weighted sums of the same float32 values).
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scan2cap_tpu.ops import boxes as jboxes
from scan2cap_tpu.ops import grouping as jgrouping
from scan2cap_tpu.ops import interpolate as jinterp
from scan2cap_tpu.ops.pallas.ballquery import ball_query_pack_pallas
from scan2cap_tpu.ops.pallas.fps import furthest_point_sample_pallas
from scan2cap_tpu.ops.sampling import _furthest_point_sample_xla
from scan2cap_tpu.ops.sampling import gather_points as jgather_points

from scan2cap_torch import kernels
from scan2cap_torch.ops import boxes, distance, grouping, interpolate, sampling

# both packages export a function named like its module
jnn = importlib.import_module("scan2cap_tpu.ops.nn_distance")
nn_distance = importlib.import_module("scan2cap_torch.ops.nn_distance")

T = torch.from_numpy


def _fps_case(name):
    rs = np.random.RandomState(7)
    if name == "random":
        return rs.randn(2, 1300, 3).astype(np.float32), 64
    if name == "padding":
        x = rs.randn(2, 500, 3).astype(np.float32) + 3.0
        x[:, 300:] = 0.0                       # zero padding never selected
        return x, 32
    if name == "all_invalid":
        x = rs.randn(2, 400, 3).astype(np.float32) + 2.0
        x[1] = 0.0
        return x, 16
    if name == "ties":
        x = np.round(rs.randn(3, 700, 3) * 2.0).astype(np.float32) / 2.0
        x[:, 350:] = x[:, :350]                # duplicate points: exact ties
        x[2] = 0.0
        return x, 48
    if name == "multi_program":                # B > 8: two Pallas programs
        return rs.randn(10, 1100, 3).astype(np.float32), 48
    raise KeyError(name)


@pytest.mark.parametrize("case", ["random", "padding", "all_invalid", "ties",
                                  "multi_program"])
def test_fps_plain_matches_xla_and_pallas(case):
    xyz, npoint = _fps_case(case)
    got = sampling.furthest_point_sample(T(xyz), npoint).numpy()
    want = np.asarray(_furthest_point_sample_xla(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(furthest_point_sample_pallas(
        jnp.asarray(xyz), npoint, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32
    if case == "padding":
        assert got.max() < 300
    if case == "all_invalid":
        assert (got[1] == 0).all()


def _bq_inputs():
    rs = np.random.RandomState(11)
    # a 0.1 lattice: many points lie exactly on the radius of a query
    pts = (np.round(rs.uniform(-.5, .5, (2, 1000, 3)) * 10) / 10).astype(np.float32)
    q = pts[:, :600].copy()                    # more queries than one slab
    q[:, 590:] += 40.0                         # rows with no hit at all
    return pts, q


@pytest.mark.parametrize("radius,nsample", [(0.1, 4), (0.2, 16), (0.3, 64),
                                            (0.8, 32)])
def test_ball_query_plain_matches_jax(radius, nsample):
    pts, q = _bq_inputs()
    got = grouping.ball_query(T(pts), T(q), radius, nsample).numpy()
    want = np.asarray(jgrouping.ball_query(jnp.asarray(pts), jnp.asarray(q),
                                           radius, nsample))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 590:] == 0).all()           # no hit -> zeros
    counts = grouping.ball_query_pack_plain(
        T(pts), T(q), grouping.radius_squared(radius))[1].sum(-1)
    assert (counts > nsample).any()            # rows cut at nsample


def test_unfused_distances_would_diverge(monkeypatch):
    # the lattice puts points exactly on the radius: one rounding per op
    # (no FMA) moves them across d2 < r2, so the FMA order above matters
    pts, q = _bq_inputs()
    want = np.asarray(jgrouping.ball_query(jnp.asarray(pts), jnp.asarray(q),
                                           0.3, 64))
    monkeypatch.setattr(grouping, "sq_dist_elementwise",
                        lambda dx, dy, dz: dx * dx + dy * dy + dz * dz)
    got = grouping.ball_query(T(pts), T(q), 0.3, 64).numpy()
    rows = int((got != want).any(-1).sum())
    print(f"rows differing without FMA: {rows} of {want.shape[0] * want.shape[1]}")
    assert rows > 0


@pytest.mark.parametrize("shape", [(2, 4500, 96), (1, 1000, 100)])
def test_pack_plain_matches_pallas(shape):
    B, N, M = shape
    rs = np.random.RandomState(13)
    if N == 1000:
        pts = _bq_inputs()[0][:1]
        r2 = grouping.radius_squared(0.3)
    else:
        pts = rs.randn(B, N, 3).astype(np.float32)
        r2 = grouping.radius_squared(0.2)
    q = pts[:, :M]
    words, counts = grouping.ball_query_pack_plain(T(pts), T(q), r2)
    pw, pc = ball_query_pack_pallas(jnp.asarray(pts), jnp.asarray(q), r2,
                                    interpret=True)
    W = -(-N // 32)
    assert words.dtype == torch.uint32 and words.shape == (B, M, W)
    np.testing.assert_array_equal(words.numpy(), np.asarray(pw)[..., :W])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(pc)[..., :W])


def test_pack_all_ones_words():
    rs = np.random.RandomState(0)
    pts = (rs.rand(1, 4096, 3) * 0.05).astype(np.float32)
    words, counts = grouping.ball_query_pack_plain(
        T(pts), T(pts[:, :64]), grouping.radius_squared(0.5))
    assert (words.numpy() == 0xFFFFFFFF).all() and (counts.numpy() == 32).all()


def test_sq_dist_rounding_matches_xla():
    rs = np.random.RandomState(1)
    d = [rs.randn(100000).astype(np.float32) for _ in range(3)]
    ew = np.asarray(jax.jit(lambda a, b, c: a * a + b * b + c * c)(*d))
    red = np.asarray(jax.jit(lambda v: jnp.sum(v ** 2, axis=-1))(
        np.stack(d, -1)))
    np.testing.assert_array_equal(
        distance.sq_dist_elementwise(*map(T, d)).numpy(), ew)
    np.testing.assert_array_equal(
        distance.sq_dist_reduce(*map(T, d)).numpy(), red)


def test_fma32_single_rounding():
    rs = np.random.RandomState(2)
    a, b, c = (rs.randn(50000).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    np.testing.assert_array_equal(distance.fma32(T(a), T(b), T(c)).numpy(),
                                  want)
    # exact products: a*b + c with no rounding left equals the f32 value
    x = T(np.float32([1.5, 3.0])), T(np.float32([2.0, 0.5])), T(np.float32([1.0, -1.5]))
    np.testing.assert_array_equal(distance.fma32(*x).numpy(), [4.0, 0.0])


def test_three_nn_and_interpolate_match_jax():
    rs = np.random.RandomState(3)
    unknown = rs.randn(2, 300, 3).astype(np.float32)
    known = rs.randn(2, 64, 3).astype(np.float32)
    known[:, 32:] = known[:, :32]              # duplicate points: tie order
    feats = rs.randn(2, 64, 16).astype(np.float32)
    jd, ji = jinterp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    d, i = interpolate.three_nn(T(unknown), T(known))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    w = interpolate.interpolation_weights(d)
    jw = jinterp.interpolation_weights(jd)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    out = interpolate.three_interpolate(T(feats), i, w)
    jout = jinterp.three_interpolate(jnp.asarray(feats), ji, jw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)


def test_group_and_gather_match_jax():
    rs = np.random.RandomState(4)
    feats = rs.randn(2, 50, 8).astype(np.float32)
    idx = rs.randint(0, 50, (2, 12, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        grouping.group_points(T(feats), T(idx)).numpy(),
        np.asarray(jgrouping.group_points(jnp.asarray(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        sampling.gather_points(T(feats), T(idx[:, :, 0])).numpy(),
        np.asarray(jgather_points(jnp.asarray(feats), jnp.asarray(idx[:, :, 0]))))


@pytest.mark.parametrize("use_xyz,normalize", [(True, True), (False, False)])
def test_query_and_group_matches_jax(use_xyz, normalize):
    pts, q = _bq_inputs()
    feats = np.random.RandomState(5).randn(2, 1000, 6).astype(np.float32)
    got = grouping.query_and_group(T(pts), T(q), T(feats), 0.3, 16,
                                   use_xyz=use_xyz, normalize_xyz=normalize)
    want = jgrouping.query_and_group(jnp.asarray(pts), jnp.asarray(q),
                                     jnp.asarray(feats), 0.3, 16,
                                     use_xyz=use_xyz, normalize_xyz=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    ga = grouping.group_all(T(pts), T(feats))
    np.testing.assert_array_equal(
        ga.numpy(), np.asarray(jgrouping.group_all(jnp.asarray(pts),
                                                   jnp.asarray(feats))))


def test_boxes_match_jax():
    rs = np.random.RandomState(6)
    size = rs.uniform(0.2, 2.0, (2, 40, 3)).astype(np.float32)
    center = rs.uniform(-3, 3, (2, 40, 3)).astype(np.float32)
    heading = np.zeros((2, 40), np.float32)
    c = boxes.get_3d_box_batch(T(size), T(heading), T(center))
    jc = jboxes.get_3d_box_batch(jnp.asarray(size), jnp.asarray(heading),
                                 jnp.asarray(center))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    iou = boxes.box3d_iou_matrix(c, c)
    jiou = jax.vmap(jboxes.box3d_iou_matrix)(jc, jc)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=1e-6,
                               atol=1e-7)


def test_cpu_tensors_take_the_plain_version():
    kernels.reset_launch_counts()
    x = T(np.random.RandomState(0).randn(1, 100, 3).astype(np.float32))
    sampling.furthest_point_sample(x, 8)
    idx = grouping.ball_query(x, x[:, :4], 0.5, 4)
    grouping.group_points(x, idx)
    assert all(w.launches == 0 for w in kernels.WRAPPERS)
    with pytest.raises(ValueError):
        kernels.group_points_cuda(x, idx)
    with pytest.raises(ValueError):
        kernels.furthest_point_sample_cuda(x, 8)
    with pytest.raises(ValueError):
        kernels.ball_query_cuda(x, x, 0.25, 4)
    with pytest.raises(ValueError):
        kernels.ball_query_pack_cuda(x, x, 0.25)


@pytest.mark.parametrize("C", [3, 8, 138])
def test_group_points_gradient_matches_jax(C):
    # forward exact; gradient (a scatter-add with repeated indices) 1e-6
    rs = np.random.RandomState(8)
    feats = rs.randn(2, 60, C).astype(np.float32)
    idx = rs.randint(0, 60, (2, 9, 7)).astype(np.int32)
    idx[:, :, 4:] = idx[:, :, :1]              # padded slots repeat a row
    idx[0, 0, 0], idx[0, 0, 1] = 0, 59         # first and last row
    g = rs.randn(2, 9, 7, C).astype(np.float32)
    jfn = lambda f: jgrouping.group_points(f, jnp.asarray(idx))
    want = np.asarray(jax.jit(jfn)(jnp.asarray(feats)))
    jgrad = jax.jit(jax.grad(lambda f: jnp.sum(jfn(f) * g)))(jnp.asarray(feats))
    t = T(feats).requires_grad_(True)
    out = grouping.group_points(t, T(idx))
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_array_equal(
        grouping.group_points_plain(T(feats), T(idx)).numpy(), want)
    (out * T(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-6)
    # and the same gradient as autograd through the plain gather
    t2 = T(feats).requires_grad_(True)
    (grouping.group_points_plain(t2, T(idx)) * T(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), t2.grad.numpy(), rtol=0,
                               atol=1e-6)


def test_group_points_keeps_the_graph_under_no_grad_and_inference():
    feats = T(np.random.RandomState(9).randn(1, 10, 4).astype(np.float32))
    idx = T(np.array([[[0, 9, 3]]], np.int32))
    with torch.inference_mode():
        out = grouping.group_points(feats, idx)
    assert out.shape == (1, 1, 3, 4) and not out.requires_grad
    assert grouping.group_points(feats.requires_grad_(True), idx).requires_grad


@pytest.mark.parametrize("mode", ["l2", "l1", "l1smooth"])
def test_nn_distance_matches_jax(mode):
    # indices exact (lowest index among equal minima), floats 1e-5
    rs = np.random.RandomState(10)
    a = rs.uniform(-2, 2, (2, 40, 3)).astype(np.float32)
    b = rs.uniform(-2, 2, (2, 16, 3)).astype(np.float32)
    b[:, 8:] = 0.0                             # padded rows: exact ties
    a[0, 5] = b[0, 3]                          # a zero distance
    kw = dict(l1=mode == "l1", l1smooth=mode == "l1smooth")
    want = jax.jit(lambda x, y: jnn.nn_distance(x, y, **kw))(
        jnp.asarray(a), jnp.asarray(b))
    got = nn_distance.nn_distance(T(a), T(b), **kw)
    for g, w, exact in zip(got, want, (False, True, False, True)):
        if exact:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_nn_distance_gradient_matches_jax():
    rs = np.random.RandomState(11)
    a = rs.uniform(-2, 2, (2, 20, 3)).astype(np.float32)
    b = rs.uniform(-2, 2, (2, 12, 3)).astype(np.float32)
    b[:, 6:] = 0.0                             # ties among the padded rows

    def jloss(x):
        d1, _, d2, _ = jnn.nn_distance(x, jnp.asarray(b))
        return jnp.sum(d1) + 2.0 * jnp.sum(d2)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(a)))
    t = T(a).requires_grad_(True)
    d1, _, d2, _ = nn_distance.nn_distance(t, T(b))
    (d1.sum() + 2.0 * d2.sum()).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_huber_loss_matches_jax():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    for delta in (1.0, 0.5):
        np.testing.assert_allclose(
            nn_distance.huber_loss(T(x), delta).numpy(),
            np.asarray(jnn.huber_loss(jnp.asarray(x), delta)), rtol=1e-6,
            atol=1e-7)


def test_box3d_iou_batch_matches_jax():
    rs = np.random.RandomState(12)
    size = rs.uniform(0.2, 2.0, (2, 30, 3)).astype(np.float32)
    center = rs.uniform(-1, 1, (2, 30, 3)).astype(np.float32)
    c = boxes.get_3d_box_batch(T(size), T(np.zeros((2, 30), np.float32)),
                               T(center))
    ref = c[:, 4]                                            # (2, 8, 3)
    got = boxes.box3d_iou_batch(c, ref[:, None])
    want = jboxes.box3d_iou_batch(jnp.asarray(c.numpy()),
                                  jnp.asarray(ref.numpy())[:, None])
    assert got.shape == (2, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    assert got[:, 4].min() > 0.999                           # a box with itself
