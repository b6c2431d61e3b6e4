"""The port's ``data/projection.py`` against ``scan2cap_tpu.data.projection``
on the CPU, exactly: the ScanNet constants, frustum corners and normals,
the frustum test, each frame's point -> pixel correspondence and the
scatter, on random scenes seen from random poses; and the cases of
``tests/test_enet_projection.py`` (an identity camera, the scatter, the
frustum's culling)."""

import numpy as np

from scan2cap_tpu.data import projection as jprojection

from scan2cap_torch.data import projection
from scan2cap_torch.data.projection import (
    DEPTH_MAX, DEPTH_MIN, PROJECTION_ACCURACY, PROJECTOR_IMAGE_DIMS,
    SCANNET_INTRINSICS, ProjectionHelper)

import chip_smoke


def _pair():
    args = (SCANNET_INTRINSICS, DEPTH_MIN, DEPTH_MAX, PROJECTOR_IMAGE_DIMS,
            PROJECTION_ACCURACY)
    return ProjectionHelper(*args), jprojection.ProjectionHelper(*args)


def test_constants_equal_the_jax_package():
    for name in ("SCANNET_INTRINSICS", "PROJECTOR_IMAGE_DIMS", "DEPTH_MIN",
                 "DEPTH_MAX", "PROJECTION_ACCURACY"):
        got, want = getattr(projection, name), getattr(jprojection, name)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype, name


def _pose(rs):
    """A camera above a 6 x 6 m room looking at a random point of it."""
    eye = np.array([*rs.uniform(-3, 3, 2), rs.uniform(1.0, 2.0)])
    return chip_smoke.look_at(np, eye, np.array([*rs.uniform(-3, 3, 2),
                                                 rs.uniform(0.0, 1.0)]))


def test_projection_of_random_scenes_equals_jax():
    port, ref = _pair()
    rs = np.random.RandomState(0)
    w, h = PROJECTOR_IMAGE_DIMS
    hits = 0
    for trial in range(40):
        n = rs.randint(1, 3000)
        points = np.concatenate([rs.uniform(-3, 3, (n, 2)),
                                 rs.uniform(0, 2, (n, 1))], 1)
        if trial % 2:
            points = points.astype(np.float32)
        pose = _pose(rs) if trial % 5 else np.eye(4)
        # depth: the points' own, with noise around the 5 cm gate, or flat
        depth = rs.uniform(0.05, 4.5, (h, w)).astype(np.float32)
        corners = port.compute_frustum_corners(pose)
        np.testing.assert_array_equal(corners,
                                      ref.compute_frustum_corners(pose))
        normals = port.compute_frustum_normals(corners)
        np.testing.assert_array_equal(normals,
                                      ref.compute_frustum_normals(corners))
        np.testing.assert_array_equal(
            port.points_in_frustum(corners, normals, points),
            ref.points_in_frustum(corners, normals, points))
        got = port.compute_projection(points, depth, pose)
        want = ref.compute_projection(points, depth, pose)
        assert (got is None) == (want is None)
        if got is None:
            continue
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        hits += int(got[0][0])
        feats = rs.randn(3, h, w).astype(np.float32)
        np.testing.assert_array_equal(port.project(feats, *got, n),
                                      ref.project(feats, *want, n))
    assert hits > 0


def test_projection_of_rendered_frames_equals_jax(tmp_path):
    # the smoke's frames: depth rendered from the scene's own points, so
    # the depth check passes for the visible ones
    from scan2cap_torch.data.frames import load_depth, load_pose
    port, ref = _pair()
    rs = np.random.RandomState(1)
    points = np.concatenate([rs.uniform(-3, 3, (4000, 2)),
                             rs.uniform(0, 2, (4000, 1))], 1)
    chip_smoke.write_frames(np, str(tmp_path), "scene", points, 6, seed=2,
                            color_size=(8, 8))
    covered = 0
    for i in range(6):
        base = tmp_path / "scene"
        pose = load_pose(base / "pose" / f"{i:06d}.txt")
        depth = load_depth(base / "depth" / f"{i:06d}.png")
        got = port.compute_projection(points, depth, pose)
        want = ref.compute_projection(points, depth, pose)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        covered += int(got[0][0])
    assert covered > 6 * 100


def test_identity_camera_scatter_and_culling():
    port, _ = _pair()
    zs = np.array([0.5, 1.0, 2.0, 3.0])
    pts = np.stack([np.zeros(4), np.zeros(4), zs], 1)
    w, h = PROJECTOR_IMAGE_DIMS
    depth = np.full((h, w), 100.0, np.float32)
    depth[16, 20] = 1.0
    ind3d, ind2d = port.compute_projection(pts, depth, np.eye(4))
    assert ind3d[0] == 1 and ind3d[1] == 1 and ind2d[1] == 16 * w + 20

    feats = np.arange(2 * h * w, dtype=np.float32).reshape(2, h, w)
    ind3d = np.zeros(6, np.int64)
    ind2d = np.zeros(6, np.int64)
    ind3d[0] = ind2d[0] = 2
    ind3d[1:3] = [4, 1]
    ind2d[1:3] = [0, h * w - 1]
    out = port.project(feats, ind3d, ind2d, 5)
    assert out.shape == (2, 5) and out[0, 4] == 0 and out[1, 1] == feats[1, -1, -1]
    assert out[0, 0] == 0

    corners = port.compute_frustum_corners(np.eye(4))
    normals = port.compute_frustum_normals(corners)
    mask = port.points_in_frustum(corners, normals, np.array(
        [[0, 0, 1.0], [0, 0, 10.0], [0, 0, -1.0], [100, 0, 1.0]]))
    assert mask.tolist() == [True, False, False, False]
