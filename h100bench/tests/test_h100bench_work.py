"""The kernels' work counts against values worked out by hand."""

import pytest
import torch

from h100bench.harness import PEAK_BYTES, PEAK_F32_FLOPS
from h100bench.reference.ops import radius_squared
from h100bench.work import ball_query, fps


def test_fps_bound_is_the_larger_of_bytes_and_operations():
    B, N, npoint = 2, 1000, 16
    ops = B * (npoint - 1) * N * 9
    nbytes = B * N * 12 + B * npoint * 4
    assert fps.call_bound_s(B, N, npoint) == max(ops / PEAK_F32_FLOPS,
                                                 nbytes / PEAK_BYTES)
    assert fps.call_bound_s(16, 1024, 1) == 16 * 4 / PEAK_BYTES


def test_ball_query_tests_up_to_the_nsample_th_hit():
    # points on a line at x = 0, 1, ..., 9; radius 2.5 around x = 0 hits
    # 0, 1, 2 (indices 0, 1, 2) and, around x = 9, 7, 8, 9
    xyz = torch.zeros((1, 10, 3))
    xyz[0, :, 0] = torch.arange(10.0)
    q = torch.zeros((1, 3, 3))
    q[0, 1, 0] = 9.0
    q[0, 2, 0] = 100.0                 # no hit: all 10 tested
    r2 = radius_squared(2.5)
    t = ball_query.tested(xyz, q, r2, nsample=2)
    # query 0: second hit at index 1 -> 2 tests; query 1: second hit at
    # index 8 -> 9 tests
    assert t.tolist() == [[2, 9, 10]]
    t3 = ball_query.tested(xyz, q, r2, nsample=4)
    assert t3.tolist() == [[10, 10, 10]]      # fewer than 4 hits anywhere


def test_ball_query_bound():
    xyz = torch.zeros((1, 10, 3))
    xyz[0, :, 0] = torch.arange(10.0)
    q = torch.zeros((1, 2, 3))
    q[0, 1, 0] = 9.0
    r2 = radius_squared(2.5)
    pairs, points, M, nsample = 2 + 9, 9, 2, 2
    want = max(pairs * 9 / PEAK_F32_FLOPS,
               (points * 12 + M * 12 + M * nsample * 4) / PEAK_BYTES)
    assert ball_query.call_bound_s(xyz, q, r2, 2) == pytest.approx(want)
