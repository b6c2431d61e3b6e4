"""Hold a path's kernel launches against their plain versions on the card.

While a ``HeldAgainstPlain`` is open, every launch of the path's three
kernels through ``scan2cap_torch.ops`` (FPS, the first-k ball query, the
row gather) must receive float32 and is held against its plain PyTorch
version on the same inputs on the same card, and must equal it exactly.
It swaps the wrappers at their call sites in ``ops.sampling`` and
``ops.grouping`` (the custom ops of ``ops/library.py`` look them up there
at each call) and restores them on exit.  The plain versions launch no
wrapper, so the launch counts stay the path's.  ``chip_smoke.py`` and
``scripts/dryrun_multicard`` hold their steps with it.
"""

from __future__ import annotations

import torch


class HeldAgainstPlain:
    """``checked`` lists (kernel, shape) per launch; ``outputs`` (with
    ``record``) the kernels' results on the host, by kernel, in launch
    order.  A launch that differs from its plain version, or receives
    another dtype than float32, raises ``error``."""

    def __init__(self, record: bool = False, error=RuntimeError):
        from scan2cap_torch.ops import grouping, sampling
        self.grouping, self.sampling = grouping, sampling
        self.error = error
        self.checked = []
        self.outputs = {} if record else None

    def fps(self, xyz, npoint, **kw):
        self._float32("furthest_point_sample_cuda", xyz)
        got = self.kernels["fps"](xyz, npoint, **kw)
        want = self.sampling.furthest_point_sample_plain(xyz, npoint)
        self._hold("furthest_point_sample_cuda", got, want,
                   [*xyz.shape[:2], npoint])
        return got

    def first_k(self, xyz, new_xyz, r2, nsample, **kw):
        self._float32("ball_query_cuda", xyz, new_xyz)
        got = self.kernels["first_k"](xyz, new_xyz, r2, nsample, **kw)
        radius = float(r2) ** 0.5
        if self.grouping.radius_squared(radius) != r2:
            raise self.error(f"radius {radius} does not give back r2 {r2}")
        want = self.grouping.ball_query_plain(xyz, new_xyz, radius, nsample)
        self._hold("ball_query_cuda", got, want,
                   [xyz.shape[0], xyz.shape[1], new_xyz.shape[1], nsample])
        return got

    def gather(self, features, idx, **kw):
        self._float32("group_points_cuda", features)
        got = self.kernels["gather"](features, idx, **kw)
        want = self.grouping.group_points_plain(features, idx)
        self._hold("group_points_cuda", got, want,
                   [*features.shape, *idx.shape[1:]])
        return got

    def _float32(self, kernel, *tensors):
        if not all(t.dtype == torch.float32 for t in tensors):
            raise self.error(f"{kernel} received "
                             f"{[t.dtype for t in tensors]}")

    def _hold(self, kernel, got, want, shape):
        if not torch.equal(got, want):
            raise self.error(f"{kernel} at {shape} on {got.device}, on the "
                             f"path: kernel != plain")
        self.checked.append((kernel, shape))
        if self.outputs is not None:
            self.outputs.setdefault(kernel, []).append(got.cpu())

    def counts(self) -> dict:
        """Launches held, by kernel."""
        out = {}
        for kernel, _ in self.checked:
            out[kernel] = out.get(kernel, 0) + 1
        return out

    def __enter__(self):
        g, s = self.grouping, self.sampling
        self.saved = dict(fps=s.furthest_point_sample_cuda,
                          first_k=g.ball_query_cuda,
                          gather=g.group_points_cuda)
        self.kernels = dict(self.saved)
        s.furthest_point_sample_cuda = self.fps
        g.ball_query_cuda, g.group_points_cuda = self.first_k, self.gather
        return self

    def __exit__(self, *exc):
        s, g, k = self.sampling, self.grouping, self.saved
        s.furthest_point_sample_cuda = k["fps"]
        g.ball_query_cuda, g.group_points_cuda = k["first_k"], k["gather"]
