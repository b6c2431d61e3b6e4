"""Prove a near tie where the card's and the CPU's index stages part.

The card and the CPU compute a forward's float32 products differently
(cuBLAS against MKL/oneDNN), so the coordinates that reach FPS and the
first-k ball query differ in their last bits between the two runs.  Each
side's kernel or plain version is exact on its own inputs, yet where two
candidates are nearly equal the two sides can pick different points, and
everything downstream then differs.  ``TieProof`` tells such a near tie
from a fault.  It hooks the same three ops as ``probes/held.py``'s
``HeldAgainstPlain`` (FPS, the first-k and the row gather, reached
through ``ops/library.py``) and works in two modes:

* record (``TieProof()``), on the card's run: each call's inputs and
  output are kept on the host, in call order.  It hooks the CUDA
  wrappers in ``ops.sampling`` / ``ops.grouping``, and the plain versions
  for CPU tensors only (so a plain run can stand in for the card in a
  test, and ``HeldAgainstPlain``'s yardstick on the card is not counted).
* replay (``TieProof(replay=recorded)``), on the CPU's run: each call
  computes the CPU's own result with the plain version.  Where it equals
  the card's recorded result, the CPU's result is used.  Where they part,
  the part must be a proven tie, and the call then returns the card's
  result, so that the CPU's later stages run from the card's picks.

The bound.  Let delta be the largest coordinate difference, measured,
between the card's and the CPU's inputs to the call.  A squared distance
d = |p - q|^2 whose two points each moved by at most delta per
coordinate changes by at most

    slack(d) = 4*sqrt(3)*delta*sqrt(d) + 12*delta^2 + ULPS * ulp32(d)

(the difference vector moves by at most 2*sqrt(3)*delta in length, so
|d' - d| = |2 v.e + |e|^2| <= 2 sqrt(d) 2 sqrt(3) delta + 12 delta^2); the
last term, ``ULPS`` float32 ulps of d, covers the rounding of the
distance's FMAs where the inputs are bitwise equal.  A fixed ulps count
alone would accept no real part: on bitwise-equal inputs the kernel
equals the plain version, so every real part comes with delta > 0.

* FPS: at every step where the CPU's argmax c differs from the card's
  pick k (the CPU's loop following the card's picks,
  ``furthest_point_sample_plain(take=)``), in the CPU's own running min
  distances m: m[c] - m[k] <= slack(m[c]) + slack(m[k]).
* first-k: within the scan that both sides' lists describe (up to the
  earlier of their last listed hits where a list is full), every point
  that one side has and the other lacks has |d^2 - r^2| <=
  slack(max(d^2, r^2)) in the CPU's values.

Inputs further apart than ``MAX_DELTA`` (the serving gates' corner
tolerance) are not a rounding: such a part fails.  So does a part beyond
the bound, naming the stage, the step and both values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from scan2cap_torch.ops.distance import sq_dist_elementwise

# float32 ulps of a distance that its FMAs' rounding may move it by
ULPS = 4
# inputs further apart than this are not last-bit differences
MAX_DELTA = 1e-3
# the flagship forward's calls of FPS and the first-k, in order
FORWARD_STAGES = ("sa1", "sa2", "sa3", "sa4", "proposal")


def slack(d: float, delta: float) -> float:
    """How far a squared distance ``d`` may move when its points move by
    ``delta`` per coordinate, with ``ULPS`` float32 ulps for rounding."""
    d = max(float(d), 0.0)
    ulp = float(np.spacing(np.float32(d)))
    return (4.0 * math.sqrt(3.0) * delta * math.sqrt(d) + 12.0 * delta * delta
            + ULPS * ulp)


def _listed(row: np.ndarray) -> List[int]:
    """The hits a first-k row lists: a strictly rising prefix, padded with
    its first entry."""
    count = 1
    while count < len(row) and row[count] > row[count - 1]:
        count += 1
    return [int(v) for v in row[:count]]


class TieProof:
    """``calls`` (record mode) or ``replay``'s calls are dicts with the
    kernel, its inputs and its output on the host.  In replay mode
    ``ties`` lists each proven tie (stage, kernel, call, scene, step or
    query and point, both values, the bound, delta).  A part that is not a
    proven tie raises ``error``; so does a replay that leaves a call of
    the card's unanswered."""

    def __init__(self, replay: Optional["TieProof"] = None,
                 error=RuntimeError):
        from scan2cap_torch.ops import grouping, sampling
        self.grouping, self.sampling = grouping, sampling
        self.replay = replay
        self.error = error
        self.calls: List[Dict] = []
        self.ties: List[Dict] = []
        self._seen = {"fps": 0, "first_k": 0, "gather": 0}

    # ---------------------------------------------------------- bookkeeping
    @staticmethod
    def _stage(kernel: str, i: int) -> str:
        name = FORWARD_STAGES[i] if i < len(FORWARD_STAGES) else f"call {i}"
        return f"{name} {kernel}"

    def _call(self, kernel: str, shape) -> Dict:
        """The card's call this CPU call answers, in order and by shape."""
        i = self._seen[kernel]
        self._seen[kernel] += 1
        theirs = [c for c in self.replay.calls if c["kernel"] == kernel]
        if i >= len(theirs):
            raise self.error(f"{self._stage(kernel, i)}: the CPU made call "
                             f"{i}, the card {len(theirs)} calls")
        call = theirs[i]
        if call["shape"] != list(shape):
            raise self.error(f"{self._stage(kernel, i)}: the CPU's shape "
                             f"{list(shape)}, the card's {call['shape']}")
        return dict(call, index=i, stage=self._stage(kernel, i))

    def _delta(self, call: Dict, *mine: torch.Tensor) -> float:
        delta = max(float((a.double() - b.detach().cpu().double()).abs()
                          .max()) if a.numel() else 0.0
                    for a, b in zip(call["inputs"], mine))
        if not delta <= MAX_DELTA:
            raise self.error(f"{call['stage']}: the card's and the CPU's "
                             f"inputs differ by {delta}, more than a "
                             f"rounding ({MAX_DELTA})")
        return delta

    def _record(self, kernel: str, shape, inputs=(), output=None, **extra):
        self.calls.append(dict(
            kernel=kernel, shape=list(shape),
            inputs=[t.detach().cpu() for t in inputs],
            output=None if output is None else output.detach().cpu(),
            **extra))

    # ---------------------------------------------------------------- record
    def _fps_card(self, xyz, npoint, **kw):
        out = self.saved["fps_cuda"](xyz, npoint, **kw)
        self._record("fps", [*xyz.shape[:2], npoint], (xyz,), out)
        return out

    def _first_k_card(self, xyz, new_xyz, r2, nsample, **kw):
        out = self.saved["first_k_cuda"](xyz, new_xyz, r2, nsample, **kw)
        self._record("first_k", [xyz.shape[0], xyz.shape[1],
                                 new_xyz.shape[1], nsample],
                     (xyz, new_xyz), out, r2=float(r2))
        return out

    def _gather_card(self, features, idx, **kw):
        self._record("gather", [*features.shape, *idx.shape[1:]])
        return self.saved["gather_cuda"](features, idx, **kw)

    # --------------------------------------------------- the plain versions
    def _fps_plain(self, xyz, npoint, **kw):
        if xyz.is_cuda:                      # HeldAgainstPlain's yardstick
            return self.saved["fps_plain"](xyz, npoint, **kw)
        if self.replay is None:
            out = self.saved["fps_plain"](xyz, npoint, **kw)
            self._record("fps", [*xyz.shape[:2], npoint], (xyz,), out)
            return out
        call = self._call("fps", [*xyz.shape[:2], npoint])
        want = call["output"].long()
        if not bool((want[:, 0] == 0).all()):
            raise self.error(f"{call['stage']}: the card's first pick is "
                             f"{want[:, 0].tolist()}, not 0")
        delta = []                           # measured at the first part

        def take(j, min_d2, argmax):
            card = want[:, j].to(argmax.device)
            for b in (argmax != card).nonzero().flatten().tolist():
                if not delta:
                    delta.append(self._delta(call, xyz))
                c, k = int(argmax[b]), int(card[b])
                mc, mk = float(min_d2[b, c]), float(min_d2[b, k])
                bound = slack(mc, delta[0]) + slack(mk, delta[0])
                if not mc - mk <= bound:
                    raise self.error(
                        f"{call['stage']} scene {b} step {j}: the CPU takes "
                        f"point {c} at {mc!r}, the card point {k} at {mk!r} "
                        f"(the CPU's running min distances), {mc - mk!r} "
                        f"apart against a bound of {bound!r} at delta "
                        f"{delta[0]!r}: not a tie")
                self._tie(call, scene=b, step=j, cpu_pick=c, card_pick=k,
                          cpu_value=mc, card_value=mk, bound=bound,
                          delta=delta[0])
            return card

        return self.saved["fps_plain"](xyz, npoint, take=take, **kw)

    def _first_k_plain(self, xyz, new_xyz, radius, nsample):
        mine = self.saved["first_k_plain"](xyz, new_xyz, radius, nsample)
        shape = [xyz.shape[0], xyz.shape[1], new_xyz.shape[1], nsample]
        if xyz.is_cuda:
            return mine
        if self.replay is None:
            self._record("first_k", shape, (xyz, new_xyz), mine,
                         r2=self.grouping.radius_squared(radius))
            return mine
        call = self._call("first_k", shape)
        r2 = self.grouping.radius_squared(radius)
        if r2 != call["r2"]:
            raise self.error(f"{call['stage']}: r2 {r2} on the CPU, "
                             f"{call['r2']} on the card")
        want = call["output"]
        if torch.equal(mine, want):
            return mine
        delta = self._delta(call, xyz, new_xyz)
        pts = xyz.detach().cpu().float()
        qs = new_xyz.detach().cpu().float()
        n = pts.shape[1]
        rows = (mine != want).any(-1).nonzero().tolist()
        for b, m in rows:
            d2 = sq_dist_elementwise(
                qs[b, m, 0] - pts[b, :, 0], qs[b, m, 1] - pts[b, :, 1],
                qs[b, m, 2] - pts[b, :, 2]).numpy()
            cpu_hits = np.flatnonzero(d2 < r2).tolist()
            card_row = want[b, m].numpy()
            listed = _listed(card_row)
            if not card_row.any():           # no hit, or one at point 0
                listed = cpu_hits[:1] if cpu_hits[:1] == [0] else []
            # the scan both lists describe: up to the earlier last hit of a
            # full list
            end = min(listed[-1] if len(listed) >= nsample else n - 1,
                      cpu_hits[nsample - 1] if len(cpu_hits) >= nsample
                      else n - 1)
            card = {p for p in listed if p <= end}
            cpu = {p for p in cpu_hits if p <= end}
            for p in sorted(cpu ^ card):
                bound = slack(max(float(d2[p]), r2), delta)
                if not abs(float(d2[p]) - r2) <= bound:
                    raise self.error(
                        f"{call['stage']} scene {b} query {m}: point {p} is "
                        f"{'in' if p in card else 'out'} on the card, its "
                        f"distance {float(d2[p])!r} against r2 {r2!r} on "
                        f"the CPU, {abs(float(d2[p]) - r2)!r} apart against "
                        f"a bound of {bound!r} at delta {delta!r}: not a "
                        f"tie")
                self._tie(call, scene=b, step=m, point=p,
                          card_has=p in card, cpu_value=float(d2[p]),
                          card_value=r2, bound=bound, delta=delta)
        return want.clone()

    def _gather_plain(self, features, idx):
        out = self.saved["gather_plain"](features, idx)
        shape = [*features.shape, *idx.shape[1:]]
        if features.is_cuda:
            return out
        if self.replay is None:
            self._record("gather", shape)
        else:
            self._call("gather", shape)
        return out

    def _tie(self, call: Dict, **row) -> None:
        self.ties.append(dict(stage=call["stage"], kernel=call["kernel"],
                              call=call["index"], **row))

    def by_stage(self) -> Dict[str, List[Dict]]:
        """The proven ties grouped by stage."""
        out: Dict[str, List[Dict]] = {}
        for t in self.ties:
            out.setdefault(t["stage"], []).append(
                {k: v for k, v in t.items() if k != "stage"})
        return out

    def entries_apart(self, other: "TieProof") -> Dict[str, int]:
        """Index entries of each FPS and first-k call where ``other``'s
        recording differs from this one's, by stage; a call one run lacks,
        or of another shape, counts whole."""
        out = {}
        for kernel in ("fps", "first_k"):
            mine, theirs = ([c["output"] for c in run.calls
                             if c["kernel"] == kernel]
                            for run in (self, other))
            for i in range(max(len(mine), len(theirs))):
                a = mine[i] if i < len(mine) else None
                b = theirs[i] if i < len(theirs) else None
                if a is None or b is None or a.shape != b.shape:
                    n = (a if a is not None else b).numel()
                else:
                    n = int((a.long() != b.long()).sum())
                if n:
                    out[self._stage(kernel, i)] = n
        return out

    def _check_consumed(self) -> None:
        """Every call the card made was answered by the CPU run."""
        for kernel, seen in self._seen.items():
            made = sum(c["kernel"] == kernel for c in self.replay.calls)
            if seen != made:
                raise self.error(f"{kernel}: the card made {made} calls, "
                                 f"the CPU run {seen}")

    # ------------------------------------------------------------- the hooks
    def __enter__(self):
        s, g = self.sampling, self.grouping
        self.saved = dict(fps_cuda=s.furthest_point_sample_cuda,
                          first_k_cuda=g.ball_query_cuda,
                          gather_cuda=g.group_points_cuda,
                          fps_plain=s.furthest_point_sample_plain,
                          first_k_plain=g.ball_query_plain,
                          gather_plain=g.group_points_plain)
        if self.replay is None:
            s.furthest_point_sample_cuda = self._fps_card
            g.ball_query_cuda = self._first_k_card
            g.group_points_cuda = self._gather_card
        s.furthest_point_sample_plain = self._fps_plain
        g.ball_query_plain = self._first_k_plain
        g.group_points_plain = self._gather_plain
        return self

    def __exit__(self, exc_type, *exc):
        s, g, k = self.sampling, self.grouping, self.saved
        s.furthest_point_sample_cuda = k["fps_cuda"]
        g.ball_query_cuda = k["first_k_cuda"]
        g.group_points_cuda = k["gather_cuda"]
        s.furthest_point_sample_plain = k["fps_plain"]
        g.ball_query_plain = k["first_k_plain"]
        g.group_points_plain = k["gather_plain"]
        if exc_type is None and self.replay is not None:
            self._check_consumed()
