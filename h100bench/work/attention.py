"""Attention's work from the program's record of its calls, never from a
kernel: a pair of a query and a key takes 4 x head dim operations a head
forward (Q K^T and P V, a multiply-add each), and a call that learns 2.5
times that again backward.  The pairs are every (query, key) of a plain
call, the lower triangle of a causal one, and the kept pairs of a masked
one, so that a kernel that skips masked blocks is held to the work that
remains.  Bytes: q, k, v, the output (float32) and the mask, once."""

from __future__ import annotations

from h100bench.work import bound_s

KERNELS = ("fmha", "attention", "flash")
BACKWARD = 2.5


def entry_bound_s(e) -> float:
    if e.kept is not None:
        pairs = float(e.kept)
    elif e.causal:
        pairs = e.batch * e.nq * (e.nq + 1) / 2
    else:
        pairs = e.batch * e.nq * e.nk
    ops = 4 * e.head_dim * pairs * e.heads * (1 + (BACKWARD if e.grad else 0))
    nbytes = (4 * e.batch * e.heads * e.head_dim * 2 * (e.nq + e.nk)
              + e.mask_bytes)
    return bound_s(nbytes, ops)


def record_bound_s(record) -> float:
    return sum(entry_bound_s(e) for e in record)
