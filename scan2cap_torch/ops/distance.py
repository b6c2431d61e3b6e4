"""Squared distances with the JAX package's float32 rounding.

XLA on the CPU contracts a float32 sum of products into fused multiply-adds
(one rounding per FMA), and it does so in two different orders:

* the elementwise form ``dx*dx + dy*dy + dz*dz`` (ball query, 3-NN) becomes
  ``fma(dz, dz, fma(dx, dx, dy*dy))``;
* the reduction ``jnp.sum(d**2, axis=-1)`` (FPS, graph distances) becomes
  ``fma(dz, dz, fma(dy, dy, dx*dx))``.

A point that lies exactly on the ball's radius is in or out depending on
that rounding, so the port computes the same FMAs.  PyTorch exposes no
float32 FMA, so ``fma32`` computes one exactly in float64: the product of
two floats is exact there, and the one rounding of the sum is corrected
with its TwoSum error where it lands on a float32 halfway point.  The CUDA
kernels use ``__fmaf_rn`` in the same orders.
"""

from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with a single rounding (IEEE fusedMultiplyAdd)."""
    p = a.double() * b.double()                  # exact: 48-bit product
    c64 = c.double()
    s = p + c64
    bb = s - p                                   # TwoSum: p + c == s + e
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    # s can only be off when it sits exactly between two float32 values:
    # then the sign of e says which way the exact sum rounds
    inf = r.new_full((), float("inf"))      # a fill: no copy to the card
    lo = torch.where(r.double() > s, torch.nextafter(r, -inf), r)
    hi = torch.nextafter(lo, inf)
    tie = (s == (lo.double() + hi.double()) * 0.5) & (e != 0)
    return torch.where(tie, torch.where(e > 0, hi, lo), r)


def sq_dist_elementwise(dx: torch.Tensor, dy: torch.Tensor,
                        dz: torch.Tensor) -> torch.Tensor:
    """XLA's rounding of ``dx*dx + dy*dy + dz*dz``."""
    return fma32(dz, dz, fma32(dx, dx, dy * dy))


def sq_dist_reduce(dx: torch.Tensor, dy: torch.Tensor,
                   dz: torch.Tensor) -> torch.Tensor:
    """XLA's rounding of ``jnp.sum(jnp.stack([dx, dy, dz], -1)**2, -1)``."""
    return fma32(dz, dz, fma32(dy, dy, dx * dx))
