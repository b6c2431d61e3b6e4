"""LR / BN-momentum schedules (counterpart of
``scan2cap_tpu/train/schedules.py``).

Reference (detection-only mode, scripts/train.py:152-156,
lib/solver.py:150-168):
  * MultiStepLR: lr x0.1 at epochs [80, 120, 160];
  * BNMomentumScheduler: momentum = max(0.5 * 0.5**(epoch // 20), 0.001).
In caption mode both schedules are off (constant lr, BN momentum 0.1).
"""

from __future__ import annotations

from typing import Sequence


def multistep_lr(base_lr: float, epoch: int,
                 milestones: Sequence[int] = (80, 120, 160),
                 gamma: float = 0.1) -> float:
    lr = base_lr
    for m in milestones:
        if epoch >= m:
            lr *= gamma
    return lr


def bn_momentum(epoch: int, init: float = 0.5, rate: float = 0.5,
                step: int = 20, floor: float = 0.001) -> float:
    return max(init * rate ** (epoch // step), floor)
