"""Point-cloud helpers (numpy, host side; copy of
``scan2cap_tpu/utils/pc_utils.py:10-40``)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def random_sampling(pc: np.ndarray, num_sample: int, replace: Optional[bool] = None,
                    return_choices: bool = False,
                    rs: Optional[np.random.RandomState] = None):
    """Down/over-sample to a fixed budget (utils/pc_utils.py:32-40):
    without replacement when enough points, else with replacement."""
    rng = rs if rs is not None else np.random
    if replace is None:
        replace = pc.shape[0] < num_sample
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    if return_choices:
        return pc[choices], choices
    return pc[choices]


def rotx(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)
