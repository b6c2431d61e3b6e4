"""What the benchmark knows of each model kind, one module a kind, found
by the configuration's ``kind``: the reference model and its loss, the
program's model and train step, the input batches and the operation
count.  A new kind is a new module here."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict


def of(cfg: Dict) -> ModuleType:
    return importlib.import_module(f"h100bench.kinds.{cfg['kind']}")


def half_batch(cfg: Dict, batch: Dict) -> Dict:
    """``batch`` with half of its scenes left out: the first half of each
    scene's input, and whole the inputs that the kind's ``SHARED`` names."""
    shared = of(cfg).SHARED
    return {k: v if k in shared else v[:v.shape[0] // 2]
            for k, v in batch.items()}
