"""Checkpoints: the best / last / resume triad as ``torch.save`` files
(counterpart of ``scan2cap_tpu/train/checkpoints.py``; lib/solver.py:186-188,
492-515 of the reference).

``<root>/best.pt`` (best by criterion), ``<root>/last.pt`` (every epoch)
and ``<root>/resume.pt`` (epoch, model and optimizer state dicts, step).
Every value is a tensor, a Python number or a dict of them, so that
``torch.load(weights_only=True)`` reads each file.

Crash safety: a save writes ``<name>.pt.new`` and swaps it in with
``os.replace``, which is atomic, so a kill at any instant leaves the old
file or the new one whole, never half a file.  Opening the directory
promotes a leftover ``.new`` that loads (a kill between its write and the
swap) and removes one that does not (a kill during its write); a
``<name>.pt.old`` set aside beside it is promoted when ``<name>.pt`` is
missing and removed otherwise.

A run over a mesh (``parallel.mesh``) writes the same files with whole
tensors: the bundles gather the caption's split parameters and their Adam
moments (every rank calls them; rank 0 writes), and ``restore_resume``
cuts a whole bundle to the shards of any mesh shape.
"""


from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from scan2cap_torch.parallel.mesh import (full_optimizer_state,
                                          full_state_dict,
                                          shard_optimizer_state,
                                          shard_state_dict)


class CheckpointIO:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".pt.new"):
                continue
            new = os.path.join(self.root, name)
            try:
                torch.load(new, map_location="cpu", weights_only=True)
            except Exception:
                os.remove(new)           # cut during its write
            else:
                os.replace(new, new[:-len(".new")])
        for name in sorted(os.listdir(self.root)):
            if name.endswith(".pt.old"):
                old = os.path.join(self.root, name)
                if os.path.exists(old[:-len(".old")]):
                    os.remove(old)
                else:
                    os.replace(old, old[:-len(".old")])

    def path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.pt")

    def save(self, name: str, bundle: Dict[str, Any]) -> None:
        path = self.path(name)
        with open(path + ".new", "wb") as f:
            torch.save(bundle, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".new", path)

    def restore(self, name: str,
                map_location: Optional[torch.device | str] = "cpu") -> Dict:
        return torch.load(self.path(name), map_location=map_location,
                          weights_only=True)

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def restore_best_or_last(self, map_location="cpu") -> Dict:
        """best-by-criterion if an eval ever fired, else the last epoch
        (the reference's model.pth vs model_last.pth pair)."""
        return self.restore("best" if self.exists("best") else "last",
                            map_location)


def model_bundle(model: torch.nn.Module) -> Dict[str, Any]:
    """What ``best.pt`` and ``last.pt`` hold: the model's state dict, whole
    (a collective under a mesh)."""
    return {"model": full_state_dict(model)}


def resume_bundle(epoch: int, model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer, step: int
                  ) -> Dict[str, Any]:
    """What ``resume.pt`` holds: the epoch (a Python int), the model's and
    the optimizer's state dicts and the number of steps taken."""
    return {"epoch": int(epoch), "step": int(step),
            **model_bundle(model),
            "optimizer": full_optimizer_state(model, optimizer)}


def restore_resume(state, bundle: Dict[str, Any]) -> int:
    """Load a resume bundle into ``state`` (a ``train.step.TrainState``
    whose model may hold shards of any mesh shape) and return the epoch to
    start at, the restored one + 1."""
    state.model.load_state_dict(
        shard_state_dict(state.model, bundle["model"]), strict=True)
    state.optimizer.load_state_dict(
        shard_optimizer_state(state.model, bundle["optimizer"]))
    state.step = int(bundle["step"])
    return int(bundle["epoch"]) + 1
