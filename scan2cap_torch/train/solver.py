"""Training solver (counterpart of ``scan2cap_tpu/train/solver.py``; a
rebuild of lib/solver.py).

Per-iteration fetch and step timing, in-training caption evaluation every
``val_step`` iterations (lib/solver.py:451-460), best-model selection by
criterion (default CIDEr, lib/solver.py:469-495), the best / last / resume
checkpoints, tensorboard and text logs, ETA reports.  ``train_stats.json``
in the run folder keeps each epoch's host timers (seconds per fetch and per
iteration) and losses, the seconds each checkpoint save took, and the
kernel launches of the train steps.

The step (forward, loss, backward, Adam) is ``train.step.make_train_step``'s
function.  Its metrics stay on the device: the solver reads step t-1's
metrics after step t has been issued, in one device-to-host copy of the
stacked scalars, so the host fetches the next batch while the card works.

Under a mesh (``parallel.mesh``) every rank runs the loop on its rows of
each batch and the metrics it reads are the global ones; rank 0 alone
logs and writes files.  Every rank builds the checkpoint bundles (they
gather the split parameters) and runs the evaluation, whose scores rank 0
computes and hands to every rank, so all ranks agree on the best model.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from scan2cap_torch.data.synthetic import to_device
from scan2cap_torch.kernels import launch_counts
from scan2cap_torch.parallel.mesh import is_main
from scan2cap_torch.train.checkpoints import (CheckpointIO, model_bundle,
                                              resume_bundle)
from scan2cap_torch.train.schedules import bn_momentum, multistep_lr
from scan2cap_torch.utils import profiling
from scan2cap_torch.utils.eta import format_eta

ITER_REPORT = (
    "[epoch {epoch}/{total_epoch}][iter {iter}/{total_iter}] "
    "loss {loss:.4f} cap {cap_loss:.4f} box {box_loss:.4f} "
    "obj_acc {obj_acc:.3f} iou {pred_ious:.3f} | "
    "fetch {fetch:.3f}s step {step:.3f}s eta {eta}"
)

# the JAX package's TrainConfig defaults (scripts/train.py:152-156)
LR_DECAY_STEPS = (80, 120, 160)
LR_DECAY_RATE = 0.1
BN_MOMENTUM_INIT = 0.5
BN_DECAY_STEP = 20
BN_DECAY_RATE = 0.5
BN_MOMENTUM_MAX = 0.001


class Solver:
    def __init__(
        self,
        state,                                # train.step.TrainState
        train_step: Callable,                 # (batch, lr, bn_momentum) -> metrics
        train_loader,
        output: str,                          # the run's folder
        lr: float = 1e-3,
        emb_table: Optional[np.ndarray] = None,
        eval_fn: Optional[Callable] = None,   # () -> {metric: float}
        val_step: int = 2000,
        criterion: str = "cider",
        verbose: int = 10,
        lr_decay: bool = False,               # detection-only schedules
        bn_decay: bool = False,
        profile_steps: int = 0,               # torch.profiler trace of steps 2..N+1
    ):
        self.state = state
        self.model = state.model
        self.train_step = train_step
        self.train_loader = train_loader
        self.lr = lr
        self.eval_fn = eval_fn
        self.val_step = val_step
        self.criterion = criterion
        self.verbose = verbose
        self.lr_decay = lr_decay
        self.bn_decay = bn_decay
        self.main = is_main()             # rank 0 (or no mesh) logs, writes
        self.profile_steps = profile_steps if self.main else 0
        self.device = self.model.device
        self.emb_table = (None if emb_table is None else
                          torch.as_tensor(np.asarray(emb_table)).to(
                              self.device, copy=True))

        self.output = output
        os.makedirs(self.output, exist_ok=True)
        self.ckpt = (CheckpointIO(os.path.join(self.output, "ckpt"))
                     if self.main else None)
        self.log_path = os.path.join(self.output, "log.txt")
        self.best = {"epoch": 0, self.criterion: -float("inf")}
        self.global_iter = 0
        self._writers = {}
        self.log_history: Dict[str, list] = defaultdict(list)
        # host timers of the epoch: seconds per fetch and per step
        self.fetch_times: list = []
        self.step_times: list = []
        self.losses: list = []
        self.stats = {"epochs": [], "save_s": [], "steps": 0,
                      "launches": dict.fromkeys(launch_counts(), 0)}

    def _make_writers(self):
        if not self.main:
            return {}
        try:
            from tensorboardX import SummaryWriter
            return {
                "train": SummaryWriter(os.path.join(self.output, "tensorboard/train")),
                "val": SummaryWriter(os.path.join(self.output, "tensorboard/val")),
            }
        except Exception:
            return {}

    def _log(self, msg: str):
        if not self.main:
            return
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def _write_scalar(self, phase: str, key: str, value: float, it: int):
        if self._writers:
            self._writers[phase].add_scalar(key, value, it)
        self.log_history[f"{phase}/{key}"].append((it, float(value)))

    # ------------------------------------------------------------------
    def __call__(self, epochs: int, verbose: Optional[int] = None,
                 start_epoch: int = 0):
        """Train epochs ``start_epoch``..``epochs``-1.  ``start_epoch`` is
        the global epoch on resume (the restored epoch + 1): the LR and BN
        schedules and the resume bundle's epoch use global numbering."""
        if verbose is not None:
            self.verbose = verbose
        self._writers = self._make_writers()
        total_iter = (epochs - start_epoch) * len(self.train_loader)
        start = time.time()
        epoch = start_epoch   # the interrupt handler needs it bound
        try:
            for epoch in range(start_epoch, epochs):
                self._log(f"epoch {epoch + 1} starting...")
                lr = (multistep_lr(self.lr, epoch, LR_DECAY_STEPS,
                                   LR_DECAY_RATE)
                      if self.lr_decay else self.lr)
                mom = (bn_momentum(epoch, BN_MOMENTUM_INIT, BN_DECAY_RATE,
                                   BN_DECAY_STEP, BN_MOMENTUM_MAX)
                       if self.bn_decay else 0.1)
                self._feed_epoch(epoch, epochs, total_iter, start, lr, mom)
                self._save_checkpoint(epoch)
            self._dump_log()
        except KeyboardInterrupt:
            # checkpoint and exit (lib/solver.py:200-203, 497-515)
            self._save_checkpoint(epoch, interrupted=True)
            raise
        finally:
            # the writers' threads end with the run (a rank's process exits
            # right after it)
            for w in self._writers.values():
                w.close()
            self._writers = {}
        return self.best

    # ------------------------------------------------------------------
    def _upload(self, batch) -> Dict[str, torch.Tensor]:
        # to_device copies on every device: with Loader(reuse_buffers=True)
        # the batch is a ring slot that a worker overwrites two batches on
        tb = to_device({k: v for k, v in batch.items()
                        if k != "glove_emb_table"}, self.device)
        if self.emb_table is not None:
            tb["glove_emb_table"] = self.emb_table
        return tb

    def _feed_epoch(self, epoch, total_epochs, total_iter, start, lr, mom):
        self.fetch_times, self.step_times, self.losses = [], [], []
        pending = None                    # (metrics, iter, issue time)

        def consume(p):
            metrics, it, t_issued = p
            # ONE device-to-host copy for all the step's scalars
            keys = sorted(metrics)
            values = torch.stack([metrics[k].float() for k in keys]).cpu()
            host = dict(zip(keys, values.tolist()))
            self.step_times.append(time.time() - t_issued)
            self.losses.append(host["loss"])
            if it % self.verbose == 0:
                mean_fetch = float(np.mean(self.fetch_times[-self.verbose:]))
                mean_step = float(np.mean(self.step_times[-self.verbose:]))
                # a deferred step time spans a whole iteration, the
                # overlapped fetch included
                eta = (total_iter - it) * mean_step
                self._log(ITER_REPORT.format(
                    epoch=epoch + 1, total_epoch=total_epochs,
                    iter=it, total_iter=total_iter, loss=host["loss"],
                    cap_loss=host.get("cap_loss", 0.0),
                    box_loss=host.get("box_loss", 0.0),
                    obj_acc=host.get("obj_acc", 0.0),
                    pred_ious=host.get("pred_ious", 0.0),
                    fetch=mean_fetch, step=mean_step, eta=format_eta(eta)))
                for k, v in host.items():
                    self._write_scalar("train", k, v, it)

        profiler = None
        t_fetch = time.time()
        for batch in self.train_loader:
            tbatch = self._upload(batch)
            self.fetch_times.append(time.time() - t_fetch)

            # device trace of warm steps 2..N+1 (the first step builds)
            if self.profile_steps and self.global_iter == 1:
                if pending is not None:
                    consume(pending)      # step 1 ends before the trace
                    pending = None
                profiler = profiling.start(self.device)
            t0 = time.time()
            before = launch_counts()
            metrics = self.train_step(tbatch, lr, mom)
            for k, v in launch_counts().items():
                self.stats["launches"][k] += v - before[k]
            self.stats["steps"] += 1
            self.global_iter += 1
            if pending is not None:
                consume(pending)
            pending = (metrics, self.global_iter, t0)
            if profiler is not None and \
                    self.global_iter == 1 + self.profile_steps:
                consume(pending)          # drain before stopping the trace
                pending = None
                trace = os.path.join(self.output, "profile")
                profiling.stop(profiler, trace)
                profiler = None
                self._log(f"profiler trace written to {trace}")

            if (self.eval_fn is not None
                    and self.global_iter % self.val_step == 0):
                if pending is not None:
                    consume(pending)
                    pending = None
                self._run_eval(epoch)
            t_fetch = time.time()
        if pending is not None:
            consume(pending)
        if profiler is not None:          # the epoch ended inside the trace
            profiling.stop(profiler, os.path.join(self.output, "profile"))
        self.stats["epochs"].append(dict(
            epoch=epoch, fetch_s=self.fetch_times, step_s=self.step_times,
            losses=self.losses))

    def _run_eval(self, epoch):
        scores = self.eval_fn()
        for k, v in scores.items():
            self._write_scalar("val", k, v, self.global_iter)
        crit = scores.get(self.criterion, None)
        report = " ".join(f"{k}={v:.4f}" for k, v in scores.items())
        self._log(f"[eval @ iter {self.global_iter}] {report}")
        if crit is not None and crit > self.best[self.criterion]:
            self.best = {**scores, "epoch": epoch, self.criterion: crit}
            self._log(f"best {self.criterion} improved -> {crit:.4f}; "
                      f"saving model...")
            self._save("best", model_bundle(self.model))

    def _save_checkpoint(self, epoch, interrupted=False):
        t0 = time.time()
        self._save("last", model_bundle(self.model))
        self._save("resume", resume_bundle(
            epoch, self.model, self.state.optimizer, self.state.step))
        self.stats["save_s"].append(time.time() - t0)
        if interrupted:
            self._log(f"interrupted at epoch {epoch}; checkpoint saved")

    def _save(self, name: str, bundle) -> None:
        if self.main:
            self.ckpt.save(name, bundle)

    def _dump_log(self):
        if not self.main:
            return
        with open(os.path.join(self.output, "scalars.json"), "w") as f:
            json.dump({k: v for k, v in self.log_history.items()}, f)
        with open(os.path.join(self.output, "train_stats.json"), "w") as f:
            json.dump(self.stats, f)
