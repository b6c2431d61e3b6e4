"""The reference's eval forward and train steps.

``eval_forced`` answers a batch as the eval step does (BN running
statistics, the scene decode of every proposal) with the decode fed the
tokens it is given.  ``follow`` takes train steps as the port's
``make_model_step`` does: forward and loss in train mode, backward, a zero
gradient for a parameter the loss does not reach, and Adam with L2 weight
decay coupled into the gradient, written out here.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch


@torch.no_grad()
def eval_forced(model, batch: Dict, forced: torch.Tensor,
                read: torch.Tensor) -> Dict:
    """The CapNet eval forward of ``batch``; returns the boxes and scores,
    the widest logit gap of the ``read`` tokens, and the decode's own
    argmax tokens under ``forced``."""
    model.eval()
    d = model.detect(batch, train=False)
    gap, picks = model.caption.forced_scene(d, forced, read)
    return dict(token_gap=gap, picks=picks, bbox_corner=d["bbox_corner"],
                objectness_scores=d["objectness_scores"],
                sem_cls_scores=d["sem_cls_scores"])


class Adam:
    """torch's Adam arithmetic: coupled L2 decay, bias-corrected moments."""

    def __init__(self, params, wd: float, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.wd, self.betas, self.eps = wd, betas, eps
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        bc1 = 1 - b1 ** self.t
        bc2_sqrt = math.sqrt(1 - b2 ** self.t)
        for p, m, v in zip(self.params, self.exp_avg, self.exp_avg_sq):
            g = p.grad.add(p, alpha=self.wd)
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / bc2_sqrt).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / bc1)


def follow(model, loss_of: Callable, batches: List[Dict], lr: float,
           momentum: float, wd: float) -> Dict:
    """One train step per batch, the loss ``loss_of(model, batch,
    momentum)``.  Returns each step's loss, and the gradient of every
    parameter as the optimizer got it at step 1 (decay included) and
    before it; the model is left after the last step."""
    params = dict(model.named_parameters())
    opt = Adam(params.values(), wd)
    out = dict(losses=[])
    for i, batch in enumerate(batches):
        model.train()
        for p in params.values():
            p.grad = None
        loss = loss_of(model, batch, momentum)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        out["losses"].append(float(loss.detach()))
        if i == 0:
            out["raw_grad"] = {n: p.grad.detach().clone()
                               for n, p in params.items()}
            out["grad"] = {n: p.grad.detach() + wd * p.detach()
                           for n, p in params.items()}
        opt.step(lr)
    return out
