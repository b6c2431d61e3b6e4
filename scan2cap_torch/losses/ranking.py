"""SoftmaxRankingLoss (counterpart of ``scan2cap_tpu/losses/ranking.py``;
reference lib/loss.py): listwise softmax cross entropy against a
(possibly multi-hot) target distribution.  No model of the repository
uses it; it is kept for the reference's API."""

from __future__ import annotations

import torch


def softmax_ranking_loss(inputs: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """inputs, targets: (B, N).  -mean_B sum_N log(softmax(inputs) + eps)
    * targets, eps = 1e-8 (added to the logits and to the probabilities,
    as the JAX function does)."""
    assert inputs.shape == targets.shape
    probs = torch.softmax(inputs + 1e-8, dim=1)
    return torch.mean(-torch.sum(torch.log(probs + 1e-8) * targets, dim=1))
