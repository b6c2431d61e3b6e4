"""The model's floating-point operations in one step, counted from the
configuration and the traffic alone.

Every matrix product of the step is counted at 2 operations a
multiply-add: the linear and 1x1 layers, the GRU cells, the attention's
products, the classifier, the box corners' rotation and the einsums of
the relation features and of sa1's projection gradient.  A training step
adds the backward: the weight's gradient of every layer, and the input's
gradient where the input needs one.  Elementwise work, reductions,
gathers and the point kernels are not counted.  So any implementation of
the step is held to the same count, and a later change that removes a
kernel cannot move it.  ``h100bench/tests`` hold the count equal to what
``torch.utils.flop_counter.FlopCounterMode`` counts on the reference.
"""

from __future__ import annotations

from typing import Dict

from h100bench import kinds


class Count:
    def __init__(self, train: bool):
        self.train = train
        self.total = 0

    def mm(self, rows: int, k: int, n: int, grad_in: bool = True) -> None:
        """A product (rows x k) @ (k x n) with a weight that learns, and in
        training its backward: the weight's gradient and, with
        ``grad_in``, the input's."""
        f = 2 * rows * k * n
        self.total += f
        if self.train:
            self.total += f * (2 if grad_in else 1)

    def fixed(self, rows: int, k: int, n: int) -> None:
        """A product of which nothing needs a gradient."""
        self.total += 2 * rows * k * n


def set_abstraction(c: Count, B, N, M, S, width, mlp, leaf=False,
                    grad_xyz=False):
    """Layer 0 over the N source points and the M centres (with input
    ``width`` = 3 + features), then the MLP over M x S grouped rows."""
    if leaf:
        # forward: cat @ w0 and centres @ w0; backward: the gradient of
        # w0 from the gathered inputs and from the centres
        c.fixed(B * N, width, mlp[0])
        c.fixed(B * M, width, mlp[0])
        if c.train:
            c.fixed(B * M * S, width, mlp[0])
            c.fixed(B * M, width, mlp[0])
    else:
        c.mm(B * N, width, mlp[0])
        c.mm(B * M, width, mlp[0], grad_in=grad_xyz)
    for a, b in zip(mlp, mlp[1:]):
        c.mm(B * M * S, a, b)


def backbone(c: Count, B: int, cfg: Dict, in_features: int) -> None:
    N = cfg["num_points"]
    n1, n2, n3, n4 = cfg["sa_npoints"]
    set_abstraction(c, B, N, n1, 64, in_features + 3, (64, 64, 128),
                    leaf=True)
    set_abstraction(c, B, n1, n2, 32, 131, (128, 128, 256))
    set_abstraction(c, B, n2, n3, 16, 259, (128, 128, 256))
    set_abstraction(c, B, n3, n4, 16, 259, (128, 128, 256))
    for rows in (n3, n2):                      # fp1, fp2
        c.mm(B * rows, 512, 256)
        c.mm(B * rows, 256, 256)
    seeds = n2
    c.mm(B * seeds, 256, 256)                  # voting
    c.mm(B * seeds, 256, 256)
    c.mm(B * seeds, 256, 259)


def proposal(c: Count, B: int, K: int, radius_samples: int, out: int,
             seeds: int) -> None:
    set_abstraction(c, B, seeds, K, radius_samples, 259, (128, 128, 128),
                    grad_xyz=True)
    c.mm(B * K, 128, 128)
    c.mm(B * K, 128, 128)
    c.mm(B * K, 128, out)


def capnet(c: Count, B: int, cfg: Dict) -> None:
    in_features = (int(cfg["use_height"]) + 3 * int(cfg["use_normal"])
                   + 128 * int(cfg["use_multiview"]))
    backbone(c, B, cfg, in_features)
    K, L = cfg["num_proposals"], cfg["num_locals"]
    H, E, C, V = (cfg["hidden_size"], cfg["emb_size"], 128,
                  cfg["num_vocabs"])
    proposal(c, B, K, 16, 97, cfg["sa_npoints"][1])
    c.fixed(B * K * 8, 3, 3)                   # box corners
    for _ in range(cfg["num_graph_steps"] + 1):    # EdgeConvs, edge layer
        c.mm(B * K * L, 256, 128)
        c.mm(B * K * L, 128, 128)
    c.mm(B * K * L, 128, cfg["num_bins"] + 1)  # edge orientations
    if c.train:
        c.fixed(B * K * L * 3, 3, 3)           # orientation labels
        T = cfg["max_des_len"] + 1
        c.mm(B * K, C, H)                      # map_feat
        for t in range(T):
            c.mm(B, E + H + C, E)              # map_topdown
            c.mm(B, E, 3 * H)                  # GRU 1
            c.mm(B, H, 3 * H, grad_in=t > 0)
            c.mm(B, H, H)                      # map_hidd
            c.mm(B * K, H, 1)                  # attend
            c.mm(B, C + H, E)                  # map_lang
            c.mm(B, E, 3 * H)                  # GRU 2
            c.mm(B, H, 3 * H, grad_in=t > 0)
            c.mm(B, H, V)                      # classifier
        return
    T = cfg["max_des_len"] - 1
    c.fixed(B * K, C, H)                       # map_feat of the proposals
    c.fixed(B * K * L, C, H)                   # and of the relations
    c.fixed(B * K * L, L, H)                   # relations onto the slots
    c.fixed(B * K * L, L, C)
    for _ in range(T):
        c.fixed(B * K, E + H + C, E)
        c.fixed(B * K, E, 3 * H)
        c.fixed(B * K, H, 3 * H)
        c.fixed(B * K, H, H)
        c.fixed(B * K, L, C)                   # attention over the slots
        c.fixed(B * K, C + H, E)
        c.fixed(B * K, E, 3 * H)
        c.fixed(B * K, H, 3 * H)
        c.fixed(B * K, H, V)


def mask_votenet(c: Count, B: int, cfg: Dict) -> None:
    in_features = (int(cfg["use_height"]) + 3 * int(cfg["use_normal"])
                   + 128 * int(cfg["use_multiview"]) + 1)
    backbone(c, B, cfg, in_features)
    proposal(c, B, cfg["num_proposals"], 512, 93, cfg["sa_npoints"][1])


def per_step(cfg: Dict, traffic: Dict) -> int:
    """Operations of one step of the traffic's path: an eval forward of a
    batch, or a train step (forward and backward)."""
    c = Count(train=traffic["path"] == "train")
    kinds.of(cfg).count(c, traffic["batch"], cfg)
    return c.total
