"""CapNet: the detect-then-describe model of the flagship."""

from __future__ import annotations

from h100bench import flops, scenes
from h100bench.reference import losses, model

batches = scenes.capnet_batches
# inputs that the whole batch shares, not cut with its scenes
SHARED = ("glove_emb_table",)
count = flops.capnet


def reference(cfg):
    return model.CapNet(cfg, cfg["num_vocabs"])


def reference_loss(ref, batch, momentum):
    return losses.capnet_loss(ref(batch, True, momentum), ref.cfg["num_bins"])


def program(mcfg, cfg, device):
    from scan2cap_torch.models import CapNet
    return CapNet(mcfg, num_vocabs=cfg["num_vocabs"], device=device)


def train_step(mcfg, state, traffic):
    from scan2cap_torch.train.step import make_train_step
    return make_train_step(mcfg, state, **traffic["losses"])
