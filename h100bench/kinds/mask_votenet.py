"""MaskVoteNet: the pretrained track's single-proposal detector."""

from __future__ import annotations

from h100bench import flops, scenes
from h100bench.reference import losses, model

batches = scenes.mask_votenet_batches
# inputs that the whole batch shares, not cut with its scenes
SHARED = ()
count = flops.mask_votenet


def reference(cfg):
    return model.MaskVoteNet(cfg)


def reference_loss(ref, batch, momentum):
    return losses.mask_votenet_loss(ref(batch, True, momentum))


def program(mcfg, cfg, device):
    from scan2cap_torch.models.mask_votenet import MaskVoteNet
    return MaskVoteNet(mcfg, device=device)


def train_step(mcfg, state, traffic):
    from scan2cap_torch.train.step import make_mask_votenet_step
    return make_mask_votenet_step(mcfg, state)
