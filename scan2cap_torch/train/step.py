"""Train and serving steps (counterpart of ``scan2cap_tpu/train/step.py``
and of the MaskVoteNet step of ``scripts/train_maskvotenet.py:84-110``).

``make_model_step`` returns the function that takes one optimisation step
of a model: forward and loss (the caller's function), backward, Adam
update, BN running-statistics update.  ``make_train_step`` builds it for
CapNet (backbone -> voting -> proposal -> graph -> teacher-forced caption,
``get_scene_cap_loss``), ``make_mask_votenet_step`` for MaskVoteNet
(``get_mask_votenet_loss``), ``make_pretrained_step`` for the caption-only
``CapNetPretrained`` (``get_pretrained_loss``), ``make_vote2cap_step`` for
Vote2Cap-DETR (``get_vote2cap_loss``).  The optimizer is
``torch.optim.Adam(weight_decay=wd)``: L2 weight decay coupled into the
gradient before the moments (scripts/train.py:135), which is what the JAX
package builds from ``add_decayed_weights`` + ``scale_by_adam``; never
``AdamW``.  The learning rate and the BN momentum are call arguments, so
the detection-only schedules (``train/schedules.py``) need no rebuild.

Under a mesh (``parallel.mesh``) a rank's loss is its share of the global
loss: its gradients and its metrics are SUMMED over the data group (plain
DDP averages, which would be wrong here), and the split caption
parameters step on their shards with their own Adam moments.

``make_eval_step`` returns the function that answers a batch of scenes
with boxes and a caption per box: one eval forward of CapNet (free-running
decode, BN running statistics) and, by default, the detection loss's
proposal-to-GT assignment, reduced to the keys the JAX eval step keeps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from scan2cap_torch.config import ModelConfig
from scan2cap_torch.losses import get_scene_cap_loss
from scan2cap_torch.losses.mask_votenet import get_mask_votenet_loss
from scan2cap_torch.losses.pretrained import get_pretrained_loss
from scan2cap_torch.losses.vote2cap import get_vote2cap_loss
from scan2cap_torch.parallel.mesh import sum_gradients, sum_metrics
from scan2cap_torch.utils.profiling import annotate, program_step

KEEP_KEYS = (
    "lang_cap", "bbox_corner", "bbox_mask", "bbox_feature",
    "objectness_scores", "sem_cls_scores", "center", "heading_scores",
    "heading_residuals", "size_scores", "size_residuals",
    "object_assignment", "objectness_label", "objectness_mask",
    "valid_masks",
)
ATTN_KEYS = ("topdown_attn", "topdown_attn_slots")
REPORT_KEYS = (
    "loss", "vote_loss", "objectness_loss", "box_loss", "center_loss",
    "heading_cls_loss", "heading_reg_loss", "size_cls_loss",
    "size_reg_loss", "sem_cls_loss", "cap_loss", "ori_loss", "dist_loss",
    "cap_acc", "ori_acc", "obj_acc", "pred_ious", "pos_ratio", "neg_ratio",
)
# what the MaskVoteNet step reports (scripts/train_maskvotenet.py:107-108)
MVN_REPORT_KEYS = (
    "loss", "vote_loss", "box_loss", "center_loss", "size_cls_loss",
    "size_reg_loss", "sem_cls_loss", "sem_cls_acc", "miou",
)
# what the Vote2Cap-DETR step reports
VOTE2CAP_REPORT_KEYS = ("loss", "set_loss", "sem_cls_loss", "center_loss",
                        "size_loss", "vote_loss", "cap_loss", "cap_acc")
# what the pretrained step reports (scripts/train_pretrained.py:120-121)
PRETRAINED_REPORT_KEYS = ("loss", "cap_loss", "cap_acc", "ori_loss",
                          "ori_acc", "dist_loss")
DEFAULT_WD = 1e-5                                  # scripts/train.py:135


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, and the
    number of steps taken.  The model is a ``CapNet``, a ``MaskVoteNet``
    or a ``CapNetPretrained``: it carries its ``cfg`` and the ``device`` it
    was built for."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _check_device(model: torch.nn.Module) -> None:
    """The model must still lie on the device it was built for: CUDA unless
    the caller built it with ``device="cpu"``."""
    where = next(model.parameters()).device
    if where.type != model.device.type:
        raise RuntimeError(
            f"the model was built for {model.device} but lies on {where}; "
            f"build it with device='cpu' to run on the CPU")


def make_optimizer(params, wd: float = DEFAULT_WD) -> torch.optim.Adam:
    """torch Adam with coupled L2 weight decay; the learning rate is set at
    every step from the call's argument."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)


def create_train_state(cfg: ModelConfig, model: torch.nn.Module,
                       wd: Optional[float] = None) -> TrainState:
    if cfg != model.cfg:
        raise ValueError("cfg differs from the config the model was built with")
    _check_device(model)
    return TrainState(model=model, optimizer=make_optimizer(
        model.parameters(), DEFAULT_WD if wd is None else wd))


def make_model_step(cfg: ModelConfig, state: TrainState,
                    forward_loss: Callable[[Dict, float], Dict],
                    report_keys: Tuple[str, ...]
                    ) -> Callable[[Dict, float, float], Dict]:
    """Returns ``step(batch, lr, bn_momentum) -> metrics`` over the model's
    device; it updates ``state`` in place.

    ``forward_loss(batch, bn_momentum)`` runs the model in train mode and
    its loss, and returns the data dict with ``"loss"``.  ``batch`` maps
    the data-dict keys to tensors on the model's device
    (``data.synthetic.to_device``).  ``metrics`` holds the
    ``report_keys`` the dict has, as 0-d tensors on that device (no host
    synchronisation); under a mesh the global values."""
    model, optimizer = state.model, state.optimizer
    if cfg != model.cfg:
        raise ValueError("cfg differs from the config the model was built with")
    _check_device(model)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    @program_step()
    def step(batch: Dict, lr: float, bn_momentum: float) -> Dict:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = forward_loss(batch, bn_momentum)
        with annotate("scan2cap.backward"):
            out["loss"].backward()
        with annotate("scan2cap.optimizer"):
            for p in params:
                # a parameter the loss does not reach still decays, as it
                # does under the JAX step, whose gradient tree holds zeros
                # for it
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            sum_gradients(params)
            for group in optimizer.param_groups:
                group["lr"] = float(lr)
            optimizer.step()
        state.step += 1
        return sum_metrics({k: out[k].detach() for k in report_keys
                            if k in out})

    return step


def make_train_step(cfg: ModelConfig, state: TrainState,
                    detection: bool = True, caption: bool = True,
                    orientation: bool = False, distance: bool = False,
                    use_tf: bool = True
                    ) -> Callable[[Dict, float, float], Dict]:
    """The CapNet step (``make_model_step``): teacher-forced forward and
    ``get_scene_cap_loss`` with the losses asked for; reports the
    ``REPORT_KEYS``."""
    model = state.model

    def forward_loss(batch: Dict, bn_momentum: float) -> Dict:
        out = model(batch, use_tf=use_tf, is_eval=False, train=True,
                    bn_momentum=bn_momentum)
        with annotate("scan2cap.loss"):
            return get_scene_cap_loss(
                out, detection=detection,
                caption=caption and not cfg.no_caption,
                orientation=orientation, distance=distance,
                num_bins=cfg.num_bins, num_heading_bin=cfg.num_heading_bin,
                num_size_cluster=cfg.num_size_cluster)

    return make_model_step(cfg, state, forward_loss, REPORT_KEYS)


def make_mask_votenet_step(cfg: ModelConfig, state: TrainState
                           ) -> Callable[[Dict, float, float], Dict]:
    """The MaskVoteNet step (``make_model_step``): train-mode forward and
    ``get_mask_votenet_loss``; reports the ``MVN_REPORT_KEYS``."""
    model = state.model

    def forward_loss(batch: Dict, bn_momentum: float) -> Dict:
        out = model(batch, train=True, bn_momentum=bn_momentum)
        with annotate("scan2cap.loss"):
            return get_mask_votenet_loss(out, cfg.num_size_cluster)

    return make_model_step(cfg, state, forward_loss, MVN_REPORT_KEYS)


def make_vote2cap_step(cfg: ModelConfig, state: TrainState
                       ) -> Callable[[Dict, float, float], Dict]:
    """The Vote2Cap-DETR step (``make_model_step``): the train-mode
    forward with its Hungarian matching and teacher-forced captions, and
    ``get_vote2cap_loss``; reports the ``VOTE2CAP_REPORT_KEYS``."""
    model = state.model

    def forward_loss(batch: Dict, bn_momentum: float) -> Dict:
        out = model(batch, train=True, bn_momentum=bn_momentum)
        with annotate("scan2cap.loss"):
            return get_vote2cap_loss(out, model.mean_size, model.vcfg)

    return make_model_step(cfg, state, forward_loss, VOTE2CAP_REPORT_KEYS)


def make_pretrained_step(cfg: ModelConfig, state: TrainState, mode: str,
                         orientation: bool = False, distance: bool = False
                         ) -> Callable[[Dict, float, float], Dict]:
    """The caption-only step of the pretrained track
    (``make_model_step``): the teacher-forced forward of
    ``CapNetPretrained`` and ``get_pretrained_loss`` in ``mode`` ("gt" or
    "votenet"); reports the ``PRETRAINED_REPORT_KEYS``."""
    model = state.model

    def forward_loss(batch: Dict, bn_momentum: float) -> Dict:
        out = model(batch, use_tf=True, is_eval=False, train=True)
        with annotate("scan2cap.loss"):
            return get_pretrained_loss(out, mode=mode,
                                       orientation=orientation,
                                       distance=distance,
                                       num_bins=cfg.num_bins)

    return make_model_step(cfg, state, forward_loss, PRETRAINED_REPORT_KEYS)


def make_eval_step(cfg: ModelConfig, model: torch.nn.Module,
                   detection_loss: bool = True,
                   keep_attn: bool = False) -> Callable[[Dict], Dict]:
    """Returns ``eval_step(batch) -> dict`` over the model's device.

    ``batch`` maps the data-dict keys to tensors on the model's device
    (``data.synthetic.to_device``).  With ``detection_loss`` the batch must
    carry the detection labels, and the result also holds
    ``object_assignment``, ``objectness_label`` and ``objectness_mask``, as
    the reference's eval path does (lib/eval_helper.py:170).  ``keep_attn``
    also keeps the top-down decoder's per-step attention: over the local
    slots, with their proposal ids (``topdown_attn_slots``), or from the
    full-K decode (``num_locals=-1``) over all K proposals, (B, K, T, K)."""
    if cfg != model.cfg:
        raise ValueError("cfg differs from the config the model was built with")
    _check_device(model)
    keep = KEEP_KEYS + (ATTN_KEYS if keep_attn else ())

    @program_step()
    def eval_step(batch: Dict) -> Dict:
        model.eval()
        with torch.inference_mode():
            out = model(batch, use_tf=False, is_eval=True, train=False)
            if detection_loss:
                with annotate("scan2cap.loss"):
                    out = get_scene_cap_loss(
                        out, detection=True, caption=False,
                        num_heading_bin=cfg.num_heading_bin,
                        num_size_cluster=cfg.num_size_cluster)
        return {k: out[k] for k in keep if k in out}

    eval_step.per_scene_outputs = keep          # parallel.mesh.mesh_eval_fn
    return eval_step
