"""Loss functions (counterpart of ``scan2cap_tpu/losses``)."""

from scan2cap_torch.losses.caption import (compute_cap_loss,
                                           compute_node_distance_loss,
                                           compute_node_orientation_loss,
                                           radian_to_label)
from scan2cap_torch.losses.detection import (compute_box_and_sem_cls_loss,
                                             compute_objectness_loss,
                                             compute_vote_loss)
from scan2cap_torch.losses.ranking import softmax_ranking_loss
from scan2cap_torch.losses.total import get_scene_cap_loss

__all__ = ["compute_vote_loss", "compute_objectness_loss",
           "compute_box_and_sem_cls_loss", "compute_cap_loss",
           "compute_node_orientation_loss", "compute_node_distance_loss",
           "radian_to_label", "get_scene_cap_loss", "softmax_ranking_loss"]
