"""PyTorch model stack (counterpart of ``scan2cap_tpu/models``):
PointNet++ backbone -> voting -> proposals -> relational graph -> caption
decoder (plain GRU or top-down attention), assembled in CapNet."""

from scan2cap_torch.models.backbone import Pointnet2Backbone
from scan2cap_torch.models.capnet import CapNet
from scan2cap_torch.models.caption import (SceneCaptionModule,
                                           TopDownSceneCaptionModule)
from scan2cap_torch.models.graph import GraphModule
from scan2cap_torch.models.proposal import ProposalModule
from scan2cap_torch.models.voting import VotingModule

__all__ = ["Pointnet2Backbone", "VotingModule", "ProposalModule",
           "GraphModule", "SceneCaptionModule", "TopDownSceneCaptionModule",
           "CapNet"]
