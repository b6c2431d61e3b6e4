"""Train and serving steps of the port, and the training schedules."""

from scan2cap_torch.train.schedules import bn_momentum, multistep_lr
from scan2cap_torch.train.step import (TrainState, create_train_state,
                                       make_eval_step, make_optimizer,
                                       make_train_step)

__all__ = ["TrainState", "create_train_state", "make_optimizer",
           "make_train_step", "make_eval_step", "multistep_lr", "bn_momentum"]
