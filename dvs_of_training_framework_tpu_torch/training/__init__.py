"""Optimizers and the training step of the port."""
from .optimizers import construct_optimizer, make_lr_schedule
from .state import (TrainState, create_train_state, make_loss_fn,
                    make_train_step)

__all__ = ['TrainState', 'construct_optimizer', 'create_train_state',
           'make_loss_fn', 'make_lr_schedule', 'make_train_step']
