"""Optimizers, the training and validation steps, the checkpoint
serializer, the hooks and the training loop of the port."""
from .optimizers import (construct_optimizer, current_learning_rates,
                         make_lr_schedule)
from .state import (TrainState, create_train_state, make_eval_step,
                    make_fused_eval_step, make_fused_window_step,
                    make_loss_fn, make_train_step)

__all__ = ['TrainState', 'construct_optimizer', 'create_train_state',
           'current_learning_rates', 'make_eval_step',
           'make_fused_eval_step', 'make_fused_window_step', 'make_loss_fn',
           'make_lr_schedule', 'make_train_step']
