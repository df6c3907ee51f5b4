"""Train state and the training step.

Counterpart of ``TrainState``, ``create_train_state``, ``make_loss_fn`` and
``make_train_step`` in ``dvs_of_training_framework_tpu/training/state.py``.
PyTorch runs eagerly, so the step is a plain function: forward, the
multi-scale loss, backward, and every ``accumulation_steps`` microbatches
one optimizer update of the model's parameters in place.
"""
import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..losses import combined_loss


@dataclasses.dataclass
class TrainState:
    """The gradient accumulator and the step counters.  The parameters
    live in the model and the optimizer state in the optimizer, both of
    which the step updates in place."""
    grad_acc: Optional[Dict[str, torch.Tensor]] = None
    micro_step: int = 0
    step: int = 0


def create_train_state(init_step: int = 0) -> TrainState:
    return TrainState(step=init_step)


def make_loss_fn(model, evaluator, weights) -> Callable:
    """``batch -> (loss, terms)`` for a device Batch on the raw path."""
    weights = tuple(weights)

    def loss_fn(batch):
        imsize = tuple(batch.images.shape[-2:])
        flows, flow_ts, flow_sample_idx = model(
            batch.events, batch.timestamps, batch.sample_idx, imsize)
        return combined_loss(evaluator, flows, flow_ts, flow_sample_idx,
                             batch.images, batch.timestamps,
                             batch.sample_idx, weights=weights)

    return loss_fn


def make_train_step(model, evaluator, optimizer, weights,
                    accumulation_steps: int):
    """Build the training step.

    Returns ``step_fn(state, batch) -> (state, (loss, terms))``; the state
    is updated in place, ``loss`` is already divided by
    ``accumulation_steps`` and ``terms`` are this microbatch's per-scale
    values.  With accumulation the optimizer applies the mean of the
    microbatch gradients on every ``accumulation_steps``-th call.
    """
    loss_fn = make_loss_fn(model, evaluator, weights)
    named = dict(model.named_parameters())
    inv = 1.0 / accumulation_steps

    def step_fn(state, batch):
        loss, terms = loss_fn(batch)
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        if accumulation_steps == 1:
            optimizer.step(grads)
            state.step += 1
        else:
            with torch.no_grad():
                if state.grad_acc is None:
                    state.grad_acc = {k: torch.zeros_like(v)
                                      for k, v in named.items()}
                for k, g in grads.items():
                    state.grad_acc[k].add_(g * inv)
            if (state.micro_step + 1) % accumulation_steps == 0:
                optimizer.step(state.grad_acc)
                state.grad_acc = None
                state.step += 1
        state.micro_step += 1
        return state, (loss.detach() * inv, terms)

    return step_fn
