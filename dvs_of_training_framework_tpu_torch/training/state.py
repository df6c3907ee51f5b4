"""Train state, the training step and the validation step.

Counterpart of ``TrainState``, ``create_train_state``, ``make_loss_fn``,
``make_train_step`` and ``make_eval_step`` in
``dvs_of_training_framework_tpu/training/state.py``.
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


def make_loss_fn(model, evaluator, weights, is_raw: bool = True) -> Callable:
    """``batch -> (loss, terms)`` for a device Batch: its raw ``events``
    or, with ``is_raw=False``, its dense ``data`` go to the model."""
    weights = tuple(weights)

    def loss_fn(batch):
        imsize = tuple(batch.images.shape[-2:])
        events = batch.events if is_raw else batch.data
        flows, flow_ts, flow_sample_idx = model(
            events, batch.timestamps, batch.sample_idx, imsize, raw=is_raw)
        return combined_loss(evaluator, flows, flow_ts, flow_sample_idx,
                             batch.images, batch.timestamps,
                             batch.sample_idx, weights=weights)

    return loss_fn


def make_train_step(model, evaluator, optimizer, weights,
                    accumulation_steps: int, is_raw: bool = True):
    """Build the training step.

    Returns ``step_fn(state, batch) -> (state, (loss, terms))``; the state
    is updated in place, ``loss`` is already divided by
    ``accumulation_steps`` and ``terms`` are this microbatch's per-scale
    values.  With accumulation the optimizer applies the mean of the
    microbatch gradients on every ``accumulation_steps``-th call.  A
    parameter the loss does not reach (the quantization layer on the
    dense path, ``is_raw=False``) gets a zero gradient, as under
    ``jax.grad``, so the optimizer still decays it and moves its slow
    weights.
    """
    loss_fn = make_loss_fn(model, evaluator, weights, is_raw)
    named = dict(model.named_parameters())

    def grad_fn(batch):
        loss, terms = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    materialize_grads=True)
        return loss, terms, dict(zip(named, grads))

    return make_update_step(grad_fn, named, optimizer, accumulation_steps)


def make_update_step(grad_fn, named, optimizer, accumulation_steps: int):
    """The step around ``grad_fn(batch) -> (loss, terms, {name: grad})``:
    every call accumulates, and every ``accumulation_steps``-th applies
    the mean of the microbatch gradients (``make_train_step``; the
    sharded steps of ``parallel/mesh.py`` give it their reduced
    gradients)."""
    inv = 1.0 / accumulation_steps

    def step_fn(state, batch):
        loss, terms, grads = grad_fn(batch)
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


def make_eval_step(model, evaluator, weights,
                   is_raw: bool = True) -> Callable:
    """Validation step: ``batch -> (loss, terms)`` with no autograd graph.
    The parameters are the model's own."""
    loss_fn = make_loss_fn(model, evaluator, weights, is_raw)

    def eval_step(batch):
        with torch.no_grad():
            return loss_fn(batch)

    return eval_step
