"""Port parity: the host training loop, validation and a resume across
frameworks.

The setup of tests/test_torch_train_step.py: EVFlowNet at depth 4, base 8,
32x32, batch 2, flow-head biases (0.37, 0.23), RANGER.

- The same host batches, one of them too large for the event capacity,
  go through the JAX package's ``train`` and the port's, with
  accumulation 1 and 2, a recording hook every 2 optimizer steps and a
  list logger.  The sequence of ``(tag, samples passed)`` pairs, the hook
  calls ``(step, samples_passed)`` and the skip count must be equal
  exactly; the logged values take the rtol 1e-5 of
  tests/test_torch_train_step.py (the frameworks sum fp32 convolutions in
  another order).
- ``validate`` gets the same checks against the JAX ``validate``.
- Resume across frameworks: JAX trains 3 steps (RANGER with the clip and
  EMA riders); its parameters go through ``flax_to_torch`` and its
  optimizer state through ``optax_state_to_torch``; then both take 3 more
  steps, across a Lookahead sync and the representation group's start.
  Parameters and EMA take the rtol 1e-5 / atol 1e-7 of
  tests/test_torch_optim.py.
"""
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.data.schema import \
    pad_batch as jax_pad_batch
from dvs_of_training_framework_tpu.losses import \
    MultiScaleLoss as JaxMultiScaleLoss
from dvs_of_training_framework_tpu.models import load_model_class
from dvs_of_training_framework_tpu.training import optimizers as jax_opt
from dvs_of_training_framework_tpu.training import state as jax_state
from dvs_of_training_framework_tpu.training import train as jax_train
from dvs_of_training_framework_tpu_torch.data.schema import pad_batch
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, current_learning_rates,
    make_eval_step, make_train_step)
from dvs_of_training_framework_tpu_torch.training import train as port_train
from dvs_of_training_framework_tpu_torch.utils.convert import (
    flax_to_torch, load_flax_params, optax_state_to_torch, torch_to_flax)
from tests.test_torch_train_step import (ARGS, CAPACITY, H, SHAPES, W,
                                         make_collated)

REPO = Path(__file__).resolve().parents[1]
TAGS = [f'{h}x{w}' for h, w in SHAPES]
CPU = torch.device('cpu')


class ListLogger:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass


def oversized(seed):
    """A batch with more events than CAPACITY; the skip report prints its
    augmentation parameters, which the dataset's collate adds."""
    batch = make_collated(seed)
    batch['events'] = {k: np.concatenate([v, v])
                       for k, v in batch['events'].items()}
    batch['augmentation_params'] = None
    assert batch['events']['x'].size > CAPACITY
    return batch


def jax_setup(args):
    """The JAX model, flow-biased parameters and optimizer."""
    module = load_model_class(REPO / 'EVFlowNet')
    model = module.Model(event_representation_depth=4, base_channels=8)
    first = jax_pad_batch(make_collated(0), capacity=CAPACITY)
    params = model.init(jax.random.PRNGKey(0), first.events,
                        first.timestamps, first.sample_idx, (H, W))['params']
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (np.array([0.37, 0.23], np.float32)
                         if 'flow' in jax.tree_util.keystr(path)
                         and p.ndim == 1 else np.asarray(p)), params)
    return model, params, jax_opt.construct_optimizer(args, params)


def port_model(params):
    model = evflownet.Model(event_representation_depth=4, base_channels=8)
    load_flax_params(model, params)
    return model


def assert_same_log(got, want):
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in want]
    np.testing.assert_allclose([v for _, v, _ in got],
                               [v for _, v, _ in want], rtol=1e-5)


@pytest.mark.parametrize('accumulation', [1, 2])
def test_train_loop_matches_jax(accumulation):
    loader = [make_collated(0), make_collated(1), oversized(5),
              make_collated(2), make_collated(3), make_collated(4)] * 2
    num_steps = 8 // accumulation
    logs, calls, results = {}, {}, {}

    model, params, tx = jax_setup(ARGS)
    step = jax_state.make_train_step(model, JaxMultiScaleLoss(SHAPES), tx,
                                     [0.5, 1, 1], accumulation)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)
    logs['jax'], calls['jax'] = ListLogger(), []
    hook = jax_train.make_hook_periodic(
        lambda s, n: calls['jax'].append((s, n)), 2)
    state, samples = jax_train.train(
        step, state, loader, num_steps, logs['jax'], TAGS,
        lr_fn=lambda s: jax_opt.current_learning_rates(ARGS, s),
        accumulation_steps=accumulation, event_capacity=CAPACITY,
        hooks={'record': hook}, metric_flush_steps=3)
    results['jax'] = (int(state.step), samples)

    port = port_model(params)
    step_fn = make_train_step(port, MultiScaleLoss(SHAPES),
                              construct_optimizer(ARGS, port), [0.5, 1, 1],
                              accumulation)
    logs['port'], calls['port'] = ListLogger(), []
    hook = port_train.make_hook_periodic(
        lambda s, n: calls['port'].append((s, n)), 2)
    state, samples = port_train.train(
        step_fn, create_train_state(), loader, num_steps, logs['port'],
        TAGS, CPU, lr_fn=lambda s: current_learning_rates(ARGS, s),
        accumulation_steps=accumulation, event_capacity=CAPACITY,
        hooks={'record': hook}, metric_flush_steps=3)
    results['port'] = (state.step, samples)

    assert results['port'] == results['jax'] == (num_steps, 16)
    assert calls['port'] == calls['jax'] == [
        (s, 2 * accumulation * s) for s in range(2, num_steps + 1, 2)]
    skips = {k: [v for t, v, _ in log.scalars
                 if t == 'General/skipped batches']
             for k, log in logs.items()}
    assert skips['port'] == skips['jax'] == [1.0, 2.0]
    assert_same_log(logs['port'].scalars, logs['jax'].scalars)
    tags = {t for t, _, _ in logs['port'].scalars}
    assert {'General/learning rate/0', 'General/learning rate/1',
            f'Train/photometric loss/{TAGS[0]}'} <= tags


def test_validate_matches_jax():
    loader = [make_collated(6), oversized(7), make_collated(8)]
    model, params, _ = jax_setup(ARGS)
    jax_log, port_log = ListLogger(), ListLogger()
    want = jax_train.validate(
        jax_state.make_eval_step(model, JaxMultiScaleLoss(SHAPES),
                                 [0.5, 1, 1]),
        jax.tree_util.tree_map(jnp.array, params), loader, 10, jax_log,
        TAGS, event_capacity=CAPACITY)
    got = port_train.validate(
        make_eval_step(port_model(params), MultiScaleLoss(SHAPES),
                       [0.5, 1, 1]),
        loader, 10, port_log, TAGS, CPU, event_capacity=CAPACITY)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(port_log.scalars) == 1 + 3 * len(TAGS)
    assert_same_log(port_log.scalars, jax_log.scalars)


def test_resume_across_frameworks():
    args = SimpleNamespace(**{**vars(ARGS), 'grad_clip_norm': 1.0,
                              'ema_decay': 0.8})
    batches = [make_collated(s) for s in range(3)]
    model, params, tx = jax_setup(args)
    step = jax_state.make_train_step(model, JaxMultiScaleLoss(SHAPES), tx,
                                     [0.5, 1, 1], 1)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)
    jax_batches = [jax_pad_batch(b, capacity=CAPACITY) for b in batches]
    for i in range(3):
        state, _ = step(state, jax_batches[i])

    port = evflownet.Model(event_representation_depth=4, base_channels=8)
    port.load_state_dict(flax_to_torch(jax.device_get(state.params)))
    optimizer = construct_optimizer(args, port)
    optimizer.load_state_dict(optax_state_to_torch(state.opt_state, port))
    assert optimizer.groups['representation'].count == 3
    step_fn = make_train_step(port, MultiScaleLoss(SHAPES), optimizer,
                              [0.5, 1, 1], 1)
    port_state = create_train_state(3)
    for i in range(3, 6):
        state, _ = step(state, jax_batches[i % 3])
        port_state, _ = step_fn(port_state,
                                pad_batch(batches[i % 3], CAPACITY).to(CPU))
    assert port_state.step == int(state.step) == 6

    for tree, want_tree in (
            (port.state_dict(), state.params),
            (optimizer.state_dict()['ema_params'],
             state.opt_state.ema_params)):
        got = dict(jax.tree_util.tree_leaves_with_path(torch_to_flax(tree)))
        for path, want in jax.tree_util.tree_leaves_with_path(want_tree):
            np.testing.assert_allclose(got[path], np.asarray(want),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=jax.tree_util.keystr(path))
