"""RecurrentFlowNet at its full channel widths against the JAX package's.

``tests/test_torch_plugins.py`` holds the recurrent plugin to the JAX
package's at base 4.  Here the channels are the plugin's own (base 32,
hidden 32, event representation depth 9), the image is cut to 64x64 and
the batch to 2 two-element samples (``tests/test_torch_sequences.py``'s
numpy batches), and both packages start from the same weights
(``utils/convert.py``).  Three RANGER steps with both groups training
from the first and the gradients clipped at a global norm of 1.0:

- golden (fp32, the 'highest' loss): each loss at rtol 1e-5 and every
  parameter after the three steps at rtol 1e-5 / atol 1e-7, the
  tolerances of ``tests/test_torch_plugins.py``'s golden sequence
  (``tests/test_torch_train_step.py``'s);
- the recipe (bf16 model, ``bf16x2`` loss, the kernel-MLP through the
  Pallas kernel in interpret mode): each loss at rtol 1e-3 and every
  parameter within ``tests/test_torch_recipe.py``'s FACTOR times the JAX
  package's own bf16-vs-fp32 gap (+1e-7), the rule
  ``tests/test_torch_plugins.py``'s recipe test applies.

The ``slow`` test (deselected from tier-1) takes the bench's shape: 256x256,
batch 8 of 2-element samples from the port's ``varied`` simulator at a cut
duration, capacity 2^18, three recipe steps under the same rule; then a
few hundred golden steps of each package's ``train()`` at this file's cut
size, the mean loss of the last 50 steps compared.
"""
import contextlib
import functools
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvs_of_training_framework_tpu.data.schema as jax_schema
from dvs_of_training_framework_tpu.losses import \
    MultiScaleLoss as JaxMultiScaleLoss
from dvs_of_training_framework_tpu.models import \
    load_model_class as jax_load_model_class
from dvs_of_training_framework_tpu.training import optimizers as jax_opt
from dvs_of_training_framework_tpu.training import state as jax_state
from dvs_of_training_framework_tpu_torch.data import schema
from dvs_of_training_framework_tpu_torch.losses import (LOSS_PRECISIONS,
                                                        MultiScaleLoss)
from dvs_of_training_framework_tpu_torch.models import recurrent_flownet
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_train_step)
from dvs_of_training_framework_tpu_torch.utils.convert import (
    load_flax_params, torch_to_flax)
from tests.test_torch_recipe import FACTOR
from tests.test_torch_sequences import (jax_init, make_sequence_collated,
                                        offset_flow_biases)
from tests.test_torch_train_step import ARGS

REPO = Path(__file__).resolve().parents[1]
FULL = dict(event_representation_depth=9, base_channels=32,
            hidden_channels=32)
# both groups train from the first step, the gradients clipped
STEP_ARGS = SimpleNamespace(**dict(vars(ARGS), rs=0.0, grad_clip_norm=1.0))
WEIGHTS = [0.5, 1, 1]


def shapes(hw):
    return [(hw >> s, hw >> s) for s in (3, 2, 1, 0)]


def jax_model(dtype='float32'):
    module = jax_load_model_class(REPO / 'RecurrentFlowNet')
    model = module.Model(prefix_length=0, max_sequence_length=2,
                         dtype=dtype, **FULL)
    if dtype == 'float32':
        return model, contextlib.nullcontext()
    # the recipe's kernel-MLP through the Pallas kernel in interpret mode
    return model, mock.patch.object(
        module, 'QuantizationLayer', functools.partial(
            module.QuantizationLayer, kernel_mlp='interpret'))


def jax_losses(hw, precision):
    evaluator = JaxMultiScaleLoss(shapes(hw),
                                  bf16x2=LOSS_PRECISIONS[precision])
    if precision != 'highest':
        for loss in evaluator.losses:
            loss.use_mxu_warp = True
    return evaluator


def port_losses(hw, precision):
    evaluator = MultiScaleLoss(shapes(hw), bf16x2=LOSS_PRECISIONS[precision])
    if precision != 'highest':
        for loss in evaluator.losses:
            loss.use_mxu_warp = True
    return evaluator


def run_jax(params, batches, hw, precision, steps=3):
    model, patch = jax_model('float32' if precision == 'highest'
                             else 'bfloat16')
    tx = jax_opt.construct_optimizer(STEP_ARGS, params)
    step = jax_state.make_train_step(model, jax_losses(hw, precision), tx,
                                     WEIGHTS, accumulation_steps=1,
                                     is_raw=True)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)
    losses = []
    with patch:
        for i in range(steps):
            state, (loss, _) = step(state, batches[i % len(batches)])
            losses.append(float(loss))
    return state, losses


def run_port(params, batches, hw, precision, steps=3):
    model = recurrent_flownet.Model(
        prefix_length=0, max_sequence_length=2,
        dtype='float32' if precision == 'highest' else 'bfloat16', **FULL)
    load_flax_params(model, params)
    step_fn = make_train_step(model, port_losses(hw, precision),
                              construct_optimizer(STEP_ARGS, model),
                              WEIGHTS, 1)
    state, losses = create_train_state(), []
    for i in range(steps):
        state, (loss, _) = step_fn(state, batches[i % len(batches)])
        losses.append(float(loss))
    return model, losses


def leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def padded(collated, capacity):
    return ([jax.tree_util.tree_map(jnp.asarray, jax_schema.pad_batch(
                c, capacity=capacity)) for c in collated],
            [schema.pad_batch(c, capacity).to('cpu') for c in collated])


def assert_recipe_within_the_gap(params, jax_batches, port_batches, hw,
                                 golden):
    state, want_losses = run_jax(params, jax_batches, hw, 'bf16x2')
    port, losses = run_port(params, port_batches, hw, 'bf16x2')
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    got = leaves(torch_to_flax(port.state_dict()))
    gold = leaves(golden.params)
    moved = 0
    for path, want in leaves(state.params).items():
        want = np.asarray(want)
        err = np.abs(got[path] - want).max()
        gap = np.abs(want - np.asarray(gold[path])).max()
        assert err <= FACTOR * gap + 1e-7, (
            f'{jax.tree_util.keystr(path)}: port-vs-jax {err:.3e}, jax '
            f'bf16-vs-fp32 {gap:.3e}')
        moved += not np.array_equal(got[path], leaves(params)[path])
    assert moved > 40     # both groups trained


@pytest.fixture(scope='module')
def cut():
    hw = 64
    jax_batches, port_batches = padded(
        [make_sequence_collated(s, H=hw, W=hw) for s in range(3)], 256)
    params = offset_flow_biases(jax_init(jax_model()[0], jax_batches[0], 0,
                                         (hw, hw)))
    golden, want_losses = run_jax(params, jax_batches, hw, 'highest')
    return SimpleNamespace(hw=hw, jax_batches=jax_batches,
                           port_batches=port_batches, params=params,
                           golden=golden, golden_losses=want_losses)


def test_full_width_golden_steps_match_jax(cut):
    port, losses = run_port(cut.params, cut.port_batches, cut.hw, 'highest')
    np.testing.assert_allclose(losses, cut.golden_losses, rtol=1e-5)
    got = leaves(torch_to_flax(port.state_dict()))
    assert got.keys() == leaves(cut.golden.params).keys()
    moved = 0
    for path, want in leaves(cut.golden.params).items():
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
        moved += not np.array_equal(got[path], leaves(cut.params)[path])
    assert moved > 40     # both groups trained


def test_full_width_recipe_steps_match_jax(cut):
    assert_recipe_within_the_gap(cut.params, cut.jax_batches,
                                 cut.port_batches, cut.hw, cut.golden)


# --- slow: the bench's shape and a few hundred steps ------------------------

def varied_sequence_batch(events, frames, frame_ts, first, size=8,
                          hw=256, capacity=2 ** 18):
    """A collated batch of ``size`` 2-element samples cut from one
    simulated recording: sample b spans frames ``first + b`` to ``first +
    b + 2``, the central ``hw`` crop, at most ``capacity / size`` events a
    sample."""
    fh, fw = frames.shape[1:3]
    oy, ox = (fh - hw) // 2, (fw - hw) // 2
    fields = {k: [] for k in ('x', 'y', 'timestamp', 'polarity',
                              'element_index', 'sample_index')}
    images, timestamps = [], []
    for b in range(size):
        w = first + b
        lo, hi = np.searchsorted(events[:, 2], [frame_ts[w], frame_ts[w + 2]])
        sel = events[lo:hi]
        keep = ((sel[:, 0] >= ox) & (sel[:, 0] < ox + hw)
                & (sel[:, 1] >= oy) & (sel[:, 1] < oy + hw))
        sel = sel[keep][:capacity // size]
        fields['x'].append(sel[:, 0] - ox)
        fields['y'].append(sel[:, 1] - oy)
        fields['timestamp'].append((sel[:, 2] - frame_ts[w])
                                   .astype(np.float32))
        fields['polarity'].append(sel[:, 3])
        fields['element_index'].append(
            (sel[:, 2] >= frame_ts[w + 1]).astype(np.int64))
        fields['sample_index'].append(np.full(sel.shape[0], b, np.int64))
        images += [frames[w + k, oy:oy + hw, ox:ox + hw] for k in range(3)]
        timestamps += [float(frame_ts[w + k] - frame_ts[w])
                       for k in range(3)]
    return {'events': {k: np.concatenate(v) for k, v in fields.items()},
            'timestamps': np.asarray(timestamps, np.float32),
            'sample_idx': np.repeat(np.arange(size), 3),
            'images': np.stack(images).astype(np.float32), 'size': size}


@pytest.mark.slow
def test_bench_shape_recipe_steps_match_jax():
    from dvs_of_training_framework_tpu_torch.data.synthetic import \
        simulate_varied
    hw, capacity = 256, 2 ** 18
    events, frames, frame_ts, _ = simulate_varied(
        np.random.default_rng(3), 1.7, 0.4)
    collated = [varied_sequence_batch(events, frames, frame_ts, first)
                for first in (0, 8, 16)]
    assert all(c['events']['x'].size > capacity // 4 for c in collated)
    jax_batches, port_batches = padded(collated, capacity)
    params = offset_flow_biases(jax_init(jax_model()[0], jax_batches[0], 0,
                                         (hw, hw)))
    golden, _ = run_jax(params, jax_batches, hw, 'highest')
    assert_recipe_within_the_gap(params, jax_batches, port_batches, hw,
                                 golden)


@pytest.mark.slow
def test_a_few_hundred_golden_steps_end_at_the_same_loss(cut):
    """Each package's ``train()`` for 300 golden steps over 12 cycled
    batches at this file's cut size: the mean train loss of the last 50
    steps within 2% (the gap in question is 17%: 1.65 against 1.41)."""
    from dvs_of_training_framework_tpu.training import train as jax_train
    from dvs_of_training_framework_tpu_torch.training import \
        train as port_train
    from tests.test_torch_train_loop import ListLogger
    steps, hw = 300, cut.hw
    loader = [make_sequence_collated(s, H=hw, W=hw) for s in range(12)]
    args = SimpleNamespace(**dict(vars(STEP_ARGS), training_steps=steps,
                                  rs=0.1))
    model, _ = jax_model()
    tx = jax_opt.construct_optimizer(args, cut.params)
    step = jax_state.make_train_step(model, jax_losses(hw, 'highest'), tx,
                                     WEIGHTS, accumulation_steps=1,
                                     is_raw=True)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, cut.params), tx)
    tags = [f'{h}x{w}' for h, w in shapes(hw)]
    jax_log = ListLogger()
    jax_train.train(step, state, loader * steps, steps, jax_log, tags,
                    event_capacity=256)
    port = recurrent_flownet.Model(prefix_length=0, max_sequence_length=2,
                                   **FULL)
    load_flax_params(port, cut.params)
    port_step = make_train_step(port, port_losses(hw, 'highest'),
                                construct_optimizer(args, port), WEIGHTS, 1)
    port_log = ListLogger()
    port_train.train(port_step, create_train_state(), loader * steps, steps,
                     port_log, tags, torch.device('cpu'), event_capacity=256)

    def last(log):
        losses = [v for t, v, _ in log.scalars if t == 'General/Train loss']
        assert len(losses) == steps
        return float(np.mean(losses[-50:]))

    print(f'mean loss of the last 50 of {steps} steps: JAX {last(jax_log)}, '
          f'port {last(port_log)}')
    np.testing.assert_allclose(last(port_log), last(jax_log), rtol=0.02)
