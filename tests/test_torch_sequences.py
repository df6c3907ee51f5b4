"""Port parity: multi-element samples (``--max-sequence-length > 1``,
``--prefix-length``, ``--dynamic-sample-length``) against the JAX package.

- The slot layout: ``layout_sample_slots`` and ``pad_batch(...,
  sequence_length=)`` equal the JAX package's exactly on a 2-element
  batch and on dynamic 1-3 element batches of the ``tests/data``
  fixtures; every length mix shares one shape, and a full-length batch
  maps to itself (tests/dataset/test_dynamic_length.py).
- The port's loaders under the sequence flags yield the JAX package's
  batches, every array equal (tests/test_torch_data.py's comparison).
- EVFlowNet at L = 2 with prefix 1: flows at the rtol 1e-4 / atol 1e-6 of
  tests/test_torch_model.py (the JAX side on its CPU path, the plain
  scatter and the XLA kernel-MLP, as tests/training/test_sequences.py
  runs it), ``flow_ts`` exactly; on dynamic batches with padding slots
  the loss at rtol 1e-5 (tests/test_torch_train_step.py's).
- A golden training sequence of EVFlowNet at L = 2, prefix 1, with
  accumulation 1 and 2: each loss at rtol 1e-5, the parameters after the
  last step at rtol 1e-5 / atol 1e-7 (tests/test_torch_train_step.py).
- The loop pads dynamic batches into slots, in training and validation.
"""
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvs_of_training_framework_tpu.data.schema as jax_schema
from dvs_of_training_framework_tpu.data.collate import \
    collate_wrapper as jax_collate
from dvs_of_training_framework_tpu.data.dataset import \
    DatasetImpl as JaxDatasetImpl
from dvs_of_training_framework_tpu.losses import \
    MultiScaleLoss as JaxMultiScaleLoss
from dvs_of_training_framework_tpu.losses.loss import \
    combined_loss as jax_combined_loss
from dvs_of_training_framework_tpu.models import load_model_class
from dvs_of_training_framework_tpu.training import optimizers as jax_opt
from dvs_of_training_framework_tpu.training import state as jax_state
from dvs_of_training_framework_tpu_torch.data import schema
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.losses.loss import combined_loss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_eval_step, make_train_step)
from dvs_of_training_framework_tpu_torch.training.hooks import ValidationHook
from dvs_of_training_framework_tpu_torch.training.train import train
from dvs_of_training_framework_tpu_torch.utils.convert import (
    load_flax_params, torch_to_flax)
from tests.helpers import data_path
from tests.test_torch_data import (PACKAGES, SEED, assert_equal_tree,
                                   mvsec_root, parse_train)  # noqa: F401
from tests.test_torch_train_step import ARGS

REPO = Path(__file__).resolve().parents[1]
SHAPE = (64, 64)
SHAPES = [(SHAPE[0] >> s, SHAPE[1] >> s) for s in (3, 2, 1, 0)]
CAPACITY = 8192


def fixture_collated(lengths):
    """A collated batch of the fixtures with per-sample element counts
    ``lengths``, as the JAX package collates it."""
    dataset = JaxDatasetImpl(path=data_path, shape=list(SHAPE),
                             augmentation=False, collapse_length=1,
                             is_raw=True, min_seq_length=1,
                             max_seq_length=max(lengths),
                             is_static_seq_length=False)
    return jax_collate([dataset.__getitem__(i, k=1, seq_length=n)
                        for i, n in enumerate(lengths)])


def batch_fields(batch):
    """Every array of a padded Batch, by name."""
    fields = {k: np.asarray(getattr(batch.events, k))
              for k in ('x', 'y', 'timestamp', 'polarity', 'element_index',
                        'sample_index')}
    fields.update(timestamps=np.asarray(batch.timestamps),
                  sample_idx=np.asarray(batch.sample_idx),
                  images=np.asarray(batch.images))
    return fields


@pytest.mark.parametrize('lengths, max_len', [([2, 2], 2), ([1, 3, 2], 3),
                                              ([3, 1], 3)])
def test_slot_layout_matches_jax(lengths, max_len):
    collated = fixture_collated(lengths)
    got = schema.layout_sample_slots(collated, max_len)
    want = jax_schema.layout_sample_slots(collated, max_len)
    assert_equal_tree({k: got[k] for k in ('timestamps', 'sample_idx',
                                           'images')},
                      {k: want[k] for k in ('timestamps', 'sample_idx',
                                            'images')})
    S, B = max_len + 1, len(lengths)
    assert got['timestamps'].shape == (B * S,)
    for b, n in enumerate(lengths):         # padding after the real slots
        assert (got['sample_idx'][b * S + n + 1:(b + 1) * S] == B).all()
        assert not got['images'][b * S + n + 1:(b + 1) * S].any()
    padded = schema.pad_batch(collated, CAPACITY, sequence_length=max_len)
    want_batch = jax_schema.pad_batch(collated, capacity=CAPACITY,
                                      sequence_length=max_len)
    assert_equal_tree(batch_fields(padded), batch_fields(want_batch))
    if min(lengths) == max_len:             # full length: the identity
        static = schema.pad_batch(collated, CAPACITY)
        assert_equal_tree(batch_fields(padded), batch_fields(static))


def test_dynamic_batches_share_one_shape():
    shapes = {tuple(a.shape for a in batch_fields(schema.pad_batch(
        fixture_collated(lengths), CAPACITY, sequence_length=3)).values())
        for lengths in ([1, 2], [3, 1], [2, 2])}
    assert len(shapes) == 1


def loader_batches(package, argv, n):
    """The first ``n`` training batches of one package's loader over the
    fixtures, the global generators seeded alike."""
    import random
    options, loader, *_ = PACKAGES[package]
    args = loader.choose_data_path(parse_train(
        options, ['-m', 'out', '--height', '64', '--width', '64', '-bs', '2',
                  '-mbs', '2', '--num_workers', '0'] + argv))
    random.seed(SEED)
    np.random.seed(SEED)
    it = iter(loader.get_dataloader(loader.get_trainset_params(args)))
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize('argv', [
    ['--min-sequence-length', '2', '--max-sequence-length', '2'],
    ['--min-sequence-length', '1', '--max-sequence-length', '3',
     '--dynamic-sample-length']])
def test_loaders_yield_jax_batches_under_sequence_flags(mvsec_root, argv):
    got = loader_batches('port', argv, 3)
    want = loader_batches('jax', argv, 3)
    for batch_got, batch_want in zip(got, want):
        assert_equal_tree(batch_got, batch_want)
    counts = {int(np.bincount(b['sample_idx']).max()) for b in got}
    assert counts <= {2, 3, 4}
    if '--dynamic-sample-length' not in argv:
        assert counts == {3}


def jax_evflownet(max_len, prefix, dynamic=False):
    module = load_model_class(REPO / 'EVFlowNet')
    return module.Model(prefix_length=prefix, max_sequence_length=max_len,
                        dynamic_sample_length=dynamic,
                        event_representation_depth=3, base_channels=4)


def jax_init(model, jax_batch, seed, imsize=SHAPE):
    """``model``'s flax parameters, initialised in one jitted program."""
    return jax.jit(lambda r, e, t, s: model.init(r, e, t, s, imsize))(
        jax.random.PRNGKey(seed), jax_batch.events, jax_batch.timestamps,
        jax_batch.sample_idx)['params']


def port_evflownet(params, max_len, prefix, dynamic=False):
    model = evflownet.Model(prefix_length=prefix,
                            max_sequence_length=max_len,
                            dynamic_sample_length=dynamic,
                            event_representation_depth=3, base_channels=4)
    load_flax_params(model, params)
    return model


def test_evflownet_prefix_forward_matches_jax():
    collated = fixture_collated([2, 2])
    jb = jax_schema.pad_batch(collated, capacity=CAPACITY)
    batch = schema.pad_batch(collated, CAPACITY).to('cpu')
    model = jax_evflownet(2, 1)
    params = jax_init(model, jb, 0)
    flows, flow_ts, flow_sidx = jax.jit(lambda p, b: model.apply(
        {'params': p}, b.events, b.timestamps, b.sample_idx, SHAPE))(
        params, jb)
    port = port_evflownet(params, 2, 1)
    with torch.no_grad():
        got_flows, got_ts, got_sidx = port(batch.events, batch.timestamps,
                                           batch.sample_idx, SHAPE)
    for got, want in zip(got_flows, flows):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(flow_ts))
    np.testing.assert_array_equal(got_sidx.numpy(), np.asarray(flow_sidx))
    # the prediction covers the second element of each sample
    ts = np.asarray(collated['timestamps'], np.float32).reshape(2, 3)
    np.testing.assert_array_equal(got_ts.numpy(), ts[:, 1:3])


def test_dynamic_losses_match_jax():
    """Dynamic batches with padding slots, EVFlowNet at L = 3: the loss of
    each, and ``flow_ts`` on each sample's first window."""
    collated = [fixture_collated(n) for n in ([1, 2], [3, 1], [2, 2])]
    jbs = [jax_schema.pad_batch(c, capacity=CAPACITY, sequence_length=3)
           for c in collated]
    model = jax_evflownet(3, 0, dynamic=True)
    params = offset_flow_biases(jax_init(model, jbs[0], 1))
    port = port_evflownet(params, 3, 0, dynamic=True)
    jax_loss = JaxMultiScaleLoss(SHAPES)
    port_loss = MultiScaleLoss(SHAPES)

    @jax.jit    # one compile: every batch has the slotted shape
    def loss_of(batch):
        out = model.apply({'params': params}, batch.events, batch.timestamps,
                          batch.sample_idx, SHAPE)
        return jax_combined_loss(jax_loss, *out[:3], batch.images,
                                 batch.timestamps, batch.sample_idx)[0]

    for c, jb in zip(collated, jbs):
        assert (np.asarray(jb.sample_idx) == 2).any()     # padding slots
        want = loss_of(jb)
        batch = schema.pad_batch(c, CAPACITY, sequence_length=3).to('cpu')
        with torch.no_grad():
            flows, flow_ts, flow_sidx = port(batch.events, batch.timestamps,
                                             batch.sample_idx, SHAPE)
            got, _ = combined_loss(port_loss, flows, flow_ts, flow_sidx,
                                   batch.images, batch.timestamps,
                                   batch.sample_idx)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        ts = batch.timestamps.numpy().reshape(2, 4)
        np.testing.assert_array_equal(flow_ts.numpy(), ts[:, :2])


def offset_flow_biases(params):
    """The flow heads' biases at (0.37, 0.23) px, away from the pixel
    centres where the bilinear gradient jumps
    (tests/test_torch_train_step.py)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, p: (np.array([0.37, 0.23], np.float32)
                         if 'flow' in jax.tree_util.keystr(path)
                         and p.ndim == 1 else np.asarray(p)), params)


def make_sequence_collated(seed, B=2, L=2, H=32, W=32):
    """A collated batch of ``L``-element samples made with numpy: events
    in each element's window and smooth frames, each shifted one more
    pixel than the last (tests/test_torch_train_step.py's frames)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(150, 240))
    sample = np.sort(rng.integers(0, B, n))
    element = rng.integers(0, L, n)
    order = np.lexsort((element, sample))
    sample, element = sample[order], element[order]
    timestamps = np.tile(np.arange(L + 1) * 0.04, B).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    phase = rng.uniform(0, 2 * np.pi)
    images = [128 + 100 * np.sin((xx + l * (1 + b)) / 3.0 + phase)
              * np.cos(yy / 5.0) for b in range(B) for l in range(L + 1)]
    return {'events': {
                'x': rng.integers(0, W, n), 'y': rng.integers(0, H, n),
                'timestamp': (element * 0.04 + rng.uniform(0, 0.04, n))
                .astype(np.float32),
                'polarity': rng.choice([-1.0, 1.0], n),
                'element_index': element, 'sample_index': sample},
            'timestamps': timestamps,
            'sample_idx': np.repeat(np.arange(B), L + 1),
            'images': np.stack(images).astype(np.float32), 'size': B}


@pytest.mark.parametrize('accumulation', [1, 2])
def test_sequence_train_step_matches_jax(accumulation):
    H = W = 32
    shapes = [(H >> s, W >> s) for s in (3, 2, 1, 0)]
    collated = [make_sequence_collated(s) for s in range(3)]
    jbs = [jax_schema.pad_batch(c, capacity=256) for c in collated]
    model = jax_evflownet(2, 1)
    params = offset_flow_biases(jax_init(model, jbs[0], 0, (H, W)))
    tx = jax_opt.construct_optimizer(ARGS, params)
    jax_step = jax_state.make_train_step(
        model, JaxMultiScaleLoss(shapes), tx, [0.5, 1, 1],
        accumulation_steps=accumulation, is_raw=True)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)

    port = port_evflownet(params, 2, 1)
    step_fn = make_train_step(port, MultiScaleLoss(shapes),
                              construct_optimizer(ARGS, port), [0.5, 1, 1],
                              accumulation)
    port_state = create_train_state()
    batches = [schema.pad_batch(c, 256).to('cpu') for c in collated]
    for i in range(7):
        state, (want_loss, _) = jax_step(state, jbs[i % 3])
        port_state, (loss, _) = step_fn(port_state, batches[i % 3])
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                                   err_msg=f'step {i}')
    assert port_state.step == int(state.step) == 7 // accumulation
    got = dict(jax.tree_util.tree_leaves_with_path(
        torch_to_flax(port.state_dict())))
    for path, want in jax.tree_util.tree_leaves_with_path(state.params):
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


class ListLogger:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def flush(self):
        pass


def test_loop_pads_dynamic_batches_into_slots():
    """``train`` and the validation hook with ``sequence_length``: two
    steps over ragged 1-3 element batches, one validation pass."""
    collated = [fixture_collated(n) for n in ([1, 3], [2, 1])]
    port = evflownet.Model(max_sequence_length=3, dynamic_sample_length=True,
                           event_representation_depth=3, base_channels=4)
    evaluator = MultiScaleLoss(SHAPES)
    args = SimpleNamespace(**vars(ARGS))
    step_fn = make_train_step(port, evaluator,
                              construct_optimizer(args, port), [0.5, 1, 1],
                              1)
    logger = ListLogger()
    state, samples = train(step_fn, create_train_state(), iter(collated), 2,
                           logger, ['8x8', '16x16', '32x32', '64x64'],
                           torch.device('cpu'), event_capacity=CAPACITY,
                           sequence_length=3)
    assert (state.step, samples) == (2, 4)
    ValidationHook(make_eval_step(port, evaluator, [0.5, 1, 1]),
                   lambda: collated, logger, ['8x8'], torch.device('cpu'),
                   event_capacity=CAPACITY, sequence_length=3)(2, 4)
    values = {tag: v for tag, v, _ in logger.scalars}
    assert np.isfinite(values['General/Train loss'])
    assert np.isfinite(values['General/Validation loss'])
