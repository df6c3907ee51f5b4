"""The port's batch prefetch, ``data/prefetch.py``.

Mirrors the JAX package's tests/dataset/test_prefetch.py (order and the
overflow pass-through, closing the source when the consumer leaves), and
adds:

- an error raised by the source reaches the consumer;
- the port's ``train`` closes an endless loader when it has taken its
  steps.
"""
import threading

import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu_torch.data.prefetch import \
    prefetch_to_device
from dvs_of_training_framework_tpu_torch.data.schema import pad_batch
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_train_step)
from dvs_of_training_framework_tpu_torch.training.train import train
from tests.test_torch_train_loop import TAGS, ListLogger, oversized
from tests.test_torch_train_step import ARGS, CAPACITY, SHAPES, make_collated

CPU = torch.device('cpu')


def make_host_batch(n_events, seed=0):
    rng = np.random.default_rng(seed)
    return {
        'events': {
            'x': rng.integers(0, 32, n_events),
            'y': rng.integers(0, 32, n_events),
            'timestamp': rng.uniform(0, 0.04, n_events)
            .astype(np.float32),
            'polarity': rng.choice([-1.0, 1.0], n_events),
            'element_index': np.zeros(n_events, np.int64),
            'sample_index': np.zeros(n_events, np.int64),
        },
        'timestamps': np.array([0, 0.04], np.float32),
        'sample_idx': np.array([0, 0], np.int64),
        'images': np.zeros((2, 1, 32, 32), np.float32),
        'augmentation_params': None,
        'size': 1,
    }


def prepare(batch):
    if batch['events']['x'].size > 64:
        raise OverflowError('too many events')
    return pad_batch(batch, 64)


def test_prefetch_preserves_order_and_flags_overflow():
    batches = [make_host_batch(10, 0), make_host_batch(999, 1),
               make_host_batch(20, 2)]
    out = list(prefetch_to_device(iter(batches), prepare, CPU))
    assert len(out) == 3
    assert all(host is batch for (host, _), batch in zip(out, batches))
    _, dev0 = out[0]
    assert dev0.events.num_events == 10
    np.testing.assert_array_equal(dev0.events.x.numpy(),
                                  pad_batch(batches[0], 64).events.x)
    # the oversized batch comes through with device_batch=None
    assert out[1][1] is None
    assert out[2][1].events.num_events == 20


def test_prefetch_closes_source_on_abandonment():
    closed = threading.Event()

    def source():
        try:
            i = 0
            while True:  # infinite, like the training loader
                yield make_host_batch(10, i)
                i += 1
        finally:
            closed.set()

    gen = prefetch_to_device(source(), prepare, CPU)
    next(gen)
    gen.close()  # the consumer leaves early
    assert closed.wait(timeout=10), 'the source iterator was not closed'


def test_prefetch_passes_source_errors_on():
    def source():
        yield make_host_batch(10)
        raise ValueError('broken shard')

    gen = prefetch_to_device(source(), prepare, CPU)
    assert next(gen)[1].events.num_events == 10
    with pytest.raises(ValueError, match='broken shard'):
        next(gen)


def test_train_closes_an_endless_loader():
    closed = threading.Event()

    def loader():
        try:
            i = 0
            while True:
                yield oversized(5) if i == 1 else make_collated(i)
                i += 1
        finally:
            closed.set()

    model = evflownet.Model(event_representation_depth=4, base_channels=8)
    step_fn = make_train_step(model, MultiScaleLoss(SHAPES),
                              construct_optimizer(ARGS, model),
                              [0.5, 1, 1], 1)
    logger = ListLogger()
    state, samples = train(step_fn, create_train_state(), loader(), 2,
                           logger, TAGS, CPU, event_capacity=CAPACITY)
    assert (state.step, samples) == (2, 4)
    assert ('General/skipped batches', 1, 2) in logger.scalars
    assert closed.is_set(), 'train() left the loader open'
