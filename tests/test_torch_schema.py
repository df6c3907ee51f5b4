"""Port parity: batch padding and segment indices, exact.

The port's ``pad_events``, ``pad_batch``, ``segment_starts`` and
``get_local_idx`` must give exactly the JAX package's arrays, values and
dtypes: padding is a copy and the segment outputs are integers, as the
exact checks of tests/dataset/test_encoding.py::test_pad_events_overflow
and tests/ops/test_warp_parity.py::test_get_local_idx.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.data import schema as jax_schema
from dvs_of_training_framework_tpu.ops import segment as jax_segment
from dvs_of_training_framework_tpu_torch.data import schema
from dvs_of_training_framework_tpu_torch.ops import segment

FIELDS = ('x', 'y', 'timestamp', 'polarity', 'element_index', 'sample_index')


def make_collated(seed=0, batch_size=3, n_events=50, H=12, W=16):
    rng = np.random.default_rng(seed)
    events = {
        'x': rng.integers(0, W, n_events),
        'y': rng.integers(0, H, n_events),
        'timestamp': rng.uniform(0, 0.05, n_events).astype(np.float32),
        'polarity': rng.choice([-1.0, 1.0], n_events),
        'element_index': np.zeros(n_events, np.int64),
        'sample_index': np.sort(rng.integers(0, batch_size, n_events)),
    }
    return {
        'events': events,
        'timestamps': np.tile([0.0, 0.05], batch_size),
        'sample_idx': np.repeat(np.arange(batch_size), 2),
        'images': rng.uniform(0, 255, (2 * batch_size, H, W)),
        'size': batch_size,
    }


@pytest.mark.parametrize('capacity', [50, 64, 200])
def test_pad_events_matches_jax(capacity):
    ev = make_collated()['events']
    got = schema.pad_events(ev, 3, capacity)
    want = jax_schema.pad_events(ev, 3, capacity)
    assert got.capacity == want.capacity == capacity
    assert got.num_events == int(want.num_events) == 50
    for name in FIELDS:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.sample_index[50:] == 3).all()


def test_pad_events_overflow():
    ev = make_collated()['events']
    with pytest.raises(OverflowError):
        schema.pad_events(ev, 3, 49)


def test_pad_batch_matches_jax_and_moves_to_device():
    collated = make_collated(seed=1)
    got = schema.pad_batch(collated, 64)
    want = jax_schema.pad_batch(collated, capacity=64)
    assert got.size == want.size == 3
    for name in ('timestamps', 'sample_idx', 'images'):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    on_device = got.to('cpu')
    assert isinstance(on_device.images, torch.Tensor)
    assert on_device.events.num_events == 50
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(on_device.events, name).numpy(),
            np.asarray(getattr(want.events, name)), err_msg=name)


@pytest.mark.parametrize('ids,num_segments', [
    ([0, 0, 1, 1, 2], 3),
    ([0, 0, 0, 2, 2, 4, 4, 4], 4),          # padding id 4, empty segment 1
    ([1, 1, 3, 3, 3], 5),                   # empty head and tail
    ([5, 5, 5], 5),                         # all padding
])
def test_segment_ops_match_jax(ids, num_segments):
    ids_np = np.asarray(ids, np.int32)
    starts = segment.segment_starts(torch.from_numpy(ids_np), num_segments)
    want = jax_segment.segment_starts(jnp.asarray(ids_np), num_segments)
    assert starts.dtype == torch.int32
    np.testing.assert_array_equal(starts.numpy(), np.asarray(want))
    local, sizes = segment.get_local_idx(torch.from_numpy(ids_np),
                                         num_segments)
    want_local, want_sizes = jax_segment.get_local_idx(jnp.asarray(ids_np),
                                                       num_segments)
    np.testing.assert_array_equal(local.numpy(), np.asarray(want_local))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    assert local.dtype == sizes.dtype == torch.int32
