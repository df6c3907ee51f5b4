"""The traffic generator: the same seed gives the same pool."""
import numpy as np

import helpers  # noqa: F401
from harness import traffic

TRAFFIC = {'stream': {'duration_s': 0.6, 'speed': 1.0},
           'events_per_element_cap': 700, 'pool_windows': 2}


def pool(seed, elements=1):
    return traffic.make_pool(TRAFFIC, seed, 3, (64, 96), elements, 2)


def same(a, b):
    return all(np.array_equal(a['events'][k], b['events'][k])
               for k in a['events']) and all(
        np.array_equal(a[k], b[k])
        for k in ('timestamps', 'sample_idx', 'images'))


def test_a_seed_gives_the_same_pool():
    seed = 2 ** 31 + 12345            # beyond 32 signed bits
    for x, y in zip(pool(seed), pool(seed)):
        assert same(x, y)


def test_seeds_differ_and_batches_all_differ():
    a, b = pool(7), pool(8)
    assert not any(same(x, y) for x, y in zip(a, b))
    assert not any(same(a[i], a[j]) for i in range(len(a))
                   for j in range(i + 1, len(a)))


def test_batches_keep_to_the_shapes_and_the_cap():
    for elements in (1, 2):
        for batch in pool(3, elements):
            ev = batch['events']
            assert batch['size'] == 3
            assert batch['images'].shape == (3 * (elements + 1), 1, 64, 96)
            assert batch['timestamps'].shape == (3 * (elements + 1),)
            assert ev['x'].max(initial=0) < 96 and ev['y'].max(initial=0) < 64
            for b in range(3):
                for e in range(elements):
                    n = np.sum((ev['sample_index'] == b)
                               & (ev['element_index'] == e))
                    assert n <= 700
            # event times inside their element's frame window
            starts = batch['timestamps'].reshape(3, elements + 1)
            t0 = starts[ev['sample_index'], ev['element_index']]
            t1 = starts[ev['sample_index'], ev['element_index'] + 1]
            assert np.all(ev['timestamp'] >= t0 - 1e-6)
            assert np.all(ev['timestamp'] <= t1 + 1e-6)
