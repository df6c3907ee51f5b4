"""Mean iteration latency of any iterable (reference utils/performance.py).

The port's copy of ``dvs_of_training_framework_tpu/utils/performance.py``,
its progress bar through ``utils/progress.py`` (tqdm where installed).
"""
from time import perf_counter_ns

from .progress import progress


def get_iterable_performance(loader, start: int = 100, num_iters: int = 500):
    """Average microseconds per iteration, skipping ``start`` warmups."""
    assert num_iters > 0
    t0 = None
    t1 = None
    for i, _ in progress(enumerate(loader), total=start + num_iters):
        if i == start:
            t0 = perf_counter_ns()
        elif i == start + num_iters:
            t1 = perf_counter_ns()
            break
    assert t0 is not None and t1 is not None, \
        'iterable exhausted before the measurement completed'
    return (t1 - t0) / num_iters / 1000
