"""Host-to-device batch upload.

Counterpart of ``dvs_of_training_framework_tpu/data/prefetch.py``
(``prefetch_to_device``), on the caller's thread: each host batch is
padded and, for a CUDA device, pinned in a fresh page-locked buffer, then
copied with ``non_blocking``, so the copy overlaps the work already
queued on the card.  A dense batch (``--ev_images``) pins and uploads
its ``data`` in float32, 8 x 9 x 256 x 256 x 4 B = 18.9 MB at the bench
shape; the model casts it to its compute type on the card, which is
what the JAX package's bf16 data wire amounts to under the bf16 recipe.
The caching host allocator keeps a pinned buffer out of reuse until its
copy has completed, so dropping the host batch after the copy is safe.

There is no background thread: the step is host-bound, and a second
Python thread padding with numpy contends for the GIL with the step's
many small torch calls.  On an H100 80GB HBM3 (700 W) the recipe step
took 48.4 ms through the loop with a padding thread two batches ahead
and 40.1 ms with padding on the loop's thread, against 39.7 ms for the
bare step with the same pinned upload (medians of 40 steps each).

Given the loop's ``timers`` (``utils/timer.py``), each read from the
loader is a ``read`` region and each batch's pinning and copy an
``upload`` region.
"""
from ..utils.timer import FakeTimer


_END = object()


def alone(drops, ended):
    """``prepare_agreed``'s ``agree`` of a single process: its own marks."""
    return drops, ended


def prepare_agreed(batch_iter, prepare_fn, n, agree=alone, timers=None):
    """Read and prepare the next ``n`` host batches, then drop every one
    that some rank could not prepare.

    Args:
        batch_iter: iterator of host-collated batch dicts.
        prepare_fn: ``host_batch -> Batch``; an ``OverflowError`` marks
            the batch's slot for dropping.
        n: the slots of this round, the same on every rank.
        agree: ``(drops, ended) -> (drops, ended)``, each rank's marks
            and whether its stream ended, combined over the ranks
            (``parallel.agree_on_drops``: one all-reduce).
        timers: ``utils/timer.py``'s interface (``FakeTimer`` if None):
            each ``next()`` of ``batch_iter`` is a ``read`` region.

    Returns:
        ``([(host_batch, prepared or None), ...], ended)``: a dropped
        batch comes with None; after ``ended`` no rank reads on.
    """
    timers = FakeTimer() if timers is None else timers
    items, ended = [], False
    for _ in range(n):
        timers('read').start()
        host_batch = next(batch_iter, _END)
        timers('read').stop()
        if host_batch is _END:
            ended = True
            break
        try:
            items.append((host_batch, prepare_fn(host_batch)))
        except OverflowError:
            items.append((host_batch, None))
    drops = [prepared is None for _, prepared in items]
    drops, ended = agree(drops + [True] * (n - len(items)), ended)
    return [(host_batch, None if drop else prepared)
            for (host_batch, prepared), drop in zip(items, drops)], ended


def prefetch_to_device(batch_iter, prepare_fn, device, agree=None,
                       timers=None):
    """Yield ``(host_batch, device_batch)`` for each host batch.

    Args:
        batch_iter: iterator of host-collated batch dicts.
        prepare_fn: ``host_batch -> Batch`` of host arrays (padding); an
            ``OverflowError`` yields ``(host_batch, None)`` so the caller
            can skip the batch.
        device: the torch device the batches go to.
        agree: on a mesh, ``prepare_agreed``'s ``agree``: a batch is
            then dropped on every rank when any rank's piece of it
            overflowed, one all-reduce a batch.
        timers: ``utils/timer.py``'s interface (``FakeTimer`` if None):
            ``read`` regions, and an ``upload`` region a batch.

    Abandoning the generator (break, exception, garbage collection)
    closes ``batch_iter``.
    """
    pin = device.type == 'cuda'
    timers = FakeTimer() if timers is None else timers
    batch_iter = iter(batch_iter)
    try:
        while True:
            items, ended = prepare_agreed(batch_iter, prepare_fn, 1,
                                          agree or alone, timers)
            if ended:
                return
            (host_batch, batch), = items
            if batch is None:
                yield host_batch, None
                continue
            timers('upload').start()
            if pin:
                batch = batch.pin_memory()
            batch = batch.to(device, non_blocking=True)
            timers('upload').stop()
            yield host_batch, batch
    finally:
        close = getattr(batch_iter, 'close', None)
        if close is not None:
            close()
