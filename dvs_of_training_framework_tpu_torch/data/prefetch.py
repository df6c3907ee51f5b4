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
"""


def prefetch_to_device(batch_iter, prepare_fn, device):
    """Yield ``(host_batch, device_batch)`` for each host batch.

    Args:
        batch_iter: iterator of host-collated batch dicts.
        prepare_fn: ``host_batch -> Batch`` of host arrays (padding); an
            ``OverflowError`` yields ``(host_batch, None)`` so the caller
            can skip the batch.
        device: the torch device the batches go to.

    Abandoning the generator (break, exception, garbage collection)
    closes ``batch_iter``.
    """
    pin = device.type == 'cuda'
    try:
        for host_batch in batch_iter:
            try:
                batch = prepare_fn(host_batch)
            except OverflowError:
                yield host_batch, None
                continue
            if pin:
                batch = batch.pin_memory()
            yield host_batch, batch.to(device, non_blocking=True)
    finally:
        close = getattr(batch_iter, 'close', None)
        if close is not None:
            close()
