"""Batch schemas: fixed-capacity padded event buffers.

Counterpart of the raw, fixed-capacity path and the dense path of
``dvs_of_training_framework_tpu/data/schema.py`` (``EventBuffer``,
``Batch``, ``pad_events``, ``layout_sample_slots``, ``pad_batch``) and
its capacity buckets (``default_buckets``, ``round_up_to_bucket``).  The
dataclasses hold numpy arrays on the host and torch tensors on the
device; ``.to(device)`` moves a host batch over, and ``.pin_memory()``
first copies it into page-locked host memory, from which that copy can
run asynchronously.
Padding rows carry ``sample_index = batch_size``, one past the last
sample.  A window of K batches stacked on a leading axis
(``data/device_queue.py``) gives batch ``k`` back through
``slice_window_batch``.
"""
import dataclasses

import numpy as np
import torch


def _to(value, device, non_blocking):
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    return value.to(device, non_blocking=non_blocking)


def _pin(value):
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    return value.pin_memory()


@dataclasses.dataclass
class EventBuffer:
    """Fixed-capacity padded event buffer.

    Attributes:
        x, y: int32 ``[capacity]`` pixel coordinates (0 for padding).
        timestamp: float32 ``[capacity]`` seconds from sample start.
        polarity: float32 ``[capacity]`` in {-1, +1} (0 for padding).
        element_index: int32 ``[capacity]`` element within the sample.
        sample_index: int32 ``[capacity]``; padding entries hold
            ``batch_size``.
        num_events: int — number of valid leading entries.
    """
    x: object
    y: object
    timestamp: object
    polarity: object
    element_index: object
    sample_index: object
    num_events: int

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    def to(self, device, non_blocking: bool = True) -> 'EventBuffer':
        arrays = {f.name: _to(getattr(self, f.name), device, non_blocking)
                  for f in dataclasses.fields(self)
                  if f.name != 'num_events'}
        return EventBuffer(num_events=int(self.num_events), **arrays)

    def pin_memory(self) -> 'EventBuffer':
        return dataclasses.replace(self, **{
            f.name: _pin(getattr(self, f.name))
            for f in dataclasses.fields(self) if f.name != 'num_events'})


@dataclasses.dataclass
class Batch:
    """Training batch.

    Exactly one of ``events`` (raw path) and ``data`` (dense path,
    ``--ev_images``) is set.

    Attributes:
        events: padded EventBuffer or None.
        data: float32 ``[B, C, H, W]`` dense event representation or None.
        timestamps: float32 ``[D]`` image timestamps.
        sample_idx: int32 ``[D]`` sample of each timestamp.
        images: float32 ``[D, 1, H, W]`` grayscale frames at the timestamps.
        size: number of samples B.
    """
    events: object
    data: object
    timestamps: object
    sample_idx: object
    images: object
    size: int

    def to(self, device, non_blocking: bool = True) -> 'Batch':
        return Batch(
            events=(None if self.events is None
                    else self.events.to(device, non_blocking)),
            data=(None if self.data is None
                  else _to(self.data, device, non_blocking)),
            timestamps=_to(self.timestamps, device, non_blocking),
            sample_idx=_to(self.sample_idx, device, non_blocking),
            images=_to(self.images, device, non_blocking),
            size=self.size)

    def pin_memory(self) -> 'Batch':
        return Batch(
            events=None if self.events is None else self.events.pin_memory(),
            data=None if self.data is None else _pin(self.data),
            timestamps=_pin(self.timestamps),
            sample_idx=_pin(self.sample_idx),
            images=_pin(self.images), size=self.size)


def slice_window_batch(batch: Batch, idx: int) -> Batch:
    """Batch ``idx`` of a window-stacked Batch (a leading K axis on every
    array, ``num_events`` one count a batch): views, no copy."""
    events = batch.events
    if events is not None:
        events = EventBuffer(num_events=events.num_events[idx], **{
            f.name: getattr(events, f.name)[idx]
            for f in dataclasses.fields(EventBuffer)
            if f.name != 'num_events'})
    return Batch(events=events,
                 data=None if batch.data is None else batch.data[idx],
                 timestamps=batch.timestamps[idx],
                 sample_idx=batch.sample_idx[idx],
                 images=batch.images[idx],
                 size=batch.size)


def round_up_to_bucket(n: int, buckets) -> int:
    """Smallest bucket >= n; buckets is a sorted iterable of capacities."""
    for b in buckets:
        if n <= b:
            return b
    raise OverflowError(f'{n} events exceed the largest bucket {buckets[-1]}')


def default_buckets(capacity: int):
    """Power-of-two bucket ladder up to ``capacity`` (limits recompiles)."""
    buckets = []
    b = 4096
    while b < capacity:
        buckets.append(b)
        b *= 2
    buckets.append(capacity)
    return buckets


def pad_events(events: dict, batch_size: int, capacity: int) -> EventBuffer:
    """Pad a ragged host-side event dict to a fixed-capacity EventBuffer.

    Args:
        events: dict with 1-d numpy arrays ``x, y, timestamp, polarity,
            element_index, sample_index``.
        batch_size: number of samples (padding sample_index = batch_size).
        capacity: target buffer length.

    Raises:
        OverflowError: when the batch holds more than ``capacity`` events.
    """
    n = int(np.asarray(events['x']).size)
    if n > capacity:
        raise OverflowError(f'{n} events exceed event buffer capacity '
                            f'{capacity}')

    def pad(arr, fill, dtype):
        out = np.full(capacity, fill, dtype=dtype)
        out[:n] = np.asarray(arr, dtype=dtype)
        return out

    return EventBuffer(
        x=pad(events['x'], 0, np.int32),
        y=pad(events['y'], 0, np.int32),
        timestamp=pad(events['timestamp'], 0.0, np.float32),
        polarity=pad(events['polarity'], 0.0, np.float32),
        element_index=pad(events['element_index'], 0, np.int32),
        sample_index=pad(events['sample_index'], batch_size, np.int32),
        num_events=n)


def layout_sample_slots(collated: dict, max_seq_length: int) -> dict:
    """Re-layout a variable-length batch into uniform per-sample slots.

    With ``--dynamic-sample-length`` samples carry different element
    counts, so the flat timestamp/image axis varies from batch to batch.
    This gives every sample a block of ``max_seq_length + 1`` slots: its
    real entries first, then padding marked by ``sample_idx = size`` (no
    prediction matches it in the loss and ``segment_starts`` drops it),
    with zero images and zero timestamps.  A batch whose samples all have
    ``max_seq_length`` elements maps to itself.
    """
    size = int(collated['size'])
    S = max_seq_length + 1
    src_sample = np.asarray(collated['sample_idx'])
    timestamps = np.asarray(collated['timestamps'], dtype=np.float32)
    images = np.asarray(collated['images'], dtype=np.float32)
    if images.ndim == 3:
        images = images[:, None]

    counts = np.bincount(src_sample, minlength=size)
    if counts.max(initial=0) > S:
        raise OverflowError(
            f'sample with {counts.max()} timestamps exceeds slot size {S}')
    # destination of every source entry: sample_block_start + local_index
    local = np.arange(src_sample.size) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    dst = src_sample * S + local

    out_ts = np.zeros(size * S, np.float32)
    out_sidx = np.full(size * S, size, np.int64)
    out_images = np.zeros((size * S,) + images.shape[1:], np.float32)
    out_ts[dst] = timestamps
    out_sidx[dst] = src_sample
    out_images[dst] = images

    out = dict(collated)
    out['timestamps'] = out_ts
    out['sample_idx'] = out_sidx
    out['images'] = out_images
    return out


def pad_batch(collated: dict, capacity=None, sequence_length=None) -> Batch:
    """Convert a host-collated batch dict into a padded host Batch.

    Args:
        collated: dict with ``events`` (ragged event dict; raw path) or
            ``data`` (``[B, C, H, W]``; dense path, a decoded quantized
            batch or ``collate_dense_wrapper``'s), ``timestamps``,
            ``sample_idx``, ``images`` (``[D, H, W]`` or ``[D, 1, H, W]``)
            and ``size``.
        capacity: fixed event capacity, required on the raw path and
            unused on the dense one.
        sequence_length: when set (dynamic sample length), re-layout the
            timestamp/image axis into uniform per-sample slots of
            ``sequence_length + 1`` entries (``layout_sample_slots``).
    """
    if sequence_length is not None:
        collated = layout_sample_slots(collated, sequence_length)
    size = int(collated['size'])
    images = np.asarray(collated['images'], dtype=np.float32)
    if images.ndim == 3:
        images = images[:, None]
    events = data = None
    if collated.get('events') is not None:
        if capacity is None:
            raise ValueError('a raw batch needs an event capacity')
        events = pad_events(collated['events'], size, capacity)
    else:
        data = np.asarray(collated['data'], dtype=np.float32)
    return Batch(events=events,
                 data=data,
                 timestamps=np.asarray(collated['timestamps'],
                                       dtype=np.float32),
                 sample_idx=np.asarray(collated['sample_idx'],
                                       dtype=np.int32),
                 images=images,
                 size=size)
