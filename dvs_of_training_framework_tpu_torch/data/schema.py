"""Batch schemas: fixed-capacity padded event buffers.

Counterpart of the raw, fixed-capacity path of
``dvs_of_training_framework_tpu/data/schema.py`` (``EventBuffer``,
``Batch``, ``pad_events``, ``pad_batch``).  The dataclasses hold numpy
arrays on the host and torch tensors on the device; ``.to(device)``
moves a host batch over, and ``.pin_memory()`` first copies it into
page-locked host memory, from which that copy can run asynchronously.
Padding rows carry ``sample_index = batch_size``, one past the last
sample.
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
    """Training batch (raw event path).

    Attributes:
        events: padded EventBuffer.
        timestamps: float32 ``[D]`` image timestamps.
        sample_idx: int32 ``[D]`` sample of each timestamp.
        images: float32 ``[D, 1, H, W]`` grayscale frames at the timestamps.
        size: number of samples B.
    """
    events: EventBuffer
    timestamps: object
    sample_idx: object
    images: object
    size: int

    def to(self, device, non_blocking: bool = True) -> 'Batch':
        return Batch(events=self.events.to(device, non_blocking),
                     timestamps=_to(self.timestamps, device, non_blocking),
                     sample_idx=_to(self.sample_idx, device, non_blocking),
                     images=_to(self.images, device, non_blocking),
                     size=self.size)

    def pin_memory(self) -> 'Batch':
        return Batch(events=self.events.pin_memory(),
                     timestamps=_pin(self.timestamps),
                     sample_idx=_pin(self.sample_idx),
                     images=_pin(self.images), size=self.size)


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


def pad_batch(collated: dict, capacity: int) -> Batch:
    """Convert a host-collated ragged batch dict into a padded host Batch.

    Args:
        collated: dict with ``events`` (ragged event dict), ``timestamps``,
            ``sample_idx``, ``images`` (``[D, H, W]`` or ``[D, 1, H, W]``)
            and ``size``.
        capacity: fixed event capacity.
    """
    size = int(collated['size'])
    images = np.asarray(collated['images'], dtype=np.float32)
    if images.ndim == 3:
        images = images[:, None]
    return Batch(events=pad_events(collated['events'], size, capacity),
                 timestamps=np.asarray(collated['timestamps'],
                                       dtype=np.float32),
                 sample_idx=np.asarray(collated['sample_idx'],
                                       dtype=np.int32),
                 images=images,
                 size=size)
