"""Encoded-batch codec: compact storable format for event batches.

Produces/consumes the same HDF5 layout as the reference
(utils/dataset.py:159-548) so preprocessed datasets are interchangeable:

- event coordinates as int16, polarity as bool, images as uint8
- counts instead of indices (``events_per_element``, ``elements_per_sample``)
  enabling O(1) pure-index subrange reads via prefix sums
- quantized variant storing dense ``(B*C, H, W)`` tensors with
  ``channels_per_sample``

Everything here is host-side NumPy; nothing depends on JAX.

The port's copy of ``dvs_of_training_framework_tpu/data/codec.py``. h5py is
imported by the functions that read and write files, so the module imports
without it.
"""
from pathlib import Path
import typing

import numpy as np

from ..utils.common import cumsum_with_prefix


Batch_t = typing.Dict[str, typing.Any]


def select_batch_info_ranges(elements_per_sample: np.ndarray,
                             sample_begin: int,
                             sample_end: int) -> Batch_t:
    """Begin/end indices to subset encoded batch *info* to samples
    [sample_begin, sample_end).  Mirrors reference utils/dataset.py:28-64."""
    assert isinstance(sample_begin, int)
    assert isinstance(sample_end, int)
    assert sample_end > sample_begin

    timestamps_shift = cumsum_with_prefix(
        np.asarray(elements_per_sample, dtype=np.int64) + 1, np.int64)
    timestamp_begin = int(timestamps_shift[sample_begin])
    timestamp_end = int(timestamps_shift[sample_end])
    per_sample = {'begin': sample_begin, 'end': sample_end}
    return {'timestamps': {'begin': timestamp_begin, 'end': timestamp_end},
            'elements_per_sample': dict(per_sample),
            'images': {'begin': timestamp_begin, 'end': timestamp_end},
            'augmentation_params': {
                'idx': dict(per_sample),
                'sequence_length': dict(per_sample),
                'collapse_length': dict(per_sample),
                'box': dict(per_sample),
                'angle': dict(per_sample),
                'is_flip': dict(per_sample)}}


def select_encoded_ranges(events_per_element: np.ndarray,
                          elements_per_sample: np.ndarray,
                          sample_begin: int,
                          sample_end: int) -> Batch_t:
    """Begin/end indices to subset a full encoded batch
    (reference utils/dataset.py:67-115)."""
    assert isinstance(sample_begin, int)
    assert isinstance(sample_end, int)
    assert sample_end > sample_begin

    events_shift = cumsum_with_prefix(
        np.asarray(events_per_element, dtype=np.int64), np.int64)
    elements_shift = cumsum_with_prefix(
        np.asarray(elements_per_sample, dtype=np.int64), np.int64)

    events_per_element_begin = int(elements_shift[sample_begin])
    events_per_element_end = int(elements_shift[sample_end])
    events_begin = int(events_shift[events_per_element_begin])
    events_end = int(events_shift[events_per_element_end])
    result = select_batch_info_ranges(elements_per_sample,
                                      sample_begin, sample_end)
    ev_range = {'begin': events_begin, 'end': events_end}
    result['events'] = {'x': dict(ev_range),
                        'y': dict(ev_range),
                        'timestamp': dict(ev_range),
                        'polarity': dict(ev_range),
                        'events_per_element': {
                            'begin': events_per_element_begin,
                            'end': events_per_element_end}}
    return result


def select_quantized_ranges(channels_per_sample: np.ndarray,
                            elements_per_sample: np.ndarray,
                            sample_begin: int,
                            sample_end: int) -> Batch_t:
    """Begin/end indices to subset an encoded quantized batch
    (reference utils/dataset.py:118-156)."""
    assert isinstance(sample_begin, int)
    assert isinstance(sample_end, int)
    assert sample_end > sample_begin

    channels_shift = cumsum_with_prefix(
        np.asarray(channels_per_sample, dtype=np.int64), np.int64)
    result = select_batch_info_ranges(elements_per_sample,
                                      sample_begin, sample_end)
    result['data'] = {'begin': int(channels_shift[sample_begin]),
                      'end': int(channels_shift[sample_end])}
    result['channels_per_sample'] = {'begin': sample_begin,
                                     'end': sample_end}
    return result


def _empty_encoded_batch() -> Batch_t:
    return {'events': {'x': np.array([], dtype=np.int16),
                       'y': np.array([], dtype=np.int16),
                       'timestamp': np.array([], dtype=np.float32),
                       'polarity': np.array([], dtype=np.bool_),
                       'events_per_element': np.array([], dtype=np.int16)},
            'timestamps': np.array([], dtype=np.float32),
            'elements_per_sample': np.array([], dtype=np.int16),
            'images': np.array([], dtype=np.uint8),
            'augmentation_params': {}}


def join_batches(batches: typing.List[Batch_t]) -> Batch_t:
    """Concatenate encoded batches into one (reference utils/dataset.py:159-198)."""
    if len(batches) == 0:
        return _empty_encoded_batch()
    if len(batches) == 1:
        return batches[0]
    result = {}
    for k in batches[0].keys():
        if isinstance(batches[0][k], dict):
            result[k] = {sk: np.concatenate([el[k][sk] for el in batches])
                         for sk in batches[0][k].keys()}
        elif batches[0][k] is None:
            assert k == 'augmentation_params'
            assert all(el[k] is None for el in batches)
            result[k] = None
        else:
            result[k] = np.concatenate([np.asarray(el[k]) for el in batches])
    return result


def encode_batch_info(timestamps,
                      sample_idx,
                      images,
                      augmentation_params,
                      size: int) -> Batch_t:
    """Encode batch metadata (reference utils/dataset.py:201-237).

    ``elements_per_sample[i]`` = (#timestamps of sample i) - 1, i.e. the number
    of flow elements, stored as uint8.
    """
    sample_idx = np.asarray(sample_idx)
    elements_per_sample = np.zeros(size, dtype=np.int16) - 1
    np.add.at(elements_per_sample, sample_idx,
              np.ones(sample_idx.size, dtype=np.int16))
    return {'timestamps': np.asarray(timestamps, dtype=np.float32),
            'elements_per_sample': elements_per_sample.astype(np.uint8),
            'images': np.asarray(images).astype(np.uint8),
            'augmentation_params': augmentation_params}


def encode_batch(events: Batch_t,
                 timestamps,
                 sample_idx,
                 images,
                 augmentation_params,
                 size: int) -> Batch_t:
    """Encode a collated batch for storage (reference utils/dataset.py:240-305).

    Polarity is stored as bool (-1/1 -> 0/1); per-event indices are replaced
    by ``events_per_element`` counts over the flattened element axis.
    """
    result = encode_batch_info(timestamps, sample_idx, images,
                               augmentation_params, size)

    x = np.asarray(events['x']).astype(np.int16)
    y = np.asarray(events['y']).astype(np.int16)
    t = np.asarray(events['timestamp'], dtype=np.float32)
    p = ((np.asarray(events['polarity']) + 1) // 2).astype(np.bool_)
    e = np.asarray(events['element_index']).astype(np.int64)
    s = np.asarray(events['sample_index']).astype(np.int64)

    element_shift = cumsum_with_prefix(
        result['elements_per_sample'].astype(np.int64), np.int64)
    flat_element = e + element_shift[s]
    # the true element count — NOT the last event's element index + 1:
    # trailing EMPTY elements (a near-still window after cropping) carry
    # no events and must still contribute a zero count row, or decoding
    # misaligns every element after them
    total_elements = int(element_shift[-1])

    events_per_element = np.zeros(total_elements, dtype=np.int64)
    np.add.at(events_per_element, flat_element,
              np.ones_like(flat_element))
    result['events'] = {'x': x, 'y': y, 'timestamp': t, 'polarity': p,
                        'events_per_element': events_per_element}
    return result


def decode_batch_info(encoded_batch_info: Batch_t) -> Batch_t:
    """Inverse of ``encode_batch_info`` (reference utils/dataset.py:308-332)."""
    elements_per_sample = np.asarray(
        encoded_batch_info['elements_per_sample'], dtype=np.int64)
    sample_idx = np.repeat(np.arange(elements_per_sample.size,
                                     dtype=np.int64),
                           elements_per_sample + 1)
    return {'timestamps': np.asarray(encoded_batch_info['timestamps'],
                                     dtype=np.float32),
            'sample_idx': sample_idx,
            'images': np.asarray(encoded_batch_info['images'],
                                 dtype=np.float32),
            'augmentation_params': encoded_batch_info['augmentation_params'],
            'size': int(elements_per_sample.size)}


def decode_batch(encoded_batch: Batch_t) -> Batch_t:
    """Inverse of ``encode_batch`` (reference utils/dataset.py:335-373).

    Index reconstruction is vectorised with ``np.repeat`` instead of the
    reference's per-sample Python loop.
    """
    result = decode_batch_info(encoded_batch)
    events = encoded_batch['events']
    polarity = np.asarray(events['polarity'], dtype=np.int64) * 2 - 1
    elements_per_sample = np.asarray(encoded_batch['elements_per_sample'],
                                     dtype=np.int64)
    events_per_element = np.asarray(events['events_per_element'],
                                    dtype=np.int64)
    num_elements = events_per_element.size
    # element j (flattened) belongs to sample sample_of_element[j]
    sample_of_element = np.repeat(
        np.arange(elements_per_sample.size, dtype=np.int64),
        elements_per_sample)
    # local element index within its sample
    sample_shift = cumsum_with_prefix(elements_per_sample, np.int64)
    local_element = (np.arange(num_elements, dtype=np.int64)
                     - sample_shift[sample_of_element])
    element_index = np.repeat(local_element, events_per_element)
    sample_index = np.repeat(sample_of_element, events_per_element)
    result['events'] = {'x': np.asarray(events['x'], dtype=np.int64),
                        'y': np.asarray(events['y'], dtype=np.int64),
                        'timestamp': np.asarray(events['timestamp'],
                                                dtype=np.float32),
                        'polarity': polarity,
                        'element_index': element_index,
                        'sample_index': sample_index}
    return result


def encode_quantized_batch(batch: Batch_t) -> Batch_t:
    """Encode a quantized (dense BxCxHxW) batch
    (reference utils/dataset.py:429-479)."""
    data = np.asarray(batch['data'])
    B, C, H, W = data.shape
    result = {'data': data.reshape(B * C, H, W).astype(np.float32),
              'channels_per_sample': np.full((B,), C, dtype=np.uint8)}
    result.update(encode_batch_info(batch['timestamps'],
                                    batch['sample_idx'],
                                    batch['images'],
                                    batch['augmentation_params'],
                                    batch['size']))
    return result


def decode_quantized_batch(batch: Batch_t) -> Batch_t:
    """Inverse of ``encode_quantized_batch``
    (reference utils/dataset.py:482-502)."""
    result = decode_batch_info(batch)
    channels = np.asarray(batch['channels_per_sample'])
    assert channels.size > 0
    assert (channels == channels[0]).all()
    B = result['size']
    C = int(channels[0])
    data = np.asarray(batch['data'])
    _, H, W = data.shape
    result['data'] = data.reshape(B, C, H, W)
    return result


def write_encoded_batch(path: Path, batch: Batch_t):
    """Write an encoded batch as nested HDF5 groups
    (reference utils/dataset.py:376-397)."""
    def write_element(descriptor, data, name):
        if isinstance(data, dict):
            subgroup = descriptor.create_group(name)
            for k, v in data.items():
                write_element(subgroup, v, k)
            return
        descriptor.create_dataset(name, data=np.asarray(data))

    import h5py
    with h5py.File(path, 'w') as f:
        for k, v in batch.items():
            write_element(f, v, k)


def read_data(descriptor, ranges):
    """Read the subranges described by ``ranges`` from an HDF5 node
    (reference utils/dataset.py:505-517)."""
    def is_final(element):
        assert isinstance(element, dict), element
        return ('begin' in element and isinstance(element['begin'], int)
                and 'end' in element and isinstance(element['end'], int))

    assert isinstance(ranges, dict)
    result = {}
    for k, v in ranges.items():
        if is_final(v):
            result[k] = np.asarray(descriptor[k][v['begin']:v['end']])
        else:
            result[k] = read_data(descriptor[k], v)
    return result


def read_encoded_batch(descriptor: 'h5py.File',
                       events_per_element,
                       elements_per_sample,
                       sample_begin: int,
                       sample_end: int) -> Batch_t:
    """Read samples [sample_begin, sample_end) of an encoded shard
    (reference utils/dataset.py:400-426)."""
    ranges = select_encoded_ranges(events_per_element,
                                   elements_per_sample,
                                   sample_begin, sample_end)
    return read_data(descriptor, ranges)


def read_encoded_quantized_batch(descriptor: 'h5py.File',
                                 channels_per_sample,
                                 elements_per_sample,
                                 sample_begin: int,
                                 sample_end: int) -> Batch_t:
    """Quantized analogue of ``read_encoded_batch``
    (reference utils/dataset.py:520-548)."""
    ranges = select_quantized_ranges(channels_per_sample,
                                     elements_per_sample,
                                     sample_begin, sample_end)
    return read_data(descriptor, ranges)
