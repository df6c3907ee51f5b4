"""Ragged batching of per-sample event dicts (host-side NumPy).

Stacks per-sample event dicts into flat arrays with a ``sample_index``
column, stacks image timestamps/images, and arranges augmentation parameters
— the same batch dict contract as the reference collate
(utils/dataset.py:961-1020), with NumPy arrays in place of torch tensors.
The fixed-shape device conversion lives in ``schema.pad_batch``.

The port's copy of ``dvs_of_training_framework_tpu/data/collate.py``.
"""
import numpy as np

from ..utils.common import to_array


def collate_wrapper(batch):
    """Collate a list of ``(events, timestamps, images, aug_params)`` samples.

    Returns a dict with keys ``events`` (flat ragged arrays + sample_index),
    ``timestamps``, ``sample_idx``, ``images`` ``[D,1,H,W]``,
    ``augmentation_params``, ``size``.
    """
    def stack_events(batch):
        events_per_sample = [sample[0]['x'].size for sample in batch]
        shift = np.cumsum(events_per_sample)
        result_keys = {'x', 'y', 'timestamp', 'polarity', 'element_index'}
        result = {k: np.hstack([sample[0][k] for sample in batch])
                  for k in result_keys}
        result['sample_index'] = np.repeat(
            np.arange(len(batch), dtype=np.int64), events_per_sample)
        assert result['sample_index'].size == (shift[-1] if len(shift) else 0)
        return result

    events = stack_events(batch)
    sample_idx = np.hstack([np.full_like(sample[1], i, dtype=np.int_)
                            for i, sample in enumerate(batch)])
    timestamps = np.hstack([sample[1] for sample in batch])
    images = np.vstack([x[2] for x in batch])
    images = np.expand_dims(images, axis=1)
    add_info = tuple()
    if len(batch) > 0 and len(batch[0]) > 3:
        #   0        1       2    3     4       5
        # (idx, seq_length,  k,  box, angle, is_flip)
        augmentation_params = [x[3] for x in batch]
        info_dict = {
            'idx': np.array([x[0] for x in augmentation_params]),
            'sequence_length': np.array([x[1]
                                         for x in augmentation_params]),
            'collapse_length': np.array([x[2] for x in augmentation_params]),
            'box': np.vstack([x[3].reshape(1, -1)
                              for x in augmentation_params]),
            'angle': np.array([x[4] for x in augmentation_params]),
            'is_flip': np.array([x[5] for x in augmentation_params]),
        }
        add_info = (to_array(info_dict), )

    events = to_array(events)
    return {'events': events,
            'timestamps': timestamps.astype(np.float32),
            'sample_idx': sample_idx.astype(np.int64),
            'images': images.astype(np.float32),
            'augmentation_params': add_info[0] if add_info else None,
            'size': len(batch)}


def collate_dense_wrapper(batch):
    """Collate samples whose elements are dense event images (--ev_images).

    Each sample's ``elements`` is a ``[L, C, H, W]`` array (produced by the
    plugin's ``compute_event_image``); the batch stacks them to ``data``
    ``[B, L*C, H, W]``.  Everything else matches ``collate_wrapper``.
    """
    data = np.stack([np.asarray(sample[0]) for sample in batch]) \
        .astype(np.float32)
    B, L, C, H, W = data.shape
    data = data.reshape(B, L * C, H, W)

    sample_idx = np.hstack([np.full_like(sample[1], i, dtype=np.int_)
                            for i, sample in enumerate(batch)])
    timestamps = np.hstack([sample[1] for sample in batch])
    images = np.vstack([x[2] for x in batch])
    images = np.expand_dims(images, axis=1)
    add_info = None
    if len(batch) > 0 and len(batch[0]) > 3:
        augmentation_params = [x[3] for x in batch]
        add_info = to_array({
            'idx': np.array([x[0] for x in augmentation_params]),
            'sequence_length': np.array([x[1]
                                         for x in augmentation_params]),
            'collapse_length': np.array([x[2] for x in augmentation_params]),
            'box': np.vstack([x[3].reshape(1, -1)
                              for x in augmentation_params]),
            'angle': np.array([x[4] for x in augmentation_params]),
            'is_flip': np.array([x[5] for x in augmentation_params]),
        })
    return {'data': data,
            'timestamps': timestamps.astype(np.float32),
            'sample_idx': sample_idx.astype(np.int64),
            'images': images.astype(np.float32),
            'augmentation_params': add_info,
            'size': len(batch)}
