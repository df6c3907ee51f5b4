"""Raw per-element dataset and sample assembly (host-side NumPy).

Reads the per-element HDF5 schema produced by ``scripts/sequence2samples.py``
(one file per inter-frame window: ``events float64[N,4]``, ``image1``,
``image2``, scalar ``start``/``stop``) and assembles samples of
``seq_length`` consecutive flow windows, each window merging ``k``
consecutive elements (collapse augmentation), with flip/rotation/crop
augmentation and fp32 timestamp alignment.

Behavioural parity target: reference utils/dataset.py:600-796 (DatasetImpl),
551-597 (IterableDataset/Dataset).  The implementation is independent —
window-dataclass assembly, vectorised contiguity checks, column-table event
handling — but keeps the reference's injectable augmentation parameters
(idx, k, is_flip, angle, box, seq_length) through ``__getitem__`` so
augmentation stays samplable in production and deterministic in tests.

The port's copy of ``dvs_of_training_framework_tpu/data/dataset.py``.  It
reads every file through ``store.open_file`` (an npy store, or an HDF5
file read with h5py imported inside), so the module imports without h5py.
"""
import random
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import store
from .augmentation import (EventCrop, ImageCentralCrop, ImageRandomCrop,
                           PlanarRotation)


def read_info(filename):
    """Read ``{sequence_name: start_time}`` from an info HDF5 file."""
    with store.open_file(filename, 'r') as f:
        names = f['set_name'][()]
        starts = f['start_time'][()]
    return {name.decode(): float(t) for name, t in zip(names, starts)}


@dataclass
class _Window:
    """One flow-prediction window: merged events + bracketing frames."""
    events: np.ndarray       # float64 [N, 4] rows (x, y, t, p)
    start: float
    stop: float
    first_frame: np.ndarray  # [C, H, W]
    last_frame: np.ndarray   # [C, H, W]


def _as_chw(frame):
    """Promote a frame to channel-first layout ([H,W] -> [1,H,W])."""
    if frame.ndim == 2:
        return frame[None]
    assert frame.ndim == 3, f'unexpected frame rank {frame.ndim}'
    return np.moveaxis(frame, -1, 0)


def _load_window(paths):
    """Merge consecutive per-element files into a single flow window.

    The window spans from the first element's ``start`` to the last
    element's ``stop``; intermediate frames are discarded (collapse-k
    semantics).  Raises if the elements are not temporally contiguous.
    """
    chunks, spans, frames = [], [], []
    for path in paths:
        with store.open_file(path, 'r') as f:
            chunks.append(f['events'][()])
            spans.append((float(f['start'][()]), float(f['stop'][()])))
            frames.append((np.asarray(f['image1']), np.asarray(f['image2'])))
    starts = np.array([s for s, _ in spans])
    stops = np.array([s for _, s in spans])
    assert (stops[:-1] == starts[1:]).all(), \
        f'elements {paths[0]}..{paths[-1]} are not temporally contiguous'
    return _Window(events=np.concatenate(chunks, axis=0),
                   start=float(starts[0]), stop=float(stops[-1]),
                   first_frame=_as_chw(frames[0][0]),
                   last_frame=_as_chw(frames[-1][1]))


def _event_columns(table):
    """Split an ``[N, 5]`` float event table into the raw-events dict."""
    return {'x': table[:, 0].astype(np.int64),
            'y': table[:, 1].astype(np.int64),
            'timestamp': table[:, 2],
            'polarity': table[:, 3].astype(np.int64),
            'element_index': table[:, 4].astype(np.int64)}


class DatasetImpl:
    """Assembles training samples from per-element HDF5 files.

    Args:
        path: directory of ``<i:06d>.hdf5`` element files.
        shape: output image (H, W) after cropping.
        augmentation: enable random flip/rotation/random-crop/collapse.
        collapse_length: max elements merged per flow window.
        min_seq_length / max_seq_length: flow windows per sample.
        is_static_seq_length: fixed vs per-sample-random sequence length.
        is_raw: emit raw event columns (vs dense event images).
        is_align: shift timestamps so each sample starts at 0 (MVSEC epoch
            stamps do not survive the later float32 cast otherwise).
        angle: max |rotation| in degrees.
        event_image_fn: events -> dense converter, required when not
            ``is_raw``.
    """

    def __init__(self, path, shape, augmentation=False, collapse_length=6,
                 min_seq_length=1, max_seq_length=1,
                 is_static_seq_length=True, is_raw=True, is_align=True,
                 angle=30, event_image_fn=None):
        root = Path(path)
        self.path = root
        self.files = sorted(root.glob('*.hdf5'), key=lambda p: int(p.stem))
        if not self.files:
            raise FileNotFoundError(f'no per-element hdf5 files in {root}')
        if not (1 <= min_seq_length <= max_seq_length):
            raise ValueError('need 1 <= min_seq_length <= max_seq_length')
        if is_static_seq_length and min_seq_length != max_seq_length:
            raise ValueError('static sequence length requires '
                             'min_seq_length == max_seq_length')
        self.shape = shape
        self.augmentation = augmentation
        self.collapse_length = collapse_length
        self.min_seq_length = min_seq_length
        self.max_seq_length = max_seq_length
        self.is_static_seq_length = is_static_seq_length
        self.is_raw = is_raw
        self.is_align = is_align
        self.angle = angle
        self.event_image_fn = event_image_fn

        self._crop_events = EventCrop(box=None)
        policy = ImageRandomCrop if augmentation else ImageCentralCrop
        self._crop_frames = policy(shape=shape, return_box=True,
                                   channel_first=True)
        self._rotation = None  # built lazily once the frame shape is known

    def __len__(self):
        if self.is_static_seq_length:
            return len(self.files) - self.max_seq_length + 1
        return len(self.files)

    # -- random augmentation draws (overridable per call in __getitem__) ----

    def _draw_seq_length(self, idx):
        if not self.augmentation:
            return self.min_seq_length
        if self.is_static_seq_length:
            return self.max_seq_length
        bound = min(len(self.files) - idx, self.max_seq_length)
        return int(np.random.randint(bound)) + 1

    def _draw_collapse(self, idx, seq_length):
        if not self.augmentation:
            return 1
        bound = min(self.collapse_length,
                    (len(self.files) - idx) // seq_length)
        return int(np.random.randint(bound)) + 1

    # -----------------------------------------------------------------------

    def _assemble(self, idx, seq_length, k):
        """Read ``seq_length`` windows of ``k`` elements starting at ``idx``.

        Returns the merged ``[N, 5]`` event table (x, y, t, p, element),
        the ``seq_length + 1`` frame timestamps, and the ``[C, H, W]``
        frame stack (first frame + one closing frame per window).
        """
        windows = [_load_window(self.files[idx + i * k:idx + (i + 1) * k])
                   for i in range(seq_length)]
        counts = [len(w.events) for w in windows]
        element = np.repeat(np.arange(seq_length, dtype=np.float64), counts)
        table = np.column_stack([np.concatenate([w.events for w in windows]),
                                 element])
        image_ts = np.array([windows[0].start]
                            + [w.stop for w in windows])
        images = np.concatenate([windows[0].first_frame]
                                + [w.last_frame for w in windows], axis=0)
        return table, image_ts, images

    def __getitem__(self, idx, k=None, is_flip=None, angle=None, box=None,
                    seq_length=None):
        """Return ``(events, image_ts, images, augmentation_params)``.

        Keyword overrides pin every random augmentation choice, keeping the
        production API samplable but tests deterministic (the technique the
        reference test-suite relies on).
        """
        if seq_length is None:
            seq_length = self._draw_seq_length(idx)
        if k is None:
            k = self._draw_collapse(idx, seq_length)
        assert idx + k * seq_length <= len(self.files), \
            f'sample [{idx}, {idx + k * seq_length}) overruns the dataset'

        table, image_ts, images = self._assemble(idx, seq_length, k)

        # Align timestamps to 0 before the float32 cast: MVSEC epoch
        # timestamps do not survive fp32 rounding.
        if self.is_align:
            table[:, 2] -= image_ts[0]
            image_ts = image_ts - image_ts[0]
        table = table.astype(np.float32)
        if table.shape[0]:
            # the float32 cast can round an event sitting within one ulp
            # of a frame time PAST it; pin the cast times into the frame
            # interval as the downstream f32 pipeline will see it
            np.clip(table[:, 2],
                    np.float32(image_ts[0]), np.float32(image_ts[-1]),
                    out=table[:, 2])

        if self.augmentation:
            if is_flip is None:
                is_flip = bool(np.random.rand() < 0.5)
            if is_flip:
                images = images[..., ::-1]
                table[:, 0] = images.shape[-1] - 1 - table[:, 0]
            if self._rotation is None:
                self._rotation = PlanarRotation(self.angle,
                                                images.shape[-2:])
            images, table, angle = self._rotation(images, table, angle=angle)
        else:
            is_flip, angle = False, 0

        images, box = self._crop_frames(images, box=box)
        table = self._crop_events(table, box=box)
        images = images.astype(np.float32)

        if table.shape[0]:
            t = table[:, 2]
            # bounds in float32: that is what the cast event times (clipped
            # above) are guaranteed against; comparing against the float64
            # originals spuriously fails on boundary-ulp events
            assert t.min() >= np.float32(image_ts[0]) \
                and t.max() <= np.float32(image_ts[-1]), \
                'event timestamps escape the frame interval'

        if self.is_raw:
            payload = _event_columns(table)
        else:
            if self.event_image_fn is None:
                raise ValueError('event_image_fn is required when '
                                 'is_raw=False (--ev_images)')
            payload = self.event_image_fn(table, image_ts[:-1], image_ts[1:],
                                          self.shape)

        params = (idx, seq_length, k, np.asarray(box, dtype=int), angle,
                  np.array([is_flip], dtype=bool))
        return payload, image_ts, images, params


class Dataset:
    """Finite map-style dataset."""

    def __init__(self, **kwargs):
        self._dataset = DatasetImpl(**kwargs)

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx):
        return self._dataset[idx]


class IterableDataset:
    """Infinite reshuffled iterator over a DatasetImpl."""

    def __init__(self, **kwargs):
        self._shuffle = kwargs.pop('shuffle', False)
        self._dataset = DatasetImpl(**kwargs)

    @property
    def impl(self):
        return self._dataset

    def index_stream(self):
        """Infinite stream of (re)shuffled dataset indices."""
        order = list(range(len(self._dataset)))
        while True:
            if self._shuffle:
                random.shuffle(order)
            yield from order

    def __iter__(self):
        return (self._dataset[i] for i in self.index_stream())
