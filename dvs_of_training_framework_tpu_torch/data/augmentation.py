"""Host-side event/image augmentation primitives (NumPy).

Behavioural parity targets in the reference: utils/data.py (EventCrop 24-42,
image crops 45-117, rotation 155-220, get_count_image 120-136,
frame_generator 139-152, central_shift 14-21).  Semantics are pinned by
tests/dataset/test_dataset.py in both repos; the implementations here are
independent (complex-arithmetic rotation table, bincount counting).
Rotation uses the native C++ ``event_map`` kernel (see ``..native``).

The port's copy of ``dvs_of_training_framework_tpu/data/augmentation.py``.
"""
import math

import numpy as np

from ..native import event_map


def central_shift(in_shape, out_shape):
    """Top-left corner of the centered ``out_shape`` box inside ``in_shape``."""
    return tuple((x - y) // 2 for x, y in zip(in_shape, out_shape))


class EventCrop:
    """Keep only events inside box ``[y0, x0, h, w]`` and shift coordinates."""

    def __init__(self, box):
        self.box = box

    def __call__(self, events, box=None):
        if box is None:
            box = self.box
        x = events[:, 0]
        y = events[:, 1]
        mask = ((x >= box[1]) & (x < box[1] + box[3])
                & (y >= box[0]) & (y < box[0] + box[2]))
        events = events[mask]
        events[:, [1, 0]] -= np.array(box[:2]).reshape(1, -1)
        return events


def crop_images(img, box, channel_first):
    """Crop ``img`` to box ``[y0, x0, h, w]``.

    Handles channel-last IO by moving the channel axis next to the spatial
    axes for the slice and back afterwards; 2-D images are treated as
    channel-first.
    """
    moved = img.ndim > 2 and not channel_first
    if moved:
        # (..., H, W, C) -> (..., C, H, W)
        img = np.rollaxis(img, img.ndim - 1, img.ndim - 3)
    y0, x0, h, w = box[0], box[1], box[2], box[3]
    res = img[..., y0:y0 + h, x0:x0 + w]
    if moved:
        res = np.rollaxis(res, img.ndim - 3, img.ndim)
    return res


class _CropPolicy:
    """Callable crop with a box-choice policy (subclasses pick the box)."""

    def __init__(self, return_box=False, channel_first=False):
        self.return_box = return_box
        self.channel_first = channel_first

    def _choose_box(self, img):
        raise NotImplementedError

    def __call__(self, img, box=None):
        channel_first = self.channel_first or img.ndim == 2
        if box is None:
            # choose on the channel-first view so shape[-2:] is spatial
            view = img if channel_first else \
                np.rollaxis(img, img.ndim - 1, img.ndim - 3)
            box = self._choose_box(view)
        res = crop_images(img, box, channel_first)
        return (res, box) if self.return_box else res


class ImageCrop(_CropPolicy):
    """Crop with a fixed box."""

    def __init__(self, box, return_box=False, channel_first=False):
        super().__init__(return_box, channel_first)
        self.box = box

    def _choose_box(self, _):
        return self.box


class ImageCentralCrop(_CropPolicy):
    """Crop the centered ``shape`` region."""

    def __init__(self, shape, return_box=False, channel_first=False):
        super().__init__(return_box, channel_first)
        self.shape = shape

    def _choose_box(self, img):
        return list(central_shift(img.shape[-2:], self.shape)) \
            + list(self.shape)


class ImageRandomCrop(_CropPolicy):
    """Crop a uniformly random ``shape`` region."""

    def __init__(self, shape, return_box=False, channel_first=False):
        super().__init__(return_box, channel_first)
        self.shape = shape

    def _choose_box(self, img):
        slack = [x - y for x, y in zip(img.shape[-2:], self.shape)]
        start = [np.random.randint(s) if s else 0 for s in slack]
        return start + list(self.shape)


def get_count_image(events, imsize):
    """Per-pixel event counts.

    Args:
        events: sequence ``[x, y, t, p]`` of equal-length arrays.
        imsize: ``(height, width)``.
    """
    h, w = imsize
    x = np.asarray(events[0], dtype=np.int64)
    y = np.asarray(events[1], dtype=np.int64)
    counts = np.bincount(y * w + x, minlength=h * w)
    return counts.astype(np.uint64).reshape(h, w)


def frame_generator(events, frames):
    """Yield ``(events_in_window, start, stop)`` per timestamp pair.

    A window ``(start, stop]`` contains the events with
    ``start < timestamp <= stop`` (searchsorted side='right' on both ends).
    """
    t = np.asarray(events[2])
    for start, stop in frames:
        lo, hi = np.searchsorted(t, [start, stop], side='right')
        yield [column[lo:hi] for column in events], float(start), float(stop)


class PlanarRotation:
    """Exact joint rotation of an image stack and its event stream.

    The rotation is realised as a pixel-index permutation: for every
    destination pixel, the nearest source pixel under the inverse rotation
    about the image centre is looked up, and the same source->destination
    table drives both the image gather and the per-event remap (through the
    native C++ kernel), so events and the pixels under them co-rotate
    bit-exactly — the property tests/dataset/test_dataset.py pins with the
    analytic 90-degree case.

    Callable as ``rotation(images, events, angle=None)`` with ``images``
    shaped ``[C, H, W]`` and event rows ``(x, y, t, p, ...)``; returns
    ``(rotated_images, surviving_events, angle_degrees)``.
    """

    def __init__(self, degrees, shape):
        if np.isscalar(degrees):
            degrees = (-abs(degrees), abs(degrees))
        lo, hi = degrees
        assert lo <= hi, f'empty angle interval [{lo}, {hi}]'
        self.angle_range = (lo, hi)
        self.shape = tuple(shape)
        h, w = self.shape
        # Destination pixels as complex offsets from the image centre,
        # raveled row-major so position == flat pixel index.
        u = np.arange(w, dtype=np.float64) - w / 2
        v = np.arange(h, dtype=np.float64) - h / 2
        self._centered = (u[None, :] + 1j * v[:, None]).ravel()

    def draw_angle(self):
        lo, hi = self.angle_range
        return lo + np.random.rand() * (hi - lo)

    def _permutation(self, angle):
        """(src, dst) flat-pixel pairs for a rotation by ``angle`` degrees."""
        h, w = self.shape
        # Multiplying the centred destination coordinate by e^{i*angle}
        # yields the source coordinate (x*cos - y*sin, x*sin + y*cos).
        source = self._centered * np.exp(1j * math.radians(angle))
        sx = np.rint(source.real + w / 2).astype(np.int64)
        sy = np.rint(source.imag + h / 2).astype(np.int64)
        inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        dst = np.flatnonzero(inside)
        src = sy[inside] * w + sx[inside]
        return src, dst

    def __call__(self, images, events, angle=None):
        if angle is None:
            angle = self.draw_angle()
        src, dst = self._permutation(angle)

        flat = images.reshape(images.shape[0], -1)
        rotated = np.zeros_like(flat)
        rotated[:, dst] = flat[:, src]

        remapped = event_map(events.astype(np.float32).copy(), self.shape,
                             src.astype(np.uint64), dst.astype(np.uint64))
        return rotated.reshape(images.shape), remapped, angle
