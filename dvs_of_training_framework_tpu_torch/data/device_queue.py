"""Device queue: windows of K batches staged in one buffer and one upload.

Counterpart of ``dvs_of_training_framework_tpu/data/device_queue.py``
(``stack_batches``, ``prefetch_windows``), on the padded float32 wire
only.  A window is K padded batches stacked on a new leading axis, every
array a view of one flat host buffer (``Window``): pinned for a card, so
that one ``non_blocking`` copy moves the whole window.  The training step
takes batch ``micro_step % K`` of it (``training/state.py``), or runs all
K steps as one replay of a captured CUDA graph, which copies the window
into its own static buffer first.  So the host touches the card once a
window for its input, and on the fused path once a window for its work.

There is no background thread, as in ``data/prefetch.py``: a second
Python thread contends for the GIL with the step's many small torch
calls.  A graph replay returns at once, so the window that the caller
asks for next is read, padded, stacked and uploaded while the card runs
the current one, if the caller asks before it waits on the card.  The
training loop (``training/train.py`` ``train``) does, in this order:
enqueue window i's work, stage window i+1 (this generator's next item),
flush the metrics (which waits for window i and the upload of i+1),
run the hooks.  ``depth`` is the number of staged windows the
generator holds when it hands one out: it reads and stages windows until
``depth`` are staged, then yields the oldest (at least 1).  ``train``
holds the next window itself and asks for ``depth=1``, so at most two
windows are on the device at once; ``validate_windowed``, which asks for
each window only after enqueueing the last, keeps the default 2.  Given the
loop's ``timers`` (``utils/timer.py``), a window's stacking is a
``stack`` region and its copy to the device an ``upload`` region.
"""
import collections
import dataclasses

import numpy as np
import torch

from ..utils.timer import FakeTimer
from .prefetch import alone, prepare_agreed
from .schema import Batch, EventBuffer

_ALIGN = 256     # bytes: every array of a window starts at a multiple
_EVENT_FIELDS = tuple(f.name for f in dataclasses.fields(EventBuffer)
                      if f.name != 'num_events')


def _arrays(batch: Batch):
    """``(name, array)`` of every array of ``batch``, in a fixed order."""
    out = []
    if batch.events is not None:
        out += [(f'events.{f}', getattr(batch.events, f))
                for f in _EVENT_FIELDS]
    if batch.data is not None:
        out.append(('data', batch.data))
    return out + [(name, getattr(batch, name))
                  for name in ('timestamps', 'sample_idx', 'images')]


@dataclasses.dataclass(frozen=True)
class Window:
    """K batches stacked on a leading axis, in one flat byte buffer.

    Attributes:
        storage: uint8 ``[bytes]`` tensor that holds every array.
        layout: ``(name, torch dtype, shape, byte offset)`` of each
            array, each shape with its leading K.
        size: the batches' static sample count.
        num_events: each batch's valid event count (raw), or None.
    """
    storage: torch.Tensor
    layout: tuple
    size: int
    num_events: tuple = None

    @property
    def window(self) -> int:
        return self.layout[0][2][0]

    @property
    def batch(self) -> Batch:
        """The stacked Batch: views of ``storage``."""
        views = {}
        for name, dtype, shape, offset in self.layout:
            nbytes = int(np.prod(shape)) * dtype.itemsize
            views[name] = self.storage[offset:offset + nbytes] \
                .view(dtype).view(shape)
        events = None
        if self.num_events is not None:
            events = EventBuffer(num_events=self.num_events, **{
                f: views[f'events.{f}'] for f in _EVENT_FIELDS})
        return Batch(events=events, data=views.get('data'),
                     timestamps=views['timestamps'],
                     sample_idx=views['sample_idx'], images=views['images'],
                     size=self.size)

    def to(self, device, non_blocking: bool = True) -> 'Window':
        """The window on ``device``: one copy of ``storage``."""
        return dataclasses.replace(
            self, storage=self.storage.to(device, non_blocking=non_blocking))

    def empty_like(self) -> 'Window':
        """A window of the same layout on the same device, uninitialised."""
        return dataclasses.replace(self,
                                   storage=torch.empty_like(self.storage))

    def copy_(self, other: 'Window') -> 'Window':
        """Copy ``other``'s arrays in, one copy; the layouts must agree."""
        if (other.layout, other.size) != (self.layout, self.size):
            raise ValueError('a window of another layout: '
                             f'{other.layout} against {self.layout}')
        self.storage.copy_(other.storage, non_blocking=True)
        return self


def stack_batches(batches, pin: bool = False) -> Window:
    """Stack K padded host Batches into one Window on the host (in
    page-locked memory with ``pin``).  The batches must share one static
    ``size`` and their arrays one shape each."""
    assert len({b.size for b in batches}) == 1, \
        'window batches must share a static batch size'
    columns = [[np.asarray(a) for _, a in _arrays(b)] for b in batches]
    K, layout, offset = len(batches), [], 0
    for (name, _), first in zip(_arrays(batches[0]), columns[0]):
        layout.append((name, torch.from_numpy(first[:0]).dtype,
                       (K,) + first.shape, offset))
        offset += -(-K * first.nbytes // _ALIGN) * _ALIGN
    storage = torch.empty(offset, dtype=torch.uint8, pin_memory=pin)
    host = storage.numpy()
    for i, (_, dtype, shape, start) in enumerate(layout):
        nbytes = int(np.prod(shape)) * dtype.itemsize
        out = host[start:start + nbytes].view(columns[0][i].dtype) \
            .reshape(shape)
        np.stack([column[i] for column in columns], out=out)
    num_events = None
    if batches[0].events is not None:
        num_events = tuple(int(b.events.num_events) for b in batches)
    return Window(storage, tuple(layout), int(batches[0].size), num_events)


def prefetch_windows(batch_iter, prepare_fn, window: int, depth: int = 2,
                     device=None, agree=None, timers=None):
    """Yield ``(host_batches, device_window, n_valid, skipped)`` tuples.

    Args:
        batch_iter: iterator of host-collated batch dicts.
        prepare_fn: ``host_batch -> padded host Batch``; an
            ``OverflowError`` drops the batch, which the next yielded
            window reports in ``skipped``.
        window: K, batches staged per upload.
        depth: staged windows held when one is handed out (at least 1).
        device: where the windows go (the CPU by default); a card's are
            stacked in pinned memory and copied without blocking.
        agree: on a mesh, ``data.prefetch.prepare_agreed``'s ``agree``:
            the batches of a window are read and prepared, then each
            slot's overflow is combined over the ranks in one all-reduce
            before the window is staged, and a batch that overflowed on
            any rank is dropped on every rank (a further round, as
            small, refills the dropped slots).
        timers: ``utils/timer.py``'s interface (``FakeTimer`` if None):
            ``prepare_agreed``'s ``read`` regions, a ``stack`` and an
            ``upload`` region a window.

    Each yielded tuple:
        host_batches: the K (or fewer, for the final window) collated
            host batches, in step order.
        device_window: the ``Window`` on ``device``; a partial final
            window is padded to K by repeating its last batch, and only
            its first ``n_valid`` batches are stepped.
        n_valid: the number of real batches.
        skipped: host batches dropped by ``OverflowError`` since the
            previous window.

    Abandoning the generator (break, exception, garbage collection)
    closes ``batch_iter``.
    """
    device = torch.device('cpu' if device is None else device)
    pin = device.type == 'cuda'
    timers = FakeTimer() if timers is None else timers
    batch_iter = iter(batch_iter)

    def staged():
        pending, skipped = [], []

        def flush():
            hosts, prepared = zip(*pending)
            n_valid = len(prepared)
            padded = list(prepared) + [prepared[-1]] * (window - n_valid)
            timers('stack').start()
            host_window = stack_batches(padded, pin=pin)
            timers('stack').stop()
            timers('upload').start()
            device_window = host_window.to(device)
            timers('upload').stop()
            item = (list(hosts), device_window, n_valid, list(skipped))
            pending.clear()
            skipped.clear()
            return item

        ended = False
        while not ended:
            # the window's free slots, read and prepared, then agreed
            items, ended = prepare_agreed(batch_iter, prepare_fn,
                                          window - len(pending),
                                          agree or alone, timers)
            for host_batch, prepared in items:
                if prepared is None:
                    skipped.append(host_batch)
                else:
                    pending.append((host_batch, prepared))
            if len(pending) == window:
                yield flush()
        if pending:
            yield flush()

    queue = collections.deque()
    try:
        for item in staged():
            queue.append(item)
            if len(queue) >= max(depth, 1):
                yield queue.popleft()
        while queue:
            yield queue.popleft()
    finally:
        close = getattr(batch_iter, 'close', None)
        if close is not None:
            close()
