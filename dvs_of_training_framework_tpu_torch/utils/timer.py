"""Named region timers that record spans: the port's tracer.

The port's copy of ``dvs_of_training_framework_tpu/utils/timer.py`` (the
reference's Megatron-style timers, reference utils/timer.py): the same
``timers(name).start()/.stop()``, context manager, ``elapsed()`` and
``log()`` line, but no region synchronises the device.  A region is the
host's time between its edges, so timing the loop does not serialise it.

Every region also records a ``Span`` (its name and its edges in
``time.perf_counter_ns()``); the number of a name's spans is that
layer's count: the ``fetch`` spans are the loop's blocking fetches.  On
a card, the regions of ``DEVICE_REGIONS`` also record a pair of CUDA
events on the device's current stream, taken from a reused pool; a pair
becomes a ``DeviceSpan`` (its ms, ``elapsed_time``) only once both
events completed (``query()``), so nothing waits for it.  ``log()``
prints the regions' host ms, the device ms and the count of each name's
spans, and drains them; past ``max_spans`` the oldest go, counted in the
line as dropped.  Given the batch size, a line that follows batches
padded (``pad`` spans) also prints samples/s: their number times the
batch size, over the host time since the last such line.  The loop pads
a window's batches (a batch's, without the device queue) before it runs
them, so over a run this is the loop's rate.

``get_rank`` and ``print_rank_0`` read ``torch.distributed``; the device
memory comes from ``torch.cuda.memory_stats`` and ``mem_get_info``, the
host's from ``/proc/meminfo`` (the card's machine has no psutil).
``FakeTimer`` is the no-op twin that keeps the hot loop branch-free when
``--timers`` is off.
"""
import collections
import time

import torch

# regions whose device work is timed with CUDA events on a card
DEVICE_REGIONS = ('upload', 'train_step', 'all_reduce')
MAX_SPANS = 2 ** 16

Span = collections.namedtuple('Span', 'name start end')
DeviceSpan = collections.namedtuple('DeviceSpan', 'name ms')


def get_rank() -> int:
    """Rank in a ``torch.distributed`` run (0 for a single process)."""
    if torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def print_rank_0(message):
    if get_rank() == 0:
        print(message)


def host_memory_percent():
    """``(memory used %, swap used %)`` of the host, from /proc/meminfo,
    as psutil's ``virtual_memory().percent`` and ``swap_memory().percent``
    compute them (used = total - available)."""
    info = {}
    with open('/proc/meminfo') as f:
        for line in f:
            key, value = line.split(':', 1)
            info[key] = int(value.split()[0])
    vm = 100.0 * (info['MemTotal'] - info['MemAvailable']) / info['MemTotal']
    swap_total = info.get('SwapTotal', 0)
    swap = (100.0 * (swap_total - info.get('SwapFree', 0)) / swap_total
            if swap_total else 0.0)
    return round(vm, 1), round(swap, 1)


class _Region:
    """One named region of ``Timers``; supports use as a context manager."""

    __slots__ = ('name', 'tracer', '_elapsed', '_since', '_mark', 'event')

    def __init__(self, name, tracer):
        self.name = name
        self.tracer = tracer
        self._elapsed = 0       # ns
        self._since = None      # the open span's start
        self._mark = 0          # where the running time counts from
        self.event = None       # the open device region's start event

    def start(self):
        assert self._since is None, f'timer {self.name} already started'
        self._since = self._mark = time.perf_counter_ns()
        self.event = self.tracer._begin(self.name)

    def stop(self):
        assert self._since is not None, f'timer {self.name} not started'
        end = time.perf_counter_ns()
        self._elapsed += end - self._mark
        self.tracer._close(self, end)
        self._since = self.event = None

    def reset(self):
        self._elapsed = 0
        self._mark = time.perf_counter_ns()

    def elapsed(self, reset=True):
        """Seconds inside the region since the last reset, a running
        region read live."""
        now = time.perf_counter_ns()
        value = self._elapsed
        if self._since is not None:
            value += now - self._mark
        if reset:
            self._elapsed, self._mark = 0, now
        return value / 1e9

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class _NullRegion:
    __slots__ = ()

    def start(self):
        pass

    def stop(self):
        pass

    def reset(self):
        pass

    def elapsed(self, reset=True):
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NULL_REGION = _NullRegion()


class FakeTimer:
    """No-op registry: zero overhead when timing is disabled."""

    def __call__(self, name):
        return _NULL_REGION

    @staticmethod
    def memory_usage():
        return ''

    def log(self, names, normalizer=1.0, reset=True,
            memory_breakdown=False):
        pass


class Timers:
    """Named regions on the host's clock, their ``spans`` and, on a card
    (``device``), the ``device_spans`` of ``DEVICE_REGIONS``; each kept up
    to ``max_spans``.  ``batch_size``: the samples a ``pad`` span stands
    for (a forward-backward pass's batch, of which a rank pads its piece
    on a mesh), None for no samples/s."""

    max_spans = MAX_SPANS

    def __init__(self, device=None, batch_size=None):
        self.device = None if device is None else torch.device(device)
        self.on_card = self.device is not None and self.device.type == 'cuda'
        self.batch_size = batch_size
        self.timers = {}
        self.spans = collections.deque()
        self.device_spans = collections.deque()
        self.dropped = 0
        self._pending = []       # (name, start event, end event)
        self._free = []          # completed events, recorded again
        self._padded_at = None   # perf_counter_ns() of the last line
        # that followed padded batches

    def __call__(self, name):
        region = self.timers.get(name)
        if region is None:
            region = self.timers[name] = _Region(name, self)
        return region

    def _keep(self, queue, item):
        if len(queue) >= self.max_spans:
            queue.popleft()
            self.dropped += 1
        queue.append(item)

    def _record(self):
        event = self._free.pop() if self._free \
            else torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _begin(self, name):
        """A device region's start event on a card, else None."""
        if not self.on_card or name not in DEVICE_REGIONS:
            return None
        self.resolve()
        return self._record()

    def _close(self, region, end):
        if region.event is not None:
            self._pending.append((region.name, region.event,
                                  self._record()))
        self._keep(self.spans, Span(region.name, region._since, end))

    def resolve(self):
        """Move every device region whose events have completed into
        ``device_spans``; waits for none."""
        waiting = []
        for name, begin, end in self._pending:
            if begin.query() and end.query():
                self._keep(self.device_spans,
                           DeviceSpan(name, begin.elapsed_time(end)))
                self._free += (begin, end)
            else:
                waiting.append((name, begin, end))
        self._pending = waiting

    def memory_usage(self):
        """This process's device memory: allocated now and at its peak,
        and the card's total, in GB; empty on the CPU."""
        if not self.on_card:
            return ''
        stats = torch.cuda.memory_stats(self.device)
        _, total = torch.cuda.mem_get_info(self.device)
        fields = [('hbm_in_use', stats.get('allocated_bytes.all.current', 0)),
                  ('hbm_peak', stats.get('allocated_bytes.all.peak', 0)),
                  ('hbm_limit', total)]
        return ''.join(f' | {k}: {v / 2 ** 30:.4f} GB' for k, v in fields)

    def log(self, names, normalizer=1.0, reset=True,
            memory_breakdown=False):
        """Print ``names``' ms; then, since the last line, the device ms
        of each device region, the count of each region's spans (which
        are drained) and of the spans dropped; and samples/s."""
        assert normalizer > 0.0
        now = time.perf_counter_ns()
        parts = [f'rank={get_rank()} time (ms)']
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) \
                    * 1000.0 / normalizer
                parts.append(f'{name}: {ms:.2f}')
        self.resolve()
        device_ms = collections.Counter()
        for span in self.device_spans:
            device_ms[span.name] += span.ms / normalizer
        if device_ms:
            parts.append('device ms ' + ' '.join(
                f'{k}={v:.2f}' for k, v in device_ms.items()))
        counts = collections.Counter(span.name for span in self.spans)
        if counts:
            parts.append('spans ' + ' '.join(f'{k}={n}'
                                             for k, n in counts.items()))
        if self.dropped:
            parts.append(f'dropped {self.dropped}')
        if self.batch_size is not None and counts['pad']:
            if self._padded_at is not None:
                rate = counts['pad'] * self.batch_size * 1e9 \
                    / (now - self._padded_at)
                parts.append(f'SamplesPerSec={rate:.2f}')
            self._padded_at = now
        self.spans.clear()
        self.device_spans.clear()
        self.dropped = 0
        if memory_breakdown:
            parts.append(self.memory_usage())
        print_rank_0(' | '.join(parts))
