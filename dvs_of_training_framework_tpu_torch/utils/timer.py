"""Named wall-clock region timers with device synchronisation.

The port's copy of ``dvs_of_training_framework_tpu/utils/timer.py`` (the
reference's Megatron-style timers, reference utils/timer.py).  A region's
edges call ``torch.cuda.synchronize(device)``, so a region holds the
device work enqueued inside it; on the CPU they synchronise nothing.
``get_rank`` and ``print_rank_0`` read ``torch.distributed``; the device
memory comes from ``torch.cuda.memory_stats`` and ``mem_get_info``, the
host's from ``/proc/meminfo`` (the card's machine has no psutil).

``FakeTimer`` is the no-op twin that keeps the hot loop branch-free when
``--timers`` is off.  ``ThroughputTimer`` reports samples/sec plus host
memory pressure.
"""
import time

import torch


def _sync_device(device):
    if device is not None and torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


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


class _RegionTimer:
    """One named region; supports use as a context manager."""

    __slots__ = ('name', 'device', '_elapsed', '_since')

    def __init__(self, name, device=None):
        self.name = name
        self.device = device
        self._elapsed = 0.0
        self._since = None

    def start(self):
        assert self._since is None, f'timer {self.name} already started'
        _sync_device(self.device)
        self._since = time.perf_counter()

    def stop(self):
        assert self._since is not None, f'timer {self.name} not started'
        _sync_device(self.device)
        self._elapsed += time.perf_counter() - self._since
        self._since = None

    def reset(self):
        self._elapsed = 0.0
        self._since = None

    def elapsed(self, reset=True):
        running = self._since is not None
        if running:
            self.stop()
        value = self._elapsed
        if reset:
            self.reset()
        if running:
            self.start()
        return value

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class _NullTimer:
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


class FakeTimer:
    """No-op registry: zero overhead when timing is disabled."""

    def __call__(self, name):
        return _NullTimer()

    @staticmethod
    def memory_usage():
        return ''

    def log(self, names, normalizer=1.0, reset=True,
            memory_breakdown=False):
        pass


class SynchronizedWallClockTimer:
    """Named-region timers whose edges synchronise ``device`` (nothing to
    synchronise on the CPU)."""

    def __init__(self, device=None):
        self.device = device
        self.timers = {}

    def __call__(self, name):
        timer = self.timers.get(name)
        if timer is None:
            timer = self.timers[name] = _RegionTimer(name, self.device)
        return timer

    def memory_usage(self):
        """This process's device memory: allocated now and at its peak,
        and the card's total, in GB; empty on the CPU."""
        if self.device is None or torch.device(self.device).type != 'cuda':
            return ''
        stats = torch.cuda.memory_stats(self.device)
        _, total = torch.cuda.mem_get_info(self.device)
        fields = [('hbm_in_use', stats.get('allocated_bytes.all.current', 0)),
                  ('hbm_peak', stats.get('allocated_bytes.all.peak', 0)),
                  ('hbm_limit', total)]
        return ''.join(f' | {k}: {v / 2 ** 30:.4f} GB' for k, v in fields)

    def log(self, names, normalizer=1.0, reset=True,
            memory_breakdown=False):
        assert normalizer > 0.0
        parts = [f'rank={get_rank()} time (ms)']
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) \
                    * 1000.0 / normalizer
                parts.append(f'{name}: {ms:.2f}')
        if memory_breakdown:
            parts.append(self.memory_usage())
        print_rank_0(' | '.join(parts))


class ThroughputTimer:
    """Samples/sec + host memory reporting for the training loop."""

    def __init__(self,
                 batch_size,
                 num_workers=1,
                 start_step=2,
                 steps_per_output=50,
                 monitor_memory=True,
                 logging_fn=None,
                 device=None):
        self.batch_size = batch_size or 1
        self.num_workers = num_workers
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.device = device
        if logging_fn is None:
            from .logging import logger
            logging_fn = logger.info
        self.logging = logging_fn

        self.started = False
        self.epoch_count = 0
        self.local_step_count = 0
        self.total_step_count = 0
        self.total_elapsed_time = 0.0
        self._t0 = 0.0

    def update_epoch_count(self):
        self.epoch_count += 1
        self.local_step_count = 0

    def start(self):
        self.started = True
        if self.total_step_count >= self.start_step:
            _sync_device(self.device)
            self._t0 = time.perf_counter()

    def stop(self, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.total_step_count += 1
        self.local_step_count += 1
        if self.total_step_count <= self.start_step:
            return
        _sync_device(self.device)
        self.total_elapsed_time += time.perf_counter() - self._t0
        if self.local_step_count % self.steps_per_output:
            return
        if report_speed:
            self.logging(f'{self.epoch_count}/{self.local_step_count}, '
                         f'SamplesPerSec={self.avg_samples_per_sec()}')
        if self.monitor_memory:
            vm, swap = host_memory_percent()
            self.logging(f'{self.epoch_count}/{self.local_step_count}, '
                         f'vm percent: {vm}, '
                         f'swap percent: {swap}')

    def avg_samples_per_sec(self):
        measured_steps = self.total_step_count - self.start_step
        if measured_steps > 0 and self.total_elapsed_time > 0:
            per_step = self.total_elapsed_time / measured_steps
            return self.batch_size * self.num_workers / per_step
        return float('-inf')
