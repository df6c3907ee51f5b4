"""Device utilisation monitor -> TensorBoard (Monitoring/*).

The port's copy of ``dvs_of_training_framework_tpu/utils/monitor.py``
(the reference GPU monitor, utils/monitors/gpumonitor.py:40-68): a daemon
thread samples when the run starts, every ``period`` seconds, and when
it ends (so a run shorter than the period leaves two samples).  It
writes the memory of this process's card (``torch.cuda.memory_stats``:
allocated now and at its peak; ``torch.cuda.mem_get_info``: the card's
occupancy, every process's allocations and caches) as
``Monitoring/GPU{i}/...``, and the host's memory and CPU use from
``/proc`` as ``Monitoring/host/...``.  One process drives one card, so a
run on several samples only the card of its rank 0, which alone runs the
monitor; on the CPU only the host is sampled.
"""
import threading
import traceback

import torch

from .tb import SummaryWriter
from .timer import host_memory_percent


def _cpu_ticks():
    """``(busy, total)`` jiffies of all CPUs since boot (/proc/stat)."""
    with open('/proc/stat') as f:
        values = [int(v) for v in f.readline().split()[1:]]
    idle = values[3] + (values[4] if len(values) > 4 else 0)   # + iowait
    total = sum(values)
    return total - idle, total


class DeviceMonitor:
    """Context manager: samples device/host stats every ``period`` seconds."""

    def __init__(self, logdir, period=30.0, device=None):
        self.logdir = logdir
        self.period = period
        self.device = device
        self._stop = threading.Event()
        self._thread = None
        self._writer = None
        self._ticks = None
        self._step = 0

    def _sample(self, step):
        device = None if self.device is None else torch.device(self.device)
        if device is not None and device.type == 'cuda':
            index = device.index if device.index is not None \
                else torch.cuda.current_device()
            stats = torch.cuda.memory_stats(device)
            free, total = torch.cuda.mem_get_info(device)
            tag = f'Monitoring/GPU{index}'
            self._writer.add_scalar(
                f'{tag}/memory used (GB)',
                stats.get('allocated_bytes.all.current', 0) / 2 ** 30, step)
            self._writer.add_scalar(
                f'{tag}/memory peak (GB)',
                stats.get('allocated_bytes.all.peak', 0) / 2 ** 30, step)
            self._writer.add_scalar(f'{tag}/memory utilisation (%)',
                                    (total - free) * 100.0 / total, step)
        vm, _ = host_memory_percent()
        self._writer.add_scalar('Monitoring/host/vm percent', vm, step)
        busy, total = _cpu_ticks()
        last_busy, last_total = self._ticks
        self._ticks = busy, total
        self._writer.add_scalar(
            'Monitoring/host/cpu percent',
            100.0 * (busy - last_busy) / max(total - last_total, 1), step)
        self._writer.flush()

    def _sample_logged(self):
        try:
            self._sample(self._step)
        except Exception:  # monitoring must never kill training
            traceback.print_exc()
        self._step += 1

    def _run(self):
        self._sample_logged()
        while not self._stop.wait(self.period):
            self._sample_logged()

    def __enter__(self):
        self._writer = SummaryWriter(self.logdir, filename_suffix='.monitor')
        self._ticks = _cpu_ticks()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._writer is not None:
            if not self._thread.is_alive():
                self._sample_logged()
            self._writer.close()
