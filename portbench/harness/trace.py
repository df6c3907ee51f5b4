"""The traced windows' profile, digested: device busy time as the union of
the device ops' intervals, each op's time, the host's launches, and the
idle gaps labelled by the benchmark's host span that covered them."""
import torch

# CUDA runtime calls that put work on the card
LAUNCHES = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaGraphLaunch',
            'cudaMemcpyAsync', 'cudaMemsetAsync', 'cudaLaunchKernelExC')
SPAN_PREFIX = 'portbench.'
# the loop's timer regions as the breakdown names them
SPAN_LABELS = {'batch_construction': 'stage', 'logging': 'flush_wait',
               'train_step': 'replay'}


def profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def _union(spans):
    """``(busy us, [(gap start, gap end)])`` of sorted intervals."""
    busy, end, gaps = 0.0, None, []
    for lo, hi in sorted(spans):
        if end is not None and lo > end:
            gaps.append((end, lo))
        if end is None or hi > end:
            busy += hi - (lo if end is None else max(lo, end))
            end = hi
    return busy, gaps


class Digest:
    """What the metric readers take from the profile of ``steps`` steps
    over ``window_s`` seconds of host clock."""

    def __init__(self, events, steps, window_s):
        self.steps = steps
        self.window_s = window_s
        device, spans, self.host_launches = [], [], 0
        on_device = torch.autograd.DeviceType.CUDA
        for e in events:
            if e.name.startswith(SPAN_PREFIX):
                # a range's device-side copy spans its kernels: no op
                if e.device_type != on_device:
                    spans.append((e.time_range.start, e.time_range.end,
                                  e.name[len(SPAN_PREFIX):]))
            elif e.device_type == on_device:
                device.append(e)
            elif e.name.startswith(LAUNCHES):
                self.host_launches += 1
        busy_us, gaps = _union((e.time_range.start, e.time_range.end)
                               for e in device)
        self.busy_s = busy_us / 1e6
        self.op_s = {}
        for e in device:
            self.op_s[e.name] = self.op_s.get(e.name, 0.0) \
                + (e.time_range.end - e.time_range.start) / 1e6
        self.gaps = sorted(((hi - lo) / 1e6, self._label(spans, lo, hi))
                           for lo, hi in gaps)[::-1]

    @staticmethod
    def _label(spans, lo, hi):
        mid = (lo + hi) / 2
        for start, end, name in spans:
            if start <= mid <= end:
                return SPAN_LABELS.get(name, name)
        return 'other'

    def seconds(self, patterns):
        """Device seconds of the ops whose names hold any of
        ``patterns``."""
        return sum(s for name, s in self.op_s.items()
                   if any(p in name for p in patterns))

    def breakdown(self, top=10):
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[name, s] for name, s in ops],
                'idle_gaps': [[label, s] for s, label in self.gaps[:top]]}
