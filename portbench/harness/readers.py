"""What a per-layer metric's reader (``metrics/<name>.py``) gets: the
timed window's host spans a window, the traced windows' digest, and the
work those windows' batches needed (model flop, each kernel's least
time).  The helpers below are the arithmetic the readers share."""
import sys
from pathlib import Path

import numpy as np

from . import flops, peaks, traffic

# each port kernel's device ops, by the names its CUDA source gives them
KERNELS = {'k1_fwd': ('voxelize_bucket_kernel', 'voxelize_tile_kernel'),
           'k1_bwd': ('voxelize_bwd_kernel',),
           'k2_fwd': ('kernel_mlp_fwd_kernel',),
           'k2_bwd': ('kernel_mlp_bwd_kernel', 'kernel_mlp_reduce_kernel'),
           'k3_fwd': ('warp_fwd_kernel',),
           'k3_bwd': ('warp_bwd_kernel',)}
PREDICTOR_PATTERNS = Path(__file__).resolve().parents[1] / 'metrics' \
    / 'predictor_kernels.txt'


def predictor_patterns():
    return [line.strip() for line in PREDICTOR_PATTERNS.read_text()
            .splitlines() if line.strip() and not line.startswith('#')]


class Records:
    """``windows``: ``{'period_s', 'stage_s', 'wait_s'}`` of each window
    of the timed window; ``trace``: the traced windows' ``Digest``;
    ``flop``: their model flop; ``least_s``: each kernel's least time
    over their steps (``KERNELS``' keys); ``peak_flops``: the peak of
    the configuration's compute type."""

    def __init__(self, cell, records, digest, periods):
        phases, recorder = records['phases'], records['recorder']
        flags = cell.config['flags']
        ends = [t for _, t in phases.ends if phases.t0 < t <= phases.t_end]
        self.windows, last = [], phases.t0
        for t, period in zip(ends, periods):
            self.windows.append({
                'period_s': period,
                'stage_s': recorder.seconds('batch_construction', last, t),
                'wait_s': recorder.seconds('logging', last, t)})
            last = t
        self.trace = digest
        self.peak_flops = peaks.PEAK_FLOPS[flags['--precision']]
        pool = records['pool']
        first, last_step = phases.trace_from[0], phases.trace_to[0]
        batches = [pool[s % len(pool)] for s in range(first, last_step)]
        self.flop, self.least_s = self._work(cell, records['program'],
                                             batches)

    @staticmethod
    def _work(cell, program, batches):
        flags, sizes = cell.config['flags'], cell.config['model']
        H, W = flags['--height'], flags['--width']
        C = flags['--event-representation-depth']
        L = flags['--max-sequence-length']
        B = flags['-mbs']
        hidden = sizes['kernel_mlp_hidden']
        capacity = program.args.event_capacity
        weight_bytes = 2 if flags['--precision'] == 'bfloat16' else 4
        conv = flops.conv_flops(cell.reference().build(cell.config,
                                                       lambda x: x),
                                B, C * L, (H, W))
        scales = [(H // 2 ** s, W // 2 ** s) for s in (3, 2, 1, 0)]
        total, least = 0.0, {k: 0.0 for k in KERNELS}
        for batch in batches:
            n = traffic.num_events(batch)
            ev = batch['events']
            plane = np.asarray(ev['sample_index']) * L \
                + np.asarray(ev['element_index'])
            cells = np.unique((plane * H + np.asarray(ev['y'])) * W
                              + np.asarray(ev['x'])).size
            total += flops.step_flops(conv, n * C, hidden)
            work = {f'k1_{d}': w for d, w in peaks.k1_work(
                capacity, n, cells, B * L, H, W, C, weight_bytes).items()}
            work.update({f'k2_{d}': w for d, w in
                         peaks.k2_work(n * C, hidden).items()})
            for h, w in scales:
                for d, kw in peaks.k3_work(B, h, w).items():
                    least[f'k3_{d}'] += peaks.bound(**kw)
            for key, kw in work.items():
                least[key] += peaks.bound(**kw)
        return total, least

    def report_unmatched(self):
        """Print the device ops that neither the predictor's patterns nor
        the port's kernels match, with their seconds, to stderr."""
        known = predictor_patterns() + [k for names in KERNELS.values()
                                        for k in names]
        other = sorted(((s, name) for name, s in self.trace.op_s.items()
                        if not any(p in name for p in known)), reverse=True)
        for s, name in other:
            print(f'unmatched device op {s:.6f} s {name}', file=sys.stderr)


def per_window_ms(rec, key):
    if not rec.windows:
        return None
    return 1e3 * sum(w[key] for w in rec.windows) / len(rec.windows)


def roofline(rec, kernel):
    """The kernel's least time over its device time, in %; None where it
    did not run."""
    spent = rec.trace.seconds(KERNELS[kernel])
    if spent <= 0:
        return None
    return 100.0 * rec.least_s[kernel] / spent
