"""One run of one cell: ``run.py --workload W --seed N --seconds S --trace
0|1``.

Set-up: the traffic and the weights from the seed, the port's training
objects, and ``program.WARM_WINDOWS`` windows through the loop (the
first captures the window's CUDA graph after one eager step, which also
lets cuDNN choose its algorithms).  Then the timed window, from a
window's end to the first window's end after ``seconds``; with ``--trace
1`` then ``program.TRACE_WINDOWS`` windows under the profiler; then the
check window, one more window of the loop with the program's state kept
before and after it.  Then the peak memory is read, the program's state
freed, and the plain reference trains over the first window's batches
from the seeded weights, and over the check window's batches from the
program's state before it, in blocks of one step, for ``check.py``'s
comparison.  The last line of standard output is the result; the last
lines of standard error are the numbers compared beside their limits.
"""
import argparse
import gc
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

from . import check

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'dvs_of_training_framework_tpu')


def process_age():
    """Seconds since this process started, from ``/proc``."""
    try:
        with open('/proc/self/stat') as f:
            start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - process_age()


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_up(cell, seed, device):
    """Set-up's objects: ``(program, pool, start weights)``, and the
    seconds of each part."""
    import torch

    from . import program as prog
    from . import traffic, weights
    flags = cell.config['flags']
    t = [time.perf_counter()]
    pool = traffic.make_pool(cell.traffic, seed, flags['-mbs'],
                             (flags['--height'], flags['--width']),
                             flags['--max-sequence-length'],
                             flags['--device-queue-window'])
    t.append(time.perf_counter())
    skeleton = cell.reference().build(cell.config, lambda x: x)
    start = weights.make(skeleton, seed, device)
    t.append(time.perf_counter())
    with torch.no_grad():
        program = prog.Program(cell.config, start, device)
    t.append(time.perf_counter())
    parts = dict(zip(('traffic', 'weights', 'program'),
                     (b - a for a, b in zip(t, t[1:]))))
    return program, pool, start, parts


def measure(cell, seed, seconds, trace, device):
    """Run the program; returns ``(kept, records)``.  ``kept``: the
    seeded start weights (``'start'``), every optimizer step's loss
    (``'loss'``), and the program's state (``Program.state``, with its
    ``'step'``) at the ``Phases`` hook's ``keep`` points, all on the CPU."""
    import torch

    from . import program as prog
    t_begin = time.perf_counter()
    if device.type == 'cuda':
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    program, pool, start, parts = set_up(cell, seed, device)
    kept = {'start': {k: v.cpu() for k, v in start.items()}}
    del start

    def keep(name, step):
        kept[name] = dict(program.state(), step=step)

    interval = program.window // program.args.accum_step
    phases = prog.Phases(interval, seconds, trace, keep)
    recorder, logger = prog.Recorder(), prog.Logger()
    t_loop = time.perf_counter()
    program.run(pool, phases, recorder, logger)
    parts = dict(imports=t_begin - T_START, **parts,
                 warm_windows=phases.t0 - t_loop)
    records = {'phases': phases, 'recorder': recorder, 'pool': pool,
               'program': program, 'skipped': logger.skipped,
               'setup_parts': parts,
               'peak': (torch.cuda.max_memory_allocated()
                        if device.type == 'cuda' else 0)}
    kept['loss'] = logger.losses
    return kept, records


def checked_windows(kept, pool, window):
    """The windows that ``correct`` compares, each ``(prefix, the state it
    starts from, its batches, the program's outputs)``: the first window,
    from the seeded weights and a fresh optimizer, and the check window,
    from the program's state before it.  A window's batches are the
    pool's, cycled, one optimizer step a batch."""
    def outputs(state, first_step):
        return {'loss': kept['loss'][first_step:first_step + window],
                'params': state['params'], 'mu': state['mu']}

    s = kept['check_start']['step']
    return [('', {'params': kept['start']}, pool[:window],
             outputs(kept['first'], 0)),
            ('late_', kept['check_start'],
             [pool[(s + k) % len(pool)] for k in range(window)],
             outputs(kept['check_end'], s))]


def reference(cell, state, batches, device, rounding='float32', fault=None):
    """The plain reference over ``batches`` from ``state``: its
    ``params``, and the optimizer's ``mu``, ``nu``, ``slow`` and
    ``count`` where it has them."""
    import torch

    from . import reference as ref
    with torch.no_grad():
        weights = {k: v.to(device) for k, v in state['params'].items()}
    return ref.train(cell.reference(), cell.config, weights, batches,
                     device, rounding, fault,
                     state=state if 'mu' in state else None)


def compare(cell, kept, pool, device, window, rounding='float32',
            fault=None, wants=None, steps=None):
    """``check.NAMES``' numbers: the program's outputs, or with
    ``rounding`` or ``fault`` the reference's so computed in the
    program's place, against the float32 reference (kept in ``wants``,
    where given, for the next call on the same run).  ``steps``, where
    given, gets each window's per-step loss gaps and reference losses,
    its first step and its leaf numbers' worst leaves."""
    wants = {} if wants is None else wants
    values = {}
    for prefix, state, batches, out in checked_windows(kept, pool, window):
        if prefix not in wants:
            wants[prefix] = reference(cell, state, batches, device)
        if rounding != 'float32' or fault is not None:
            out = reference(cell, state, batches, device, rounding, fault)
        values.update(check.numbers(out, wants[prefix], state['params'],
                                    prefix, steps))
        if steps is not None:
            steps[prefix + 'first_step'] = state.get('step', 0)
            steps[prefix + 'loss_gaps'] = check.loss_gaps(
                out['loss'], wants[prefix]['loss'])
            steps[prefix + 'reference_loss'] = wants[prefix]['loss']
    return values


def end_to_end(phases, records, window_samples):
    """``{name: (value, unit)}`` of the timed window."""
    ends = [t for _, t in phases.ends if phases.t0 < t <= phases.t_end]
    periods, last = [], phases.t0
    for t in ends:
        periods.append(t - last)
        last = t
    elapsed = phases.t_end - phases.t0
    # a window too long for two in the timed window (a loaded CPU in the
    # tests) leaves one period, its own 90th percentile
    p90 = (statistics.quantiles(periods, n=10, method='inclusive')[-1]
           if len(periods) > 1 else periods[0])
    return {
        'samples_per_s': (len(ends) * window_samples / elapsed, 'samples/s'),
        'window_ms_p90': (1e3 * p90, 'ms'),
        'peak_mem_gib': (records['peak'] / 2 ** 30, 'GiB'),
        'setup_s': (phases.t0 - T_START, 's')}, periods


def main(argv=None, device=None, root=None):
    """A run as the command line says; returns the exit code.  The tests
    pass ``device`` (the CPU), which skips the look for a chip, and
    ``root``, a checkout of their own."""
    args = parse(sys.argv[1:] if argv is None else argv)
    import torch

    from . import readers, spec
    root = spec.checkout() if root is None else Path(root)
    cell = spec.Cell(spec.load_benchmark(root), args.workload,
                     root / spec.ROOT.name)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f'{cell.name} needs {cell.chips} CUDA card(s); '
                  f'{torch.cuda.device_count()} available', file=sys.stderr)
            return 2
        device = torch.device('cuda', 0)
    on_card = device.type == 'cuda'
    flags = cell.config['flags']
    window_samples = flags['--device-queue-window'] * flags['-mbs']
    kept, records = measure(cell, args.seed, args.seconds, bool(args.trace),
                            device)
    phases = records['phases']
    found = forbidden_modules()
    if found:
        print(f'loaded after the window: {found}', file=sys.stderr)
        return 3
    metrics, periods = end_to_end(phases, records, window_samples)
    steps = len(periods) * flags['--device-queue-window']
    skipped = records['skipped']
    print(f'{cell.name}: {len(periods)} windows, {steps} steps in the timed '
          f'window of {phases.t_end - phases.t0:.3f} s; {skipped} batches '
          'skipped; set-up ' + ', '.join(
              f'{k} {v:.3f} s' for k, v in records['setup_parts'].items()),
          file=sys.stderr)
    device_info = {'platform': 'gpu' if on_card else device.type,
                   'kind': (torch.cuda.get_device_name(device) if on_card
                            else device.type),
                   'count': 1, 'memory_peak_bytes': int(records['peak'])}
    result_metrics = {m['name']: {'value': metrics[m['name']][0],
                                  'unit': metrics[m['name']][1]}
                      for m in cell.end_to_end}
    breakdown = None
    if args.trace:
        digest = phases.digest()
        rec = readers.Records(cell, records, digest, periods)
        result_metrics = {}
        units = {m['name']: m['unit'] for m in cell.per_layer}
        for name, read in cell.readers().items():
            value = read(rec)
            if value is not None:
                result_metrics[name] = {'value': value, 'unit': units[name]}
        rec.report_unmatched()
        device_info.update(busy_s=digest.busy_s, window_s=digest.window_s)
        breakdown = digest.breakdown()
    program = records.pop('program')
    pool = records['pool']
    window = program.window
    del program, records, phases
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    values = compare(cell, kept, pool, device, window)
    limits = cell.config['correct']
    correct = check.verdict(values, limits)
    for line in check.lines(values, limits):
        print(line, file=sys.stderr)
    result = {'correct': correct, 'attempted': steps, 'failed': skipped,
              'metrics': result_metrics, 'device': device_info}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['compared'] = {k: {'value': _finite(values[k]),
                              'limit': limits[k]} for k in check.NAMES}
    print(json.dumps(result))
    return 0


def _finite(value):
    """JSON has no infinity or NaN: such a number is written as text."""
    return value if math.isfinite(value) else str(value)
