"""The readings that ``correct``'s limits are set from, in one process.

For each seed: a run of the program as a cell's run makes it, with a
timed window of ``--seconds`` (``run_seconds`` of ``BENCHMARK.json``
unless given: where the check window falls in training moves its
readings) and no trace, then its first window and its
check window against the float32 reference (``cli.compare``): the sound
runs' numbers, whose largest is a limit's lower reading.  On the first
``control`` seeds also the control, the reference computed a step below
the configuration's precision (``precision.FP8`` for bf16), and each
fault of ``reference.FAULTS`` planted in the reference in the program's
place, each from the same states over the same batches: their smallest
is a limit's upper reading.  The benchmark's own runs do not run this.

    python3 portbench/calibrate.py --workload W --seeds 12 --control 3 \
        [--seconds S] [--first-seed N] [--out FILE]
"""
import argparse
import gc
import json
import sys

from . import check, cli, spec
from .reference import FAULTS

CONTROL = {'bfloat16': 'fp8', 'float32': 'bfloat16'}


def readings(cell, seed, device, control, seconds):
    """``{'program': numbers, 'control': ..., fault: ...}`` of one seed."""
    import torch
    kept, records = cli.measure(cell, seed, seconds, False, device)
    pool, window = records['pool'], records['program'].window
    del records
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    wants, steps = {}, {}
    out = {'program': cli.compare(cell, kept, pool, device, window,
                                  wants=wants, steps=steps),
           'steps': {'program': steps}}
    if control:
        rounding = CONTROL[cell.config['flags']['--precision']]
        steps = out['steps']['control'] = {}
        out['control'] = cli.compare(cell, kept, pool, device, window,
                                     rounding, wants=wants, steps=steps)
        for fault in FAULTS:
            steps = out['steps'][fault] = {}
            out[fault] = cli.compare(cell, kept, pool, device, window,
                                     fault=fault, wants=wants, steps=steps)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, default=12)
    parser.add_argument('--control', type=int, default=3)
    parser.add_argument('--seconds', type=float, default=None)
    parser.add_argument('--first-seed', type=int, default=3000000000)
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    benchmark = spec.load_benchmark()
    cell = spec.Cell(benchmark, args.workload)
    seconds = args.seconds or benchmark['run_seconds']
    device = torch.device('cuda', 0)
    table = {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        table[seed] = readings(cell, seed, device, i < args.control,
                               seconds)
        print(seed, json.dumps(table[seed]), flush=True)
    names = list(next(iter(table.values()))['program'])
    summary = {'program': {k: max(r['program'][k] for r in table.values())
                           for k in names}}
    for kind in ('control', *FAULTS):
        rows = [r[kind] for r in table.values() if kind in r]
        if rows:
            summary[kind] = {k: min(row[k] for row in rows)
                             for k in names}
    print('largest sound / smallest control and fault readings',
          json.dumps(summary))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'readings': table, 'summary': summary}, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
