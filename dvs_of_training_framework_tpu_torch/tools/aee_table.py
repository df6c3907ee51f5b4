#!/usr/bin/env python3
"""Render an ACCURACY.md-style AEE table from the evaluation CLI's pickles.

The port's entry point after ``scripts/aee_table.py``:

    python -m dvs_of_training_framework_tpu_torch.tools.aee_table \
        [--median] [--worst N] <eval_dir> ...

Each ``step_N.pkl`` that ``test.py`` writes holds a list of namespaces
with ``step`` (frame step), ``mAEE``, ``mpAEE``, ``mMedEE`` (mean over
windows of the per-window MEDIAN endpoint error) and ``windows``
(per-window records).  The output is one markdown row per checkpoint,
``| step N | AEE (%<3px) | ... |``, ordered by frame step: the layout of
ACCURACY.md.  ``--median`` appends the outlier-robust median EE to each
cell; ``--worst N`` prints the N worst windows (by AEE) of every
(checkpoint, frame step), which traces a spiking mean to the windows
that spike.

Unlike the script, the EMA's pickles (``step_N_ema.pkl``, ``test.py
--use-ema``) give rows of their own, ``| step N EMA | ... |``, after the
live row of the same step; the live rows are the script's, character for
character.
"""
import argparse
import pickle
import re
import sys
from pathlib import Path


def _load(eval_dir: Path):
    """(label, results) of every pickle, by step, the live one first."""
    def key(path):
        return (int(re.findall(r'\d+', path.stem)[0]),
                path.stem.endswith('_ema'))

    for f in sorted(eval_dir.glob('step_*.pkl'), key=key):
        n, ema = key(f)
        yield f'{n} EMA' if ema else f'{n}', \
            pickle.loads(f.read_bytes())


def rows(eval_dir: Path, median=False):
    for n, results in _load(eval_dir):
        by_fs = {r.step: r for r in results}

        def cell(r):
            out = f'{r.mAEE:.3f} ({100 * r.mpAEE:.1f})'
            med = getattr(r, 'mMedEE', None)
            if median and med is not None:
                out += f' med {med:.3f}'
            return out

        cells = ' | '.join(cell(by_fs[fs]) for fs in sorted(by_fs))
        yield f'| step {n} | {cells} |'


def worst_windows(eval_dir: Path, k):
    for n, results in _load(eval_dir):
        for r in results:
            wins = getattr(r, 'windows', None)
            if not wins:
                continue
            t0 = wins[0]['start']
            print(f'-- checkpoint {n}, fs{r.step}: {k} worst windows '
                  f'of {len(wins)} (t relative to sequence start)')
            for w in sorted(wins, key=lambda w: -w['aee'])[:k]:
                print(f"   t={w['start'] - t0:7.2f}s  "
                      f"aee {w['aee']:7.3f}  med {w['median_ee']:7.3f}  "
                      f"%<3px {100 * w['percent_aee']:5.1f}  "
                      f"n={w['n_points']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('dirs', nargs='+', type=Path)
    ap.add_argument('--median', action='store_true',
                    help='append the per-window-median column')
    ap.add_argument('--worst', type=int, default=0, metavar='N',
                    help='print the N worst windows per checkpoint/step')
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for d in args.dirs:
        print(f'### {d}')
        for row in rows(d, median=args.median):
            print(row)
        if args.worst:
            worst_windows(d, args.worst)


if __name__ == '__main__':
    main()
