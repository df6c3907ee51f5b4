#!/usr/bin/env python3
"""Generate a synthetic MVSEC-format dataset with exact ground-truth flow.

The port's entry point after ``scripts/make_synthetic_mvsec.py``, with the
same arguments and the same simulation (``data/synthetic.py``).  It
writes the npy store (``data/store.py``) under the script's names:
``raw/<ds>/<family>/<seq>_data.hdf5`` with
``davis/left/{events,image_raw,image_raw_ts,image_raw_event_inds}``, the
``raw/<ds>/FlowGT/<family>/<seq>_gt_flow_dist.npz`` ground truth
(``timestamps, x_flow_dist, y_flow_dist``), and ``info/<ds>.hdf5``.

Usage:
    python -m dvs_of_training_framework_tpu_torch.tools.make_synthetic_mvsec \
        <out_root> [--train-secs 60] [--eval-secs 12] [--motion varied] \
        [--speed 0.35]
"""
import argparse
from pathlib import Path

import numpy as np

from ..data.synthetic import simulate_sequence, write_info, write_sequence


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('out_root', type=Path)
    ap.add_argument('--train-secs', type=float, default=60.0)
    ap.add_argument('--eval-secs', type=float, default=12.0)
    ap.add_argument('--val-secs', type=float, default=12.0,
                    help='length of the outdoor_synth3 VALIDATION split '
                         '(independent phase + seed; 0 disables)')
    ap.add_argument('--seed', type=int, default=7)
    ap.add_argument('--speed', type=float, default=1.0,
                    help='camera drift amplitude scale (~0.35 gives '
                         'MVSEC-like 1-5 px/frame motion)')
    ap.add_argument('--motion', choices=('translate', 'varied'),
                    default='translate',
                    help='translate = constant flow per frame pair; '
                         'varied = rotation+zoom+parallax flow fields '
                         'with exact analytic GT')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    ds_name = 'synth'
    specs = [('outdoor_synth2', args.train_secs, 0.0),     # train split
             ('outdoor_synth1', args.eval_secs, 2.1)]      # test split
    if args.val_secs > 0:
        # last, so that outdoor_synth2/1 keep their seeds (seed + index)
        specs.append(('outdoor_synth3', args.val_secs, 4.2))  # val split
    names, starts = [], []
    for seq_name, secs, phase in specs:
        rng = np.random.default_rng(args.seed + len(names))
        events, frames, frame_ts, gt = simulate_sequence(
            rng, secs, phase, args.speed, args.motion)
        write_sequence(args.out_root, ds_name, seq_name, events, frames,
                       frame_ts, gt)
        names.append(seq_name)
        starts.append(frame_ts[0])
        rate = events.shape[0] / secs
        print(f'{seq_name}: {events.shape[0]} events ({rate / 1e3:.0f} '
              f'kev/s), {frames.shape[0]} frames, {secs:.0f}s')
    write_info(args.out_root, ds_name, names, starts)
    print(f'wrote {args.out_root}')


if __name__ == '__main__':
    main()
