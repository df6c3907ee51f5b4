#!/usr/bin/env python3
"""Summarize a training run's TensorBoard log: the train loss and skips.

Reads every event file of a run's log directory (the port's TFRecord
codec, ``utils/tb.py``) and prints one JSON line: the number of logged
optimizer steps, the mean ``General/Train loss`` of the first and of the
last 500 of them (the accuracy protocol's figures), its maximum, and the
last ``General/skipped batches`` count.  Where a restart logged a step
again, the later record counts.

Usage:
    python -m dvs_of_training_framework_tpu_torch.tools.loss_summary \
        <model_dir>/log
"""
from argparse import ArgumentParser
import json
from pathlib import Path

import numpy as np

from ..utils.tb import read_events

LOSS = 'General/Train loss'
SKIPS = 'General/skipped batches'
WINDOW = 500


def summarize(log_dir, window: int = WINDOW) -> dict:
    """The summary of the event files in ``log_dir``, in file order; each
    tag's values keyed by the step (samples passed) they were logged at."""
    series = {LOSS: {}, SKIPS: {}}
    for path in sorted(Path(log_dir).glob('events.out.tfevents.*')):
        for event in read_events(path):
            for tag, value in event['scalars'].items():
                if tag in series:
                    series[tag][event['step']] = value
    losses = [series[LOSS][k] for k in sorted(series[LOSS])]
    if not losses:
        raise ValueError(f'no {LOSS!r} scalar under {log_dir}')
    skips = series[SKIPS]
    return {'steps': len(losses),
            'first_mean': float(np.mean(losses[:window])),
            'last_mean': float(np.mean(losses[-window:])),
            'max': max(losses),
            'skipped_batches': int(skips[max(skips)]) if skips else 0,
            'window': window}


def main(argv=None):
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('log_dir', type=Path)
    print(json.dumps(summarize(parser.parse_args(argv).log_dir)))


if __name__ == '__main__':
    main()
