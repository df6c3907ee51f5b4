#!/usr/bin/env python3
"""Generate the per-dataset info file (sequence start times).

The port's entry point after ``scripts/make_info.py``.  Sequence slicing
and evaluation are keyed on each sequence's epoch start time, stored in
``info/<dataset>.hdf5`` as parallel ``set_name`` / ``start_time``
datasets (read by ``data.dataset.read_info``).  This derives it from the
raw MVSEC-format sequences (``<raw_dir>/*/*_data.hdf5``), HDF5 files or
the npy store alike (``data/store.py``), and writes it in the npy store.

Usage:
    python -m dvs_of_training_framework_tpu_torch.tools.make_info \
        /path/to/data/raw/mvsec /path/to/data/info/mvsec.hdf5
"""
from pathlib import Path
import sys

import numpy as np

from ..data import store


def sequence_start_time(seq_file):
    with store.open_file(seq_file, 'r') as f:
        left = f['davis']['left']
        first_event_ts = float(np.array(left['events'][0])[2])
        first_image_ts = float(np.array(left['image_raw_ts'][:1])[0])
    return min(first_event_ts, first_image_ts)


def main(raw_dir, out_file):
    raw_dir = Path(raw_dir)
    names = []
    starts = []
    for seq_file in sorted(raw_dir.glob('*/*_data.hdf5')):
        seq_name = seq_file.stem.replace('_data', '')
        names.append(seq_name)
        starts.append(sequence_start_time(seq_file))
        print(f'{seq_name}: {starts[-1]:.6f}')
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    with store.open_file(out_file, 'w') as f:
        f.create_dataset('set_name',
                         data=np.array([n.encode() for n in names]))
        f.create_dataset('start_time', data=np.array(starts))
    print(f'wrote {len(names)} sequences to {out_file}')


if __name__ == '__main__':
    main(sys.argv[1], sys.argv[2])
