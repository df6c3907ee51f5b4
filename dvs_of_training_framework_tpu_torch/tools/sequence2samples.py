#!/usr/bin/env python3
"""Slice raw MVSEC sequences into per-element training files.

The port's entry point after ``scripts/sequence2samples.py``, with the
same argument (a config of time ranges, ``.json`` or ``.yml``; default
the package's ``config/training_datasets.json``, the JSON twin of the
script's ``config/training_datasets.yml``) and the
data root ``$DVS_DATA_ROOT``, which must be set (the script also falls
back to a docker mount or to a ``data/`` directory beside the checkout).
For every inter-frame window of each configured sequence it writes one file of the npy store holding the window's events,
the bracketing frames, and start/stop timestamps: the schema that
``data.dataset.DatasetImpl`` reads.  It reads the raw sequences and the
info files in either format (``data/store.py``).

Usage:
    DVS_DATA_ROOT=<root> python -m \
        dvs_of_training_framework_tpu_torch.tools.sequence2samples \
        dvs_of_training_framework_tpu_torch/config/synth_train_datasets.json
"""
import sys
from pathlib import Path

import numpy as np

from ..data import store
from ..data.dataset import read_info
from ..evaluation.testing import read_config
from ..utils.common import data_root
from ..utils.progress import progress

CONFIG = Path(__file__).resolve().parents[1] / 'config'


def _verify_window(events, window, lo, hi, t_start, t_stop):
    """The window must hold exactly the events inside [t_start, t_stop]."""
    if window.shape[0]:  # a still scene can produce an eventless window
        assert window[0, 2] >= t_start, \
            'The first event is before the first image'
        assert window[-1, 2] <= t_stop, \
            'The last event is after the second image'
    assert lo == 0 or events[lo - 1, 2] <= t_start, 'Some events are missed'
    assert hi >= events.shape[0] or events[hi, 2] >= t_stop, \
        'Some events are missed'


def export_windows(events, images, image_ts, frame_event_index, out_dir,
                   ts0):
    """Write one file per inter-frame window.

    ``frame_event_index[i]`` is the index of the last event at or before
    frame i (MVSEC's image_raw_event_inds), so window i owns the event
    range ``(frame_event_index[i], frame_event_index[i+1]]``.
    """
    n_windows = frame_event_index.size - 1
    for i in progress(range(n_windows), total=n_windows):
        lo = int(frame_event_index[i]) + 1
        hi = int(frame_event_index[i + 1]) + 1
        t_start, t_stop = image_ts[i], image_ts[i + 1]
        window = np.asarray(events[lo:hi])
        _verify_window(events, window, lo, hi, t_start, t_stop)
        window[:, 2] -= ts0
        with store.open_file(str(out_dir / f'{i:06d}.hdf5'), 'w') as f:
            f.create_dataset('image1', data=np.asarray(images[i]))
            f.create_dataset('image2', data=np.asarray(images[i + 1]))
            f.create_dataset('events', data=window)
            f.create_dataset('start', data=t_start - ts0)
            f.create_dataset('stop', data=t_stop - ts0)


def process_sequence(raw_file, out_dir, t0, start_offset, stop_offset):
    """Slice one raw MVSEC sequence to the configured time range."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with store.open_file(str(raw_file), 'r') as f:
        left = f['davis']['left']
        image_ts = np.asarray(left['image_raw_ts'])
        keep = image_ts >= t0 + (start_offset or 0)
        if stop_offset is not None:
            keep &= image_ts <= t0 + stop_offset
        export_windows(left['events'],
                       left['image_raw'][keep, :],
                       image_ts[keep],
                       np.asarray(left['image_raw_event_inds'],
                                  dtype=np.int64)[keep],
                       out_dir, t0)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    data_dir = data_root('DVS_DATA_ROOT')
    info_dir = data_dir / 'info'

    config_path = (Path(argv[0]) if argv
                   else CONFIG / 'training_datasets.json')
    config = read_config(config_path)

    for ds_name, sequences in config.items():
        info = read_info(str(info_dir / f'{ds_name}.hdf5'))
        for seq_name, seq_range in sequences.items():
            # take directory: sequence name minus the trailing take digit
            raw_file = (data_dir / 'raw' / ds_name / seq_name[:-1]
                        / f'{seq_name}_data.hdf5')
            process_sequence(raw_file,
                             data_dir / 'training' / ds_name / seq_name,
                             info[seq_name],
                             seq_range['start'], seq_range['stop'])


if __name__ == '__main__':
    main()
