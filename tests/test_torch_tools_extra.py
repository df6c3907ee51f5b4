"""The port's accuracy and log tools against the repo's scripts.

- ``tools/zero_flow_baseline.py`` and ``tools/oracle_flow_baseline.py``
  print, line for line, what ``scripts/zero_flow_baseline.py`` and
  ``scripts/oracle_flow_baseline.py`` print over the miniature MVSEC
  sequence of tests/test_torch_eval_cli.py (HDF5, read by the port
  through ``data/store.py``), with a spatially varying ground truth so
  that the constant-flow oracle keeps a residual; the config is JSON,
  which the scripts' PyYAML reads too.  The printed numbers are equal
  (the exactness the scripts' own format allows).
- ``tools/fix_events.py`` rewrites tests/utils/test_tb.py's restart case
  into a file byte for byte the one ``scripts/fix_events.py`` writes,
  and keeps the post-restart values.
- ``tools/aee_table.py``: its live rows equal ``scripts/aee_table.py``'s
  character for character, with ``--median`` and ``--worst``; the EMA
  pickles give rows of their own.
- ``tools/make_info.py`` over raw sequences, HDF5 or the npy store:
  what it writes reads, through the port's ``read_info``, the same as
  what ``scripts/make_info.py`` writes reads through the JAX package's.
- ``tools/profile_dataset.py`` times the loader over ``tests/data/seq``
  and prints its line.
"""
import pickle
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pytest

import scripts.aee_table as root_table
import scripts.fix_events as root_fix
import scripts.make_info as root_info
import scripts.oracle_flow_baseline as root_oracle
import scripts.zero_flow_baseline as root_zero
from dvs_of_training_framework_tpu.data.dataset import \
    read_info as jax_read_info
from dvs_of_training_framework_tpu_torch.data import store
from dvs_of_training_framework_tpu_torch.data.dataset import read_info
from dvs_of_training_framework_tpu_torch.tools import (
    aee_table, fix_events, make_info, oracle_flow_baseline, profile_dataset,
    zero_flow_baseline)
from dvs_of_training_framework_tpu_torch.utils.tb import (SummaryWriter,
                                                          read_events)

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 64


def write_sequence(path, events, image_ts, images):
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, 'w') as f:
        left = f.create_group('davis').create_group('left')
        left.create_dataset('events', data=events)
        left.create_dataset('image_raw_ts', data=image_ts)
        left.create_dataset('image_raw', data=images)
        left.create_dataset(
            'image_raw_event_inds',
            data=np.searchsorted(events[:, 2], image_ts) - 1)


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """tests/test_torch_eval_cli.py's miniature sequence as a data root
    (``raw/``, ``info/``), with a ground truth that varies over the frame
    and in time; returns the JSON test config."""
    rng = np.random.default_rng(0)
    n_events, t0, duration = 5000, 100.0, 2.0
    events = np.stack([
        rng.integers(0, W, n_events).astype(np.float64),
        rng.integers(0, H, n_events).astype(np.float64),
        np.sort(rng.uniform(t0, t0 + duration, n_events)),
        rng.choice([-1.0, 1.0], n_events)], axis=1)
    image_ts = np.arange(t0, t0 + duration, 0.1)
    raw = tmp_path / 'root' / 'raw' / 'mini'
    write_sequence(raw / 'mini_seq' / 'mini_seq1_data.hdf5', events,
                   image_ts, rng.integers(0, 255, (image_ts.size, H, W))
                   .astype(np.uint8))
    gt_ts = np.arange(t0, t0 + duration + 0.2, 0.1)
    cols = np.arange(W, dtype=np.float32) / W
    rows = np.arange(H, dtype=np.float32)[:, None] / H
    phase = np.arange(gt_ts.size, dtype=np.float32)[:, None, None]
    gt_dir = raw / 'FlowGT' / 'mini_seq'
    gt_dir.mkdir(parents=True)
    np.savez(gt_dir / 'mini_seq1_gt_flow_dist.npz', timestamps=gt_ts,
             x_flow_dist=(0.5 + 3 * cols + 0.1 * phase) * np.ones(
                 (1, H, 1), np.float32),
             y_flow_dist=(2 * rows - 0.05 * phase) * np.ones(
                 (1, 1, W), np.float32))
    (tmp_path / 'root' / 'info').mkdir()
    with h5py.File(tmp_path / 'root' / 'info' / 'mini.hdf5', 'w') as f:
        f.create_dataset('set_name', data=np.array([b'mini_seq1']))
        f.create_dataset('start_time', data=np.array([t0]))
    config = tmp_path / 'testing.json'
    config.write_text('{"mini": {"mini_seq1": {"step": [1, 2], "start": '
                      '0.2, "stop": 1.0, "test_shape": [48, 48], '
                      '"crop_type": "central", "is_car": false}}}')
    monkeypatch.setenv('DVS_DATA_ROOT', str(tmp_path / 'root'))
    return config


@pytest.mark.parametrize('root, port', [
    (root_zero, zero_flow_baseline),
    (root_oracle, oracle_flow_baseline)], ids=['zero', 'oracle'])
def test_baselines_print_the_scripts_lines(root, port, data_root, capsys,
                                           monkeypatch):
    monkeypatch.setattr('sys.argv', ['baseline.py', '--test-config',
                                     str(data_root)])
    root.main()
    want = capsys.readouterr().out
    port.main(['--test-config', str(data_root)])
    got = capsys.readouterr().out
    assert got == want
    lines = got.splitlines()
    assert len(lines) == 2 and all(
        re.fullmatch(r'\[mini_seq1, step=[12]\] .* AEE=\d+\.\d{4} px, '
                     r'%AEE<3px=\d+\.\d{2}', line) for line in lines), got
    aees = [float(re.search(r'AEE=([\d.]+) px', line)[1]) for line in lines]
    assert all(a > 0.05 for a in aees), aees    # a residual to beat


def test_fix_events_writes_the_scripts_file(tmp_path, capsys):
    w = SummaryWriter(tmp_path / 'log')
    for step in (10, 20, 30, 40):
        w.add_scalar('loss', float(step), step)
    # a restart from step 20: steps 30 and 40 are stale
    for step in (20, 30, 50):
        w.add_scalar('loss', float(step) + 0.5, step)
    w.close()
    (original,) = (tmp_path / 'log').glob('events.out.tfevents.*')
    for name in ('root', 'port'):
        (tmp_path / name).mkdir()
        shutil.copy(original, tmp_path / name / original.name)
    root_fix.main([str(tmp_path / 'root')])
    want = capsys.readouterr().out
    fix_events.main([str(tmp_path / 'port')])
    assert capsys.readouterr().out == want.replace(str(tmp_path / 'root'),
                                                   str(tmp_path / 'port'))
    for name in (original.name, original.name + '.orig'):
        assert (tmp_path / 'port' / name).read_bytes() == \
            (tmp_path / 'root' / name).read_bytes()
    events = [e for e in read_events(tmp_path / 'port' / original.name)
              if e['scalars']]
    assert [e['step'] for e in events] == [10, 20, 30, 50]
    assert [e['scalars']['loss'] for e in events] == \
        [10.0, 20.5, 30.5, 50.5]
    fix_events.main([str(tmp_path / 'port' / original.name)])
    assert 'already monotonic' in capsys.readouterr().out


def result(rng, step, n_windows=6):
    windows = [dict(start=100.0 + 0.1 * i, stop=100.1 + 0.1 * i,
                    aee=float(rng.uniform(0.2, 3)),
                    percent_aee=float(rng.uniform(0, 1)),
                    median_ee=float(rng.uniform(0.1, 2)),
                    n_points=int(rng.integers(50, 500)))
               for i in range(n_windows)]
    return SimpleNamespace(step=step, mAEE=float(rng.uniform(0.2, 3)),
                           mpAEE=float(rng.uniform(0, 1)),
                           mMedEE=float(rng.uniform(0.1, 2)),
                           windows=windows)


def test_aee_table_rows_and_ema_rows(tmp_path, capsys):
    rng = np.random.default_rng(1)
    live, both = tmp_path / 'live', tmp_path / 'both'
    live.mkdir()
    both.mkdir()
    for n in (2, 10):
        for suffix in ('', '_ema'):
            records = [result(rng, fs) for fs in (2, 1)]
            name = f'step_{n}{suffix}.pkl'
            (both / name).write_bytes(pickle.dumps(records))
            if not suffix:
                (live / name).write_bytes(pickle.dumps(records))
    for median in (False, True):
        want = list(root_table.rows(live, median=median))
        got = list(aee_table.rows(both, median=median))
        assert [r for r in got if ' EMA |' not in r] == want
        ema = [r for r in got if ' EMA |' in r]
        assert [r.split(' | ')[0] for r in ema] == ['| step 2 EMA',
                                                    '| step 10 EMA']
        assert not set(ema) & set(want)
        assert got.index(ema[0]) == got.index(want[0]) + 1
    root_table.worst_windows(live, 2)
    want = capsys.readouterr().out
    aee_table.worst_windows(both, 2)
    got = capsys.readouterr().out.splitlines(keepends=True)
    assert 'checkpoint 10 EMA, fs1: 2 worst windows of 6' in ''.join(got)
    # the EMA blocks' window lines follow their headers: drop them
    kept, skip = [], False
    for line in got:
        if line.startswith('--'):
            skip = 'EMA' in line
        if not skip:
            kept.append(line)
    assert ''.join(kept) == want
    aee_table.main([str(both), '--median', '--worst', '1'])
    out = capsys.readouterr().out
    assert out.startswith(f'### {both}\n| step 2 | ')
    assert out.count(' EMA | ') == 2 and out.count(' med ') == 8 + 8


def test_make_info_reads_as_the_scripts_file(tmp_path, capsys):
    rng = np.random.default_rng(2)
    starts = {}
    for name, t0 in (('outdoor_day1', 1506117898.2), ('outdoor_day2',
                                                      1506118400.5)):
        events = np.stack([rng.integers(0, W, 50).astype(np.float64),
                           rng.integers(0, H, 50).astype(np.float64),
                           np.sort(rng.uniform(t0 + 0.01, t0 + 1, 50)),
                           rng.choice([-1.0, 1.0], 50)], axis=1)
        image_ts = t0 + np.arange(0.0, 1.0, 0.25)
        images = rng.integers(0, 255, (image_ts.size, 4, 5)).astype(np.uint8)
        family = name.rstrip('0123456789')
        write_sequence(tmp_path / 'raw' / family / f'{name}_data.hdf5',
                       events, image_ts, images)
        # the same sequence in the npy store, as the port's tools write it
        with store.open_file(tmp_path / 'npy' / family / f'{name}_data.hdf5',
                             'w') as f:
            left = f.create_group('davis').create_group('left')
            left.create_dataset('events', data=events)
            left.create_dataset('image_raw_ts', data=image_ts)
        starts[name] = t0
    root_info.main(tmp_path / 'raw', tmp_path / 'info_root' / 'mvsec.hdf5')
    want_out = capsys.readouterr().out
    want = jax_read_info(str(tmp_path / 'info_root' / 'mvsec.hdf5'))
    assert want == starts
    for raw in ('raw', 'npy'):
        out = tmp_path / f'info_{raw}' / 'mvsec.hdf5'
        make_info.main(tmp_path / raw, out)
        assert capsys.readouterr().out == want_out.replace(
            str(tmp_path / 'info_root'), str(tmp_path / f'info_{raw}'))
        assert out.is_dir()                 # the npy store
        assert read_info(str(out)) == want
    assert read_info(str(tmp_path / 'info_root' / 'mvsec.hdf5')) == want


def test_profile_dataset_prints_its_line(tmp_path, capsys, monkeypatch):
    (tmp_path / 'outdoor_day2').symlink_to(REPO / 'tests' / 'data' / 'seq')
    monkeypatch.setenv('DVS_DATA_PATH', str(tmp_path))
    args = profile_dataset.parse_args(
        ['--start', '2', '--num-iters', '4', '--num_workers', '0', '-mbs',
         '2', '--height', '64', '--width', '64'])
    us = profile_dataset.main(args)
    assert us > 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        f'{us:.1f} us/iteration'
