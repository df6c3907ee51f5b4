"""Inference and the evaluation CLI of the port against the JAX package.

Both sides get the same EVFlowNet weights: the port's seeded
initialisation, carried to the JAX package as a msgpack checkpoint of
its own Serializer (``utils/convert.torch_to_flax``), which the port
reads back with ``read_params_file``.

- Inference: the JAX plugin's ``EVFlowNet.OpticalFlow`` and the port's
  ``OpticalFlow`` predict the same flow at every scale on the same
  windows of seeded random events, at 48x48 and capacity 4096, in blocks
  of 4 windows with a partial final block repeat-padded as ``evaluate``
  pads it.  Tolerance rtol 1e-4 / atol 1e-6, the flows' tolerance of
  tests/test_torch_model.py, whose voxel grid takes the 1e-5 of
  tests/training/test_models.py::test_pallas_scatter_method_matches_default:
  the two frameworks sum each convolution in another order.
- The evaluation path end to end, on the raw sequence of
  tests/training/test_eval_cli.py (HDF5, read by the port through
  ``data/store.py``): the root ``test.perform_single_test`` with the
  EVFlowNet plugin and the port's ``perform_single_test`` give the same
  mean AEE, %AEE and mean median EE to rtol 1e-5 (tighter than the rel
  1e-2 of tests/training/test_eval_cli.py::test_perform_single_test:
  the flows' 1e-4 is seen through endpoint errors of ~0.5 px), and one
  ``process_single`` pickle of each CLI holds the same records, live and
  EMA-named.
- ``process_all`` scores every checkpoint of a run and writes the
  TensorBoard summary keyed by samples passed, as
  tests/training/test_eval_cli.py::test_process_all_aggregates_tb asks
  of the root CLI.
"""
import importlib
import pickle
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.training.serializer import \
    Serializer as JaxSerializer
from dvs_of_training_framework_tpu_torch import test as port_cli
from dvs_of_training_framework_tpu_torch.models import Model, OpticalFlow
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from dvs_of_training_framework_tpu_torch.utils.convert import torch_to_flax

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 64
MODEL_ARGS = dict(flownet_path=REPO / 'EVFlowNet', mish=False,
                  prefix_length=0, suffix_length=0, max_sequence_length=1,
                  dynamic_sample_length=False, event_representation_depth=9)


@pytest.fixture(scope='module')
def weights():
    """The port's seeded EVFlowNet weights."""
    model = Model(generator=torch.Generator().manual_seed(3))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def jax_checkpoint(weights, run_dir, step=1, samples_passed=4):
    """The weights as a JAX package checkpoint; returns its path."""
    ser = JaxSerializer(run_dir)
    ser.checkpoint_model(torch_to_flax(weights), {}, global_step=step,
                         samples_passed=samples_passed)
    ser.wait()
    return ser._id2path(step)


def random_windows(rng, n_windows, size=48):
    windows = []
    for i in range(n_windows):
        n = int(rng.integers(300, 900))
        t0 = 0.1 * i
        windows.append((np.stack([rng.integers(0, size, n).astype(float),
                                  rng.integers(0, size, n).astype(float),
                                  np.sort(rng.uniform(t0, t0 + 0.1, n)),
                                  rng.choice([-1.0, 1.0], n)]),
                        t0, t0 + 0.1))
    return windows


def test_inference_matches_jax(weights, tmp_path):
    jax_plugin = importlib.import_module('EVFlowNet')
    ckpt = jax_checkpoint(weights, tmp_path / 'jax')
    jax_of = jax_plugin.OpticalFlow((48, 48), model=ckpt,
                                    event_capacity=4096)
    port_of = OpticalFlow((48, 48), model=ckpt, event_capacity=4096,
                          device='cpu')
    windows = random_windows(np.random.default_rng(0), 6)
    block = 4
    for first in range(0, len(windows), block):
        wins = windows[first:first + block]
        wins = wins + [wins[-1]] * (block - len(wins))    # partial block
        args = ([w for w, _, _ in wins], [s for _, s, _ in wins],
                [t for _, _, t in wins])
        want = jax_of(*args, return_all=True)
        got = port_of(*args, return_all=True)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(port_of(*args), got[-1])


@pytest.fixture
def raw_sequence(tmp_path):
    """tests/training/test_eval_cli.py's miniature MVSEC sequence."""
    rng = np.random.default_rng(0)
    n_events = 5000
    t0 = 100.0
    duration = 2.0
    events = np.stack([
        rng.integers(0, W, n_events).astype(np.float64),
        rng.integers(0, H, n_events).astype(np.float64),
        np.sort(rng.uniform(t0, t0 + duration, n_events)),
        rng.choice([-1.0, 1.0], n_events)], axis=1)
    image_ts = np.arange(t0, t0 + duration, 0.1)
    seq_dir = tmp_path / 'mini' / 'mini_seq1'[:-1]
    seq_dir.mkdir(parents=True)
    with h5py.File(seq_dir / 'mini_seq1_data.hdf5', 'w') as f:
        left = f.create_group('davis').create_group('left')
        left.create_dataset('events', data=events)
        left.create_dataset('image_raw_ts', data=image_ts)
        left.create_dataset('image_raw',
                            data=rng.integers(0, 255,
                                              (image_ts.size, H, W))
                            .astype(np.uint8))
        left.create_dataset(
            'image_raw_event_inds',
            data=np.searchsorted(events[:, 2], image_ts) - 1)
    gt_dir = tmp_path / 'mini' / 'FlowGT' / 'mini_seq'
    gt_dir.mkdir(parents=True)
    gt_ts = np.arange(t0, t0 + duration + 0.2, 0.1)
    np.savez(gt_dir / 'mini_seq1_gt_flow_dist.npz',
             timestamps=gt_ts,
             x_flow_dist=np.full((gt_ts.size, H, W), 0.5, np.float32),
             y_flow_dist=np.zeros((gt_ts.size, H, W), np.float32))
    return tmp_path / 'mini', t0


def load(cli, ds_dir, t0):
    seq_file, gt_file = cli.seq2paths(ds_dir, 'mini_seq1')
    dataset = SimpleNamespace(name='mini_seq1', first_ts=t0)
    dataset.events, dataset.image_ts = cli.load_events(seq_file)
    dataset.gt = cli.load_gt(gt_file)
    dataset.imshape = dataset.gt['x_flow_dist'].shape[1:]
    return dataset


def test_perform_single_test_matches_root_cli(raw_sequence, weights,
                                              tmp_path):
    import test as root_cli

    ds_dir, t0 = raw_sequence
    ckpt = jax_checkpoint(weights, tmp_path / 'jax')
    results = {}
    for name, cli, extra in (('root', root_cli, {}),
                             ('port', port_cli, {'device': 'cpu'})):
        dataset = load(cli, ds_dir, t0)
        args = SimpleNamespace(model=ckpt, eval_batch_windows=3,
                               **MODEL_ARGS, **extra)
        cfg = SimpleNamespace(start=0.2, stop=1.0, step=1,
                              test_shape=[48, 48], crop_type='central',
                              is_car=False)
        results[name] = cli.perform_single_test(args, cfg, dataset)
    (maee, mpaee, stats), (want_maee, want_mpaee, want_stats) = \
        results['port'], results['root']
    np.testing.assert_allclose([maee, mpaee, stats['median_ee']],
                               [want_maee, want_mpaee,
                                want_stats['median_ee']], rtol=1e-5)
    assert len(stats['windows']) == len(want_stats['windows']) == 7
    for got, want in zip(stats['windows'], want_stats['windows']):
        assert got.keys() == want.keys()
        assert (got['start'], got['stop'], got['n_points']) == \
            (want['start'], want['stop'], want['n_points'])
        np.testing.assert_allclose(
            [got[k] for k in ('aee', 'percent_aee', 'median_ee')],
            [want[k] for k in ('aee', 'percent_aee', 'median_ee')],
            rtol=1e-5)


@pytest.mark.parametrize('use_ema', [False, True])
def test_process_single_pickle_matches_root_cli(raw_sequence, weights,
                                                tmp_path, monkeypatch,
                                                use_ema):
    import test as root_cli

    ds_dir, t0 = raw_sequence
    root = tmp_path / 'root'
    (root / 'raw').mkdir(parents=True)
    (root / 'raw' / 'mini').symlink_to(ds_dir)
    (root / 'info').mkdir()
    with h5py.File(root / 'info' / 'mini.hdf5', 'w') as f:
        f.create_dataset('set_name', data=np.array([b'mini_seq1']))
        f.create_dataset('start_time', data=np.array([t0]))
    cfg_path = tmp_path / 'cfg.yml'
    cfg_path.write_text(
        'mini:\n'
        '  mini_seq1:\n'
        '    step: [1, 2]\n'
        '    start: 0.2\n'
        '    stop: 1.0\n'
        '    test_shape: [48, 48]\n'
        '    crop_type: central\n'
        '    is_car: False\n')
    monkeypatch.setenv('DVS_DATA_ROOT', str(root))

    # each CLI's own run directory, the same weights at step 2 (the EMA
    # under use_ema, other weights live)
    live = {k: v + 1.0 for k, v in weights.items()} if use_ema else weights
    jax_ser = JaxSerializer(tmp_path / 'jax_run')
    jax_ser.checkpoint_model(
        torch_to_flax(live),
        {'ema_params': torch_to_flax(weights)} if use_ema else {},
        global_step=2, samples_passed=8)
    jax_ser.wait()
    Serializer(tmp_path / 'port_run').checkpoint_model(
        live, {'ema_params': weights} if use_ema else {}, global_step=2,
        samples_passed=8)

    records = {}
    for name, cli, run, extra in (
            ('root', root_cli, 'jax_run', {}),
            ('port', port_cli, 'port_run', {'device': 'cpu'})):
        out = tmp_path / f'{name}_out'
        args = SimpleNamespace(model=tmp_path / run, output=out, step=2,
                               use_ema=use_ema, test_config=cfg_path, bs=4,
                               eval_batch_windows=4, **MODEL_ARGS, **extra)
        cli.process_single(args)
        pkl = out / ('step_2_ema.pkl' if use_ema else 'step_2.pkl')
        assert cli.get_output_path(SimpleNamespace(
            model=args.model, step=2, output=out, use_ema=use_ema)) == pkl
        records[name] = [vars(r) for r in pickle.loads(pkl.read_bytes())]
    assert len(records['port']) == len(records['root']) == 2
    for got, want in zip(records['port'], records['root']):
        assert got.keys() == want.keys()
        numbers = ('mAEE', 'mpAEE', 'mMedEE')
        np.testing.assert_allclose([got[k] for k in numbers],
                                   [want[k] for k in numbers], rtol=1e-5)
        for key in got.keys() - set(numbers) - {'windows'}:
            assert got[key] == want[key], key
        assert [(w['start'], w['stop'], w['n_points'])
                for w in got['windows']] == \
            [(w['start'], w['stop'], w['n_points'])
             for w in want['windows']]


def test_process_all_aggregates_tb(raw_sequence, weights, tmp_path,
                                   monkeypatch):
    from dvs_of_training_framework_tpu_torch.utils.tb import read_events

    ds_dir, t0 = raw_sequence
    root = tmp_path / 'root'
    (root / 'raw').mkdir(parents=True)
    (root / 'raw' / 'mini').symlink_to(ds_dir)
    (root / 'info').mkdir()
    with h5py.File(root / 'info' / 'mini.hdf5', 'w') as f:
        f.create_dataset('set_name', data=np.array([b'mini_seq1']))
        f.create_dataset('start_time', data=np.array([t0]))
    cfg_path = tmp_path / 'cfg.json'
    cfg_path.write_text('{"mini": {"mini_seq1": {"step": [1], "start": 0.2, '
                        '"stop": 1.0, "test_shape": [48, 48], "crop_type": '
                        '"central", "is_car": false}}}')
    monkeypatch.setenv('DVS_DATA_ROOT', str(root))
    run = tmp_path / 'run'
    ser = Serializer(run)
    for step in (1, 2):
        ser.checkpoint_model(weights, {}, global_step=step,
                             samples_passed=4 * step + 1)
    out = tmp_path / 'out'
    args = SimpleNamespace(model=run, output=out, test_config=cfg_path,
                           tests_per_device=1, bs=4, device='cpu',
                           eval_batch_windows=4, **MODEL_ARGS)
    port_cli.process_all(args)
    assert (out / 'step_1.pkl').is_file() and (out / 'step_2.pkl').is_file()
    steps = {}
    for path in (out / 'log').glob('events.out.tfevents.*'):
        for event in read_events(path):
            for tag in event['scalars']:
                steps.setdefault(tag.split('/')[1], set()).add(event['step'])
    assert steps == {'mean AEE': {5, 9}, 'mean %AEE': {5, 9}}
