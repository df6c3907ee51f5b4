"""The port stands without JAX, and its kernel wrappers route by device.

Both subprocess checks below run in a fresh interpreter where jax, flax,
optax, h5py, yaml, psutil, tqdm, msgpack and PIL cannot be imported (the
card's machine lacks them, or may), and fail if any module of the JAX package
(``dvs_of_training_framework_tpu``, the port aside) or of the repo's root
plugin packages (``EVFlowNet``, ``RecurrentFlowNet``, ``DummyFlowNet``,
which import flax) was loaded:

- importing every module of the port (``parallel/`` and the timers,
  profiler, monitor, logger and iterable timing of ``utils/`` among them)
  and running one CPU training step of the golden configuration and one
  of the bf16 recipe, then one of RecurrentFlowNet on 2-element samples;
- the training CLI's ``run`` training 2 steps on the CPU from an in-memory
  loader, checkpointing, and a second ``run`` resuming and taking a third,
  with the device queue's windows of one step (``--device-queue-window
  1``, the checkpoints' cadence) and windowed validation;
- the whole data path and both CLIs' ``main``: the port's tools build a
  tiny synthetic set in the npy store (raw ``varied`` sequences, their
  per-element files, encoded shards), the training CLI's ``main`` trains
  2 steps on the shards in windows of one step with validation on a raw
  split, checkpointing, and a second ``main`` resumes and takes a third
  the same way; then the evaluation
  CLI's ``main`` scores the EMA of the last checkpoint; the bake tool
  bakes that checkpoint's representation into dense shards, and
  ``main`` trains a step on them with ``--ev_images``; then
  ``main`` trains RecurrentFlowNet (``--flownet_path RecurrentFlowNet``)
  a step on the raw split's 2-element samples; the visualize CLI's
  ``main`` renders the raw validation split with the last checkpoint and
  a spawned writer, which runs the script's top level too and reports
  what it loaded; then the zero-flow and oracle baselines, the AEE
  table, the log repair, the info file and the loader's timing.
- the evaluation CLI's ``build_test_matrix``, ``sequence2samples`` and
  both baselines with no config given: each reads its default, the JSON
  twin of ``config/testing.yml`` or ``config/training_datasets.yml`` in
  the package's ``config/``, and then stops at the data, which is absent;
- ``train.main(['--mesh', 'data:2', ...])`` spawning two gloo workers
  that train a step and validate sharded; the script is a file, so the
  spawned workers run its top level, install the same block and report
  what they loaded when they exit.
- CPU tensors go to the plain twins and leave the launch counters alone.
- On a CUDA card (tests marked ``cuda``; they skip without one) each
  kernel agrees with its twin: K1 forward 1e-5 and backward 1e-6, with
  bf16 weights forward 1e-5 and a bf16 backward, K2 forward 2e-6 and its
  seven gradients 1e-5 * scale, the tolerances of the JAX package's
  tests/ops/test_voxel_pallas.py and tests/ops/test_kernel_mlp.py; K3's
  corners exactly (a gather is exact), the fused warp's values at 1e-5
  and its grid gradient at 1e-4 (tests/ops/test_warp_parity.py).  This
  file imports no JAX, so on a machine without it run ``python -m pytest
  --noconftest tests/test_torch_no_jax.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu_torch.ops import (kernel_mlp_cuda,
                                                     voxel_cuda, warp,
                                                     warp_cuda)

REPO = Path(__file__).resolve().parents[1]

# imports fail for these; the scripts print what of them and of the JAX
# package was loaded
BLOCK = r'''
import sys
BLOCKED = ('jax', 'flax', 'optax', 'h5py', 'yaml', 'psutil', 'tqdm',
           'msgpack', 'PIL')
for name in BLOCKED:
    sys.modules[name] = None          # import fails


def loaded():
    watched = BLOCKED + ('dvs_of_training_framework_tpu', 'EVFlowNet',
                         'RecurrentFlowNet', 'DummyFlowNet')
    return sorted(m for m in sys.modules if sys.modules[m] is not None
                  and m.split('.')[0] in watched)
'''

STEP = BLOCK + r'''
import importlib, pkgutil, types
import numpy as np, torch
import dvs_of_training_framework_tpu_torch as port
walked = set()
for info in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):
    importlib.import_module(info.name)
    walked.add(info.name[len(port.__name__) + 1:])
assert {'parallel.mesh', 'parallel.distributed', 'utils.timer',
        'utils.monitor', 'utils.profiling', 'utils.performance',
        'utils.logging', 'utils.visualization', 'visualize',
        'tools.zero_flow_baseline', 'tools.oracle_flow_baseline',
        'tools.aee_table', 'tools.fix_events', 'tools.profile_dataset',
        'tools.make_info'} <= walked, walked
from dvs_of_training_framework_tpu_torch.data import pad_batch
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import Model
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_train_step)

rng = np.random.default_rng(0)
B, H, W, n = 2, 16, 16, 60
collated = {
    'events': {'x': rng.integers(0, W, n), 'y': rng.integers(0, H, n),
               'timestamp': rng.uniform(0, 0.04, n),
               'polarity': rng.choice([-1.0, 1.0], n),
               'element_index': np.zeros(n, int),
               'sample_index': np.sort(rng.integers(0, B, n))},
    'timestamps': np.tile([0.0, 0.04], B),
    'sample_idx': np.repeat(np.arange(B), 2),
    'images': rng.uniform(0, 255, (2 * B, H, W)), 'size': B}
args = types.SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                             half_life=1e5, num_warmup_steps=0,
                             training_steps=10, rs=0.5)
shapes = [(H >> s, W >> s) for s in (3, 2, 1, 0)]
for dtype, bf16x2 in (('float32', False), ('bfloat16', True)):
    model = Model(event_representation_depth=3, base_channels=4,
                  dtype=dtype)
    evaluator = MultiScaleLoss(shapes, bf16x2=bf16x2)
    for loss in evaluator.losses:
        loss.use_mxu_warp = bf16x2
    step = make_train_step(model, evaluator,
                           construct_optimizer(args, model), [0.5, 1, 1], 1)
    state, (loss, _) = step(create_train_state(),
                            pad_batch(collated, 64).to('cpu'))
    assert state.step == 1 and torch.isfinite(loss)

# RecurrentFlowNet on 2-element samples
from dvs_of_training_framework_tpu_torch.models import recurrent_flownet
events = dict(collated['events'], element_index=(
    collated['events']['timestamp'] > 0.02).astype(int))
sequences = dict(collated, events=events,
                 timestamps=np.tile([0.0, 0.02, 0.04], B),
                 sample_idx=np.repeat(np.arange(B), 3),
                 images=rng.uniform(0, 255, (3 * B, H, W)))
model = recurrent_flownet.Model(max_sequence_length=2,
                                event_representation_depth=3,
                                base_channels=4, hidden_channels=4)
step = make_train_step(model, MultiScaleLoss(shapes),
                       construct_optimizer(args, model), [0.5, 1, 1], 1)
state, (loss, _) = step(create_train_state(),
                        pad_batch(sequences, 64).to('cpu'))
assert state.step == 1 and torch.isfinite(loss)
print('LOADED', loaded())
'''


LOOP = BLOCK + r'''
import tempfile
import numpy as np, torch
from dvs_of_training_framework_tpu_torch import train as cli
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from dvs_of_training_framework_tpu_torch.utils.tb import SummaryWriter

B, H, W = 2, 32, 32


def collated(seed):
    rng = np.random.default_rng(seed)
    n = 100
    return {
        'events': {'x': rng.integers(0, W, n), 'y': rng.integers(0, H, n),
                   'timestamp': rng.uniform(0, 0.04, n),
                   'polarity': rng.choice([-1.0, 1.0], n),
                   'element_index': np.zeros(n, int),
                   'sample_index': np.sort(rng.integers(0, B, n))},
        'timestamps': np.tile([0.0, 0.04], B),
        'sample_idx': np.repeat(np.arange(B), 2),
        'images': rng.uniform(0, 255, (2 * B, H, W)), 'size': B}


def stream(samples_passed):
    i = samples_passed // B
    while True:
        yield collated(i)
        i += 1


with tempfile.TemporaryDirectory() as out:
    for steps in (2, 3):
        args = cli.parse_args([
            '-m', out, '-d', 'cpu', '-bs', str(B), '-mbs', str(B),
            '-ne', str(steps), '--height', str(H), '--width', str(W),
            '--event-capacity', '128', '--checkpointing_interval', '1',
            '--permanent_interval', '1', '-vp', '2',
            '--device-queue-window', '1'])
        _, _, state, samples = cli.run(
            args, stream, lambda: [collated(100)],
            SummaryWriter(out + '/log'))
        assert (state.step, samples) == (steps, steps * B)
    assert Serializer(out).list_known_steps() == [0, 1, 2, 3]
print('LOADED', loaded())
'''


MAIN = BLOCK + r'''
import atexit
if __name__ == '__mp_main__':          # a spawned panel writer
    atexit.register(lambda: print('LOADED', loaded(), flush=True))
if __name__ == '__main__':
  import json, os, tempfile
  from pathlib import Path
  import numpy as np
  from dvs_of_training_framework_tpu_torch import test, train, visualize
  from dvs_of_training_framework_tpu_torch.data import synthetic
  from dvs_of_training_framework_tpu_torch.tools import (
      aee_table, fix_events, make_info, make_synthetic_mvsec,
      oracle_flow_baseline, prepare_batches, profile_dataset,
      quantize_preprocessed, sequence2samples, zero_flow_baseline)
  from dvs_of_training_framework_tpu_torch.training.serializer import \
      Serializer
  from dvs_of_training_framework_tpu_torch.utils.visualization import \
      read_png

  # cheaper textures, drawn by the simulator's own code
  scene, foreground = synthetic.make_scene, synthetic.make_foreground
  synthetic.make_scene = lambda rng, shape=synthetic.SCENE, \
      num_blobs=260: scene(rng, shape, max(num_blobs // 40, 1))
  synthetic.make_foreground = lambda rng, shape=synthetic.SCENE, \
      num_objects=28: foreground(rng, shape, 4)
  configs = Path(synthetic.__file__).parents[1] / 'config'

  with tempfile.TemporaryDirectory() as tmp:
      tmp = Path(tmp)
      root = tmp / 'synth'
      make_synthetic_mvsec.main([str(root), '--motion', 'varied', '--speed',
                                 '0.35', '--train-secs', '0.4', '--eval-secs',
                                 '0.25', '--val-secs', '0.25'])
      os.environ['DVS_DATA_ROOT'] = str(root)
      sequence2samples.main([str(configs / 'synth_train_datasets.json')])
      split = root / 'training' / 'synth'
      (split / 'outdoor_day2').symlink_to(split / 'outdoor_synth2')
      (split / 'outdoor_day1').symlink_to(split / 'outdoor_synth3')
      os.environ['DVS_DATA_PATH'] = str(split)
      shards = tmp / 'shards'
      prepare_batches.main(prepare_batches.parse_args([
          '-o', str(shards), '-s', '8', '--samples-per-file', '4',
          '--height', '32', '--width', '32', '-mbs', '2', '--num_workers',
          '0']))
      run = tmp / 'run'
      for steps in (2, 3):
          train.main(['-m', str(run), '-d', 'cpu', '-bs', '2', '-mbs', '2',
                      '-ne', str(steps), '--height', '32', '--width', '32',
                      '--num_workers', '0', '--event-capacity', '65536',
                      '--preprocessed-dataset-path', str(shards),
                      '--checkpointing_interval', '1',
                      '--permanent_interval', '1', '-vp', '2',
                      '--device-queue-window', '1',
                      '--ema-decay', '0.999', '--allow-arguments-change'])
      assert Serializer(run).list_known_steps() == [0, 1, 2, 3]
      config = json.loads((configs / 'synth_testing.json').read_text())
      config['synth']['outdoor_synth1'].update(step=[1, 2],
                                               test_shape=[32, 32])
      (tmp / 'testing.json').write_text(json.dumps(config))
      test.main(['-m', str(run), '-o', str(tmp / 'eval'), '-s', '3', '-d',
                 'cpu', '--use-ema', '--test-config',
                 str(tmp / 'testing.json')])
      assert (tmp / 'eval' / 'step_3_ema.pkl').is_file()
      # bake the run's representation, then train on the dense shards
      baked = tmp / 'baked'
      stats = quantize_preprocessed.main(quantize_preprocessed.parse_args([
          '-o', str(baked), '-d', 'cpu', '-s', '4', '--samples-per-file',
          '2', '-mbs', '2', '--height', '32', '--width', '32',
          '--num_workers', '0', '--preprocessed-dataset-path', str(shards),
          '--event-capacity', '65536', '-sp', str(run / 'step_3.ckpt')]))
      assert stats.samples == 4
      train.main(['-m', str(tmp / 'dense'), '-d', 'cpu', '-bs', '2', '-mbs',
                  '2', '-ne', '1', '--height', '32', '--width', '32',
                  '--num_workers', '0', '--event-capacity', '65536',
                  '--ev_images', '--preprocessed-dataset-path', str(baked),
                  '-sp', str(run / 'step_3.ckpt'), '-vp', '1'])
      assert Serializer(tmp / 'dense').list_known_steps() == [0, 1]
      train.main(['-m', str(tmp / 'recurrent'), '-d', 'cpu', '-bs', '2',
                  '-mbs', '2', '-ne', '1', '--height', '32', '--width', '32',
                  '--num_workers', '0', '--event-capacity', '65536',
                  '--flownet_path', 'RecurrentFlowNet',
                  '--min-sequence-length', '2', '--max-sequence-length', '2',
                  '-vp', '1'])
      assert Serializer(tmp / 'recurrent').list_known_steps() == [0, 1]
      # the visualize CLI over the raw validation split, then the tools
      panels = tmp / 'panels'
      visualize.choose_output_path = lambda args: (
          panels.mkdir(exist_ok=True), panels)[1]
      record = visualize.main([
          '-m', str(run), '-sp', str(run / 'step_3.ckpt'), '-d', 'cpu',
          '--height', '32', '--width', '32', '--num_workers', '0',
          '--event-capacity', '65536'], num_writers=1)
      assert record['panels'] == 5, record
      assert read_png(panels / '0004.png').shape == (80 + 32 + 48, 64, 3)
      zero_flow_baseline.main(['--test-config', str(tmp / 'testing.json')])
      oracle_flow_baseline.main(['--test-config',
                                 str(tmp / 'testing.json')])
      aee_table.main([str(tmp / 'eval')])
      fix_events.main([str(run / 'log')])
      make_info.main(root / 'raw' / 'synth', tmp / 'info' / 'synth.hdf5')
      profile_dataset.main(profile_dataset.parse_args([
          '--start', '1', '--num-iters', '2', '--num_workers', '0',
          '-mbs', '2', '--height', '32', '--width', '32']))
  print('LOADED', loaded())
'''


MESH = BLOCK + r'''
import atexit
if __name__ == '__mp_main__':          # a spawned worker of the mesh
    atexit.register(lambda: print('LOADED', loaded(), flush=True))
if __name__ == '__main__':
    import os, sys, tempfile
    from pathlib import Path
    from dvs_of_training_framework_tpu_torch import train
    with tempfile.TemporaryDirectory() as tmp:
        mvsec = Path(tmp) / 'mvsec'
        mvsec.mkdir()
        for split in ('outdoor_day1', 'outdoor_day2'):
            (mvsec / split).symlink_to(sys.argv[1])
        os.environ['DVS_DATA_PATH'] = str(mvsec)
        ranks = train.main(['-m', str(Path(tmp) / 'run'), '-d', 'cpu',
                            '-bs', '2', '-mbs', '2', '-ne', '1',
                            '--height', '32', '--width', '32',
                            '--num_workers', '0', '--event-capacity',
                            '16384', '-vp', '1', '--mesh', 'data:2'])
        assert [(r['rank'], r['step'], r['samples_passed'])
                for r in ranks] == [(0, 1, 2), (1, 1, 2)], ranks
    print('LOADED', loaded())
'''


def test_port_runs_a_step_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', STEP], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'LOADED []' in proc.stdout, proc.stdout


def test_loop_checkpoints_and_resumes_without_missing_packages():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', LOOP], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'LOADED []' in proc.stdout, proc.stdout


def test_main_builds_trains_resumes_and_evaluates_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = tmp_path / 'chain.py'
    script.write_text(MAIN)
    proc = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # the script and the visualize CLI's writer, each after its imports
    assert proc.stdout.count('LOADED []') == 2, proc.stdout
    assert 'LOADED [' not in proc.stdout.replace('LOADED []', ''), \
        proc.stdout


DEFAULTS = BLOCK + r'''
import json, os, sys, tempfile
from pathlib import Path
from dvs_of_training_framework_tpu_torch import test
from dvs_of_training_framework_tpu_torch.evaluation import read_config
from dvs_of_training_framework_tpu_torch.tools import (
    oracle_flow_baseline, sequence2samples, zero_flow_baseline)

read = []
def recording(path):
    read.append((str(path), read_config(path)))
    return read[-1][1]
test.read_config = sequence2samples.read_config = recording

with tempfile.TemporaryDirectory() as root:     # the config, and no data
    os.environ['DVS_DATA_ROOT'] = root
    for label, run in (('test', test.build_test_matrix),
                       ('sequence2samples', lambda: sequence2samples.main([])),
                       ('zero_flow_baseline', lambda: zero_flow_baseline.main([])),
                       ('oracle_flow_baseline',
                        lambda: oracle_flow_baseline.main([]))):
        try:
            run()
        except FileNotFoundError as missing:
            print('READ', json.dumps([label, *read.pop(), str(missing)]))
print('LOADED', loaded())
'''


def test_cli_defaults_read_json_without_yaml():
    """The evaluation CLI's matrix, ``sequence2samples``' time ranges and
    both baselines' matrix default to the JSON twins of
    ``config/{testing,training_datasets}.yml`` in the package's
    ``config/``: each reads its default with PyYAML blocked, then stops at
    the data, which is not there."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', DEFAULTS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'LOADED []' in proc.stdout, proc.stdout
    config = REPO / 'dvs_of_training_framework_tpu_torch' / 'config'
    reads = {label: (path, doc, missing) for label, path, doc, missing in (
        json.loads(line[5:]) for line in proc.stdout.splitlines()
        if line.startswith('READ '))}
    assert sorted(reads) == ['oracle_flow_baseline', 'sequence2samples',
                             'test', 'zero_flow_baseline'], proc.stdout
    for label, (path, doc, missing) in reads.items():
        name = 'training_datasets' if label == 'sequence2samples' \
            else 'testing'
        assert Path(path) == config / f'{name}.json'
        assert doc == json.loads(Path(path).read_text())
        assert 'info/mvsec.hdf5' in missing, missing


def test_mesh_ranks_train_without_jax(tmp_path):
    from dvs_of_training_framework_tpu_torch.data import store
    from tests.torch_procs import env, python, run_group
    # ten contiguous 50 ms elements of random events and frames, laid out
    # as tests/data/seq's, in the npy store: the script has no h5py
    rng = np.random.default_rng(5)
    split = tmp_path / 'seq'
    split.mkdir()
    for i in range(10):
        start, stop = 10 + 0.05 * i, 10 + 0.05 * (i + 1)
        n = 400
        events = np.stack([rng.integers(0, 346, n), rng.integers(0, 260, n),
                           np.sort(rng.uniform(start, stop, n)),
                           rng.choice([-1.0, 1.0], n)], axis=1)
        with store.open_file(split / f'{i:06d}.hdf5', 'w') as out:
            out.create_dataset('events', data=events)
            for name in ('image1', 'image2'):
                out.create_dataset(name, data=rng.integers(
                    0, 256, (260, 346)).astype(np.uint8))
            out.create_dataset('start', data=np.float64(start))
            out.create_dataset('stop', data=np.float64(stop))
    script = tmp_path / 'mesh_main.py'
    script.write_text(MESH)
    (out,) = run_group([python(script, split)], tmp_path / 'logs',
                       timeout=240, environ=env())
    # the parent and both spawned workers, each after its imports
    assert out.count('LOADED []') == 3, out
    assert 'LOADED [' not in out.replace('LOADED []', ''), out


def test_cpu_tensors_take_the_twins():
    rng = np.random.default_rng(0)
    E, C, P, H, W = 50, 3, 2, 4, 5
    x = torch.from_numpy(rng.integers(0, W, E).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, H, E).astype(np.int32))
    plane = torch.from_numpy(np.sort(rng.integers(0, P, E))
                             .astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(E, C)).astype(np.float32))
    valid = torch.arange(E) < 40
    delta = torch.from_numpy(rng.uniform(-1, 1, (C, E)).astype(np.float32))
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in [(1, 8), (8,), (8, 8), (8,), (8, 1), (1,)]]
    before = (dict(voxel_cuda.launches), dict(kernel_mlp_cuda.launches))
    assert torch.equal(voxel_cuda.voxelize(x, y, plane, w, valid, P, H, W),
                       voxel_cuda.plain(x, y, plane, w, valid, P, H, W))
    assert torch.equal(kernel_mlp_cuda.kernel_mlp(delta, *params),
                       kernel_mlp_cuda.plain(delta, *params))
    assert (voxel_cuda.launches, kernel_mlp_cuda.launches) == before


def test_cpu_frames_take_the_corner_twin():
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.normal(size=(2, 1, 6, 7))
                              .astype(np.float32))
    iy = torch.from_numpy(rng.uniform(-2, 8, (2, 30)).astype(np.float32))
    ix = torch.from_numpy(rng.uniform(-2, 9, (2, 30)).astype(np.float32))
    before = dict(warp_cuda.launches)
    assert torch.equal(warp_cuda.corner_values(images, iy, ix),
                       warp.corner_values(images, iy, ix))
    grid = torch.zeros(2, 3, 4, 2, requires_grad=True)
    warp.grid_sample_onehot(images, grid, True).sum().backward()
    assert warp_cuda.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
def test_voxelize_kernel_matches_twin(cuda):
    rng = np.random.default_rng(1)
    E, C, P, H, W = 20000, 9, 8, 64, 80
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(0, W, E).astype(np.int32),
        rng.integers(0, H, E).astype(np.int32),
        np.sort(rng.integers(0, P, E)).astype(np.int32),
        rng.normal(size=(E, C)).astype(np.float32),
        np.arange(E) < E - 999)]
    g = torch.randn(P, H, W, C, device=cuda)
    outs = []
    for fn in (voxel_cuda.voxelize, voxel_cuda.plain):
        w = args[3].clone().requires_grad_(True)
        grid = fn(*args[:3], w, args[4], P, H, W)
        grid.backward(g)
        outs.append((grid.detach(), w.grad))
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-6)
    assert not outs[0][1][E - 999:].any()


@pytest.mark.cuda
def test_kernel_mlp_kernel_matches_twin(cuda):
    rng = np.random.default_rng(2)
    hd = 30
    arrays = [rng.uniform(-1.2, 1.2, (9, 30001)),
              rng.normal(size=(1, hd)), 0.1 * rng.normal(size=hd),
              rng.normal(size=(hd, hd)) / np.sqrt(hd),
              0.1 * rng.normal(size=hd),
              rng.normal(size=(hd, 1)) / np.sqrt(hd),
              0.1 * rng.normal(size=1)]
    g = torch.randn(9, 30001, device=cuda)
    results = []
    for fn in (kernel_mlp_cuda.kernel_mlp, kernel_mlp_cuda.plain):
        ts = [torch.from_numpy(a.astype(np.float32)).to(cuda)
              .requires_grad_(True) for a in arrays]
        out = fn(*ts)
        out.backward(g)
        results.append((out.detach(), [t.grad for t in ts]))
    torch.cuda.synchronize()
    torch.testing.assert_close(results[0][0], results[1][0], rtol=2e-6,
                               atol=2e-6)
    for got, want in zip(results[0][1], results[1][1]):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
def test_voxelize_kernel_bf16_weights(cuda):
    rng = np.random.default_rng(3)
    E, C, P, H, W = 20000, 9, 8, 64, 80
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(0, W, E).astype(np.int32),
        rng.integers(0, H, E).astype(np.int32),
        np.sort(rng.integers(0, P, E)).astype(np.int32))]
    w = torch.from_numpy(rng.normal(size=(E, C)).astype(np.float32)) \
        .to(cuda).bfloat16()
    valid = torch.arange(E, device=cuda) < E - 999
    g = torch.randn(P, H, W, C, device=cuda)
    outs = []
    for fn in (voxel_cuda.voxelize, voxel_cuda.plain):
        wr = w.clone().requires_grad_(True)
        grid = fn(*args, wr, valid, P, H, W)
        grid.backward(g)
        outs.append((grid.detach(), wr.grad))
    torch.cuda.synchronize()
    assert outs[0][0].dtype == torch.float32
    assert outs[0][1].dtype == torch.bfloat16
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_corner_kernel_matches_twin(cuda):
    rng = np.random.default_rng(4)
    N, H, W = 8, 64, 48
    images = torch.from_numpy(rng.uniform(0, 255, (N, 1, H, W))
                              .astype(np.float32)).to(cuda)
    iy = rng.uniform(-3, H + 2, (N, H * W)).astype(np.float32)
    ix = rng.uniform(-3, W + 2, (N, H * W)).astype(np.float32)
    iy[:, :5] = [1e6, -1e6, np.nan, 3e9, -3e9]
    ix[:, 5:10] = [1e6, -1e6, np.nan, 3e9, -3e9]
    iy, ix = (torch.from_numpy(a).to(cuda) for a in (iy, ix))
    got = warp_cuda.corner_values(images, iy, ix)
    torch.cuda.synchronize()
    assert torch.equal(got, warp.corner_values(images, iy, ix))
    assert not got[:, :, :, :10].any()

    grid = torch.from_numpy(rng.uniform(-1.2, 1.2, (N, 20, 30, 2))
                            .astype(np.float32)).to(cuda)
    cot = torch.randn(N, 1, 20, 30, device=cuda)
    results = []
    for plain_ops in (False, True):
        g = grid.clone().requires_grad_(True)
        out = warp.grid_sample_onehot(images, g, True, plain_ops)
        (out * cot).sum().backward()
        results.append((out.detach(), g.grad))
    torch.cuda.synchronize()
    # the fused blend may round in another order than the twin's sum
    torch.testing.assert_close(results[0][0], results[1][0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(results[0][1], results[1][1], rtol=1e-4,
                               atol=1e-4)
