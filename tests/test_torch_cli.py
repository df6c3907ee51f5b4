"""The port's training CLI,
``python -m dvs_of_training_framework_tpu_torch.train``.

Mirrors the JAX package's tests/training/test_cli.py (end to end, resume,
the guard against changed arguments) with the same fixture layout, on the
CPU, with the port's EVFlowNet at 64x64, batch 2, two steps; and adds
``--ema-decay`` with ``finalize``, the flags of the ported items 10-14
accepted (sequences, plugins, dense mode, the timers, the profiler, a
mesh and the multi-host flags), the refusal of a mesh the batch or the
dense mode cannot take, the refusal of ``-d cuda`` without a card, and
one ignored TPU-only flag that logs its line.  The runs take the device
queue with windows of 1 step (the cadence of their checkpoints), and a
mesh with windows logs that its ranks stage their own, run by the
backend's rule, and that its validation runs per batch.
"""
import os
from pathlib import Path

import pytest
import torch

from dvs_of_training_framework_tpu_torch import train as cli
from dvs_of_training_framework_tpu_torch.models import init_model
from dvs_of_training_framework_tpu_torch.training.serializer import (
    Serializer, read_params_file)
from tests.helpers import data_path

REPO = Path(__file__).resolve().parents[1]
BASE = ['-d', 'cpu', '-bs', '2', '-mbs', '2', '-ne', '2',
        '--num_workers', '0', '--height', '64', '--width', '64', '-cl', '1',
        '--optimizer', 'ADAM', '--event-capacity', '4096']


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CLI trains the full-width model on the CPU.  One intra-op
    thread keeps it from oversubscribing the cores that parallel test
    workers share, which slowed this file more than tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def mvsec_layout(tmp_path):
    """Fixture data arranged as the expected MVSEC split directories."""
    root = tmp_path / 'mvsec'
    root.mkdir()
    (root / 'outdoor_day2').symlink_to(data_path)
    (root / 'outdoor_day1').symlink_to(data_path)
    return root


def run_cli(tmp_path, mvsec_layout, extra=()):
    model_dir = tmp_path / 'model'
    # a window that divides the cadence of 1: every step one fused window
    argv = ['-m', str(model_dir), '--flownet_path', str(REPO / 'EVFlowNet'),
            '--checkpointing_interval', '1', '--permanent_interval', '1',
            '-vp', '1', '--device-queue-window', '1'] + BASE + list(extra)
    os.environ['DVS_DATA_PATH'] = str(mvsec_layout)
    try:
        cli.main(argv)
    finally:
        os.environ.pop('DVS_DATA_PATH', None)
    return model_dir


def test_train_cli_end_to_end(tmp_path, mvsec_layout):
    model_dir = run_cli(tmp_path, mvsec_layout)
    assert torch.backends.cudnn.deterministic    # resumes repeat exactly
    assert (model_dir / 'parameters').is_file()
    ser = Serializer(model_dir)
    assert ser.list_known_steps() == [0, 1, 2]
    assert any((model_dir / 'log').glob('events.out.tfevents.*'))
    state = ser.read_state_dict(2)
    assert int(state['samples_passed']) == 4
    assert state['optimizer']['groups']['predictor']['count'] == 2
    # trained: the weights moved from step 0's
    start = ser.read_state_dict(0)['model']
    assert any(not torch.equal(start[k], v)
               for k, v in state['model'].items())


def test_train_cli_resumes(tmp_path, mvsec_layout):
    run_cli(tmp_path, mvsec_layout)
    first = Serializer(tmp_path / 'model').read_state_dict(2)
    # a second run resumes from step 2 and has nothing left to do
    model_dir = run_cli(tmp_path, mvsec_layout)
    state = Serializer(model_dir).read_state_dict(2)
    assert int(state['samples_passed']) == 4
    assert all(torch.equal(first['model'][k], v)
               for k, v in state['model'].items())
    # a longer run resumes at step 2, sample 4, and goes on to step 3
    run_cli(tmp_path, mvsec_layout,
            extra=['-ne', '3', '--allow-arguments-change'])
    state = Serializer(model_dir).read_state_dict(3)
    assert int(state['samples_passed']) == 6
    assert state['optimizer']['groups']['predictor']['count'] == 3


def test_train_cli_guards_argument_change(tmp_path, mvsec_layout):
    run_cli(tmp_path, mvsec_layout)
    with pytest.raises(AssertionError, match='argument'):
        run_cli(tmp_path, mvsec_layout, extra=['-lr', '0.9'])
    # explicit override allows it
    run_cli(tmp_path, mvsec_layout,
            extra=['-lr', '0.9', '--allow-arguments-change'])


def test_train_cli_ema_finalize(tmp_path, mvsec_layout):
    model_dir = run_cli(tmp_path, mvsec_layout,
                        extra=['--ema-decay', '0.9', '--skip-validation'])
    serializer = Serializer(model_dir)
    step = serializer.list_known_steps()[-1]
    serializer.finalize(step, tmp_path / 'ema.ckpt', use_ema=True)
    serializer.finalize(step, tmp_path / 'live.ckpt')
    ema = read_params_file(tmp_path / 'ema.ckpt')
    live = read_params_file(tmp_path / 'live.ckpt')
    assert ema.keys() == live.keys()
    saved = serializer.read_state_dict(step)['optimizer']['ema_params']
    assert all(torch.equal(ema[k], saved[k]) for k in ema)
    # after 2 steps at decay .9 the EMA differs from the live weights
    assert any(not torch.equal(ema[k], live[k]) for k in ema)
    args = cli.parse_args(['-m', str(model_dir)] + BASE)
    model = init_model(args, torch.device('cpu'))
    model.load_state_dict(ema, strict=True)


@pytest.mark.parametrize('flags', [
    ['--flownet_path', str(REPO / 'DummyFlowNet')],
    ['--flownet_path', 'RecurrentFlowNet', '--max-sequence-length', '2'],
    ['--max-sequence-length', '3', '--prefix-length', '1',
     '--suffix-length', '1'],
    ['--max-sequence-length', '2', '--dynamic-sample-length'],
    ['--mish'],
    ['--ev_images'],
    ['--timers'],
    ['--profiling', 'JAX'],
    ['--mesh', 'data:2'],
    ['--num-processes', '2'],
])
def test_train_cli_accepts_ported_flags(tmp_path, flags):
    args = cli.parse_args(['-m', str(tmp_path)] + BASE + flags)
    model = init_model(args, torch.device('cpu'))
    assert model.max_sequence_length == args.max_sequence_length
    assert cli.pad_sequence_length(args) == (
        args.max_sequence_length if args.dynamic_sample_length else None)
    assert args.is_raw == ('--ev_images' not in flags)
    assert (cli.make_event_image_fn(args) is None) == args.is_raw
    mesh = cli.mesh_of(args)
    if '--mesh' in flags or '--num-processes' in flags:
        # two data shards of one rank each: by --mesh, or by default
        # over the multi-host flags' processes
        assert (mesh.data, mesh.event, mesh.size) == (2, 1, 2)
    else:
        assert mesh is None


@pytest.mark.parametrize('flags, match', [
    (['--mesh', 'data:3'], 'not divisible'),
    (['--mesh', 'foo:2'], 'axis "foo"'),
    (['--mesh', 'data:1,event:2', '--ev_images'], 'requires raw events'),
])
def test_train_cli_refuses_a_mesh_it_cannot_shard(tmp_path, flags, match):
    with pytest.raises(ValueError, match=match):
        cli.parse_args(['-m', str(tmp_path)] + BASE + flags)


def test_train_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = cli.parse_args(['-m', str(tmp_path), '-bs', '2', '-mbs', '2'])
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.resolve_device(args.device)


def test_train_cli_ignores_tpu_only_flag(tmp_path, capsys):
    args = cli.parse_args(['-m', str(tmp_path)] + BASE
                          + ['--wire-events', 'pooled'])
    assert args.wire_events == 'pooled'
    lines = capsys.readouterr().out.splitlines()
    assert lines == ['--wire-events pooled: a TPU-only option, ignored']


@pytest.mark.parametrize('flags, lines', [
    (['--device-queue-window', '4'], []),
    (['--mesh', 'data:2', '--device-queue-window', '4'],
     ['--device-queue-window 4 on a mesh: each rank stages its own windows, '
      'run as the backend\'s rule says (printed beside the backend)',
      '--validation-window 8: validation on a mesh runs per batch']),
    (['--mesh', 'data:2', '--device-queue-window', '0',
      '--validation-window', '0'], []),
])
def test_train_cli_logs_the_windows_on_a_mesh(tmp_path, capsys, flags,
                                              lines):
    """The windows are no TPU-only option; on a mesh a training window
    says in one line how it runs, and a validation window in another
    that validation stays per batch."""
    args = cli.parse_args(['-m', str(tmp_path)] + BASE + flags)
    assert args.device_queue_window == int(flags[flags.index(
        '--device-queue-window') + 1])
    assert capsys.readouterr().out.splitlines() == lines
