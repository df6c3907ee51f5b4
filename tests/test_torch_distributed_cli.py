"""The port's training CLI on two ranks on the CPU (gloo).

Mirrors the JAX package's tests/training/test_multihost.py with the
port's two ways to start ranks: ``train.main(['--mesh', 'data:2', ...])``,
which spawns its two workers, and two processes started with the
multi-host flags (``--coordinator-address``, ``--num-processes``,
``--process-id``); each over the raw fixture split (each data rank draws
its own samples) and over preprocessed shards (strided reads and the
``ShardedBatchSkipper``).  DummyFlowNet at 64x64, global batch 4.  Every
run holds test_multihost.py:54-70's checks: the final checkpoint,
``samples_passed`` counted globally (4 a step), provenance written, and
no TensorBoard file of rank 1.  Over the shards, a run cut at step 2 and
resumed equals the uninterrupted run to step 3 bit for bit, and so do
the two launchers' runs.  Every group of processes runs under one
wall-clock limit (``tests/torch_procs.py``).
"""
import json
import re
from types import SimpleNamespace

import pytest
import torch

from dvs_of_training_framework_tpu_torch.parallel.distributed import \
    free_port
from dvs_of_training_framework_tpu_torch.tools import prepare_batches
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from tests import torch_procs
from tests.helpers import data_path

MAIN = ('import json, sys\n'
        'from dvs_of_training_framework_tpu_torch import train\n'
        'print("RESULT", json.dumps(train.main(sys.argv[1:])))\n')
ARGV = ['-d', 'cpu', '-bs', '4', '-mbs', '4', '--num_workers', '0',
        '--height', '64', '--width', '64', '-cl', '1', '--flownet_path',
        'DummyFlowNet', '--optimizer', 'ADAM', '--checkpointing_interval',
        '1', '--permanent_interval', '1', '--event-capacity', '16384',
        '-vp', '2', '--device-queue-window', '1']
# run: (launcher, over the shards, steps)
RUNS = {'mesh_raw': ('mesh', False, 2), 'hosts_raw': ('hosts', False, 2),
        'mesh_shards': ('mesh', True, 3), 'hosts_shards': ('hosts', True, 3),
        'mesh_cut': ('mesh', True, 2)}


def commands(run_dir, launcher, extra):
    argv = ['-m', str(run_dir)] + ARGV + extra
    if launcher == 'mesh':
        return [torch_procs.python('-c', MAIN, *argv, '--mesh', 'data:2')]
    address = f'127.0.0.1:{free_port()}'
    return [torch_procs.python('-c', MAIN, *argv, '--coordinator-address',
                               address, '--num-processes', '2',
                               '--process-id', rank) for rank in (0, 1)]


def records(outputs):
    """The per-rank records that ``main`` returned, in rank order."""
    found = [r for out in outputs
             for line in out.splitlines() if line.startswith('RESULT ')
             for r in json.loads(line[len('RESULT '):])]
    return sorted(found, key=lambda r: r['rank'])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('ranks')
    mvsec = root / 'mvsec'
    mvsec.mkdir()
    for split in ('outdoor_day1', 'outdoor_day2'):
        (mvsec / split).symlink_to(data_path)
    environ = torch_procs.env(DVS_DATA_PATH=str(mvsec))
    shards = root / 'shards'
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv('DVS_DATA_PATH', str(mvsec))
        prepare_batches.main(prepare_batches.parse_args(
            ['-o', str(shards), '-s', '16', '--samples-per-file', '4',
             '--height', '64', '--width', '64', '-mbs', '4',
             '--num_workers', '0']))

    def extra(over_shards, steps):
        return ['-ne', str(steps)] + (
            ['--preprocessed-dataset-path', str(shards)] if over_shards
            else [])

    groups = {name: commands(root / name, launcher, extra(shards_, steps))
              for name, (launcher, shards_, steps) in RUNS.items()}
    all_commands = [c for cmds in groups.values() for c in cmds]
    outputs = iter(torch_procs.run_group(all_commands, root / 'logs',
                                         timeout=300, environ=environ))
    results = {name: [next(outputs) for _ in cmds]
               for name, cmds in groups.items()}
    # the cut run resumes from its step 2 to step 3
    results['mesh_resumed'] = torch_procs.run_group(
        commands(root / 'mesh_cut', 'mesh',
                 extra(True, 3) + ['--allow-arguments-change']),
        root / 'logs_resume', timeout=180, environ=environ)
    return SimpleNamespace(root=root, outputs=results)


@pytest.mark.parametrize('name', ['mesh_raw', 'hosts_raw', 'mesh_shards',
                                  'hosts_shards'])
def test_two_ranks_train_through_main(runs, name):
    steps = RUNS[name][2]
    run_dir = runs.root / name
    outputs = runs.outputs[name]
    ranks = records(outputs)
    assert [r['rank'] for r in ranks] == [0, 1]
    assert all(r['step'] == steps and r['samples_passed'] == 4 * steps
               and r['device'] == 'cpu' for r in ranks)
    assert sum(out.count('torch.distributed: gloo backend, 2 ranks')
               for out in outputs) == 1
    serializer = Serializer(run_dir)
    assert serializer.list_known_steps() == list(range(steps + 1))
    state = serializer.read_state_dict(steps)
    # global samples: `steps` optimizer steps of global batch 4
    assert int(state['samples_passed']) == 4 * steps
    assert (run_dir / 'parameters').is_file()
    # one writer: rank 0's logger and its monitor; nothing of rank 1
    files = [p.name for p in (run_dir / 'log').glob('events.out.tfevents.*')]
    assert files
    pids = {re.search(r'\.(\d+)\.0(\.monitor)?$', f).group(1) for f in files}
    assert pids == {str(ranks[0]['pid'])}, files


def model_state(run_dir, step):
    return Serializer(run_dir).read_state_dict(step)['model']


def test_two_ranks_resume_to_the_uninterrupted_run(runs):
    assert 'Flushed logs for step 3 (12 passed)' in \
        runs.outputs['mesh_resumed'][0]
    whole = model_state(runs.root / 'mesh_shards', 3)
    resumed = model_state(runs.root / 'mesh_cut', 3)
    assert whole.keys() == resumed.keys()
    assert all(torch.equal(whole[k], resumed[k]) for k in whole)
    assert any(not torch.equal(whole[k], v)
               for k, v in model_state(runs.root / 'mesh_shards', 0).items())


def test_two_launchers_train_alike(runs):
    mesh = model_state(runs.root / 'mesh_shards', 3)
    hosts = model_state(runs.root / 'hosts_shards', 3)
    assert all(torch.equal(mesh[k], hosts[k]) for k in mesh)
