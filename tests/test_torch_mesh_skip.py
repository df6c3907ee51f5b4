"""Oversized batches on a mesh of two gloo ranks (``train.py``
``read_train``, ``parallel.agree_on_drops``).

DummyFlowNet at 32x32, global batch 4 (2 samples a data rank), on the
CPU, every group of processes under ``tests/torch_procs.py``'s limit.

- A resume over raw preprocessed shards read in order.  Sixteen
  1-element samples, 4 a shard, written here with numpy: every batch
  position's pieces hold 3,000 events but positions 1 and 3, where one
  rank's piece holds 4,500, over the 4,096 a shard that
  ``--event-capacity 8192`` gives each of two ranks.  Both ranks skip
  those positions from the shards' counts.  A run cut at step 1 (before
  the first skip) and one cut at step 2 (after it), each resumed to step
  4, equal the uninterrupted run bit for bit: every checkpoint's
  parameters, optimizer state and ``samples_passed``, and every logged
  scalar (a mesh logs no skip count).  Before the repair the resume read
  on at ``samples_passed``, which counts trained samples only, and
  trained position 2 twice.
- The same shards served out of order (a non-blocking ``--cache-dir``
  smaller than the set): each rank decodes its own piece, and the ranks
  drop a batch together when any piece overflows.  The two ranks print
  the same skip lines' count, at least one, and end; ``run`` holds the
  replicas equal bit for bit at its end (``check_replicas``).
- The raw loader over ``tests/data/seq`` at 64x64, each rank's stream
  seeded, at a capacity that one rank's 2-sample piece alone exceeds at
  some step: one batch at a time and in windows of 2.  Each rank logs
  the event count of every batch it reads; a batch is dropped on both
  ranks exactly when either rank's count exceeds the capacity, each rank
  reports those drops with its own counts, and at least one of them
  overflowed on one rank alone.

The JAX package's multi-process loop drops such a batch on the rank that
overflowed alone (ROADMAP, "Faults in the reference itself"), so no case
here is held against it.
"""
import json
import re

import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu_torch.data import codec
from dvs_of_training_framework_tpu_torch.data.preprocessed import (
    per_sample_event_counts, stream_position)
from dvs_of_training_framework_tpu_torch.data.sharding import ShardWriter
from dvs_of_training_framework_tpu_torch.parallel.distributed import \
    free_port
from tests import torch_procs
from tests.helpers import data_path
from tests.test_torch_skip import _leaves, scalars

SIZE, MBS, PER_FILE, HW = 16, 4, 4, 32
LIGHT, HOT = 1500, 3000
HOT_SAMPLES = (6, 12)         # position 1 on rank 1, position 3 on rank 0
CAPACITY = 8192               # 4096 a shard on two ranks
MAIN = ('import json, sys\n'
        'from dvs_of_training_framework_tpu_torch import train\n'
        'print("RESULT", json.dumps(train.main(sys.argv[1:])))\n')
# a rank of the multi-host launcher, its streams seeded by its rank
RANK = ('import json, random, sys\n'
        'import numpy as np\n'
        'rank = int(sys.argv[1])\n'
        'random.seed(rank)\n'
        'np.random.seed(rank)\n'
        'from dvs_of_training_framework_tpu_torch import train\n'
        '{}'
        'print("RESULT", json.dumps(train.main(sys.argv[2:])))\n')
# ... printing the events of every raw batch it reads
COUNT_READS = ('read = train.get_dataloader\n'
               'def counted(*args, **kwargs):\n'
               '    for batch in read(*args, **kwargs):\n'
               '        print("READ", batch["events"]["x"].size, '
               'flush=True)\n'
               '        yield batch\n'
               'train.get_dataloader = counted\n')
COMMON = ['-d', 'cpu', '-bs', str(MBS), '-mbs', str(MBS), '--num_workers',
          '0', '--flownet_path', 'DummyFlowNet', '--optimizer', 'ADAM',
          '--skip-validation', '--checkpointing_interval', '1',
          '--permanent_interval', '1', '--num_checkpoints', '100']
SHARDS = ['--height', str(HW), '--width', str(HW), '--event-capacity',
          str(CAPACITY)]
RAW_CAPACITY, RAW_STEPS = 40, 6


def make_sample(rng, events):
    """One collated 1-element sample of ``events`` events and two
    frames."""
    yy, xx = np.meshgrid(np.arange(HW), np.arange(HW), indexing='ij')
    phase = rng.uniform(0, 2 * np.pi)
    frames = [128 + 100 * np.sin((xx + k) / 3.0 + phase) * np.cos(yy / 5.0)
              for k in range(2)]
    return {'events': {'x': rng.integers(0, HW, events),
                       'y': rng.integers(0, HW, events),
                       'timestamp': np.sort(rng.uniform(0, 0.04, events))
                       .astype(np.float32),
                       'polarity': rng.choice([-1.0, 1.0], events),
                       'element_index': np.zeros(events, np.int64),
                       'sample_index': np.zeros(events, np.int64)},
            'timestamps': np.array([0.0, 0.04], np.float32),
            'sample_idx': np.zeros(2, np.int64),
            'images': np.stack(frames).astype(np.float32),
            'augmentation_params': {
                'idx': np.zeros(1, np.int64),
                'sequence_length': np.ones(1, np.int64),
                'collapse_length': np.ones(1, np.int64),
                'box': np.array([[0, 0, HW, HW]]),
                'angle': np.zeros(1), 'is_flip': np.zeros(1, bool)},
            'size': 1}


@pytest.fixture(scope='module')
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp('mesh_skip')
    mvsec = root / 'mvsec'
    mvsec.mkdir()
    for split in ('outdoor_day1', 'outdoor_day2'):
        (mvsec / split).symlink_to(data_path)
    shards = root / 'shards'
    shards.mkdir()
    writer = ShardWriter(shards, PER_FILE)
    rng = np.random.default_rng(0)
    for i in range(SIZE):
        writer.add(codec.encode_batch(**make_sample(
            rng, HOT if i in HOT_SAMPLES else LIGHT)))
    writer.flush()
    return root, mvsec, shards


def run(layout, commands, timeout=240):
    root, mvsec, _ = layout
    return torch_procs.run_group(
        commands, root / f'logs{free_port()}', timeout,
        environ=torch_procs.env(DVS_DATA_PATH=str(mvsec)))


def mesh_command(layout, run_dir, steps, extra=()):
    argv = ['-m', str(run_dir), '-ne', str(steps),
            '--preprocessed-dataset-path', str(layout[2]),
            '--device-queue-window', '1'] + COMMON + SHARDS + list(extra)
    return torch_procs.python('-c', MAIN, *argv, '--mesh', 'data:2')


def rank_commands(run_dir, argv, count_reads=False):
    address = f'127.0.0.1:{free_port()}'
    code = RANK.format(COUNT_READS if count_reads else '')
    return [torch_procs.python(
        '-c', code, rank, '-m', str(run_dir), *argv, '--coordinator-address',
        address, '--num-processes', '2', '--process-id', rank)
        for rank in (0, 1)]


def test_the_shards_skip_positions_1_and_3(layout):
    counts = per_sample_event_counts(layout[2])
    assert counts.tolist() == [HOT if i in HOT_SAMPLES else LIGHT
                               for i in range(SIZE)]
    # the rule of two data ranks: positions 0 and 2 are trained
    assert [stream_position(counts, MBS, CAPACITY // 2, kept, 2)
            for kept in (0, 4, 8, 12)] == [0, 4, 12, 20]
    # one rank's rule (the whole batch of 4) skips nothing here
    assert stream_position(counts, MBS, CAPACITY, 8) == 8


def assert_same_runs(got, want, steps):
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer
    got_s, want_s = Serializer(got), Serializer(want)
    assert got_s.list_known_steps() == want_s.list_known_steps() \
        == list(range(steps + 1))
    for step in range(steps + 1):
        a, b = got_s.read_state_dict(step), want_s.read_state_dict(step)
        assert int(a['samples_passed']) == int(b['samples_passed']) \
            == step * MBS
        for key, value in b['model'].items():
            assert torch.equal(a['model'][key], value), (step, key)
        flat_a, flat_b = dict(_leaves(a['optimizer'])), \
            dict(_leaves(b['optimizer']))
        assert flat_a.keys() == flat_b.keys()
        for key, value in flat_b.items():
            if isinstance(value, torch.Tensor):
                assert torch.equal(flat_a[key], value), (step, key)
            else:
                assert flat_a[key] == value, (step, key)
    assert scalars(got) == scalars(want)


def test_a_resumed_mesh_repeats_the_uninterrupted_run(layout, tmp_path):
    steps = 4
    cuts = {'before_a_skip': 1, 'after_a_skip': 2}
    run(layout, [mesh_command(layout, tmp_path / 'whole', steps)]
        + [mesh_command(layout, tmp_path / name, at)
           for name, at in cuts.items()])
    run(layout, [mesh_command(layout, tmp_path / name, steps,
                              ['--allow-arguments-change'])
                 for name in cuts])
    for name in cuts:
        assert_same_runs(tmp_path / name, tmp_path / 'whole', steps)


def record(output):
    line, = re.findall(r'^RESULT (.*)$', output, re.M)
    rank_record, = json.loads(line)
    return rank_record


def skips(output):
    return [int(n) for n in re.findall(r'^Skipping batch with (\d+) events',
                                       output, re.M)]


def test_ranks_drop_together_a_stream_served_out_of_order(layout,
                                                          tmp_path):
    steps = 8
    argv = ['-ne', str(steps), '--preprocessed-dataset-path',
            str(layout[2]), '--cache-dir', str(tmp_path / 'cache'),
            '--cache-size', '1', '--device-queue-window', '2'] \
        + COMMON + SHARDS
    outputs = run(layout, rank_commands(tmp_path / 'run', argv))
    counts = [len(skips(out)) for out in outputs]
    assert counts[0] == counts[1] >= 1, counts
    for out in outputs:
        assert record(out)['step'] == steps
        assert record(out)['samples_passed'] == steps * MBS


@pytest.fixture(scope='module')
def raw_runs(layout, tmp_path_factory):
    root = tmp_path_factory.mktemp('raw_mesh')
    argv = ['-ne', str(RAW_STEPS), '--height', '64', '--width', '64',
            '-cl', '1', '--event-capacity', str(RAW_CAPACITY)] + COMMON
    commands = []
    for window in (0, 2):
        commands += rank_commands(root / f'w{window}', argv + [
            '--device-queue-window', str(window)], count_reads=True)
    outputs = run(layout, commands)
    return {0: outputs[:2], 2: outputs[2:]}


@pytest.mark.parametrize('window', [0, 2])
def test_ranks_drop_together_over_the_raw_loader(raw_runs, window):
    outputs = raw_runs[window]
    reads = [[int(n) for n in re.findall(r'^READ (\d+)', out, re.M)]
             for out in outputs]
    # the batches consumed: up to the one that completed the last step
    kept, dropped, i = 0, [], 0
    while kept < RAW_STEPS:
        over = [r[i] > RAW_CAPACITY for r in reads]
        if any(over):
            dropped.append((i, over))
        else:
            kept += 1
        i += 1
    for rank, out in enumerate(outputs):
        assert skips(out) == [reads[rank][j] for j, _ in dropped], rank
        assert record(out)['step'] == RAW_STEPS
        assert record(out)['samples_passed'] == RAW_STEPS * MBS
    # at least one batch overflowed on one rank alone
    assert any(sum(over) == 1 for _, over in dropped), dropped
