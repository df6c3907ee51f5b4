"""The oversized-batch skip from the shards' recorded event counts on one
rank (``train.py`` ``read_train``: ``parallel.ShardedBatchSkipper`` at one
shard, reporting its skips to the loop).

Eleven 2-element samples of ``tests/data/seq`` at 32x32, written by the
port's ``tools.prepare_batches`` (an npy store) and by the JAX package's
``scripts/prepare_batches.py`` (HDF5), from the same seeds; batches of 2,
so that one batch position of the eleven straddles the epoch's wrap.

- At every batch position of two epochs, the skipper decides what
  decoding the batch and padding it to the capacity decides
  (``pad_batch`` raising ``OverflowError``), over both writers' shards,
  and the batches it serves are the decoded ones.
- ``train.main()`` with the metadata skip against the same run over the
  bare reader (decode, then skip): the losses, the skip lines, the
  ``General/skipped batches`` scalars and every checkpoint equal bit for
  bit, one batch at a time (``--device-queue-window 0``) and with the
  default windows.
- The port's ``train()`` over the metadata skip against the JAX package's
  one-process ``train()`` over its own reader of the same HDF5 shards
  (RecurrentFlowNet at depth 3, base 4): skip counts equal, the logged
  values at tests/test_torch_train_loop.py's rtol 1e-5.
- A run cut at a checkpoint and resumed, both ways, before and after a
  skip: the resumed runs equal each other and the uninterrupted run bit
  for bit.  A checkpoint's ``samples_passed`` counts trained samples
  only, so the reader resumes at ``stream_position``, the batch after
  the last one trained, where the JAX package reads again what the run
  had skipped.  ``stream_position`` against the skipper's own walk.
- A stream served out of order (a non-blocking cache) is decoded, then
  skipped; an ordered one, cached or not, is skipped unread.
- A stream whose every batch position overflows raises; it does not spin.
- ``tools.loss_summary`` over a run's log.
"""
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu_torch import train as train_cli
from dvs_of_training_framework_tpu_torch.data.dataloader import \
    get_dataloader
from dvs_of_training_framework_tpu_torch.data.preprocessed import (
    per_sample_event_counts, stream_position)
from dvs_of_training_framework_tpu_torch.data.schema import (SKIPPED_EVENTS,
                                                             pad_batch)
from dvs_of_training_framework_tpu_torch.parallel import ShardedBatchSkipper
from dvs_of_training_framework_tpu_torch.tools import (loss_summary,
                                                       prepare_batches)
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from dvs_of_training_framework_tpu_torch.utils.tb import read_events
from tests.helpers import data_path

SIZE, MBS = 11, 2
SEQUENCE = ['--min-sequence-length', '2', '--max-sequence-length', '2']


def write_shards(module, out):
    random.seed(5)
    np.random.seed(5)
    module.main(module.parse_args(
        ['-o', str(out), '-s', str(SIZE), '--samples-per-file', '4',
         '--height', '32', '--width', '32', '-mbs', '1',
         '--num_workers', '0'] + SEQUENCE))


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp('skip')
    mvsec = root / 'mvsec'
    mvsec.mkdir()
    for split in ('outdoor_day1', 'outdoor_day2'):
        (mvsec / split).symlink_to(data_path)
    out = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv('DVS_DATA_PATH', str(mvsec))
        write_shards(prepare_batches, root / 'port')
        out['port'] = root / 'port'
        try:
            import h5py  # noqa: F401
            import scripts.prepare_batches as jax_prepare
        except ImportError:
            pass
        else:
            write_shards(jax_prepare, root / 'jax')
            out['jax'] = root / 'jax'
    return SimpleNamespace(root=root, mvsec=mvsec, paths=out)


def position_events(path):
    """The recorded events of the batch at each of the stream's SIZE
    batch positions (the stream wraps)."""
    counts = per_sample_event_counts(path)
    return [int(counts[[(p + k) % SIZE for k in range(MBS)]].sum())
            for p in range(0, MBS * SIZE, MBS)]


def middle_capacity(path):
    """A capacity that some batch positions fit and others overflow."""
    sums = sorted(set(position_events(path)))
    capacity = sums[len(sums) // 2]
    assert min(sums) <= capacity < max(sums)
    return capacity


def reader(path, sample_idx=0):
    params = SimpleNamespace(preprocessed_dataset_path=path, batch_size=MBS,
                             is_raw=True, cache_dir=None, cache_size=0)
    return get_dataloader(params, sample_idx=sample_idx)


def test_the_shards_record_what_is_read(shards):
    for path in shards.paths.values():
        loader = reader(path)
        got = [int(next(loader)['events']['x'].size) for _ in range(SIZE)]
        assert got == position_events(path)
    if 'jax' in shards.paths:
        np.testing.assert_array_equal(
            per_sample_event_counts(shards.paths['jax']),
            per_sample_event_counts(shards.paths['port']))


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('where', ['low', 'middle', 'high'])
def test_skipper_decides_as_the_pad(shards, writer, where):
    if writer not in shards.paths:
        pytest.skip('h5py is not installed: no shards of the JAX package')
    path = shards.paths[writer]
    sums = sorted(set(position_events(path)))
    capacity = {'low': sums[0], 'middle': middle_capacity(path),
                'high': sums[-1] - 1}[where]
    bare = reader(path)
    skipper = iter(ShardedBatchSkipper(
        reader(path), per_sample_event_counts(path), global_batch=MBS,
        n_shards=1, capacity_per_shard=capacity, report_skips=True))
    decisions = []
    for position in range(2 * SIZE):    # two epochs: every position twice
        decoded = next(bare)
        try:
            pad_batch(decoded, capacity)
            overflows = False
        except OverflowError:
            overflows = True
        served = next(skipper)
        decisions.append(overflows)
        if overflows:
            assert served == {SKIPPED_EVENTS: decoded['events']['x'].size,
                              'sample': position * MBS % SIZE}
            continue
        assert SKIPPED_EVENTS not in served
        for key in ('timestamps', 'sample_idx', 'images'):
            np.testing.assert_array_equal(served[key], decoded[key])
        for key, value in decoded['events'].items():
            np.testing.assert_array_equal(served['events'][key], value)
    assert any(decisions) and not all(decisions)


# --- train.main() ----------------------------------------------------------

@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def main(shards, run, steps, capacity, window, decode, extra=()):
    """``train.main()`` on the CPU over the port's shards; ``decode``
    reads every batch (the bare reader) instead of skipping unread."""
    argv = ['-m', str(run), '-d', 'cpu', '-bs', str(MBS), '-mbs', str(MBS),
            '-ne', str(steps), '--height', '32', '--width', '32',
            '--num_workers', '0', '--event-capacity', str(capacity),
            '--flownet_path', 'RecurrentFlowNet',
            '--preprocessed-dataset-path', str(shards.paths['port']),
            '--checkpointing_interval', '2', '--permanent_interval', '2',
            '--num_checkpoints', '100', '--skip-validation',
            '--device-queue-window', str(window)] + SEQUENCE + list(extra)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv('DVS_DATA_PATH', str(shards.mvsec))
        if decode:
            patch.setattr(train_cli, 'ShardedBatchSkipper',
                          lambda loader, *args, **kwargs: loader)
        return train_cli.main(argv)


def scalars(run):
    """Every scalar of a run's training, ``(tag, samples passed, value)``
    in the order written: all but the host monitor's samples."""
    out = []
    for path in sorted((run / 'log').glob('events.out.tfevents.*')):
        for event in read_events(path):
            out += [(tag, event['step'], value)
                    for tag, value in event['scalars'].items()
                    if not tag.startswith('Monitoring/')]
    return out


def skip_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(('Skipping batch', 'Processing rate'))]


def assert_same_checkpoints(got, want, steps):
    got, want = Serializer(got), Serializer(want)
    assert set(steps) <= set(got.list_known_steps()) \
        & set(want.list_known_steps())
    for step in steps:
        a, b = got.read_state_dict(step), want.read_state_dict(step)
        assert int(a['samples_passed']) == int(b['samples_passed'])
        for key, value in b['model'].items():
            assert torch.equal(a['model'][key], value), (step, key)
        flat_a = dict(_leaves(a['optimizer']))
        flat_b = dict(_leaves(b['optimizer']))
        assert flat_a.keys() == flat_b.keys()
        for key, value in flat_b.items():
            if isinstance(value, torch.Tensor):
                assert torch.equal(flat_a[key], value), (step, key)
            else:
                assert flat_a[key] == value, (step, key)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize('window', [0, 16])
def test_main_skips_unread_as_it_skips_decoded(shards, tmp_path, capsys,
                                               one_torch_thread, window):
    capacity = middle_capacity(shards.paths['port'])
    steps = 6
    records = {}
    for name, decode in (('metadata', False), ('decoded', True)):
        records[name] = main(shards, tmp_path / name, steps, capacity,
                             window, decode)
        records[name + '_out'] = capsys.readouterr().out
    assert records['metadata'][0]['step'] == records['decoded'][0]['step'] \
        == steps
    lines = skip_lines(records['metadata_out'])
    assert lines == skip_lines(records['decoded_out'])
    assert 'skipped by its recorded event count' in records['metadata_out']
    assert 'skipped by its recorded event count' not in \
        records['decoded_out']
    got, want = scalars(tmp_path / 'metadata'), scalars(tmp_path / 'decoded')
    assert got == want
    skips = [v for tag, _, v in got if tag == 'General/skipped batches']
    assert skips == list(range(1, len(skips) + 1)) and len(skips) >= 3
    losses = [v for tag, _, v in got if tag == 'General/Train loss']
    assert len(losses) == steps and np.isfinite(losses).all()
    assert_same_checkpoints(tmp_path / 'metadata', tmp_path / 'decoded',
                            [0, 2, 4, 6])


@pytest.mark.parametrize('cut', ['before_a_skip', 'after_a_skip'])
def test_a_resumed_run_repeats_its_decisions(shards, tmp_path, capsys,
                                             one_torch_thread, cut):
    path = shards.paths['port']
    events = position_events(path)
    capacity = middle_capacity(path)
    steps = 4
    # the steps trained before the stream's first skip: the cut falls at
    # that step or at the next, the first past the skip
    leading = next(i for i, n in enumerate(events) if n > capacity)
    assert leading >= 1
    at = leading if cut == 'before_a_skip' else leading + 1
    # a checkpoint every step; the representation group from the start,
    # so that its schedule does not hang on -ne, which the cut changes
    every = ['--checkpointing_interval', '1', '--permanent_interval', '1',
             '--representation-start', '0']
    for name, decode in (('metadata', False), ('decoded', True)):
        main(shards, tmp_path / f'{name}_cut', at, capacity, 1, decode,
             every)
        main(shards, tmp_path / f'{name}_cut', steps, capacity, 1, decode,
             every + ['--allow-arguments-change'])
    main(shards, tmp_path / 'whole', steps, capacity, 1, False, every)
    capsys.readouterr()
    all_steps = list(range(steps + 1))
    assert_same_checkpoints(tmp_path / 'metadata_cut',
                            tmp_path / 'decoded_cut', all_steps)
    resumed = scalars(tmp_path / 'metadata_cut')
    assert resumed == scalars(tmp_path / 'decoded_cut')
    # the resumed run skipped after its cut too
    assert any(tag == 'General/skipped batches' and samples > at * MBS
               for tag, samples, _ in resumed)
    assert_same_checkpoints(tmp_path / 'metadata_cut', tmp_path / 'whole',
                            all_steps)
    # every loss term as the uninterrupted run's; the skip count starts
    # again in each run, as in the JAX package
    def trained(logged):
        return [entry for entry in logged
                if entry[0] != 'General/skipped batches']

    assert trained(resumed) == trained(scalars(tmp_path / 'whole'))


@pytest.mark.parametrize('seed', range(4))
def test_stream_position_is_where_the_skipper_stands(seed):
    """After each trained batch, ``stream_position`` of the samples
    trained so far is the skipper's cursor, across several wraps."""
    rng = np.random.default_rng(seed)
    length = int(rng.integers(5, 24))
    batch = int(rng.integers(1, length + 1))
    counts = rng.integers(1, 100, length)
    sums = [int(counts[[(p + k) % length for k in range(batch)]].sum())
            for p in range(0, batch * length, batch)]
    capacity = sorted(sums)[len(sums) // 2]

    class Loader:
        def __next__(self):
            return {'size': batch}

        def skip_batch(self):
            pass

    skipper = ShardedBatchSkipper(Loader(), counts, global_batch=batch,
                                  n_shards=1, capacity_per_shard=capacity,
                                  report_skips=True)
    served, trained = iter(skipper), 0
    assert stream_position(counts, batch, capacity, 0) == 0
    for _ in range(4 * length):
        if SKIPPED_EVENTS in next(served):
            continue
        trained += batch
        assert stream_position(counts, batch, capacity, trained) \
            == skipper.cursor


@pytest.mark.parametrize('cache, wrapped', [
    ([], True),
    (['--cache-size', '1'], False),
    (['--cache-size', '1', '--process-only-once'], True),
    (['--cache-size', '5'], True),
], ids=['no_cache', 'non_blocking', 'once', 'whole_set'])
def test_only_an_ordered_stream_is_skipped_unread(shards, tmp_path, capsys,
                                                  one_torch_thread, cache,
                                                  wrapped):
    built = []

    def recorded(loader, *args, **kwargs):
        built.append(loader)
        return ShardedBatchSkipper(loader, *args, **kwargs)

    flags = [] if not cache else ['--cache-dir', str(tmp_path / 'cache')]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(train_cli, 'ShardedBatchSkipper', recorded)
        main(shards, tmp_path / 'run', 1, middle_capacity(
            shards.paths['port']), 0, False, flags + cache)
    capsys.readouterr()
    assert bool(built) == wrapped
    assert len(built) <= 1


def test_a_stream_that_always_overflows_raises(shards, tmp_path,
                                               one_torch_thread):
    capacity = min(position_events(shards.paths['port'])) - 1
    with pytest.raises(RuntimeError, match='every global batch'):
        main(shards, tmp_path / 'run', 2, capacity, 0, False)


# --- against the JAX package's loop ----------------------------------------

def test_train_over_the_metadata_skip_matches_jax(shards):
    if 'jax' not in shards.paths:
        pytest.skip('h5py is not installed: no shards of the JAX package')
    import jax
    import jax.numpy as jnp
    from dvs_of_training_framework_tpu.data import dataloader as jax_loader
    from dvs_of_training_framework_tpu.data.schema import \
        pad_batch as jax_pad_batch
    from dvs_of_training_framework_tpu.training import \
        optimizers as jax_opt
    from dvs_of_training_framework_tpu.training import state as jax_state
    from dvs_of_training_framework_tpu.training import train as jax_train
    from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, create_train_state, current_learning_rates,
        make_train_step)
    from dvs_of_training_framework_tpu_torch.training import \
        train as port_train
    from tests.test_torch_plugins import (SHAPES, jax_recurrent,
                                          port_recurrent, recurrent_params)
    from tests.test_torch_recipe import jax_losses
    from tests.test_torch_train_loop import ListLogger
    from tests.test_torch_train_step import ARGS

    path = shards.paths['jax']
    capacity = middle_capacity(path)
    tags = [f'{h}x{w}' for h, w in SHAPES]
    steps = 5
    params_for = SimpleNamespace(preprocessed_dataset_path=path,
                                 batch_size=MBS, is_raw=True, cache_dir=None,
                                 cache_size=0)
    first = jax_pad_batch(next(jax_loader.get_dataloader(params_for)),
                          capacity=capacity)
    params = recurrent_params(jax.tree_util.tree_map(jnp.asarray, first))
    logs = {'jax': ListLogger(), 'port': ListLogger()}

    model, _ = jax_recurrent(0)
    tx = jax_opt.construct_optimizer(ARGS, params)
    step = jax_state.make_train_step(model, jax_losses('highest'), tx,
                                     [0.5, 1, 1], 1, is_raw=True)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)
    state, samples = jax_train.train(
        step, state, jax_loader.get_dataloader(params_for), steps,
        logs['jax'], tags,
        lr_fn=lambda s: jax_opt.current_learning_rates(ARGS, s),
        event_capacity=capacity, metric_flush_steps=3)
    want = (int(state.step), samples)

    port = port_recurrent(params, 0)
    step_fn = make_train_step(port, MultiScaleLoss(SHAPES),
                              construct_optimizer(ARGS, port), [0.5, 1, 1],
                              1)
    loader = ShardedBatchSkipper(
        reader(path), per_sample_event_counts(path), global_batch=MBS,
        n_shards=1, capacity_per_shard=capacity, report_skips=True)
    state, samples = port_train.train(
        step_fn, create_train_state(), loader, steps, logs['port'], tags,
        torch.device('cpu'), lr_fn=lambda s: current_learning_rates(ARGS, s),
        event_capacity=capacity, metric_flush_steps=3)
    assert (state.step, samples) == want == (steps, steps * MBS)
    skips = {k: [v for t, v, _ in log.scalars
                 if t == 'General/skipped batches']
             for k, log in logs.items()}
    assert skips['port'] == skips['jax'] and len(skips['jax']) >= 3
    # the tags and steps exactly; the losses at the loop test's rtol
    # 1e-5, every term (a smoothness term is ~2e-3) with the atol 1e-7 of
    # tests/test_torch_plugins.py's recurrent steps
    assert [(t, s) for t, _, s in logs['port'].scalars] == \
        [(t, s) for t, _, s in logs['jax'].scalars]
    losses = {k: [v for t, v, _ in log.scalars if t == 'General/Train loss']
              for k, log in logs.items()}
    assert len(losses['jax']) == steps
    np.testing.assert_allclose(losses['port'], losses['jax'], rtol=1e-5)
    np.testing.assert_allclose([v for _, v, _ in logs['port'].scalars],
                               [v for _, v, _ in logs['jax'].scalars],
                               rtol=1e-5, atol=1e-7)


# --- tools.loss_summary ----------------------------------------------------

def test_loss_summary_reads_a_runs_log(shards, tmp_path, capsys,
                                       one_torch_thread):
    capacity = middle_capacity(shards.paths['port'])
    main(shards, tmp_path / 'run', 4, capacity, 0, False)
    capsys.readouterr()
    got = loss_summary.summarize(tmp_path / 'run' / 'log', window=3)
    logged = scalars(tmp_path / 'run')
    losses = [v for t, _, v in logged if t == 'General/Train loss']
    skips = [v for t, _, v in logged if t == 'General/skipped batches']
    assert got == {'steps': 4, 'first_mean': float(np.mean(losses[:3])),
                   'last_mean': float(np.mean(losses[-3:])),
                   'max': max(losses), 'skipped_batches': int(skips[-1]),
                   'window': 3}
    loss_summary.main([str(tmp_path / 'run' / 'log')])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
        loss_summary.summarize(tmp_path / 'run' / 'log') == \
        dict(got, first_mean=float(np.mean(losses)),
             last_mean=float(np.mean(losses)), window=500)
