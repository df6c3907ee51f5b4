"""The preprocessed reader over the slow-storage file cache
(``--cache-dir``): a stream served out of order counts each served file's
own samples.

Ten samples of ``tests/data/seq`` at 32x32, 1- and 2-element, written by
the port's ``tools.prepare_batches`` in files of 4, 4 and 2 (and by the
JAX package's ``scripts/prepare_batches.py`` as HDF5 where h5py is
installed), read in batches of 3, which straddle the files' boundaries.

- Out of order: a non-blocking cache smaller than the set, its copies
  finished on a schedule (``tests/served_stream.py``'s gated
  ``FileLoader``, no sleeps), which re-serves the short file where a long
  one stands in the file order and a long one where the short one does.
  Over three passes and more, every batch holds exactly the samples of
  the files served, one after another, each read whole, in the order
  served; no slice reads past its file's end.  The same for each rank of
  two (the first slice and the stride past the peer's), and through
  ``skip_batch`` and ``set_index``, which walks the files the restarted
  cache serves by their own counts.  Before the repair the reader
  counted the file at the stream's shard index: it read 2 samples of a
  4-sample file and moved on, or read 4 of a 2-sample file.
- Ordered (no cache, the strict ``--process-only-once`` iterator, the
  warm path): batches, ``skip_batch`` and ``set_index`` read the files in
  their order, and equal the JAX package's reader over the same HDF5
  shards.  The JAX package keeps the fault on the out-of-order path, so
  no parity is asked there.
- Two gloo ranks of ``train.main(['--mesh', 'data:2', ...])`` over a
  non-blocking ``--cache-dir`` whose copies
  ``tests/torch_mesh_worker.py`` slows: the run ends, every rank's
  batches hold the samples of the files that rank served, and the ranks
  drop an overflowing batch together.
"""
import json
import random
import re

import numpy as np
import pytest

from dvs_of_training_framework_tpu_torch.data import codec
from dvs_of_training_framework_tpu_torch.data.preprocessed import \
    PreprocessedDataloader
from dvs_of_training_framework_tpu_torch.data.sharding import ShardWriter
from dvs_of_training_framework_tpu_torch.parallel.distributed import \
    free_port
from dvs_of_training_framework_tpu_torch.tools import prepare_batches
from tests import served_stream, torch_procs
from tests.helpers import data_path
from tests.test_torch_mesh_skip import make_sample

SIZE, BATCH = 10, 3
# samples a file -> the files' sizes, and the largest cache that is
# smaller than the set (2 files: one cached; 3: two cached)
LAYOUTS = {4: ([4, 4, 2], 2), 3: ([3, 3, 3, 1], 3)}
PER_FILE = 4
# the non-blocking iterator's next calls after the first: F lets a copy
# land first, S serves a cached file again
SCHEDULE = 'SFFSSFSFFFSS'
PASSES = 3


def write_shards(module, out, elements, per_file=PER_FILE):
    random.seed(7)
    np.random.seed(7)
    sequence = ['--min-sequence-length', str(elements),
                '--max-sequence-length', str(elements)]
    module.main(module.parse_args(
        ['-o', str(out), '-s', str(SIZE), '--samples-per-file',
         str(per_file), '--height', '32', '--width', '32', '-mbs', '1',
         '--num_workers', '0'] + sequence))


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp('cache_stream')
    mvsec = root / 'mvsec'
    mvsec.mkdir()
    for split in ('outdoor_day1', 'outdoor_day2'):
        (mvsec / split).symlink_to(data_path)
    out = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv('DVS_DATA_PATH', str(mvsec))
        for elements in (1, 2):
            for per_file in LAYOUTS:
                path = root / f'port{elements}_{per_file}'
                write_shards(prepare_batches, path, elements, per_file)
                out['port', elements, per_file] = path
        try:
            import h5py  # noqa: F401
            import scripts.prepare_batches as jax_prepare
        except ImportError:
            pass
        else:
            write_shards(jax_prepare, root / 'jax', 2)
            out['jax', 2, PER_FILE] = root / 'jax'
    return out


def files_of(path):
    return sorted(path.glob('*.hdf5'), key=lambda p: int(p.stem))


def test_the_shards_are_unequal(shards):
    for (_, _, per_file), path in shards.items():
        assert [served_stream.Source.size(f) for f in files_of(path)] \
            == LAYOUTS[per_file][0], path


def gated_reader(monkeypatch, tmp_path, path, cache_size, process_index=0,
                 process_count=1):
    """A reader over a non-blocking cache of ``cache_size`` files whose
    copies land on SCHEDULE, checked batch by batch."""
    copies = served_stream.Copies(schedule=SCHEDULE)
    served_stream.install(monkeypatch.setattr, copies)
    reader = PreprocessedDataloader(
        path, BATCH, is_raw=True, cache_dir=tmp_path / 'cache',
        cache_size=cache_size, process_only_once=False, show_progress=False,
        process_index=process_index, process_count=process_count)
    assert not reader.in_order
    return reader


def reserved_in_place(path, stream):
    """``(short for long, long for short)``: whether a visit served the
    short file where the file order has a long one, and the reverse."""
    files = files_of(path)
    served = stream.visits[stream.origin:]
    order = [files[i % len(files)] for i in range(len(served))]
    size = served_stream.Source.size
    short_for_long = any(size(s) < size(o) for s, o in zip(served, order))
    long_for_short = any(size(s) > size(o) for s, o in zip(served, order))
    return short_for_long, long_for_short


def passes_batches(process_count):
    """Batches that cover PASSES passes of the set and a batch more."""
    return -(-PASSES * SIZE // (BATCH * process_count)) + 1


@pytest.mark.parametrize('per_file', list(LAYOUTS))
@pytest.mark.parametrize('elements', [1, 2])
def test_an_out_of_order_stream_reads_the_served_files(
        shards, monkeypatch, tmp_path, elements, per_file):
    path = shards['port', elements, per_file]
    reader = gated_reader(monkeypatch, tmp_path, path, LAYOUTS[per_file][1])
    n = passes_batches(1)
    for _ in range(n):
        batch = next(reader)     # checked against the served files
        assert batch['size'] == BATCH
    stream = reader.stream
    assert stream.batches == n
    assert stream.pos >= PASSES * SIZE
    assert reserved_in_place(path, stream) == (True, True)


@pytest.mark.parametrize('process_index', [0, 1])
@pytest.mark.parametrize('elements', [1, 2])
def test_a_rank_reads_its_slices_of_its_served_stream(
        shards, monkeypatch, tmp_path, elements, process_index):
    path = shards['port', elements, PER_FILE]
    reader = gated_reader(monkeypatch, tmp_path, path, 2, process_index, 2)
    n = passes_batches(2)
    for _ in range(n):
        next(reader)
    stream = reader.stream
    assert stream.batches == n
    assert stream.pos >= PASSES * SIZE
    assert reserved_in_place(path, stream) == (True, True)


@pytest.mark.parametrize('process_index, process_count',
                         [(0, 1), (0, 2), (1, 2)])
def test_skips_and_seeks_walk_the_served_files(
        shards, monkeypatch, tmp_path, process_index, process_count):
    reader = gated_reader(monkeypatch, tmp_path,
                          shards['port', 2, PER_FILE], 2, process_index,
                          process_count)
    for seek in (None, 7, 23):
        if seek is not None:
            reader.set_index(seek)
        for _ in range(3):
            next(reader)
            reader.skip_batch()
            next(reader)
    assert reader.stream.batches == 18
    assert reader.stream.origin > 0


# --- ordered streams --------------------------------------------------------

POLICIES = {'no_cache': {},
            'strict': {'cache_size': 2, 'process_only_once': True},
            'warm': {'cache_size': 5}}


def ordered_ops(reader):
    """Batches read through skips and seeks (None marks a skip)."""
    out = []
    for seek in (None, 7, 23):
        if seek is not None:
            reader.set_index(seek)
        for _ in range(4):
            out.append(next(reader))
        reader.skip_batch()
        out.append(None)
        out.append(next(reader))
    return out


def file_order(path, process_index, process_count):
    """``ordered_ops``' batches read straight from the files in their
    order, the stream wrapping at the set's end."""
    files = files_of(path)
    where = [(f, i) for f in files
             for i in range(served_stream.Source.size(f))]
    stride = BATCH * process_count
    out = []

    def read(pos):
        runs = []
        for k in range(BATCH):
            f, i = where[(pos + k) % SIZE]
            if runs and runs[-1][0] == f and runs[-1][2] == i:
                runs[-1][2] = i + 1
            else:
                runs.append([f, i, i + 1])
        return served_stream.Source.read([tuple(r) for r in runs], True)

    for seek in (0, 7, 23):
        pos = seek if process_count == 1 else \
            (seek // stride) * stride + process_index * BATCH
        for _ in range(4):
            out.append(read(pos))
            pos += stride
        out.append(None)
        pos += stride
        out.append(read(pos))
    return out


def assert_same_ops(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            served_stream.assert_trees_equal(a, b)


@pytest.mark.parametrize('process_index, process_count',
                         [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize('policy', list(POLICIES))
def test_an_ordered_stream_reads_the_files_in_order(
        shards, tmp_path, policy, process_index, process_count):
    kwargs = dict(POLICIES[policy], batch_size=BATCH, is_raw=True,
                  show_progress=False, process_index=process_index,
                  process_count=process_count)
    if policy != 'no_cache':
        kwargs['cache_dir'] = tmp_path / 'cache'
    path = shards['port', 2, PER_FILE]
    reader = PreprocessedDataloader(path, **kwargs)
    assert reader.in_order
    assert_same_ops(ordered_ops(reader), file_order(path, process_index,
                                                    process_count))
    if ('jax', 2, PER_FILE) not in shards:
        return
    from dvs_of_training_framework_tpu.data.preprocessed import \
        PreprocessedDataloader as JaxReader
    hdf5 = shards['jax', 2, PER_FILE]
    if policy != 'no_cache':
        kwargs['cache_dir'] = tmp_path / 'jax_cache'
    want = ordered_ops(JaxReader(hdf5, **kwargs))
    if policy != 'no_cache':
        kwargs['cache_dir'] = tmp_path / 'port_cache'
    assert_same_ops(ordered_ops(PreprocessedDataloader(hdf5, **kwargs)),
                    want)


# --- two gloo ranks of train.main() -----------------------------------------

MESH_STEPS, MESH_BATCH, HW = 16, 4, 32
LIGHT, HOT = 1500, 3000
CAPACITY = 8192                 # 4096 a shard on two ranks
DELAY = 0.3                     # seconds a copy takes in the ranks


@pytest.fixture(scope='module')
def hot_shards(tmp_path_factory):
    """Ten 1-element samples in files of 4, 4 and 2, each of LIGHT events
    but sample 0's HOT: a rank's 2-sample piece holding it overflows the
    4,096 events of a shard, every other piece fits."""
    root = tmp_path_factory.mktemp('cache_mesh')
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
            rng, HOT if i == 0 else LIGHT)))
    writer.flush()
    return root, mvsec, shards


def test_a_mesh_reads_each_ranks_served_files(hot_shards, tmp_path):
    root, mvsec, shards = hot_shards
    argv = ['-m', str(tmp_path / 'run'), '-d', 'cpu', '-bs', str(MESH_BATCH),
            '-mbs', str(MESH_BATCH), '-ne', str(MESH_STEPS),
            '--num_workers', '0', '--flownet_path', 'DummyFlowNet',
            '--optimizer', 'ADAM', '--skip-validation',
            '--checkpointing_interval', str(MESH_STEPS),
            '--permanent_interval', str(MESH_STEPS),
            '--height', str(HW), '--width', str(HW),
            '--event-capacity', str(CAPACITY),
            '--preprocessed-dataset-path', str(shards),
            '--cache-dir', str(tmp_path / 'cache'), '--cache-size', '2',
            '--mesh', 'data:2']
    reports = tmp_path / 'reports'
    reports.mkdir()
    out, = torch_procs.run_group(
        [torch_procs.python(torch_procs.REPO / 'tests' /
                            'torch_mesh_worker.py', 'main', DELAY, reports,
                            *argv)],
        root / f'logs{free_port()}', 240,
        environ=torch_procs.env(DVS_DATA_PATH=str(mvsec)))
    records = json.loads(re.search(r'^RESULT (.*)$', out, re.M).group(1))
    assert [(r['rank'], r['step'], r['samples_passed']) for r in records] \
        == [(0, MESH_STEPS, MESH_STEPS * MESH_BATCH),
            (1, MESH_STEPS, MESH_STEPS * MESH_BATCH)]
    # each rank's batches, checked in the rank against the files it served
    reads, copies = {}, {}
    for rank in (0, 1):
        text = (reports / f'rank{rank}.txt').read_text()
        reads[rank] = [int(n) for n in re.findall(r'^BATCH (\d+)$', text,
                                                  re.M)]
        copies[rank] = re.findall(r'^VISIT (\S+) \S+$', text, re.M)
        assert reads[rank], rank
        # a copy served more than once: the cache served it out of order
        assert len(set(copies[rank])) < len(copies[rank]), rank
    # the batches trained or dropped: up to the one that completed the last
    # step; a batch is dropped on both ranks when either piece overflows
    kept, dropped, i = 0, [], 0
    while kept < MESH_STEPS:
        over = [reads[r][i] > CAPACITY // 2 for r in (0, 1)]
        if any(over):
            dropped.append(i)
        else:
            kept += 1
        i += 1
    # the two ranks print to one stream: their lines may interleave
    skipped = sorted(int(n) for n in re.findall(
        r'Skipping batch with (\d+) events', out))
    assert skipped == sorted(reads[r][i] for r in (0, 1) for i in dropped)
    # some batch overflowed on one rank alone, and both dropped it
    assert any(sum(reads[r][i] > CAPACITY // 2 for r in (0, 1)) == 1
               for i in dropped)
