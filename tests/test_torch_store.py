"""The port's npy store (``data/store.py``) and the readers over it.

The store keeps the part of ``h5py.File`` that the data modules use; a
file read through it gives what h5py gives from the HDF5 original:

- groups, datasets, ``[()]``, slices, boolean and integer indices, ``in``,
  ``len`` and ``keys``; byte strings and 0-d scalars round-trip exactly;
  h5py's storage keywords are ignored; ``'w'`` replaces a store whole;
- ``mode='r'`` opens a directory as the store and a regular file as HDF5;
- over ``tests/data/seq`` (HDF5) and its npy twin, the training loader
  (shuffled, augmented, seeded) and the validation loader yield equal
  batches, and so does the preprocessed reader over an HDF5 shard of the
  JAX package and its npy twin, across the shard boundary and after a
  seek; the shard-size sidecar is JSON, and a YAML sidecar of the JAX
  package is read by counting the shard;
- the prefetch cache (``--cache-dir``) copies npy-store shards, which are
  directories, and the reader serves the same batches through it;
- the provenance document is written as JSON and a YAML one of the JAX
  package is still read; the data roots come from the environment only.

Every comparison is exact (``np.array_equal`` on dtype, shape and value),
as tests/test_torch_data.py holds the copies to their originals.
"""
import json
import random
from types import SimpleNamespace

import h5py
import numpy as np
import pytest

import dvs_of_training_framework_tpu.data.codec as jax_codec
import dvs_of_training_framework_tpu.data.collate as jax_collate
import dvs_of_training_framework_tpu.data.dataset as jax_dataset
import dvs_of_training_framework_tpu.utils.common as jax_common
import dvs_of_training_framework_tpu_torch.test as port_test
import dvs_of_training_framework_tpu_torch.data.dataloader as port_loader
import dvs_of_training_framework_tpu_torch.data.preprocessed as \
    port_preprocessed
import dvs_of_training_framework_tpu_torch.utils.common as port_common
import dvs_of_training_framework_tpu_torch.utils.options as port_options
from dvs_of_training_framework_tpu_torch.data import store
from tests.helpers import data_path
from tests.test_torch_data import LOADER_ARGV, assert_equal_tree, parse_train


def hdf5_to_store(src, dst):
    """The npy twin of an HDF5 file: every group and dataset copied."""
    def copy(node, group):
        for name, item in node.items():
            if isinstance(item, h5py.Group):
                copy(item, group.create_group(name))
            else:
                group.create_dataset(name, data=item[()])
    with h5py.File(src, 'r') as f, store.open_file(dst, 'w') as out:
        copy(f, out)


def test_store_round_trip(tmp_path):
    path = tmp_path / 'a.hdf5'
    rng = np.random.default_rng(0)
    events = rng.normal(size=(50, 4))
    names = np.array([b'outdoor_synth2', b'outdoor_synth1'])
    with store.open_file(path, 'w') as f:
        left = f.create_group('davis').create_group('left')
        left.create_dataset('events', data=events, compression='gzip')
        f.create_dataset('set_name', data=names)
        f.create_dataset('start', data=np.float64(1000.05))
        f.create_dataset('empty', data=np.zeros((0, 4)))
        with pytest.raises(TypeError):
            f.create_dataset('objects', data=np.array([{}], dtype=object))
    assert path.is_dir() and not (tmp_path / 'a.hdf5.tmp').exists()
    with store.open_file(path, 'r') as f:
        assert sorted(f.keys()) == ['davis', 'empty', 'set_name', 'start']
        assert len(f) == 4 and 'davis/left/events' in f and 'x' not in f
        ev = f['davis']['left']['events']
        assert ev.shape == (50, 4) and ev.dtype == np.float64
        assert len(ev) == 50
        assert np.array_equal(ev[()], events)
        assert np.array_equal(f['davis/left/events'][3:7], events[3:7])
        assert ev[4, 2] == events[4, 2]
        keep = events[:, 0] > 0
        assert np.array_equal(ev[keep, :], events[keep, :])
        assert np.array_equal(np.asarray(ev, dtype=np.float32),
                              events.astype(np.float32))
        assert type(ev[2:5]) is np.ndarray      # a fresh array, as h5py
        got_names = f['set_name'][()]
        assert got_names.dtype == names.dtype
        assert np.array_equal(got_names, names)
        start = f['start'][()]
        assert isinstance(start, np.float64) and start == 1000.05
        assert f['empty'][()].shape == (0, 4)
        with pytest.raises(KeyError):
            f['missing']
        with pytest.raises(OSError):
            f.create_group('more')
    with store.open_file(path, 'w') as f:     # 'w' replaces the store
        f.create_dataset('only', data=np.arange(3))
    with store.open_file(path, 'r') as f:
        assert f.keys() == ['only']


def test_open_file_takes_the_format_from_the_path(tmp_path):
    with h5py.File(tmp_path / 'h.hdf5', 'w') as f:
        f.create_dataset('start', data=2.5)
        f.create_dataset('set_name', data=np.array([b'seq1']))
    hdf5_to_store(tmp_path / 'h.hdf5', tmp_path / 'n.hdf5')
    for name, kind in (('h.hdf5', h5py.File), ('n.hdf5', store.Store)):
        with store.open_file(tmp_path / name, 'r') as f:
            assert isinstance(f, kind)
            assert f['start'][()] == 2.5
            assert list(f['set_name'][()]) == [b'seq1']
    with pytest.raises(FileNotFoundError):
        store.open_file(tmp_path / 'none.hdf5')


@pytest.fixture
def twin_roots(tmp_path, monkeypatch):
    """``tests/data/seq`` as both MVSEC splits, in HDF5 and as npy twins."""
    twin = tmp_path / 'seq_npy'
    twin.mkdir()
    for src in data_path.glob('*.hdf5'):
        hdf5_to_store(src, twin / src.name)
    roots = {}
    for kind, seq in (('hdf5', data_path), ('npy', twin)):
        root = tmp_path / kind
        root.mkdir()
        for split in ('outdoor_day1', 'outdoor_day2'):
            (root / split).symlink_to(seq)
        roots[kind] = root
    return roots, monkeypatch


def port_batches(root, monkeypatch, split, n=3, seed=7):
    monkeypatch.setenv('DVS_DATA_PATH', str(root))
    args = port_loader.choose_data_path(parse_train(port_options,
                                                    LOADER_ARGV))
    params = (port_loader.get_trainset_params(args) if split == 'train'
              else port_loader.get_valset_params(args))
    random.seed(seed)
    np.random.seed(seed)
    it = iter(port_loader.get_dataloader(params))
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize('split', ['train', 'val'])
def test_loaders_read_hdf5_and_npy_alike(twin_roots, split):
    roots, monkeypatch = twin_roots
    want = port_batches(roots['hdf5'], monkeypatch, split)
    got = port_batches(roots['npy'], monkeypatch, split)
    for batch_got, batch_want in zip(got, want):
        assert_equal_tree(batch_got, batch_want)


def write_jax_shards(out, samples_per_file=3, num_files=2):
    """Fixture samples encoded into HDF5 shards by the JAX package."""
    data = jax_dataset.Dataset(path=data_path, shape=[64, 64],
                               augmentation=False, collapse_length=1,
                               is_raw=True, max_seq_length=1)
    out.mkdir()
    idx = 0
    for j in range(num_files):
        encoded = []
        for _ in range(samples_per_file):
            encoded.append(jax_codec.encode_batch(
                **jax_collate.collate_wrapper([data[idx]])))
            idx += 1
        jax_codec.write_encoded_batch(out / f'{j}.hdf5',
                                      jax_codec.join_batches(encoded))


def test_preprocessed_reader_reads_hdf5_and_npy_alike(tmp_path):
    write_jax_shards(tmp_path / 'hdf5')
    (tmp_path / 'npy').mkdir()
    for shard in (tmp_path / 'hdf5').glob('*.hdf5'):
        hdf5_to_store(shard, tmp_path / 'npy' / shard.name)
    # the JAX package's sidecar is YAML, not JSON: the shard is counted
    (tmp_path / 'hdf5' / '0.info').write_text('size: 3\n')
    runs = {}
    for kind in ('hdf5', 'npy'):
        loader = port_preprocessed.PreprocessedDataloader(
            tmp_path / kind, batch_size=2, is_raw=True, show_progress=False)
        assert len(loader) == 6
        batches = [next(loader), next(loader)]
        loader.set_index(5)
        batches.append(next(loader))
        runs[kind] = batches
    for got, want in zip(runs['npy'], runs['hdf5']):
        assert_equal_tree(got, want)
    assert json.loads((tmp_path / 'npy' / '1.info').read_text()) == \
        {'size': 3}
    assert (tmp_path / 'hdf5' / '0.info').read_text() == 'size: 3\n'


@pytest.mark.parametrize('cache_size', [1, 2])
def test_preprocessed_reader_caches_npy_shards(tmp_path, cache_size):
    """One cached shard at a time (the strict prefetch iterator), and both
    shards copied up front (the warm path)."""
    write_jax_shards(tmp_path / 'hdf5')
    (tmp_path / 'npy').mkdir()
    for shard in (tmp_path / 'hdf5').glob('*.hdf5'):
        hdf5_to_store(shard, tmp_path / 'npy' / shard.name)
    runs = {}
    for cache_dir in (None, tmp_path / 'cache'):
        loader = port_preprocessed.PreprocessedDataloader(
            tmp_path / 'npy', batch_size=2, is_raw=True, show_progress=False,
            cache_dir=cache_dir, cache_size=cache_size)
        runs[cache_dir] = [next(loader) for _ in range(4)]
    cached = list((tmp_path / 'cache').iterdir())
    assert cached and all(p.is_dir() for p in cached)
    for got, want in zip(runs[tmp_path / 'cache'], runs[None]):
        assert_equal_tree(got, want)


def test_provenance_is_json_and_reads_the_jax_yaml(tmp_path):
    args = SimpleNamespace(bs=8, shape=(64, 64), model=tmp_path / 'run',
                           flownet_path=None, allow_obsolete_code=False,
                           allow_arguments_change=False)
    written = port_common.collect_execution_info(args)
    assert json.loads(written)['arguments']['shape'] == [64, 64]
    (tmp_path / 'parameters').write_text(
        jax_common.collect_execution_info(args))
    assert port_common.execution_info2args(
        port_common.read_execution_info(tmp_path)) == \
        jax_common.execution_info2args(
            jax_common.read_execution_info(tmp_path))
    port_common.check_execution_info(tmp_path, written, args)
    args.bs = 4
    with pytest.raises(AssertionError, match='bs'):
        port_common.check_execution_info(
            tmp_path, port_common.collect_execution_info(args), args)


@pytest.mark.parametrize('variable', ['DVS_DATA_PATH', 'DVS_DATA_ROOT'])
def test_data_roots_come_from_the_environment(monkeypatch, variable):
    monkeypatch.delenv(variable, raising=False)
    read_root = {
        'DVS_DATA_PATH': lambda: port_loader.choose_data_path(
            SimpleNamespace()),
        'DVS_DATA_ROOT': lambda: port_test.build_test_matrix(
            SimpleNamespace(test_config=None)),
    }[variable]
    with pytest.raises(RuntimeError, match=variable):
        read_root()
