"""The port's own host modules against the JAX package's originals.

The port keeps copies of the JAX package's option groups, TensorBoard
writer, provenance helpers and data pipeline (raw dataset, augmentation
with its native remapping library, collate, codec, preprocessed shards,
file cache, loader facade).  Over the repo's ``tests/data`` fixtures
and one seed, each copy must give exactly what its original gives:

- the training loader (shuffled, augmented) and the validation loader
  yield equal batches, every field compared with ``np.array_equal``;
- shards encoded and written by each package, read back through each
  package's ``PreprocessedDataloader``, yield equal batches;
- a set of command lines parses into the same namespace;
- the writer's events read back equal through both readers.
"""
from argparse import ArgumentParser
import random

import numpy as np
import pytest

import dvs_of_training_framework_tpu.data.codec as jax_codec
import dvs_of_training_framework_tpu.data.collate as jax_collate
import dvs_of_training_framework_tpu.data.dataloader as jax_loader
import dvs_of_training_framework_tpu.data.dataset as jax_dataset
import dvs_of_training_framework_tpu.data.preprocessed as jax_preprocessed
import dvs_of_training_framework_tpu.utils.options as jax_options
import dvs_of_training_framework_tpu.utils.tb as jax_tb
import dvs_of_training_framework_tpu_torch.data.codec as port_codec
import dvs_of_training_framework_tpu_torch.data.collate as port_collate
import dvs_of_training_framework_tpu_torch.data.dataloader as port_loader
import dvs_of_training_framework_tpu_torch.data.dataset as port_dataset
import dvs_of_training_framework_tpu_torch.data.preprocessed as \
    port_preprocessed
import dvs_of_training_framework_tpu_torch.utils.options as port_options
import dvs_of_training_framework_tpu_torch.utils.tb as port_tb
from tests.helpers import data_path

PACKAGES = {
    'jax': (jax_options, jax_loader, jax_dataset, jax_collate, jax_codec,
            jax_preprocessed),
    'port': (port_options, port_loader, port_dataset, port_collate,
             port_codec, port_preprocessed),
}
SEED = 7
LOADER_ARGV = ['-m', 'out', '--height', '64', '--width', '64', '-bs', '2',
               '-mbs', '2', '--num_workers', '0', '-cl', '2']


def assert_equal_tree(got, want, where='batch'):
    """Equal structure, and every array equal in dtype, shape and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for key in want:
            assert_equal_tree(got[key], want[key], f'{where}.{key}')
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_tree(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype, where
        assert np.array_equal(got, want, equal_nan=True), where
    else:
        assert got == want, where


def parse_train(options, argv):
    parser = ArgumentParser()
    options.add_train_arguments(parser)
    options.add_preprocessed_dataset_arguments(parser)
    return options.validate_train_args(parser.parse_args(argv))


@pytest.fixture
def mvsec_root(tmp_path, monkeypatch):
    """The fixture sequence as both MVSEC split directories."""
    root = tmp_path / 'mvsec'
    root.mkdir()
    for split in ('outdoor_day1', 'outdoor_day2'):
        (root / split).symlink_to(data_path)
    monkeypatch.setenv('DVS_DATA_PATH', str(root))
    return root


def loader_batches(package, split, n):
    """The first ``n`` batches of one package's loader for ``split``,
    with Python's and NumPy's global generators seeded alike."""
    options, loader, *_ = PACKAGES[package]
    args = loader.choose_data_path(parse_train(options, LOADER_ARGV))
    params = (loader.get_trainset_params(args) if split == 'train'
              else loader.get_valset_params(args))
    random.seed(SEED)
    np.random.seed(SEED)
    batches = loader.get_dataloader(params)
    it = iter(batches)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()      # stops the prefetch thread before the next reseed


@pytest.mark.parametrize('split', ['train', 'val'])
def test_loaders_yield_equal_batches(mvsec_root, split):
    want = loader_batches('jax', split, 3)
    got = loader_batches('port', split, 3)
    for batch_got, batch_want in zip(got, want):
        assert_equal_tree(batch_got, batch_want)
    if split == 'train':    # augmented: the draws were really exercised
        assert any(b['augmentation_params'] is not None for b in got)


def write_shards(package, out, samples_per_file=3, num_files=2):
    """Fixture samples encoded into shards by one package's codec."""
    *_, dataset, collate, codec, _ = PACKAGES[package]
    data = dataset.Dataset(path=data_path, shape=[64, 64],
                           augmentation=False, collapse_length=1,
                           is_raw=True, max_seq_length=1)
    out.mkdir()
    idx = 0
    for j in range(num_files):
        encoded = []
        for _ in range(samples_per_file):
            batch = collate.collate_wrapper([data[idx]])
            encoded.append(codec.encode_batch(**batch))
            idx += 1
        codec.write_encoded_batch(out / f'{j}.hdf5',
                                  codec.join_batches(encoded))


@pytest.mark.parametrize('reader', ['jax', 'port'])
def test_preprocessed_shards_read_alike(tmp_path, reader):
    """Shards written by either package read back as the same batches,
    across the file boundary and after a seek: the port's shards (the npy
    store) through the port's loader, against the JAX package's HDF5
    shards through ``reader``'s loader."""
    runs = {}
    for writer in ('jax', 'port'):
        out = tmp_path / writer
        write_shards(writer, out)
        loader_cls = PACKAGES[reader if writer == 'jax'
                              else 'port'][-1].PreprocessedDataloader
        loader = loader_cls(out, batch_size=2, is_raw=True,
                            show_progress=False)
        batches = [next(loader), next(loader)]
        loader.set_index(5)
        batches.append(next(loader))
        runs[writer] = batches
    for got, want in zip(runs['port'], runs['jax']):
        assert_equal_tree(got, want)
    assert runs['jax'][1]['size'] == 2


@pytest.mark.parametrize('argv', [
    ['-m', 'out'],
    ['-m', 'out', '-d', 'cpu', '-bs', '8', '-mbs', '4', '-ne', '12',
     '--precision', 'bfloat16', '--loss-precision', 'bf16x2',
     '--event-capacity', '4096', '--grad-clip-norm', '1.0'],
    ['-m', 'out', '--ema-decay', '0.999', '--half_life', '20000',
     '--num-warmup-steps', '200', '--loss_weights', '0.25', '1', '2',
     '--checkpointing_interval', '4', '--permanent_interval', '8',
     '--num_checkpoints', '3', '-vp', '4', '--skip-validation'],
    ['-m', 'out', '--preprocessed-dataset-path', 'prep', '--cache-dir',
     'cache', '--cache-size', '3', '--process-only-once',
     '--event-capacity', 'auto', '--wire-data', 'bf16', '--precision',
     'bfloat16', '-sp', 'weights.ckpt', '--init-seed', '3'],
])
def test_options_parse_alike(argv):
    assert vars(parse_train(port_options, argv)) == \
        vars(parse_train(jax_options, argv))


def test_test_options_parse_alike():
    argv = ['-m', 'run', '-o', 'results', '-s', '8', '--use-ema',
            '--eval-batch-windows', '4']
    parsed = []
    for options in (jax_options, port_options):
        parser = ArgumentParser()
        options.add_test_arguments(parser)
        parsed.append(vars(options.validate_test_args(
            parser.parse_args(argv))))
    assert parsed[0] == parsed[1]


def test_summary_events_read_back_equal(tmp_path):
    scalars = [('General/Train loss', 0.5, 1), ('General/Train loss', 0.25, 2),
               ('General/learning rate/0', 1e-3, 2),
               ('Train/photometric loss/64x64', -3.5e-7, 7)]
    events = {}
    for name, tb in (('jax', jax_tb), ('port', port_tb)):
        log = tmp_path / name
        with tb.SummaryWriter(log) as writer:
            for tag, value, step in scalars:
                writer.add_scalar(tag, value, step, walltime=1.5 + step)
        (path,) = log.glob('events.out.tfevents.*')
        for reader in (jax_tb, port_tb):
            first, *rest = reader.read_events(path)
            del first['wall_time']      # the file version event's: now
            events.setdefault(name, []).append([first] + rest)
    # each writer's file reads back alike through both readers, and the
    # two writers' files hold the same events
    want = events['jax'][0]
    for got in events['jax'][1:] + events['port']:
        assert got == want
    assert [(e['step'], e['scalars']) for e in want if e['scalars']] == [
        (step, {tag: pytest.approx(value)}) for tag, value, step in scalars]


@pytest.mark.parametrize('sample_offset', [0, 13 * 8])
def test_synthetic_bench_batches_equal_bench(sample_offset):
    """The port's copy of bench.py's batch maker and of the simulator it
    calls gives the batches ``bench.make_collated`` gives, for one seed."""
    import bench
    from dvs_of_training_framework_tpu_torch.data import synthetic
    assert (synthetic.BATCH_SIZE, synthetic.IMSIZE, synthetic.CAPACITY) == \
        (bench.BATCH_SIZE, bench.IMSIZE, bench.CAPACITY)
    want = bench.make_collated(np.random.default_rng(0), sample_offset)
    got = synthetic.make_collated(np.random.default_rng(0), sample_offset)
    assert_equal_tree(got, want)
    assert got['events']['x'].size > 0
