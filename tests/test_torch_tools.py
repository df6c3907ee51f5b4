"""The port's data tools against the repo's scripts, array for array.

The chain that builds the synthetic benchmark runs twice, once through
``scripts/{make_synthetic_mvsec,sequence2samples,prepare_batches}.py``
(HDF5, PyYAML) and once through the port's
``tools/{make_synthetic_mvsec,sequence2samples,prepare_batches}.py``
(the npy store, JSON configs), on the same seeds:

- the raw ``varied``-motion sequences, their ground truth and the info
  file;
- the per-element files of every split;
- the augmented, encoded training shards (Python's and NumPy's global
  generators seeded alike before each run, as tests/test_torch_data.py
  seeds the loaders).

Every array must be equal in dtype, shape and value.  To keep the chain
short, both simulators draw their textures with fewer blobs and
foreground objects (a wrapper around each module's own ``make_scene``
and ``make_foreground``, patched alike into both); the two functions
themselves are held equal at their real blob counts on small planes.
"""
import functools
import random
from pathlib import Path

import h5py
import numpy as np
import pytest

import scripts.make_synthetic_mvsec as jax_make
import scripts.prepare_batches as jax_prepare
import scripts.sequence2samples as jax_slice
from dvs_of_training_framework_tpu_torch.data import store, synthetic
from dvs_of_training_framework_tpu_torch.tools import (
    make_synthetic_mvsec as port_make, prepare_batches as port_prepare,
    sequence2samples as port_slice)

REPO = Path(__file__).resolve().parents[1]
SECS = ['--train-secs', '0.4', '--eval-secs', '0.25', '--val-secs', '0.25']


def assert_same_arrays(hdf5_path, store_path):
    """Every dataset of an HDF5 file equals its twin in the npy store."""
    def walk(want, got, where):
        assert sorted(want.keys()) == sorted(got.keys()), where
        for name in want.keys():
            if isinstance(want[name], h5py.Group):
                walk(want[name], got[name], f'{where}/{name}')
                continue
            w, g = want[name][()], got[name][()]
            assert np.asarray(g).dtype == np.asarray(w).dtype, where + name
            assert np.array_equal(g, w), f'{where}/{name}'
    with h5py.File(hdf5_path, 'r') as want, \
            store.open_file(store_path, 'r') as got:
        assert isinstance(got, store.Store)
        walk(want, got, str(store_path.name))


def test_texture_makers_equal_the_script():
    for fn, args in (('make_scene', ((48, 64),)),
                     ('make_foreground', ((64, 80),))):
        want = getattr(jax_make, fn)(np.random.default_rng(1), *args)
        got = getattr(synthetic, fn)(np.random.default_rng(1), *args)
        for g, w in zip(np.atleast_3d(got), np.atleast_3d(want)):
            assert np.array_equal(g, w)


@pytest.fixture
def few_blobs(monkeypatch):
    """Cheaper textures in both simulators, drawn by their own code."""
    for module in (jax_make, synthetic):
        scene, foreground = module.make_scene, module.make_foreground
        monkeypatch.setattr(module, 'make_scene', functools.partial(
            lambda f, rng, shape=module.SCENE, num_blobs=260:
                f(rng, shape, max(num_blobs // 40, 1)), scene))
        monkeypatch.setattr(module, 'make_foreground', functools.partial(
            lambda f, rng, shape=module.SCENE, num_objects=28:
                f(rng, shape, 4), foreground))


def test_the_chain_writes_what_the_scripts_write(few_blobs, tmp_path,
                                                 monkeypatch):
    roots = {'jax': tmp_path / 'jax', 'port': tmp_path / 'port'}
    # 1. the raw sequences
    monkeypatch.setattr('sys.argv', ['make_synthetic_mvsec.py',
                                     str(roots['jax']), '--motion', 'varied',
                                     '--speed', '0.35'] + SECS)
    jax_make.main()
    port_make.main([str(roots['port']), '--motion', 'varied', '--speed',
                    '0.35'] + SECS)
    raw = sorted((roots['jax'] / 'raw').rglob('*_data.hdf5'))
    assert len(raw) == 3
    for path in raw + [roots['jax'] / 'info' / 'synth.hdf5']:
        assert_same_arrays(path, roots['port'] / path.relative_to(
            roots['jax']))
    for gt in (roots['jax'] / 'raw').rglob('*.npz'):
        with np.load(gt) as want, np.load(
                roots['port'] / gt.relative_to(roots['jax'])) as got:
            assert want.files == got.files
            for key in want.files:
                assert np.array_equal(got[key], want[key])

    # 2. the per-element files of every split
    for name, root in roots.items():
        monkeypatch.setenv('DVS_DATA_ROOT', str(root))
        if name == 'jax':
            monkeypatch.setattr('sys.argv', [
                'sequence2samples.py',
                str(REPO / 'config' / 'synth_train_datasets.yml')])
            jax_slice.main()
        else:
            port_slice.main([str(REPO / 'dvs_of_training_framework_tpu_torch'
                                 / 'config' / 'synth_train_datasets.json')])
    elements = sorted((roots['jax'] / 'training').rglob('*.hdf5'))
    assert len(elements) == 8 + 5 + 5
    for path in elements:
        assert_same_arrays(path, roots['port'] / path.relative_to(
            roots['jax']))

    # 3. the training shards, from the augmenting loader
    shards = {}
    for name, root in roots.items():
        split = root / 'training' / 'synth'
        (split / 'outdoor_day2').symlink_to(split / 'outdoor_synth2')
        monkeypatch.setenv('DVS_DATA_PATH', str(split))
        module = jax_prepare if name == 'jax' else port_prepare
        shards[name] = tmp_path / f'{name}_shards'
        args = module.parse_args(['-o', str(shards[name]), '-s', '6',
                                  '--samples-per-file', '4', '--height',
                                  '64', '--width', '64', '-mbs', '2',
                                  '--num_workers', '0', '-cl', '2'])
        random.seed(5)
        np.random.seed(5)
        module.main(args)
    files = sorted(shards['jax'].glob('*.hdf5'))
    assert [p.name for p in files] == ['0.hdf5', '1.hdf5']
    assert sorted(p.name for p in shards['port'].glob('*.hdf5')) == \
        ['0.hdf5', '1.hdf5']
    for path in files:
        assert_same_arrays(path, shards['port'] / path.name)
