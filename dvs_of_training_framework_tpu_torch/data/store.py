"""Array store: the part of ``h5py.File`` that the data pipeline uses,
over a directory of ``.npy`` files, with numpy alone.

The port's data modules read and write every file through ``open_file``:
the raw sequences (``<seq>_data.hdf5``), the per-element files
(``<i:06d>.hdf5``), the encoded shards (``<j>.hdf5``) and the info files
(``info/<ds>.hdf5``).  A group is a directory and a dataset one ``.npy``
file in it, read with ``np.load(mmap_mode='r')``, so a slice reads only
its rows.  The store keeps the HDF5 file names as its directory names,
so no glob or path of the copied modules changes, and a file and its npy
twin read alike.

The format follows the path, never what is installed: ``mode='w'``
always writes the npy store (nothing here writes HDF5); ``mode='r'``
opens a directory as the npy store and a regular file as HDF5, through
``h5py`` imported inside the call.

What the store keeps of h5py's interface: groups (``create_group``,
``f[name]``, ``'a/b'`` paths, ``in``, ``len``, ``keys()``),
``create_dataset(name, data=...)`` with h5py's other keywords
(``compression`` and the like) accepted and ignored, and datasets with
``shape``, ``dtype``, ``len``, slicing (basic, integer and boolean
indices, as numpy takes them) and ``np.asarray``.  A read returns a
fresh array, as h5py does, and ``[()]`` of a 0-d dataset a numpy
scalar.  Byte strings (dtype ``S``) and 0-d scalars round-trip exactly;
object arrays are refused.  A store opened for writing is built in
``<path>.tmp`` and moved into place when it is closed, so a run killed
mid-write leaves no half-written store under the final name.
"""
import os
import shutil
from pathlib import Path

import numpy as np

_SUFFIX = '.npy'


def open_file(path, mode='r'):
    """Open ``path`` as h5py opens a file: ``'r'`` reads the npy store (a
    directory) or an HDF5 file (a regular file); ``'w'`` creates the npy
    store, replacing whatever ``path`` held."""
    path = Path(path)
    if mode == 'w':
        return Store(path)
    if mode != 'r':
        raise ValueError(f'open_file: mode {mode!r}, expected "r" or "w"')
    if path.is_dir():
        return Store(path, read_only=True)
    if path.is_file():
        import h5py
        return h5py.File(path, 'r')
    raise FileNotFoundError(f'no array store or HDF5 file at {path}')


class Dataset:
    """One array, stored as ``<name>.npy``."""

    def __init__(self, path: Path):
        self._path = path
        self._array = None

    @property
    def _data(self):
        if self._array is None:
            self._array = np.load(self._path, mmap_mode='r',
                                  allow_pickle=False)
        return self._array

    @property
    def shape(self):
        return self._data.shape

    @property
    def dtype(self):
        return self._data.dtype

    def __len__(self):
        if self._data.ndim == 0:
            raise TypeError('a scalar dataset has no len()')
        return self._data.shape[0]

    def __getitem__(self, key):
        value = self._data[key]
        return np.array(value) if isinstance(value, np.ndarray) else value

    def __array__(self, dtype=None, copy=None):
        return np.array(self._data, dtype=dtype)


class Group:
    """A directory of datasets and groups."""

    def __init__(self, path: Path, read_only: bool):
        self._path = path
        self._read_only = read_only

    def _member(self, name):
        path = self._path
        for part in str(name).strip('/').split('/'):
            path = path / part
        return path

    def __getitem__(self, name):
        path = self._member(name)
        if path.is_dir():
            return Group(path, self._read_only)
        array = path.with_name(path.name + _SUFFIX)
        if array.is_file():
            return Dataset(array)
        raise KeyError(f'{name!r} is not in {self._path}')

    def __contains__(self, name):
        path = self._member(name)
        return path.is_dir() or path.with_name(path.name + _SUFFIX).is_file()

    def keys(self):
        return sorted(p.name[:-len(_SUFFIX)] if p.is_file() else p.name
                      for p in self._path.iterdir()
                      if p.is_dir() or p.name.endswith(_SUFFIX))

    def __len__(self):
        return len(self.keys())

    def _check_new(self, name):
        if self._read_only:
            raise OSError(f'{self._path} is open for reading')
        if '/' in str(name).strip('/') or name in self:
            raise ValueError(f'cannot create {name!r} in {self._path}')

    def create_group(self, name):
        self._check_new(name)
        path = self._member(name)
        path.mkdir()
        return Group(path, self._read_only)

    def create_dataset(self, name, data, **ignored):
        """Write ``data``; h5py's storage keywords (``compression``,
        ``chunks``, ...) are ignored."""
        self._check_new(name)
        array = np.asarray(data)
        if array.dtype.hasobject:
            raise TypeError(f'{name}: object arrays cannot be stored')
        if array.dtype.metadata and array.dtype.names is None:
            # h5py's type annotations (an enum for bool, ...): npy keeps
            # none, and the values are the same without them
            array = array.astype(np.dtype(array.dtype.str))
        path = self._member(name)
        np.save(path.with_name(path.name + _SUFFIX), array,
                allow_pickle=False)
        return Dataset(path.with_name(path.name + _SUFFIX))


class Store(Group):
    """The root group of an npy store; a context manager like
    ``h5py.File``."""

    def __init__(self, path: Path, read_only: bool = False):
        self._final = path
        if not read_only:
            path = path.with_name(path.name + '.tmp')
            _remove(path)
            path.mkdir(parents=True)
        super().__init__(path, read_only)

    def close(self):
        """Move a store built for writing into place (once)."""
        if not self._read_only and self._path != self._final:
            _remove(self._final)
            os.replace(self._path, self._final)
            self._path = self._final
        self._read_only = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        elif not self._read_only:
            shutil.rmtree(self._path, ignore_errors=True)


def _remove(path: Path):
    if path.is_dir() and not path.is_symlink():
        shutil.rmtree(path)
    elif path.exists() or path.is_symlink():
        path.unlink()
