"""ctypes bindings for the native C++ transformation kernels.

Builds ``libdvs_transformations.so`` from ``transformations.cc`` on first use
(the reference builds its pybind11 module via CMake in build.sh:10-15; here a
single translation unit + g++ suffices and avoids a cmake dependency).  A
NumPy fallback keeps the package importable on systems without a compiler.

The port's copy of ``dvs_of_training_framework_tpu/native/__init__.py``.
The library is built into ``build/native/`` at the root of the checkout
(git-ignored), under a temporary name that is then renamed, so processes
that build at once never load a partial file.
"""
import ctypes
import os
from pathlib import Path
import subprocess
import threading

import numpy as np

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parents[1] / 'build' / 'native'
_LIB_PATH = _BUILD_DIR / 'libdvs_transformations.so'
_SRC_PATH = _HERE / 'transformations.cc'
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build_library():
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f'{_LIB_PATH.name}.{os.getpid()}.tmp'
    cmd = ['g++', '-O3', '-march=native', '-shared', '-fPIC',
           '-o', str(tmp), str(_SRC_PATH)]
    subprocess.check_call(cmd, cwd=str(_HERE))
    os.replace(tmp, _LIB_PATH)   # atomic: other processes never see a part


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not _LIB_PATH.is_file()
                    or _LIB_PATH.stat().st_mtime < _SRC_PATH.stat().st_mtime):
                _build_library()
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.dvs_event_map.restype = ctypes.c_int64
            lib.dvs_event_map.argtypes = [
                ctypes.POINTER(ctypes.c_float),   # events
                ctypes.c_int64,                   # n_events
                ctypes.c_int64,                   # n_cols
                ctypes.c_int64,                   # height
                ctypes.c_int64,                   # width
                ctypes.POINTER(ctypes.c_uint64),  # src_idx
                ctypes.POINTER(ctypes.c_uint64),  # dst_idx
                ctypes.c_int64,                   # n_map
                ctypes.POINTER(ctypes.c_float),   # out_events
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as exc:  # pragma: no cover
            import warnings
            warnings.warn('native transformations build failed '
                          f'({exc}); using NumPy fallback')
            _build_failed = True
    return _lib


def _event_map_numpy(events, shape, src_idx, dst_idx):
    height, width = int(shape[0]), int(shape[1])
    table = np.full(height * width, -1, dtype=np.int64)
    table[src_idx.astype(np.int64)] = dst_idx.astype(np.int64)
    x = events[:, 0].astype(np.int64)
    y = events[:, 1].astype(np.int64)
    inside = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    pix = np.where(inside, y * width + x, 0)
    mapped = np.where(inside, table[pix], -1)
    keep = mapped >= 0
    out = events[keep].copy()
    out[:, 0] = (mapped[keep] % width).astype(np.float32)
    out[:, 1] = (mapped[keep] // width).astype(np.float32)
    return out


def event_map(events, shape, src_idx, dst_idx):
    """Remap event pixel coordinates through an index mapping.

    Args:
        events: float32 ``[N, C>=2]`` rows ``(x, y, ...)``.
        shape: ``(height, width)`` of the pixel grid.
        src_idx: uint64 raveled source pixel indices.
        dst_idx: uint64 raveled destination pixel indices (same length).

    Returns:
        float32 ``[M, C]`` surviving remapped events (M <= N).
    """
    events = np.ascontiguousarray(events, dtype=np.float32)
    src_idx = np.ascontiguousarray(src_idx, dtype=np.uint64)
    dst_idx = np.ascontiguousarray(dst_idx, dtype=np.uint64)
    assert events.ndim == 2 and events.shape[1] >= 2
    assert src_idx.shape == dst_idx.shape

    lib = _load()
    if lib is None:
        return _event_map_numpy(events, shape, src_idx, dst_idx)

    n_events, n_cols = events.shape
    out = np.empty_like(events)
    n_out = lib.dvs_event_map(
        events.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_events, n_cols, int(shape[0]), int(shape[1]),
        src_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        dst_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        src_idx.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if n_out < 0:
        raise ValueError('dvs_event_map: invalid arguments '
                         f'(shape={shape}, n_cols={n_cols})')
    return out[:n_out]
