"""Build the port's CUDA kernels with nvcc on first use and bind them.

The sources in ``csrc/`` have a plain C interface, so they compile with
nvcc alone in seconds (no PyTorch headers), one nvcc process per source,
all started together, and link into one shared library, which ``ctypes``
loads.  The library lands in ``build/kernels/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as is.  Nothing here runs
at import time: the CPU tests import every module of the port.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / 'csrc'
BUILD_DIR = PACKAGE.parent / 'build' / 'kernels'
SOURCES = ('voxelize.cu', 'kernel_mlp.cu', 'warp_corners.cu',
           'flow_head.cu')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of every C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    'voxelize_fwd': [_P] * 9 + [_LL] + [_I] * 6 + [_P],
    'voxelize_fwd_blocks': [_LL],
    'voxelize_bwd': [_P] * 6 + [_LL, _I, _I, _I, _I, _I, _P],
    'kernel_mlp_fwd': [_P] * 8 + [_LL, _I, _P],
    'kernel_mlp_bwd': [_P] * 11 + [_LL, _I, _I, _P],
    'kernel_mlp_grad_size': [],
    'kernel_mlp_bwd_blocks': [_LL],
    'warp_corners': [_P] * 4 + [_I, _I, _I, _I, _P],
    'warp_fwd': [_P] * 3 + [_I] * 5 + [_LL] * 4 + [_P],
    'warp_bwd': [_P] * 4 + [_I] * 5 + [_LL] * 4 + [_P],
    'flow_head_blocks': [_LL, _I, _LL, _I],
    'flow_head_fwd': [_P] * 4 + [_LL, _I, _LL, _I, _P],
    'flow_head_bwd': [_P] * 6 + [_LL, _I, _LL, _I, _I, _P],
}


def find_nvcc() -> str:
    nvcc = shutil.which('nvcc')
    if nvcc is None and Path('/usr/local/cuda/bin/nvcc').exists():
        nvcc = '/usr/local/cuda/bin/nvcc'
    if nvcc is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (PATH or /usr/local/cuda/bin)')
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f'libdvs_of_kernels_{digest.hexdigest()[:16]}.so'


def build() -> tuple:
    """Compile the kernels unless the library is already built.

    Returns ``(path, log)``: ``log`` holds nvcc's output, including
    ``-Xptxas -v``'s registers, shared memory and spills per kernel, and
    is empty when nothing was compiled.
    """
    lib = library_path()
    if lib.exists():
        return lib, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    stem = f'{lib.stem}.{os.getpid()}'
    objects = [BUILD_DIR / f'{stem}.{Path(name).stem}.o' for name in SOURCES]
    steps = [[nvcc, *NVCC_FLAGS, '-c', str(CSRC / name), '-o', str(obj)]
             for name, obj in zip(SOURCES, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in steps]
    outs = [proc.communicate()[0] for proc in procs]   # wait for all
    for cmd, proc, out in zip(steps, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed with code {proc.returncode}:\n'
                               f'{" ".join(cmd)}\n{out}')
    log = ''.join(outs)
    tmp = BUILD_DIR / f'{stem}.so.tmp'
    cmd = [nvcc, *NVCC_FLAGS[:2], '-shared', '-o', str(tmp),
           *map(str, objects)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed with code {proc.returncode}:\n'
                           f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
    for obj in objects:
        obj.unlink()
    os.replace(tmp, lib)   # atomic: concurrent builders never see a partial
    return lib, log + proc.stdout + proc.stderr


# the first call builds and loads under it; the launch counters add under
# it, since the evaluation CLI's DevicePool launches from several threads
_LOCK = threading.Lock()


def count(launches: dict, key: str) -> None:
    """Add one launch to ``launches[key]``, atomically across threads."""
    with _LOCK:
        launches[key] += 1


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use; threads that ask
    together wait for one build and one load."""
    with _LOCK:
        return _library()


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dvs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dvs_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        message = library().dvs_cuda_error_string(status).decode()
        raise RuntimeError(f'{name} failed: CUDA error {status} ({message})')
