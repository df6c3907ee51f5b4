"""Whole-run profiler context (reference utils/profiling.py:10-62).

The port's counterpart of ``dvs_of_training_framework_tpu/utils/
profiling.py``, with the choices of ``--profiling``:

- ``JAX``: a ``torch.profiler`` trace of the host and, where there is a
  card, of its kernels and copies, written on exit as a Chrome trace
  (``trace.<pid>.json``, for Perfetto or ``chrome://tracing``) into
  ``logdir``;
- ``CPU``: the same trace of the host alone;
- ``NVTX``: ``torch.autograd.profiler.emit_nvtx()``, an NVTX range around
  every operator for an external profiler (Nsight Systems) to read;
  nothing is written here;
- ``None``: nothing.
"""
import os
from pathlib import Path

import torch

PROFILER_TYPES = ('JAX', 'CPU', 'NVTX', 'None')


class Profiler:
    def __init__(self, profiler_type, logdir=Path('.')):
        if profiler_type is None:
            profiler_type = 'None'
        if profiler_type not in PROFILER_TYPES:
            raise AssertionError(f'Unknown profiler type {profiler_type}')
        self.profiler_type = profiler_type
        self._logdir = Path(logdir)
        self._context = None
        if profiler_type in ('JAX', 'CPU'):
            self._logdir.mkdir(exist_ok=True, parents=True)

    @property
    def trace_path(self):
        return self._logdir / f'trace.{os.getpid()}.json'

    def __enter__(self):
        if self.profiler_type in ('JAX', 'CPU'):
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.profiler_type == 'JAX' and torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._context = torch.profiler.profile(activities=activities)
        elif self.profiler_type == 'NVTX':
            self._context = torch.autograd.profiler.emit_nvtx()
        if self._context is not None:
            self._context.__enter__()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._context is None:
            return
        self._context.__exit__(exc_type, exc_val, exc_tb)
        if self.profiler_type in ('JAX', 'CPU'):
            self._context.export_chrome_trace(str(self.trace_path))
        self._context = None
