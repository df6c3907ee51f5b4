"""The port's copy of the prefetch file cache held to the JAX package's
``data/file_iterators.py``.

The JAX package's five iterator tests (``tests/utils/test_file_iterator.py``,
which stays the JAX package's own), each run once over each module: the
loader thread only copies a file when the test grants it a permit, so
the cache's states are asserted step by step without sleeps.  Then each
policy of ``create_file_iterator`` (no cache, the warm path, the strict
iterator, the non-blocking one) over one gated schedule in both modules:
the sequences of files served are equal.
"""
import importlib
import queue
import time
from pathlib import Path

import pytest

MODULES = {'jax': 'dvs_of_training_framework_tpu.data.file_iterators',
           'port': 'dvs_of_training_framework_tpu_torch.data.file_iterators'}


@pytest.fixture(params=list(MODULES))
def fi(request):
    return importlib.import_module(MODULES[request.param])


def gated(fi):
    """``fi``'s FileLoader that blocks until the test grants a copy
    permit."""
    class GatedFileLoader(fi.FileLoader):
        def __init__(self, cache_dir):
            super().__init__(cache_dir)
            self.permits = queue.Queue()

        def allow(self, n=1):
            for _ in range(n):
                self.permits.put(None)

        def __call__(self, filename):
            self.permits.get()
            return super().__call__(filename)
    return GatedFileLoader


def make_files(tmp_path, n=6):
    src = tmp_path / 'remote'
    src.mkdir()
    files = []
    for i in range(n):
        f = src / f'{i}.hdf5'
        f.write_text(str(i))
        files.append(f)
    return files


def content(file):
    return Path(file.name).read_text()


def test_strict_iterator_step_by_step(fi, tmp_path):
    files = make_files(tmp_path)
    loader = gated(fi)(tmp_path / 'cache')
    it = fi.CachingFileIterator(files, loader, num_files_to_cache=2,
                                num_non_cached_files=1)
    # nothing loaded yet: non-blocking next returns None
    assert it.next(block=False) is None
    loader.allow(1)
    f0 = it.next()           # blocks until file 0 is cached
    assert content(f0) == '0'
    # file 1 not loaded yet
    assert it.next(block=False) is None
    loader.allow(1)
    f1 = it.next()
    assert content(f1) == '1'
    # cache full of unreleased files -> strict policy refuses
    with pytest.raises(fi.CacheIsFullError):
        it.next(block=False)
    # releasing the oldest frees a slot
    f0.release()
    loader.allow(1)
    f2 = it.next()
    assert content(f2) == '2'
    f1.release()
    f2.release()


def test_strict_iterator_reset(fi, tmp_path):
    files = make_files(tmp_path)
    loader = gated(fi)(tmp_path / 'cache')
    it = fi.CachingFileIterator(files, loader, num_files_to_cache=2,
                                num_non_cached_files=1)
    loader.allow(1)
    f0 = it.next()
    assert content(f0) == '0'
    f0.release()
    loader.allow(4)  # let in-flight loads finish so reset can drain
    it.reset()
    loader.allow(1)
    again = it.next()
    assert content(again) == '0'
    again.release()


def test_nonblocking_iterator_reserves_cached(fi, tmp_path):
    files = make_files(tmp_path)
    loader = gated(fi)(tmp_path / 'cache')
    it = fi.NonBlockingFileIterator(files, loader, num_files_to_cache=2,
                                    num_non_cached_files=1)
    loader.allow(1)
    f0 = it.next()
    assert content(f0) == '0'
    f0.release()
    # file 1 still loading: the non-blocking policy re-serves file 0
    again = it.next()
    assert content(again) == '0'
    again.release()
    loader.allow(1)
    _wait_for_response(it)
    f1 = it.next()
    assert content(f1) == '1'
    f1.release()


def _wait_for_response(it, timeout=5.0):
    """Wait until the loader thread has deposited a finished file (keeps the
    non-blocking assertions deterministic without sleeping in the
    protocol itself)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if it.response_queue.qsize() > 0:
            return
        time.sleep(0.005)
    raise TimeoutError('loader thread produced no file')


def test_cache_everything_fast_path(fi, tmp_path):
    files = make_files(tmp_path, n=3)
    it = fi.create_file_iterator(files, cache_dir=tmp_path / 'cache',
                                 num_files_in_cache=5)
    # all files cached up front; iteration cycles without management
    seen = [Path(it.next().name).read_text() for _ in range(6)]
    assert seen == ['0', '1', '2', '0', '1', '2']


def test_no_cache_dir_iterates_in_place(fi, tmp_path):
    files = make_files(tmp_path, n=3)
    it = fi.create_file_iterator(files, cache_dir=None)
    f = it.next()
    assert Path(f.name) == files[0]
    f.release()  # no-op
    assert Path(it.next().name) == files[1]


# --- every policy over one schedule ---------------------------------------

# before each next call after the first: F lets one copy land (when none
# waits to be collected), S lets none
SCHEDULE = 'SFFSSFSFFFSSFSFS'
POLICIES = {'no_cache': dict(num_files_in_cache=0),
            'warm': dict(num_files_in_cache=8),
            'strict': dict(num_files_in_cache=3, process_only_once=True),
            'non_blocking': dict(num_files_in_cache=3,
                                 process_only_once=False)}
N_FILES = 5


def served_sequence(fi, tmp_path, monkeypatch, policy):
    """The files ``policy``'s iterator serves over SCHEDULE, each released
    before the next call; None where the strict iterator had none
    ready."""
    files = make_files(tmp_path, n=N_FILES)
    loaders, gated_loader = [], gated(fi)

    def loader(cache_dir):
        loaders.append(gated_loader(cache_dir))
        if policy == 'warm':     # it copies the whole set up front
            loaders[-1].allow(N_FILES)
        return loaders[-1]
    monkeypatch.setattr(fi, 'FileLoader', loader)
    it = fi.create_file_iterator(
        files, None if policy == 'no_cache' else tmp_path / 'cache',
        **POLICIES[policy])
    managed = policy in ('strict', 'non_blocking')
    served, current = [], None
    for mark in 'F' + SCHEDULE:
        if current is not None:
            current.release()
        if managed and mark == 'F' and not it.response_queue.qsize():
            loaders[0].allow(1)
            _wait_for_response(it)
        current = it.next(False) if policy == 'strict' else it.next()
        served.append(None if current is None else content(current))
    return served


@pytest.mark.parametrize('policy', list(POLICIES))
def test_each_policy_serves_as_the_jax_package(tmp_path, monkeypatch,
                                               policy):
    runs = {}
    for name, module in MODULES.items():
        fi = importlib.import_module(module)
        (tmp_path / name).mkdir()
        with monkeypatch.context() as patch:
            runs[name] = served_sequence(fi, tmp_path / name, patch, policy)
    assert runs['port'] == runs['jax']
    served = runs['port']
    assert len(served) == len(SCHEDULE) + 1
    in_order = [str(i % N_FILES) for i in range(len(served))]
    if policy in ('no_cache', 'warm'):
        assert served == in_order
    elif policy == 'strict':
        # each file once, in order, with None where none was ready
        ready = [s for s in served if s is not None]
        assert ready == in_order[:len(ready)] and None in served
    else:
        # a cached file served again while the next one copies
        assert served != in_order[:len(served)] and None not in served
        assert served[:2] == ['0', '0']
