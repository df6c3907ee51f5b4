"""Background-thread file prefetch cache for slow storage.

TPU-VM training streams preprocessed HDF5 shards from remote/slow storage;
a daemon thread copies upcoming shards into a fast local cache directory
(SSD) ahead of the consumer.  Two policies match the reference
(utils/file_iterators.py — behavioural parity only; the structure here is
a composition design: a ``_PrefetchPump`` owns the loader thread and its
flow-control queues, and the two policy classes consume it):

- ``CachingFileIterator`` (strict): every file is processed exactly once per
  epoch; the consumer blocks until the next file is cached, and a full cache
  of unreleased files raises ``CacheIsFullError``.
- ``NonBlockingFileIterator``: may re-serve already-cached files while the
  next one downloads (better device utilisation when loading is slower than
  processing).

Flow control uses a bounded slot queue: the loader thread must acquire a
slot before copying, so at most ``num_non_cached_files`` finished downloads
sit outside the cache.  The deterministic token-driven tests in
tests/utils/test_file_iterator.py pin the step-by-step cache states.

The port's copy of
``dvs_of_training_framework_tpu/data/file_iterators.py``.  A shard of the
npy store is a directory (``data/store.py``), so the loader copies a
directory as a tree and a cached directory is removed as one.
"""
import queue
import shutil
import tempfile
import threading
from collections import deque
from pathlib import Path


class CacheIsFullError(Exception):
    pass


class DummyFile:
    """A named file whose release is a no-op (not cache-managed)."""

    def __init__(self, filename):
        self.filename = filename

    @property
    def name(self):
        return self.filename

    def release(self):
        pass


class ReleasableFile:
    """A cached file removed from disk once released by the consumer.

    ``in_use`` needs no lock: only the consumer thread flips it and removes
    the file.
    """

    def __init__(self, filename):
        self.filename = Path(filename)
        self.in_use = True

    def _assert_exists(self):
        assert self.filename.exists(), \
            f"File {self.filename} doesn't exist"

    @property
    def name(self):
        self._assert_exists()
        return self.filename

    def release(self):
        self._assert_exists()
        self.in_use = False

    def is_in_use(self):
        self._assert_exists()
        return self.in_use

    def start_use(self):
        self._assert_exists()
        self.in_use = True

    def remove(self):
        self._assert_exists()
        assert not self.in_use, 'Currently used file cannot be removed'
        if self.filename.is_dir():
            shutil.rmtree(self.filename)
        else:
            self.filename.unlink()


class FileIterator:
    """Cycle over a file list without caching."""

    def __init__(self, files):
        self.files = list(files)
        self.index = 0

    def next(self, blocking=True):
        result = self.files[self.index]
        self.index = (self.index + 1) % len(self.files)
        return DummyFile(result)

    def reset(self):
        self.index = 0


class FileLoader:
    """Copy a file (or an npy-store directory) into the cache dir under a
    unique temporary name."""

    def __init__(self, cache_dir):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(exist_ok=True, parents=True)

    def __call__(self, filename):
        suffix = Path(filename).suffix
        if Path(filename).is_dir():
            cached = Path(tempfile.mkdtemp(dir=self.cache_dir, suffix=suffix))
            shutil.copytree(filename, cached, dirs_exist_ok=True)
            return cached
        with tempfile.NamedTemporaryFile(dir=self.cache_dir, suffix=suffix,
                                         delete=False) as f:
            cached = Path(f.name)
        shutil.copyfile(filename, cached)
        return cached


class _PrefetchPump:
    """The loader thread plus its flow-control state.

    Downloads cycle through ``sources`` in order.  The bounded ``_slots``
    queue caps how many finished-but-uncollected downloads may exist, so a
    slow consumer back-pressures the loader instead of filling the disk.
    """

    def __init__(self, sources, loader, max_uncollected):
        self._sources = list(sources)
        self._cursor = 0       # next source file to schedule
        self._pending = 0      # scheduled but not yet collected
        self._work = queue.Queue()
        self._slots = queue.Queue(max_uncollected)
        self._done = queue.Queue()
        thread = threading.Thread(target=self._run, args=(loader,),
                                  daemon=True)
        thread.start()

    def _run(self, loader):
        while True:
            source = self._work.get()
            if source is None:
                return
            self._slots.put(None)  # back-pressure: wait for a slot
            self._done.put(loader(source))

    @property
    def pending(self):
        return self._pending

    def schedule(self):
        """Queue the next source file for download."""
        self._work.put(self._sources[self._cursor])
        self._cursor = (self._cursor + 1) % len(self._sources)
        self._pending += 1

    def collect(self, block):
        """Take one finished download and schedule its replacement.

        Raises ``queue.Empty`` when ``block`` is false and nothing is ready.
        """
        cached = self._done.get(block)
        self._slots.get()
        self._pending -= 1
        self.schedule()
        return ReleasableFile(cached)

    def restart(self, prime):
        """Discard everything in flight and rewind to source file 0."""
        for _ in range(self._pending):
            stale = ReleasableFile(self._done.get(True))
            self._slots.get()
            stale.release()
            stale.remove()
        self._pending = 0
        self._cursor = 0
        for _ in range(prime):
            self.schedule()


def _drop(cache, position):
    """Remove the cache's front file from disk; shift the serve position."""
    cache.popleft().remove()
    return max(position - 1, 0)


class CachingFileIterator:
    """Strict process-once prefetching iterator.

    Behavioural twin of the reference's FileIteratorWithCache: each file is
    served exactly once per cycle, released files are evicted, and when all
    cache slots hold unreleased files ``next`` raises ``CacheIsFullError``.
    """

    def __init__(self, remote_files, file_loader, num_files_to_cache,
                 num_non_cached_files):
        remote_files = list(remote_files)
        self.capacity = min(num_files_to_cache, len(remote_files))
        self._pump = _PrefetchPump(remote_files, file_loader,
                                   num_non_cached_files)
        self._cache = deque()
        self._served = 0  # cache entries already handed to the consumer
        for _ in range(self.capacity):
            self._pump.schedule()

    # test hook: deterministic tests poll the loader thread's output queue
    @property
    def response_queue(self):
        return self._pump._done

    def next(self, block=True):
        """Return the next cached file, or None when non-blocking and
        nothing is ready.

        Raises:
            CacheIsFullError: every cache slot holds an unreleased file.
        """
        while self._cache and not self._cache[0].is_in_use():
            self._served = _drop(self._cache, self._served)
        if self._served == self.capacity:
            raise CacheIsFullError(
                'List of the cached files is full. Please release the '
                f"oldest file '{self._cache[0].name}'")
        while len(self._cache) < self.capacity:
            try:
                must_wait = block and len(self._cache) <= self._served
                self._cache.append(self._pump.collect(must_wait))
            except queue.Empty:
                break
        if self._served >= len(self._cache):
            return None
        self._served += 1
        return self._cache[self._served - 1]

    def reset(self):
        """Drop all cached and in-flight files; restart from file 0."""
        while self._cache:
            stale = self._cache.pop()
            stale.release()
            stale.remove()
        self._served = 0
        self._pump.restart(self.capacity)


class NonBlockingFileIterator:
    """Round-robin over the cache while downloads are in flight.

    Behavioural twin of the reference's FileIteratorNonBlocking: when the
    next file is still loading, an already-cached file is re-served instead
    of blocking, trading strict ordering for consumer throughput.
    """

    def __init__(self, remote_files, file_loader, num_files_to_cache,
                 num_non_cached_files):
        remote_files = list(remote_files)
        self.capacity = min(num_files_to_cache, len(remote_files))
        self._pump = _PrefetchPump(remote_files, file_loader,
                                   num_non_cached_files)
        self._cache = deque()
        self._position = 0  # round-robin serve index
        for _ in range(self.capacity):
            self._pump.schedule()

    @property
    def response_queue(self):
        return self._pump._done

    def next(self, block=True):
        while (len(self._cache) < self.capacity
               or not self._cache[0].is_in_use()):
            try:
                block = block and not self._cache
                fresh = self._pump.collect(block)
                if (len(self._cache) == self.capacity
                        and not self._cache[0].is_in_use()):
                    self._position = _drop(self._cache, self._position)
                self._cache.append(fresh)
            except queue.Empty:
                break
        if not self._cache:
            assert not block
            return None
        self._position %= len(self._cache)
        served = self._cache[self._position]
        served.start_use()
        self._position += 1
        return served

    def reset(self):
        """Drop all cached and in-flight files; restart from file 0."""
        while self._cache:
            stale = self._cache.pop()
            stale.release()
            stale.remove()
        self._position = 0
        self._pump.restart(self.capacity)


# Aliases matching the reference class names.
FileIteratorWithCache = CachingFileIterator
FileIteratorNonBlocking = NonBlockingFileIterator


def create_file_iterator(files,
                         cache_dir=None,
                         num_files_in_cache=5,
                         process_only_once=True):
    """Select and build the right iterator for the cache configuration.

    Same decision table as reference utils/file_iterators.py:63-94,
    including the cache-everything fast path: when the cache can hold every
    file, all files are copied up front and a plain FileIterator cycles
    over the cached copies with no management overhead.
    """
    files = [Path(f) for f in files]
    if cache_dir is None:
        return FileIterator(files)
    if num_files_in_cache >= len(files):
        # Warm the whole cache once, then serve without management.
        warmer = CachingFileIterator(files, FileLoader(cache_dir),
                                     num_files_in_cache, 2)
        return FileIterator([warmer.next().name for _ in files])
    policy = (CachingFileIterator if process_only_once
              else NonBlockingFileIterator)
    return policy(files, FileLoader(cache_dir),
                  max(num_files_in_cache - 1, 1), 1)
