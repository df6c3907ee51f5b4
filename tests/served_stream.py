"""The port's preprocessed reader held to the files its cache served.

``install(setattr, copies)`` patches the port's ``data.file_iterators``
and ``data.preprocessed`` (through ``setattr``: pytest's
``monkeypatch.setattr``, or the builtin in a rank of
``tests/torch_mesh_worker.py``) so that

- every copy into a ``--cache-dir`` goes through ``copies``
  (:class:`Copies`): finished on the test's schedule or after a fixed
  delay, and its source recorded;
- every file a non-blocking cache serves is recorded as a visit of its
  source;
- every slice the reader reads must lie inside its served file;
- every batch must hold exactly the samples of the reader's stream: the
  served files one after another, each read whole, in the order served,
  and of that stream this rank's slice of every stride of
  ``batch_size * process_count`` samples, read straight from the source
  shards.

Imports nothing of JAX.
"""
import itertools
import queue
import time
from pathlib import Path

import numpy as np

from dvs_of_training_framework_tpu_torch.data import (codec, file_iterators,
                                                      preprocessed, store)

WAIT = 30.0         # seconds a gated copy may take to land


class Copies:
    """The copies of a cache, each finished on a permit (``schedule``) or
    after ``delay`` seconds.

    ``schedule`` is a string cycled over the non-blocking iterator's
    ``next`` calls: ``F`` lets one copy finish before the call (when none
    is waiting to be collected), ``S`` lets none, so the iterator serves
    a cached file again.  The first call after the iterator starts or
    restarts is always ``F``.  Without a schedule every copy finishes
    after ``delay`` seconds, as from slow storage."""

    def __init__(self, schedule=None, delay=0.0):
        self.marks = None if schedule is None else itertools.cycle(schedule)
        self.delay = delay
        self.permits = queue.Queue()
        self.sources = {}           # a cached copy's path -> its source
        self.base = None            # the FileLoader that install() wraps

    def loader(self, cache_dir):
        copies, base = self, self.base

        class Loader(base):
            def __call__(self, filename):
                if copies.marks is not None:
                    copies.permits.get()
                else:
                    time.sleep(copies.delay)
                cached = base.__call__(self, filename)
                copies.sources[Path(cached)] = Path(filename)
                return cached
        return Loader(cache_dir)

    def _land_one(self, iterator):
        if iterator.response_queue.qsize():
            return
        self.permits.put(None)
        deadline = time.monotonic() + WAIT
        while not iterator.response_queue.qsize():
            if time.monotonic() > deadline:
                raise TimeoutError('a gated copy did not land')
            time.sleep(0.001)

    def before_next(self, iterator):
        if self.marks is None:
            return
        fresh = getattr(iterator, 'fresh', True)
        iterator.fresh = False
        if fresh or next(self.marks) == 'F':
            self._land_one(iterator)

    def before_reset(self, iterator):
        """Let the copies in flight land, so that the restart can drain
        them; the restarted cache's first call lands one more."""
        if self.marks is not None:
            for _ in range(iterator._pump.pending
                           - iterator.response_queue.qsize()):
                self.permits.put(None)
        iterator.fresh = True


class Source:
    """A source shard's samples, read straight from it."""
    _sizes = {}

    @classmethod
    def size(cls, path):
        if path not in cls._sizes:
            with store.open_file(path, 'r') as f:
                cls._sizes[path] = len(f['elements_per_sample'])
        return cls._sizes[path]

    @staticmethod
    def read(pieces, is_raw):
        """The decoded batch of ``[(source, begin, end), ...]``."""
        encoded = []
        for path, begin, end in pieces:
            with store.open_file(path, 'r') as f:
                spans = np.asarray(f['elements_per_sample'])
                if is_raw:
                    sizes = np.asarray(f['events']['events_per_element'])
                    encoded.append(codec.read_encoded_batch(
                        f, sizes, spans, begin, end))
                else:
                    sizes = np.asarray(f['channels_per_sample'])
                    encoded.append(codec.read_encoded_quantized_batch(
                        f, sizes, spans, begin, end))
        merged = codec.join_batches(encoded)
        return (codec.decode_batch(merged) if is_raw
                else codec.decode_quantized_batch(merged))


def assert_trees_equal(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for key in want:
            assert_trees_equal(got[key], want[key], path + (key,))
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


class Stream:
    """One reader's model: the visits its cache served (source paths),
    where its current stream starts among them (``origin``: a
    ``set_index`` restarts the cache and the stream), and the stream
    position of its next slice."""

    def __init__(self, reader, visits):
        self.reader = reader
        self.visits = visits
        self.origin = 0
        self.pos = reader.process_index * reader.batch_size
        self.slices = []        # (visit, begin, end) of the batch being read
        self.batches = 0

    def pieces(self, start, n):
        """``[(visit, begin, end), ...]`` of stream positions
        ``[start, start + n)``."""
        out, offset = [], 0
        for visit in itertools.count(self.origin):
            if visit >= len(self.visits):
                raise AssertionError(
                    f'positions [{start}, {start + n}) lie past the '
                    f'{len(self.visits) - self.origin} visits served')
            size = Source.size(self.visits[visit])
            lo, hi = max(start, offset), min(start + n, offset + size)
            if lo < hi:
                out.append((visit, lo - offset, hi - offset))
            offset += size
            if offset >= start + n:
                return out

    def stride(self):
        return self.reader.batch_size * self.reader.process_count


def install(setattr, copies):
    """Patch the port's cache and reader (module docstring)."""
    fi, pre = file_iterators, preprocessed
    Reader = pre.PreprocessedDataloader
    copies.base = fi.FileLoader
    setattr(fi, 'FileLoader', copies.loader)

    nb_next, nb_reset = fi.NonBlockingFileIterator.next, \
        fi.NonBlockingFileIterator.reset

    def next_visit(self, block=True):
        copies.before_next(self)
        served = nb_next(self, block)
        if served is not None:
            if not hasattr(self, 'visits'):
                self.visits, self.served, self.restart_at = [], [], 0
            self.visits.append(copies.sources[Path(served.name)])
            self.served.append(Path(served.name))
        return served

    def reset(self):
        copies.before_reset(self)
        self.restart_at = len(self.visits)
        nb_reset(self)

    def init(self, *args, **kwargs):
        reader_init(self, *args, **kwargs)
        if not self.in_order:
            self.stream = Stream(self, self.iterator.visits)

    def read_slice(self, shard, begin, end):
        size = len(shard['elements_per_sample'])
        assert 0 <= begin < end <= size, \
            f'slice [{begin}, {end}) of a file of {size} samples'
        stream = getattr(self, 'stream', None)
        if stream is not None:
            stream.slices.append((len(stream.visits) - 1, begin, end))
        return reader_slice(self, shard, begin, end)

    def next_batch(self):
        stream = getattr(self, 'stream', None)
        if stream is None:
            return reader_next(self)
        stream.slices = []
        batch = reader_next(self)
        want = stream.pieces(stream.pos, self.batch_size)
        assert stream.slices == want, (stream.slices, want)
        expected = Source.read([(stream.visits[v], b, e) for v, b, e in want],
                               self.is_raw)
        assert_trees_equal(batch, expected)
        stream.pos += stream.stride()
        stream.batches += 1
        return batch

    def skip_batch(self):
        reader_skip(self)
        stream = getattr(self, 'stream', None)
        if stream is not None:
            stream.pos += stream.stride()

    def set_index(self, idx):
        reader_set_index(self, idx)
        stream = getattr(self, 'stream', None)
        if stream is not None:
            if self.process_count > 1:
                stride = stream.stride()
                idx = (idx // stride) * stride \
                    + self.process_index * self.batch_size
            # the restarted cache's first visit opens the new stream
            stream.origin = self.iterator.restart_at
            stream.pos = idx % self.length

    reader_init, reader_slice, reader_next = \
        Reader.__init__, Reader._read_slice, Reader.__next__
    reader_skip, reader_set_index = Reader.skip_batch, Reader.set_index
    setattr(fi.NonBlockingFileIterator, 'next', next_visit)
    setattr(fi.NonBlockingFileIterator, 'reset', reset)
    setattr(Reader, '__init__', init)
    setattr(Reader, '_read_slice', read_slice)
    setattr(Reader, '__next__', next_batch)
    setattr(Reader, 'skip_batch', skip_batch)
    setattr(Reader, 'set_index', set_index)
