"""Streaming loader over preprocessed encoded HDF5 shards.

Sequential batch reader with cross-file reads, ``.info`` sidecar size
caching, and exact resume by global sample index.  Behavioural parity
target: reference utils/dataset.py:799-954 (PreprocessedDataloader); the
implementation is independent — shard sizes are tabulated once up front and
the loader tracks its own shard position instead of re-deriving sizes from
cached file handles on every read.

The port's copy of ``dvs_of_training_framework_tpu/data/preprocessed.py``.
It opens every shard through ``store.open_file`` (an npy store, or an
HDF5 file read with h5py imported inside), and writes the shard-size
sidecar as JSON; its progress bar is tqdm's where tqdm is installed and
none where it is not (``utils/progress.py``), so the module imports and
reads without h5py, PyYAML and tqdm.
"""
import json
import math
from pathlib import Path

import numpy as np

from . import codec, store
from ..utils.progress import progress as show
from .file_iterators import NonBlockingFileIterator, create_file_iterator


def _shard_sample_count(shard_path):
    """Number of samples in an encoded shard, memoised in a ``.info``
    sidecar next to the shard, written as JSON (which YAML readers read
    too).  A sidecar that is not JSON (the JAX package writes ``size: n``)
    is left as it is and the shard counted."""
    shard_path = Path(shard_path)
    sidecar = shard_path.with_suffix('.info')
    if sidecar.is_file():
        try:
            return int(json.loads(sidecar.read_text())['size'])
        except json.JSONDecodeError:
            with store.open_file(shard_path, 'r') as f:
                return len(f['elements_per_sample'])
    with store.open_file(shard_path, 'r') as f:
        count = len(f['elements_per_sample'])
    sidecar.write_text(json.dumps({'size': count}))
    return count


def per_sample_event_counts(path) -> np.ndarray:
    """Event count of every sample in stream order (int64 ``[length]``).

    A pure metadata scan (``elements_per_sample`` +
    ``events_per_element`` prefix sums; no event payload reads).  Powers
    ``--event-capacity auto`` and the multi-host deterministic
    oversized-batch rule: the counts are a property of the (static,
    pre-augmented) stream, so every process derives the SAME skip
    decisions from them with zero communication
    (parallel/distributed.py ShardedBatchSkipper).
    """
    files = sorted(Path(path).glob('*.hdf5'), key=lambda p: int(p.stem))
    if not files:
        raise FileNotFoundError(
            f'No preprocessed dataset at {path} (no .hdf5 files)')
    counts = []
    for f in files:
        with store.open_file(f, 'r') as shard:
            if 'events' not in shard:
                raise ValueError(
                    'per-sample event counts require raw event shards; '
                    f'{f} holds quantized (dense) samples')
            spans = np.asarray(shard['elements_per_sample'], np.int64)
            per_element = np.asarray(
                shard['events']['events_per_element'], np.int64)
            # per-sample events via prefix sums (robust to empty samples,
            # unlike np.add.reduceat with repeated offsets)
            csum = np.concatenate([[0], np.cumsum(per_element)])
            ends = np.cumsum(spans)
            counts.append(csum[ends] - csum[ends - spans])
    return np.concatenate(counts)


def per_sample_channel_counts(path) -> np.ndarray:
    """Channel count of every DENSE (quantized) stream sample, in order.

    The dense analogue of :func:`per_sample_event_counts`: quantized
    shards store ``(B*C, H, W)`` planes plus ``channels_per_sample``
    (reference utils/dataset.py:429-479), so a sample's device-side size
    is its channel count.  With static sequence lengths every sample has
    the same count; with ``--dynamic-sample-length`` the counts vary and
    the multi-host skip rule needs them to stay globally deterministic
    (parallel/distributed.py ShardedBatchSkipper with these counts).
    """
    files = sorted(Path(path).glob('*.hdf5'), key=lambda p: int(p.stem))
    if not files:
        raise FileNotFoundError(
            f'No preprocessed dataset at {path} (no .hdf5 files)')
    counts = []
    for f in files:
        with store.open_file(f, 'r') as shard:
            if 'channels_per_sample' not in shard:
                raise ValueError(
                    'per-sample channel counts require quantized (dense) '
                    f'shards; {f} holds raw event samples')
            counts.append(np.asarray(shard['channels_per_sample'],
                                     np.int64))
    return np.concatenate(counts)


def max_batch_events(path, batch_size: int) -> int:
    """Largest event count a batch of ``batch_size`` consecutive samples
    can reach, over every stream alignment including the epoch wrap.

    Drives ``--event-capacity auto``: the on-device event buffer must
    admit the worst batch the stream can serve and nothing more — the
    2^18 default pads typical DVS batches 2-3x, costing upload bytes and
    voxelizer work proportionally (PERFORMANCE.md round 3).  Alignment
    matters: ``set_index`` can resume the stream at any sample, so the
    bound covers all sliding windows, not just epoch-aligned batches.
    """
    per_sample = per_sample_event_counts(path)
    if batch_size >= per_sample.size:
        return int(per_sample.sum())
    # sliding-window sums over the wrapped stream
    wrapped = np.concatenate([per_sample, per_sample[:batch_size - 1]])
    csum = np.concatenate([[0], np.cumsum(wrapped)])
    return int((csum[batch_size:] - csum[:-batch_size]).max())


def batch_events(per_sample_events, global_batch: int,
                 n_shards: int = 1) -> np.ndarray:
    """The events of the fullest of the ``n_shards`` equal slices of each
    global batch position of a stream that cycles ``per_sample_events``:
    entry k for stream samples ``[k * global_batch, (k + 1) *
    global_batch)`` modulo the stream's length.  The positions repeat
    after the result's length."""
    counts = np.asarray(per_sample_events, np.int64)
    length = counts.size
    assert global_batch <= length, \
        f'global batch {global_batch} exceeds dataset ({length})'
    csum = np.concatenate([[0], np.cumsum(np.tile(counts, 2))])
    positions = length // math.gcd(length, global_batch)
    spd = global_batch // n_shards
    lo = (np.arange(positions)[:, None] * global_batch % length
          + np.arange(n_shards) * spd)
    return (csum[lo + spd] - csum[lo]).max(axis=1)


def stream_position(per_sample, batch_size, capacity, samples_kept,
                    n_shards=1):
    """The stream's sample index after the batches that kept
    ``samples_kept`` samples, the skipped ones among them: batches of
    ``batch_size`` consecutive samples from index 0, wrapping at the end
    of ``per_sample`` (each sample's event count), each skipped when the
    fullest of its ``n_shards`` equal slices holds more than ``capacity``
    events (a mesh's rule, ``batch_events``; one slice on one rank).  A
    bake's resume and a training run's: a checkpoint's ``samples_passed``
    counts the trained batches only, and reading on from it would read
    again the batches that the run skipped (the JAX package's training
    and bake do)."""
    kept = -(-samples_kept // batch_size)
    if kept == 0:
        return 0
    events = batch_events(per_sample, batch_size, n_shards)
    fits = np.flatnonzero(events <= capacity)
    if fits.size == 0:
        raise ValueError(f'no batch of {batch_size} samples fits '
                         f'{capacity} events')
    cycles, k = divmod(kept - 1, fits.size)
    return (cycles * events.size + int(fits[k]) + 1) * batch_size


class PreprocessedDataloader:
    """Iterates decoded batches out of encoded shards.

    Batches may span shard boundaries; ``set_index`` seeks the stream to an
    arbitrary global sample index (modulo dataset length) so a resumed run
    continues from the exact sample its checkpoint recorded.

    Multi-host sharding (``process_count > 1``): the GLOBAL stream is
    consumed in strides of ``batch_size * process_count`` samples, and
    this loader serves only process ``process_index``'s ``batch_size``-
    sample slice of each stride — each host reads and decodes 1/P of the
    data instead of collating the full global batch and slicing
    (reference analogue: per-worker torch loaders, utils/dataloader.py:
    103-108).  ``set_index`` still takes the GLOBAL sample index; on an
    ordered stream the skip to the local slice is pure shard-size
    arithmetic (no reads).  A stream served out of order (a non-blocking
    cache) is the sequence of files the cache serves, each counted by its
    own samples, and a rank takes its slices of its own such stream.

    Attributes:
        sample_index: next sample within the current shard.
        batch_size: samples served per batch (the LOCAL batch size).
        files: shard paths.
        length: total samples in the dataset.
    """

    def __init__(self,
                 path: Path,
                 batch_size: int,
                 is_raw: bool,
                 cache_dir=None,
                 cache_size=0,
                 process_only_once=True,
                 show_progress=True,
                 process_index: int = 0,
                 process_count: int = 1):
        self.batch_size = batch_size
        self.is_raw = is_raw
        self.process_index = process_index
        self.process_count = process_count
        self.files = sorted(Path(path).glob('*.hdf5'),
                            key=lambda p: int(p.stem))
        if not self.files:
            raise FileNotFoundError(
                f'No preprocessed dataset at {path} (no .hdf5 files)')

        progress = self.files
        if show_progress:
            progress = show(progress,
                            desc='Reading information about the dataset')
        self._shard_sizes = [_shard_sample_count(f) for f in progress]
        self.length = int(sum(self._shard_sizes))

        self.iterator = create_file_iterator(
            self.files, cache_dir, process_only_once=process_only_once,
            num_files_in_cache=cache_size)
        self._shard = 0        # index of the current shard in self.files
        self.sample_index = 0  # next sample within the current shard
        self._meta = None      # (served file, (spans, per-element sizes))
        self.current_file = self.iterator.next()
        if self.process_index:
            self._skip(self.process_index * self.batch_size)

    def __len__(self):
        return self.length

    def __iter__(self):
        return self

    @property
    def in_order(self) -> bool:
        """Does it serve the stream in file order?  A non-blocking cache
        (``--cache-dir`` with a cache smaller than the set and
        ``--process-only-once`` unset) re-serves cached files instead."""
        return not isinstance(self.iterator, NonBlockingFileIterator)

    def _advance_shard(self):
        self.current_file.release()
        self.current_file = self.iterator.next()
        self._shard = (self._shard + 1) % len(self.files)
        self.sample_index = 0

    def set_index(self, idx: int):
        """Seek by GLOBAL sample index (deterministic resume).

        Single-process: the next sample served is ``idx % length``.
        Sharded: ``idx`` counts samples of the global stream; the loader
        seeks to this process's slice of the global batch containing
        ``idx`` (resume passes the checkpoint's global samples_passed).

        A stream served out of order (``in_order`` false) walks the files
        the restarted cache serves, each by its own sample count, from
        ``idx`` as the JAX package does.  Which files those are depends on
        how fast the copies finish, so such a resume is not exact, in
        either package.
        """
        if self.process_count > 1:
            stride = self.batch_size * self.process_count
            idx = (idx // stride) * stride \
                + self.process_index * self.batch_size
        remaining = idx % self.length
        self.current_file.release()
        self.iterator.reset()
        self._shard = 0
        self.current_file = self.iterator.next()
        while remaining >= self._visit_size():
            remaining -= self._visit_size()
            self._advance_shard()
        self.sample_index = remaining

    def _skip(self, n: int):
        """Advance the stream position ``n`` samples without decoding
        (on an ordered stream pure shard-size arithmetic: files are
        cycled, not read)."""
        remaining = self.sample_index + n
        while remaining >= self._visit_size():
            remaining -= self._visit_size()
            self._advance_shard()
        self.sample_index = remaining

    def skip_batch(self):
        """Skip one full batch stride — this process's next slice AND the
        peer slices — without reading (the multi-host oversized-batch
        rule advances every process past the same global batch)."""
        self._skip(self.batch_size * self.process_count)

    def _visit_size(self) -> int:
        """Samples of the file being served.  An ordered stream counts by
        shard index, from the table (no read).  A stream served out of
        order counts the served file's own samples: the cache may hand
        out a short shard where a long one stands in the stream, or the
        reverse, and a served copy's temporary name does not say which
        shard it holds."""
        if self.in_order:
            return self._shard_sizes[self._shard]
        spans, _ = self._shard_meta()
        return len(spans)

    def _shard_meta(self, shard=None):
        """The served file's size metadata, read once a visit (from
        ``shard`` where the caller has it open): re-reading the full
        ``elements_per_sample``/``events_per_element`` arrays on every
        batch was a fixed ~ms-scale cost per __next__.  Keyed by the file
        served, not by the stream's shard index: a non-blocking cache
        serves files out of order, and the JAX package's cache by shard
        index then reads one file's events with another's sizes."""
        name = self.current_file.name
        if self._meta is None or self._meta[0] != name:
            if shard is None:
                with store.open_file(name, 'r') as f:
                    return self._shard_meta(f)
            spans = np.asarray(shard['elements_per_sample'])
            sizes = (np.asarray(shard['events']['events_per_element'])
                     if self.is_raw
                     else np.asarray(shard['channels_per_sample']))
            self._meta = (name, (spans, sizes))
        return self._meta[1]

    def _read_slice(self, shard, begin, end):
        """Read encoded samples ``[begin, end)`` out of an open shard."""
        spans, sizes = self._shard_meta(shard)
        if self.is_raw:
            return codec.read_encoded_batch(shard, sizes, spans,
                                            begin, end)
        return codec.read_encoded_quantized_batch(shard, sizes, spans,
                                                  begin, end)

    def __next__(self):
        """Read the next batch, spanning shard boundaries when needed."""
        pieces = []
        wanted = self.batch_size
        while wanted > 0:
            available = self._visit_size() - self.sample_index
            take = min(wanted, available)
            if take > 0:
                stop = self.sample_index + take
                with store.open_file(self.current_file.name, 'r') as f:
                    pieces.append(self._read_slice(f, self.sample_index,
                                                   stop))
                self.sample_index = stop
                wanted -= take
            if wanted > 0:
                self._advance_shard()
        if self.process_count > 1:   # stride past the peer slices
            self._skip(self.batch_size * (self.process_count - 1))
        merged = codec.join_batches(pieces)
        decode = (codec.decode_batch if self.is_raw
                  else codec.decode_quantized_batch)
        return decode(merged)
