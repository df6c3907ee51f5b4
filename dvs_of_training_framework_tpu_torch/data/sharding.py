"""Resumable shard writing for offline preprocessing CLIs.

Both offline preprocessing scripts (prepare_batches, quantize_preprocessed)
accumulate encoded batches and periodically write numbered ``<j>.hdf5``
shards; on restart they must continue exactly where the previous run
stopped.  ShardWriter owns that pattern: it counts the samples already on
disk, never reuses an existing shard index, and flushes whenever the
pending sample count reaches the per-file target.

Reference behaviour: scripts/prepare_batches.py:50-79 and
scripts/quantize_preprocessed.py:59-108 in the reference repo (resume by
counting written samples).

The port's copy of ``dvs_of_training_framework_tpu/data/sharding.py``.  It
opens shards through ``store.open_file``: it writes the npy store and
counts the samples of existing shards in either format.
"""
from . import codec, store


class ShardWriter:
    """Accumulates encoded batches into numbered shards.

    Attributes:
        samples_written: samples on disk plus samples pending in memory —
            the resume point for the data stream.
    """

    def __init__(self, output_dir, samples_per_file):
        self.output_dir = output_dir
        self.samples_per_file = samples_per_file
        existing = list(output_dir.glob('*.hdf5'))
        self._taken = {int(f.stem) for f in existing}
        self.samples_written = sum(self._count_samples(f) for f in existing)
        self._next_index = 0
        self._pending = []
        self._pending_samples = 0

    @staticmethod
    def _count_samples(shard_path):
        with store.open_file(shard_path, 'r') as f:
            return len(f['elements_per_sample'])

    def add(self, encoded_batch):
        """Queue one encoded batch; flush when a shard's worth is pending."""
        size = len(encoded_batch['elements_per_sample'])
        self._pending.append(encoded_batch)
        self._pending_samples += size
        self.samples_written += size
        if self._pending_samples >= self.samples_per_file:
            self.flush()

    def flush(self):
        """Write all pending batches as the next free shard index."""
        if not self._pending:
            return
        while self._next_index in self._taken:
            self._next_index += 1
        codec.write_encoded_batch(
            self.output_dir / f'{self._next_index}.hdf5',
            codec.join_batches(self._pending))
        self._taken.add(self._next_index)
        self._pending = []
        self._pending_samples = 0
