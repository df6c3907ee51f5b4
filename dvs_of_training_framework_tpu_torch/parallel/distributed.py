"""Multi-process initialisation, host-batch broadcast and the sharded
skip rule.

The port's counterpart of ``dvs_of_training_framework_tpu/parallel/
distributed.py``.  There, every process calls
``jax.distributed.initialize`` and one SPMD program spans all devices;
here each process drives one device and joins a ``torch.distributed``
process group.  Activation is explicit, with the same flags and
environment names:

    --coordinator-address host:port --num-processes N --process-id P
or  JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID

The ranks meet in a ``TCPStore`` served by rank 0 at the coordinator
address.  Through it each rank learns which ranks share its host, takes
the card of its place among them (``cuda:<local rank % cards>``) and
picks the backend by one rule, printed once by rank 0: NCCL where every
rank of a host has a card of its own, gloo on the CPU and where ranks
share a card (NCCL refuses two ranks on one device; gloo reduces and
broadcasts CUDA tensors through the host).  The backend and the device
also decide how a device-queue window runs (``window_rule``), which rank 0
prints beside the backend.
"""
import datetime
import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

# a dead rank leaves the others waiting inside a collective: the store
# rendezvous and every gloo collective give up after this long
TIMEOUT = datetime.timedelta(minutes=30)


def distributed_spec(args=None):
    """Resolve (coordinator, num_processes, process_id) or None."""
    def pick(attr, env):
        value = getattr(args, attr, None) if args is not None else None
        if value is None:
            value = os.environ.get(env)
        return value

    coordinator = pick('coordinator_address', 'JAX_COORDINATOR_ADDRESS')
    num_processes = pick('num_processes', 'JAX_NUM_PROCESSES')
    process_id = pick('process_id', 'JAX_PROCESS_ID')
    if num_processes is None:
        return None
    return (coordinator,
            int(num_processes),
            None if process_id is None else int(process_id))


def initialize(address: str, world_size: int, rank: int,
               device: torch.device) -> torch.device:
    """Join the process group of ``world_size`` ranks whose rank 0 serves
    the store at ``address`` ("host:port"); returns this rank's device.

    ``device`` is the requested one: a CPU device, or a CUDA device whose
    index, when not given, is this rank's place among the ranks of its
    host (modulo the host's cards).
    """
    host, port = address.rsplit(':', 1)
    store = dist.TCPStore(host, int(port), world_size, is_master=rank == 0,
                          timeout=TIMEOUT)
    hostname = socket.gethostname()
    store.set(f'host/{rank}', hostname)
    hosts = [store.get(f'host/{r}').decode() for r in range(world_size)]
    local = [r for r in range(world_size) if hosts[r] == hostname]
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'-d {device}: no CUDA device is available')
        cards = torch.cuda.device_count()
        if device.index is None:
            device = torch.device('cuda', local.index(rank) % cards)
        torch.cuda.set_device(device)
    store.set(f'device/{rank}', str(device))
    devices = [store.get(f'device/{r}').decode() for r in local]
    shared = len(set(devices)) < len(devices)
    if device.type == 'cuda' and not shared:
        backend, why = 'nccl', 'every rank of a host has a card of its own'
    else:
        backend = 'gloo'
        why = ('ranks share a card' if device.type == 'cuda'
               else 'CPU devices')
    dist.init_process_group(backend, store=dist.PrefixStore('pg', store),
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    if rank == 0:
        print(f'torch.distributed: {backend} backend, {world_size} ranks '
              f'({why}); rank 0 on {device}')
        print(f'device-queue windows: {window_rule(backend, device)}')
    return device


def window_runs_as_graph(backend: str, device) -> bool:
    """Whether a staged training window on a mesh is one CUDA graph replay:
    under NCCL on a card, whose all-reduces a capture can hold.  A gloo
    all-reduce of a card's tensor syncs through the host, which a graph
    cannot capture, so under gloo (and on the CPU) a window runs eagerly;
    never as the fallback of a failed capture."""
    return backend == 'nccl' and torch.device(device).type == 'cuda'


def window_rule(backend: str, device) -> str:
    """How a window runs under ``backend`` on ``device``, in words."""
    if window_runs_as_graph(backend, device):
        return ('a window is one CUDA graph replay, its NCCL all-reduces '
                'captured inside')
    if torch.device(device).type == 'cuda':
        return ('a window runs its steps eagerly in one call (a gloo '
                'all-reduce syncs through the host, which a graph cannot '
                'capture)')
    return 'a window runs its steps eagerly in one call on the CPU'


def check_windows_agree(group):
    """``check(n_valid, n_skipped)`` for ``train``'s windows: raises unless
    every rank of ``group`` (a gloo group) staged a window of as many
    batches after as many skipped ones.  A rank that skipped a batch
    alone would pair its collectives with the others' next step."""
    def check(n_valid, n_skipped):
        mine = torch.tensor([n_valid, n_skipped, -n_valid, -n_skipped])
        extremes = mine.clone()
        dist.all_reduce(extremes, op=dist.ReduceOp.MAX, group=group)
        if not torch.equal(extremes[:2], -extremes[2:]):
            raise RuntimeError(
                f'the ranks staged different windows: this rank {n_valid} '
                f'batches after {n_skipped} skipped, the ranks\' largest '
                f'{extremes[:2].tolist()} and smallest '
                f'{(-extremes[2:]).tolist()}; a shard over its capacity '
                'was skipped on one rank alone (raise --event-capacity, or '
                'train over preprocessed shards, whose skip rule every rank '
                'shares)')
    return check


def maybe_initialize_distributed(args, device):
    """Join the process group when the multi-host flags (or their
    environment variables) are set: returns this rank's device, or None
    for a single-process run."""
    spec = distributed_spec(args)
    if spec is None:
        return None
    coordinator, num_processes, process_id = spec
    if coordinator is None or process_id is None:
        raise ValueError('--num-processes needs --coordinator-address and '
                         '--process-id (or JAX_COORDINATOR_ADDRESS and '
                         'JAX_PROCESS_ID): there is no cluster to ask')
    if not 0 <= process_id < num_processes:
        raise ValueError(f'--process-id {process_id} is not in '
                         f'[0, {num_processes})')
    return initialize(coordinator, num_processes, process_id, device)


def free_port() -> int:
    """A TCP port of this host that is free now."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def broadcast_batches(loader, src: int, group):
    """The host batches of ``loader`` on rank ``src``, sent to every rank
    of ``group`` (a gloo group): on ``src`` pass the loader, elsewhere
    None.  Every rank yields the same batches, so every rank takes the
    same skip decisions; the stream ends on all ranks when ``src``'s
    loader ends.  Closing the generator on ``src`` closes its loader."""
    if loader is None:
        while True:
            message = [None]
            dist.broadcast_object_list(message, src=src, group=group)
            if message[0] is None:
                return
            yield message[0]
    try:
        for batch in loader:
            dist.broadcast_object_list([batch], src=src, group=group)
            yield batch
        dist.broadcast_object_list([None], src=src, group=group)
    finally:
        close = getattr(loader, 'close', None)
        if close is not None:
            close()


class ShardedBatchSkipper:
    """Globally-deterministic oversized-batch rule over a per-process
    strided preprocessed stream (PreprocessedDataloader with
    ``process_count > 1``).

    The port's copy of the JAX package's ``ShardedBatchSkipper``
    (``parallel/distributed.py:116-202``).

    Each process reads only its 1/P slice of every global batch, so no
    process can SEE the others' event counts — but all processes must
    still agree on which global batches to skip (a per-process skip of a
    dispatched step would desynchronise the SPMD collectives).  The
    stream is static and pre-augmented, so per-sample event counts are a
    pure metadata property (data/preprocessed.py
    ``per_sample_event_counts``): every process evaluates the SAME rule —
    "does any of the ``n_shards`` per-device slices of global batch g
    exceed ``capacity_per_shard``?" — from the same counts array, with
    zero communication.  Skipped global batches are strided past without
    reading (``skip_batch``), and the rule is a deterministic function of
    the stream position, so checkpoint resume replays identical
    decisions.  Unlike the JAX package's, it raises when it has skipped
    every batch position the stream has (a global batch over
    ``capacity_per_shard`` everywhere would otherwise skip forever).

    Args:
        loader: this process's PreprocessedDataloader (already sharded).
        per_sample_events: int64 ``[length]`` per-sample device cost,
            identical on every process — event counts for raw streams,
            channel counts for dense quantized streams
            (data/preprocessed.py per_sample_event_counts /
            per_sample_channel_counts).
        global_batch: samples per GLOBAL batch (local batch x P).
        n_shards: devices on the mesh data axis (global).
        capacity_per_shard: per-device capacity in the same unit.
        start_sample: global samples already consumed (resume position).
        unit: display name of the cost unit for the skip log line.
    """

    def __init__(self, loader, per_sample_events, global_batch: int,
                 n_shards: int, capacity_per_shard: int,
                 start_sample: int = 0, unit: str = 'events'):
        self.unit = unit
        assert global_batch % n_shards == 0, (global_batch, n_shards)
        self.loader = loader
        self.global_batch = global_batch
        self.spd = global_batch // n_shards
        self.n_shards = n_shards
        self.capacity_per_shard = capacity_per_shard
        counts = np.asarray(per_sample_events, np.int64)
        self.length = counts.size
        assert global_batch <= self.length, \
            f'global batch {global_batch} exceeds dataset ({self.length})'
        self._csum = np.concatenate([[0], np.cumsum(counts)])
        self.cursor = (start_sample // global_batch) * global_batch
        # the distinct start positions of a global batch in the stream
        self.positions = self.length // math.gcd(self.length, global_batch)

    def _range_events(self, lo: int, hi: int) -> int:
        """Events in stream samples ``[lo, hi)`` (wrapping modulo length)."""
        total = int(self._csum[-1])
        full, lo = divmod(lo, self.length)
        hi -= full * self.length
        if hi <= self.length:
            return int(self._csum[hi] - self._csum[lo])
        return int(total - self._csum[lo]
                   + self._csum[hi - self.length])

    def _overflows(self, start: int) -> bool:
        return any(self._range_events(start + k * self.spd,
                                      start + (k + 1) * self.spd)
                   > self.capacity_per_shard
                   for k in range(self.n_shards))

    def __iter__(self):
        skipped = 0
        while True:
            start = self.cursor % self.length
            if skipped == self.positions:
                raise RuntimeError(
                    f'every global batch of the stream has a shard over '
                    f'{self.capacity_per_shard} {self.unit}: raise '
                    '--event-capacity')
            if self._overflows(start):
                worst = max(self._range_events(start + k * self.spd,
                                               start + (k + 1) * self.spd)
                            for k in range(self.n_shards))
                print(f'Skipping batch at sample {start} '
                      f'(per-shard {self.unit} {worst} > capacity '
                      f'{self.capacity_per_shard})')
                self.loader.skip_batch()
                self.cursor += self.global_batch
                skipped += 1
                continue
            skipped = 0
            self.cursor += self.global_batch
            yield next(self.loader)

    def close(self):
        close = getattr(self.loader, 'close', None)
        if close is not None:
            close()
