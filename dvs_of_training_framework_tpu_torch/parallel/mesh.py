"""Data and event parallelism over ``torch.distributed`` process groups.

The port's counterpart of ``dvs_of_training_framework_tpu/parallel/
mesh.py``.  There, one SPMD program spans a ``jax.sharding.Mesh`` of the
devices, the host splits each batch into per-device sub-batches and
``shard_map`` runs the single-device program on each, with ``psum`` over
ICI.  Here each rank is a process that drives one device; the host split
is the same (``split_batch_for_mesh``, a copy), each rank takes its
piece, and the collectives are ``all_reduce`` calls over the process
groups of ``MeshGroups``:

- the data axis: one all-reduce a micro step of one flat fp32 buffer
  holding every gradient, the loss and the loss terms, divided by the
  axis's size (``pmean``); parameters and optimizer state stay
  replicated, so every rank applies the same update to the same bits;
- the event axis (raw events only): each rank voxelizes its slice of the
  events (voxelization is linear in the events), the partial grids are
  summed over the event group, the predictor runs on the full grid, and
  the quantization layer's gradients, partial per event slice, are summed
  over the event group (the split VJP of ``mesh.py:261-310``).

A ``--mesh`` spec is "data:D[,event:E]"; rank r sits at the coordinates
of r in the spec's axis order (``np.unravel_index``, the order of
``make_mesh``'s reshape): for "data:D,event:E", data r // E, event r % E.
"""
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.schema import Batch, EventBuffer, layout_sample_slots, \
    pad_events
from ..losses import combined_loss
from ..training.state import (make_fused_update_step, make_loss_fn,
                              make_update_step, window_slots)
from ..utils.timer import FakeTimer
from .distributed import window_runs_as_graph

AXES = ('data', 'event')


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes of a ``--mesh`` spec, in the spec's order."""
    names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def data(self) -> int:
        return self.shape['data']

    @property
    def event(self) -> int:
        return self.shape.get('event', 1)

    def coordinates(self, rank: int):
        """``(data, event)`` coordinates of ``rank``."""
        place = dict(zip(self.names, np.unravel_index(rank, self.sizes)))
        return int(place['data']), int(place.get('event', 0))

    def rank_of(self, data: int, event: int = 0) -> int:
        place = {'data': data, 'event': event}
        return int(np.ravel_multi_index([place[n] for n in self.names],
                                        self.sizes))


def parse_mesh(spec: str) -> MeshSpec:
    """A ``--mesh`` spec, "name:size[,name:size]" with a ``data`` axis and
    an optional ``event`` axis (``make_mesh``'s parsing)."""
    names, sizes = [], []
    for part in spec.split(','):
        name, sep, size = part.partition(':')
        name = name.strip()
        if not sep or not size.strip().isdigit() or int(size) < 1:
            raise ValueError(f'--mesh {spec}: "{part}" is not name:size '
                             'with a size of at least 1')
        if name not in AXES or name in names:
            raise ValueError(f'--mesh {spec}: axis "{name}" is not one of '
                             f'{AXES} or is repeated')
        names.append(name)
        sizes.append(int(size))
    if 'data' not in names:
        raise ValueError(f'--mesh {spec}: no data axis')
    return MeshSpec(tuple(names), tuple(sizes))


class MeshGroups:
    """This rank's place on the mesh and the process groups it reduces
    over: ``data_group`` (the ranks of its event coordinate: gradients
    and metrics), ``event_group`` (the ranks of its data coordinate:
    partial grids and quantization gradients), and gloo groups for host
    objects, ``event_host_group`` and ``world_host_group`` (the compute
    groups themselves where the backend is gloo).  Every rank creates
    every group, in the same order, as ``new_group`` requires.
    ``window_graph`` says how a staged window runs
    (``distributed.window_rule``).

    Args:
        mesh: the MeshSpec; its size must be the world size.
        device: this rank's device.
        multi_host: the caller started the ranks with the multi-host
            flags (rank 0 validates alone), rather than ``--mesh``
            spawning them (every rank validates its shard).
    """

    def __init__(self, mesh: MeshSpec, device, multi_host: bool = False):
        self.mesh = mesh
        self.device = torch.device(device)
        self.multi_host = multi_host
        self.rank = dist.get_rank()
        world = dist.get_world_size()
        if world != mesh.size:
            raise ValueError(f'a mesh of {mesh.size} devices over {world} '
                             'processes: one device a process')
        self.data_index, self.event_index = mesh.coordinates(self.rank)
        gloo = dist.get_backend() == 'gloo'
        D, E = mesh.data, mesh.event
        for e in range(E):
            group = dist.new_group([mesh.rank_of(d, e) for d in range(D)])
            if e == self.event_index:
                self.data_group = group
        for d in range(D):
            ranks = [mesh.rank_of(d, e) for e in range(E)]
            group = dist.new_group(ranks)
            host = group if gloo else dist.new_group(ranks, backend='gloo')
            if d == self.data_index:
                self.event_group, self.event_host_group = group, host
        self.world_host_group = (dist.group.WORLD if gloo
                                 else dist.new_group(backend='gloo'))
        # a staged window is one graph replay under NCCL; under gloo or on
        # the CPU it runs eagerly (distributed.window_rule)
        self.window_graph = window_runs_as_graph(dist.get_backend(),
                                                 self.device)
        # the rank that reads the host batches of this data shard
        self.event_src = mesh.rank_of(self.data_index, 0)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def split_batch_for_mesh(collated: dict, n_shards: int,
                         capacity_per_shard: int,
                         event_shards: int = 1,
                         sequence_length: Optional[int] = None) -> Batch:
    """Split a host-collated batch into n equal per-device shards.

    A copy of the JAX package's ``split_batch_for_mesh``
    (``mesh.py:52-170``) over the port's host ``Batch``.  Every array
    gains a leading shard axis; events are re-padded per shard (they are
    sorted by sample, so shard boundaries are just searchsorted cuts).
    Sample indices are localised to each shard.  Dense batches
    (``--ev_images``: a ``data [B, L*C, H, W]`` leaf instead of
    ``events``) split on the sample axis directly.

    With ``sequence_length`` set (``--dynamic-sample-length``) the batch is
    first re-laid into uniform per-sample slots (schema.layout_sample_slots)
    so every shard carries ``per_shard * (sequence_length + 1)`` timestamp
    slots regardless of the per-sample element counts; padding slots keep
    the out-of-range marker, localised to the PER-SHARD batch size.

    With ``event_shards > 1`` each data shard's flat event list is further
    cut into ``event_shards`` contiguous pieces — the event buffers gain a
    second leading axis ``[data, event, capacity]`` while timestamps/images
    keep one (they are replicated over the event axis).  Voxelization is
    linear in events, so partial grids summed over the event axis equal
    the full grid.

    Raises:
        OverflowError: when a shard exceeds ``capacity_per_shard`` events.
    """
    if sequence_length is not None:
        collated = layout_sample_slots(collated, sequence_length)

    size = int(collated['size'])
    assert size % n_shards == 0, \
        f'batch size {size} not divisible by {n_shards} shards'
    per_shard = size // n_shards

    sample_idx = np.asarray(collated['sample_idx'])
    if sequence_length is not None:
        # uniform slots: cut arithmetic, no searchsorted (padding markers
        # interleave with real entries, so the axis is not sorted)
        slots = sequence_length + 1
        ts_cuts = np.arange(n_shards + 1) * per_shard * slots
    else:
        ts_cuts = np.searchsorted(sample_idx,
                                  np.arange(n_shards + 1) * per_shard)
    images = np.asarray(collated['images'], dtype=np.float32)
    if images.ndim == 3:
        images = images[:, None]
    timestamps = np.asarray(collated['timestamps'], dtype=np.float32)

    ev = collated.get('events')
    data = collated.get('data')
    if ev is not None:
        sample_index = np.asarray(ev['sample_index'])
        # shard boundaries on the flat (sample-sorted) event axis
        cuts = np.searchsorted(sample_index,
                               np.arange(n_shards + 1) * per_shard)
    else:
        assert data is not None, 'batch carries neither events nor data'
        assert event_shards == 1, \
            'event-axis sharding requires raw events (--ev_images batches ' \
            'have no event axis)'
        data = np.asarray(data, dtype=np.float32)

    buffers = []
    ts_shards = []
    si_shards = []
    im_shards = []
    for s in range(n_shards):
        if ev is not None:
            lo, hi = int(cuts[s]), int(cuts[s + 1])
            shard_events = {
                'x': ev['x'][lo:hi],
                'y': ev['y'][lo:hi],
                'timestamp': ev['timestamp'][lo:hi],
                'polarity': ev['polarity'][lo:hi],
                'element_index': ev['element_index'][lo:hi],
                'sample_index': sample_index[lo:hi] - s * per_shard,
            }
            if event_shards == 1:
                buffers.append(pad_events(shard_events, per_shard,
                                          capacity_per_shard))
            else:
                # contiguous cuts of the flat event axis; any partition
                # works (the grid is a sum over events), contiguous keeps
                # IO simple
                n_ev = hi - lo
                ev_cuts = np.linspace(0, n_ev,
                                      event_shards + 1).astype(int)
                buffers.append(_stack_buffers(
                    [pad_events({k: v[ev_cuts[e]:ev_cuts[e + 1]]
                                 for k, v in shard_events.items()},
                                per_shard, capacity_per_shard)
                     for e in range(event_shards)]))
        tlo, thi = int(ts_cuts[s]), int(ts_cuts[s + 1])
        si = sample_idx[tlo:thi]
        # padding slots (dynamic layout) carry the GLOBAL size marker;
        # each shard's standalone batch needs the per-shard one
        si_shards.append(np.where(si == size, per_shard,
                                  si - s * per_shard))
        ts_shards.append(timestamps[tlo:thi])
        im_shards.append(images[tlo:thi])

    return Batch(events=None if ev is None else _stack_buffers(buffers),
                 data=(None if data is None else
                       data.reshape(n_shards, per_shard, *data.shape[1:])),
                 timestamps=np.stack(ts_shards).astype(np.float32),
                 sample_idx=np.stack(si_shards).astype(np.int32),
                 images=np.stack(im_shards),
                 size=size)


def _stack_buffers(buffers):
    """EventBuffers stacked on a new leading axis, ``num_events`` too."""
    return EventBuffer(**{
        f.name: np.stack([np.asarray(getattr(b, f.name)) for b in buffers])
        for f in dataclasses.fields(EventBuffer)})


def shard_of(sharded: Batch, data: int, event: Optional[int] = None
             ) -> Batch:
    """One device's batch of ``split_batch_for_mesh``'s output: data shard
    ``data`` and, where the events carry an event axis, its slice
    ``event``.  Its ``size`` is the shard's own sample count."""
    events = sharded.events
    if events is not None:
        index = (data,) if event is None else (data, event)
        events = EventBuffer(**{
            f.name: getattr(events, f.name)[index]
            for f in dataclasses.fields(EventBuffer)})
        events.num_events = int(events.num_events)
    return Batch(events=events,
                 data=None if sharded.data is None else sharded.data[data],
                 timestamps=sharded.timestamps[data],
                 sample_idx=sharded.sample_idx[data],
                 images=sharded.images[data],
                 size=sharded.size // sharded.timestamps.shape[0])


def _flat_terms(terms):
    return [t for group in terms for t in group]


# elements: every tensor in a flat buffer starts 512 bytes apart, as the
# caching allocator places tensors
_ALIGN = 128


def _memory_order(t):
    """The dimensions of ``t`` from the outermost in memory to the
    innermost: ``t.permute(order)`` is contiguous for a dense tensor."""
    return sorted(range(t.dim()), key=lambda d: (-t.stride(d), -t.size(d)))


def _flatten(tensors):
    """One flat fp32 buffer of ``tensors``, each in its own memory order
    at an aligned offset; returns it and the offsets.  ``_unflatten``
    gives views with the tensors' own strides and alignment: a reduction
    kernel picks its loads, and with them the order of its sums, by its
    input's layout and alignment, so a gradient seen through a view of
    another layout (a channels-last convolution's, read as contiguous)
    could round otherwise in the optimizer, and a one-rank all-reduce
    would then differ from no reduce."""
    parts, offsets, at = [], [], 0
    pad = torch.zeros(_ALIGN, device=tensors[0].device)
    for t in tensors:
        t = t.detach()
        parts.append(t.permute(_memory_order(t)).reshape(-1).float())
        offsets.append(at)
        at += t.numel()
        if at % _ALIGN:
            parts.append(pad[:_ALIGN - at % _ALIGN])
            at += _ALIGN - at % _ALIGN
    return torch.cat(parts), offsets


def _unflatten(flat, offsets, tensors):
    """Views of ``flat`` shaped, strided (and typed) as ``tensors``."""
    out = []
    for o, t in zip(offsets, tensors):
        order = _memory_order(t)
        view = flat[o:o + t.numel()].view([t.size(d) for d in order])
        out.append(view.permute([order.index(d) for d in range(t.dim())])
                   .to(t.dtype))
    return out


def _mean_over(group, size, tensors, timers):
    """The mean over ``group`` of each tensor, through one all-reduce of
    one flat fp32 buffer; returns the tensors in their own types."""
    flat, offsets = _flatten(tensors)
    timers('all_reduce').start()
    dist.all_reduce(flat, group=group)
    timers('all_reduce').stop()
    flat.div_(size)
    return _unflatten(flat, offsets, tensors)


def _sum_over(group, tensors, timers):
    """The sum over ``group`` of each tensor, summed in fp32 in one
    all-reduce."""
    flat, offsets = _flatten(tensors)
    timers('all_reduce').start()
    dist.all_reduce(flat, group=group)
    timers('all_reduce').stop()
    return _unflatten(flat, offsets, tensors)


def _restore_terms(terms, values):
    it = iter(values)
    return tuple([next(it) for _ in group] for group in terms)


def make_sharded_grad_fn(model, evaluator, weights, groups: MeshGroups,
                         is_raw: bool = True, event_axis: bool = False,
                         timers=None):
    """One rank's ``grad_fn(batch) -> (loss, terms, {name: grad})`` (the
    role of the JAX package's ``step_fn._single``): the loss and the
    gradients of this rank's device batch (``shard_of`` a
    ``split_batch_for_mesh`` output), averaged with the terms over the
    data group in one all-reduce.  With ``event_axis`` the batch carries
    this rank's slice of the events: the grid is the sum of the event
    group's partial grids, and the quantization layer's gradients are
    summed over the event group before the data mean.  Unused parameters
    get zero gradients (``materialize_grads``), as in the single-device
    step.  ``timers('all_reduce')`` spans each collective; it synchronises
    the device, so a body captured in a CUDA graph takes ``FakeTimer``.
    """
    if event_axis and not is_raw:
        raise ValueError('event-axis sharding requires raw events')
    timers = FakeTimer() if timers is None else timers
    loss_fn = make_loss_fn(model, evaluator, weights, is_raw)
    named = dict(model.named_parameters())
    params = list(named.values())
    weights = tuple(weights)
    data_size = groups.mesh.data

    def local_grads(batch):
        loss, terms = loss_fn(batch)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        return loss, terms, list(grads)

    def local_grads_event(batch):
        ts, si = batch.timestamps, batch.sample_idx
        imsize = tuple(batch.images.shape[-2:])
        grid_local = model.quantize(batch.events, ts, si, imsize)
        (grid,) = _sum_over(groups.event_group, [grid_local], timers)
        grid.requires_grad_(True)
        flows, flow_ts, flow_sample_idx = model(grid, ts, si, imsize,
                                                raw=False)
        loss, terms = combined_loss(evaluator, flows, flow_ts,
                                    flow_sample_idx, batch.images, ts, si,
                                    weights=weights)
        *grads, c_grid = torch.autograd.grad(loss, params + [grid],
                                             materialize_grads=True)
        if grid_local.requires_grad:
            grads_q = torch.autograd.grad(grid_local, params, c_grid,
                                          allow_unused=True)
            reached = [i for i, g in enumerate(grads_q) if g is not None]
            summed = _sum_over(groups.event_group,
                               [grads_q[i] for i in reached], timers)
            for i, g in zip(reached, summed):
                grads[i] = grads[i] + g
        return loss, terms, grads

    grad_of = local_grads_event if event_axis else local_grads

    def grad_fn(batch):
        loss, terms, grads = grad_of(batch)
        loss, *rest = _mean_over(groups.data_group, data_size,
                                 [loss] + _flat_terms(terms) + grads, timers)
        n_terms = len(_flat_terms(terms))
        return (loss, _restore_terms(terms, rest[:n_terms]),
                dict(zip(named, rest[n_terms:])))

    return grad_fn


def make_sharded_train_step(model, evaluator, optimizer, weights,
                            accumulation_steps: int, groups: MeshGroups,
                            is_raw: bool = True, event_axis: bool = False,
                            timers=None, window: int = 0):
    """The training step of one rank (``make_sharded_train_step`` of the
    JAX package; signature and return of ``state.make_train_step``).

    ``step_fn(state, batch) -> (state, (loss, terms))`` takes this rank's
    device batch.  The gradients, the loss and the terms are averaged
    over the data group (``make_sharded_grad_fn``), then accumulated and
    applied as ``make_train_step`` does, so every rank holds the same
    parameters after the step.  With ``window = K > 0`` the step takes
    this rank's staged ``Window`` of K batches and steps its batch
    ``micro_step % K``, as the JAX package's ``step_fn`` does.
    """
    grad_fn = make_sharded_grad_fn(model, evaluator, weights, groups,
                                   is_raw, event_axis, timers)
    return window_slots(make_update_step(
        grad_fn, dict(model.named_parameters()), optimizer,
        accumulation_steps), window)


def make_sharded_fused_window_step(model, evaluator, optimizer, weights,
                                   accumulation_steps: int,
                                   groups: MeshGroups, window: int,
                                   is_raw: bool = True,
                                   event_axis: bool = False):
    """K sharded training steps in one call over this rank's staged window
    of K batches (``make_sharded_fused_window_step`` of the JAX package).

    Returns ``fused(state, staged) -> (state, (loss[K], terms))``, the
    contract of ``state.make_fused_window_step``, around the gradients of
    ``make_sharded_grad_fn``; ``window % accumulation_steps`` must be 0.
    How a window runs is the rule of ``groups.window_graph``: under NCCL
    (one rank a card) one ``WindowGraph`` replay whose capture holds the
    K steps with their all-reduces; under gloo, or on the CPU, the same
    body eagerly over the staged window, in one call.  The all-reduces are
    not timed.
    """
    grad_fn = make_sharded_grad_fn(model, evaluator, weights, groups,
                                   is_raw, event_axis)
    return make_fused_update_step(grad_fn, model, optimizer,
                                  accumulation_steps, window,
                                  len(evaluator.shapes),
                                  graph=groups.window_graph)


def make_sharded_eval_step(model, evaluator, weights, groups: MeshGroups,
                           is_raw: bool = True):
    """Loss-only twin of ``make_sharded_train_step``: every rank
    evaluates its data shard, the loss and terms are averaged over the
    data group in one all-reduce (equal shards: the mean of shard means
    is the full-batch mean); ranks of one data shard on the event axis
    evaluate the same shard."""
    loss_fn = make_loss_fn(model, evaluator, weights, is_raw)

    def eval_step(batch):
        with torch.no_grad():
            loss, terms = loss_fn(batch)
            loss, *rest = _mean_over(groups.data_group, groups.mesh.data,
                                     [loss] + _flat_terms(terms),
                                     FakeTimer())
        return loss, _restore_terms(terms, rest)

    return eval_step


def check_replicas(model, groups: MeshGroups, when: str):
    """Raise unless every rank holds the same parameters: a checksum of
    each parameter's bits, broadcast from rank 0 and compared on every
    rank, the verdict all-reduced."""
    sums = torch.stack([
        p.detach().reshape(-1).view(
            torch.int16 if p.element_size() == 2 else torch.int32)
        .long().sum() for p in model.parameters()])
    reference = sums.clone()
    dist.broadcast(reference, src=0)
    differ = (reference != sums).any().float().reshape(1)
    dist.all_reduce(differ)
    if differ.item():
        raise RuntimeError(f'{when}: the ranks hold different parameters')
