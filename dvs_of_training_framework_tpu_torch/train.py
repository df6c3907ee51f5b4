#!/usr/bin/env python3
"""Training CLI of the port.

Counterpart of the JAX package's composition root ``train_flownet.py``:
it parses the shared option groups, builds the plugin's model
(``--flownet_path``: EVFlowNet, RecurrentFlowNet, DummyFlowNet or a torch
plugin directory, ``models/loader.py``), the optimizer, the loss, the
serializer and the hooks, resumes from the
newest checkpoint (parameters, optimizer state, step, samples passed and
the data stream's position) or writes step 0, validates, trains,
validates again and writes the final checkpoint.

    python -m dvs_of_training_framework_tpu_torch.train -m OUT [options]

``main`` parses and checks the run's provenance and builds the data
loaders over the dataset; ``run`` does the rest for any loaders, so
a caller with batches in memory can drive it without a dataset.  With
``--ev_images`` the model trains on dense batches: baked shards
(``tools/quantize_preprocessed.py``) through
``--preprocessed-dataset-path``, or raw data turned into images on the
host by the plugin's ``compute_event_image``; validation stays raw.  ``run``
turns cuDNN's nondeterministic algorithms off, so that a resumed run
repeats the uninterrupted one.  The device defaults to ``cuda``; ``-d
cuda`` without a card raises.  The TPU-only flags are accepted and
ignored with one line each.

On one device the batches go through the device queue
(``--device-queue-window K``, 16 by default, 0 for one batch at a time):
K batches staged in one upload, and every window that covers whole
optimizer steps with no checkpoint or validation due inside it runs as
one call, a replay of one CUDA graph on a card.  Validation stages
``--validation-window`` batches a call (8 by default, 0 for one at a
time).  A resumed run starts a new window at its checkpoint, so a window
that divides the checkpoint and validation cadence keeps every window
whole.  On a mesh every rank stages windows of its own pieces, and a
window runs by the backend's rule, which rank 0 prints beside the
backend: one CUDA graph replay with its NCCL all-reduces inside under
NCCL, its steps eagerly in one call under gloo and on the CPU
(``parallel.window_rule``); the ranks check that they staged the same
windows.  Validation on a mesh runs per batch, as in the JAX package.

Several devices, one process each (``parallel/``):

- ``--mesh data:D[,event:E]`` alone: ``main`` builds the kernels, then
  spawns D x E worker processes on this host (``cuda:<rank % cards>``)
  and returns when all have ended; if one fails, the others are stopped
  and ``main`` raises.  They validate sharded, every rank on its shard.
- ``--coordinator-address HOST:PORT --num-processes N --process-id P``
  (or the ``JAX_*`` environment variables): the caller starts the N
  processes, on one host or several; the mesh defaults to ``data:N``.
  Rank 0 validates alone, as ``train_flownet.py`` does.

Either way, data rank d reads ``1 / D`` of each batch (``-mbs / D``
samples: strided shards, or its own draws of the raw stream), event rank
0 of each data rank sends it to its event group, every rank cuts its
piece, and samples are counted globally.  Rank 0 alone writes the
provenance, checkpoints, TensorBoard logs, the profiler's trace and the
monitor's samples; every rank loads the same checkpoint on resume.
"""
from argparse import ArgumentParser
from contextlib import nullcontext
import os
import sys

import torch
import torch.distributed as dist

from .data.dataloader import (choose_data_path, get_dataloader,
                              get_trainset_params, get_valset_params)
from .losses import LOSS_PRECISIONS, MultiScaleLoss
from .models import init_model, load_model_class
from .ops import launch_counts
from .parallel import (MeshGroups, ShardedBatchSkipper, broadcast_batches,
                       check_replicas, check_windows_agree, distributed_spec,
                       initialize, make_sharded_eval_step,
                       make_sharded_fused_window_step,
                       make_sharded_train_step, maybe_initialize_distributed,
                       parse_mesh, shard_of, split_batch_for_mesh)
from .parallel.distributed import free_port
from .training import (construct_optimizer, create_train_state,
                       current_learning_rates, make_eval_step,
                       make_fused_eval_step, make_fused_window_step,
                       make_train_step)
from .training.hooks import SerializationHook, ValidationHook
from .training.serializer import Serializer
from .training.train import make_hook_periodic, shapes2tags, train
from .utils.common import (check_execution_info, collect_execution_info,
                           write_execution_info)
from .utils.monitor import DeviceMonitor
from .utils.options import (add_preprocessed_dataset_arguments,
                            add_train_arguments, resolve_event_capacity,
                            validate_train_args)
from .utils.profiling import Profiler
from .utils.tb import NullSummaryWriter, SummaryWriter
from .utils.timer import FakeTimer, SynchronizedWallClockTimer

# TPU and tunnel workarounds the port leaves out (ROADMAP "Not to port")
TPU_ONLY = ('wire_timestamps', 'wire_events', 'wire_data', 'split_decoder',
            'flat_optimizer')


def parse_args(argv):
    """The shared training options, checked; no file is touched."""
    parser = ArgumentParser()
    add_train_arguments(parser)
    add_preprocessed_dataset_arguments(parser)
    parser.set_defaults(device='cuda')
    args = parser.parse_args(argv)
    for dest in TPU_ONLY:
        if getattr(args, dest) != parser.get_default(dest):
            print(f'--{dest.replace("_", "-")} {getattr(args, dest)}: '
                  'a TPU-only option, ignored')
    args = validate_train_args(args)
    args.log_path = args.model / 'log'
    mesh = mesh_of(args)
    for dest in ('device_queue_window', 'validation_window'):
        if getattr(args, dest) < 0:
            raise ValueError(f'--{dest.replace("_", "-")} must be 0 or more')
    if mesh is not None and args.device_queue_window:
        print(f'--device-queue-window {args.device_queue_window} on a mesh: '
              'each rank stages its own windows, run as the backend\'s '
              'rule says (printed beside the backend)')
    if mesh is not None and args.validation_window \
            and not args.skip_validation:
        print(f'--validation-window {args.validation_window}: validation '
              'on a mesh runs per batch')
    if mesh is not None:
        if args.mbs % mesh.data:
            raise ValueError(f'-mbs {args.mbs} is not divisible by the '
                             f'{mesh.data} data shards of the mesh')
        if mesh.event > 1 and not args.is_raw:
            raise ValueError('--mesh with an event axis requires raw '
                             'events: --ev_images batches have no event '
                             'axis to shard')
    return args


def mesh_of(args):
    """The run's MeshSpec: ``--mesh``, else ``data:N`` under the
    multi-host flags, else None (one device)."""
    spec = distributed_spec(args)
    if args.mesh is None:
        return None if spec is None else parse_mesh(f'data:{spec[1]}')
    mesh = parse_mesh(args.mesh)
    if spec is not None and mesh.size != spec[1]:
        raise ValueError(f'--mesh {args.mesh} has {mesh.size} devices for '
                         f'{spec[1]} processes: one device a process')
    return mesh


def resolve_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'-d {name}: no CUDA device is available')
    return device


def flow_shapes(shape):
    """The plugin contract's four flow scales for ``(H, W)`` images,
    coarse first."""
    h, w = shape
    return [(h // 2 ** s, w // 2 ** s) for s in (3, 2, 1, 0)]


def make_event_image_fn(args):
    """The dataset's host-side event-image function under ``--ev_images``
    (the plugin's ``compute_event_image`` at
    ``--event-representation-depth``, as ``train_flownet.py`` builds it),
    None on the raw path."""
    if args.is_raw:
        return None
    net = load_model_class(args.flownet_path)
    depth = args.event_representation_depth

    def event_image_fn(events, start_ts, stop_ts, shape):
        return net.compute_event_image(events, start_ts, stop_ts, shape,
                                       depth=depth)

    return event_image_fn


def pad_sequence_length(args):
    """Per-sample slot count for dynamic sample lengths, None for static
    ones (``train_flownet.py``'s ``pad_sequence_length``):
    ``max_sequence_length`` counts every element of a sample, its prefix
    and suffix context included."""
    return args.max_sequence_length if args.dynamic_sample_length else None


def shard_capacity(capacity, groups):
    """Events a device buffer of the mesh holds (``train_flownet.py``:
    the batch's capacity over the data shards, at least 4096)."""
    return max(capacity // groups.mesh.data, 4096)


def sharded_validation(groups):
    """Whether every rank validates on its shard: a spawned ``--mesh``
    run does; under the multi-host flags rank 0 validates alone."""
    return groups is not None and not groups.multi_host


def run(args, train_loader_factory, val_loader_factory, logger,
        timers=None, groups=None):
    """Build, resume or start, validate, train, checkpoint, validate.

    Args:
        args: ``parse_args`` output with ``event_capacity`` resolved to a
            number.
        train_loader_factory: ``samples_passed -> iterable of host
            batches``, the training stream from that position on (this
            rank's share of it on a mesh).
        val_loader_factory: zero-argument callable giving a fresh finite
            validation loader.
        logger: SummaryWriter; closed at the end.
        timers: ``utils/timer.py``'s interface for ``train``; by default
            ``SynchronizedWallClockTimer`` under ``--timers``, else
            ``FakeTimer``.
        groups: this rank's ``parallel.MeshGroups`` on a mesh, None for
            one device.

    Returns:
        (model, optimizer, train state, samples passed)
    """
    device = resolve_device(args.device) if groups is None \
        else groups.device
    is_main = groups is None or groups.is_main
    if timers is None:
        timers = SynchronizedWallClockTimer(device) if args.timers \
            else FakeTimer()
    # fp32 convolutions and matmuls in full precision, as the JAX
    # package's 'highest'; and only cuDNN's deterministic algorithms, so a
    # resumed run repeats the uninterrupted one.  On an H100 80GB HBM3
    # (700 W), over the bench batches, the recipe's steps after a resume
    # then equaled the uninterrupted run's bit for bit (without it they
    # differed by up to 6e-7), at a cost of ~30% of the recipe's device
    # time, which its host-bound step hides, and 18-21% of golden's step.
    # The kernels add in a fixed order, so with this a step's gradients
    # are the same on every run from the same state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = init_model(args, device)
    serializer = Serializer(args.model, args.num_checkpoints,
                            args.permanent_interval)
    optimizer = construct_optimizer(args, model)
    evaluator = MultiScaleLoss(flow_shapes(args.shape),
                               bf16x2=LOSS_PRECISIONS[args.loss_precision])
    tags = shapes2tags(evaluator.shapes)
    sequence_length = pad_sequence_length(args)
    # dense training (--ev_images) validates raw, as the JAX package does
    prepare_batch = val_prepare_batch = None
    eval_step = make_eval_step(model, evaluator, args.loss_weights)
    # the device queue; validation on a mesh runs per batch, as in the JAX
    # package (train_flownet.py wires no mesh-windowed validation)
    window = args.device_queue_window
    val_window = args.validation_window if groups is None else 0
    fused = window > 0 and window % args.accum_step == 0
    train_step_fused = fused_eval_step = window_check = None
    if groups is None:
        train_step = make_train_step(model, evaluator, optimizer,
                                     args.loss_weights, args.accum_step,
                                     is_raw=args.is_raw, window=window)
        if fused:
            train_step_fused = make_fused_window_step(
                model, evaluator, optimizer, args.loss_weights,
                args.accum_step, window, is_raw=args.is_raw)
        if val_window > 0 and not args.skip_validation:
            fused_eval_step = make_fused_eval_step(
                model, evaluator, args.loss_weights, val_window)
    else:
        event_axis = groups.mesh.event > 1
        train_step = make_sharded_train_step(
            model, evaluator, optimizer, args.loss_weights, args.accum_step,
            groups, is_raw=args.is_raw, event_axis=event_axis,
            timers=timers, window=window)
        if fused:
            train_step_fused = make_sharded_fused_window_step(
                model, evaluator, optimizer, args.loss_weights,
                args.accum_step, groups, window, is_raw=args.is_raw,
                event_axis=event_axis)
        if window > 0:
            window_check = check_windows_agree(groups.world_host_group)

        def prepare_batch(collated, capacity):
            # this rank's batch is its data shard; cut its event slice
            return shard_of(split_batch_for_mesh(
                collated, 1, shard_capacity(capacity, groups),
                event_shards=groups.mesh.event,
                sequence_length=sequence_length), 0,
                groups.event_index if event_axis else None)

        if sharded_validation(groups):
            eval_step = make_sharded_eval_step(model, evaluator,
                                               args.loss_weights, groups)

            def val_prepare_batch(collated, capacity):
                # every rank holds the whole batch: its data shard
                if int(collated['size']) % groups.mesh.data:
                    raise ValueError('remainder batch not divisible by '
                                     'the mesh')
                return shard_of(split_batch_for_mesh(
                    collated, groups.mesh.data,
                    shard_capacity(capacity, groups),
                    sequence_length=sequence_length), groups.data_index)

    def no_checkpoint(steps, samples):
        return None

    hooks = {'serialization': (
        SerializationHook(serializer, model, optimizer, logger) if is_main
        else no_checkpoint)}
    periods = {'serialization': args.checkpointing_interval}
    if not args.skip_validation and (is_main or sharded_validation(groups)):
        hooks['validation'] = ValidationHook(
            eval_step, val_loader_factory, logger, tags, device,
            event_capacity=args.event_capacity,
            sequence_length=sequence_length,
            prepare_batch=val_prepare_batch,
            fused_eval_step=fused_eval_step, window=val_window)
        periods['validation'] = args.vp

    # every rank decides before rank 0 can write step 0
    resume = not args.do_not_continue and serializer.has_checkpoints()
    if groups is not None:
        dist.barrier()
    if resume:
        global_step, _, _, extra = serializer.load_checkpoint(
            serializer.list_known_steps()[-1], model=model,
            optimizer=optimizer)
        samples_passed = int(extra.get('samples_passed',
                                       global_step * args.bs))
    else:
        global_step = samples_passed = 0
        hooks['serialization'](global_step, samples_passed)
    if groups is not None:
        check_replicas(model, groups, 'at the start')
    if 'validation' in hooks:
        hooks['validation'](global_step, samples_passed)

    profiler = Profiler(args.profiling, args.model / 'profiling') \
        if is_main else nullcontext()
    monitor = DeviceMonitor(args.log_path, device=device) if is_main \
        else nullcontext()
    with profiler, monitor:
        state, samples_passed = train(
            train_step,
            create_train_state(global_step),
            train_loader_factory(samples_passed),
            args.training_steps,
            logger=logger,
            tags=tags,
            device=device,
            lr_fn=lambda step: current_learning_rates(args, step,
                                                      optimizer.groups),
            accumulation_steps=args.accum_step,
            event_capacity=args.event_capacity,
            timers=timers,
            hooks={k: make_hook_periodic(hooks[k], periods[k])
                   for k in periods},
            init_step=global_step,
            init_samples_passed=samples_passed,
            max_events_per_batch=args.max_events_per_batch,
            sequence_length=sequence_length,
            is_raw=args.is_raw,
            prepare_batch=prepare_batch,
            samples_scale=1 if groups is None else groups.mesh.data,
            window=window,
            train_step_fused=train_step_fused,
            window_check=window_check)

    if groups is not None:
        check_replicas(model, groups, 'after training')
    hooks['serialization'](args.training_steps, samples_passed)
    if 'validation' in hooks:
        hooks['validation'](args.training_steps, samples_passed)
    logger.close()
    return model, optimizer, state, samples_passed


def main(argv=None):
    """Train as the arguments say; returns one record a rank of this
    process's run (``run_rank``), all ranks' when it spawned them."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    args = choose_data_path(args)
    args.model.mkdir(exist_ok=True, parents=True)
    resolve_event_capacity(args)
    # every process checks; rank 0 alone writes, once all have checked
    check_execution_info(args.model, collect_execution_info(args), args)
    mesh = mesh_of(args)
    if distributed_spec(args) is not None:
        device = maybe_initialize_distributed(args, args.device)
        return [run_rank(args, MeshGroups(mesh, device, multi_host=True))]
    if mesh is not None and mesh.size > 1:
        return spawn_mesh(args, mesh)
    return [run_rank(args, None)]


def spawn_mesh(args, mesh):
    """Run ``--mesh`` in ``mesh.size`` spawned processes on this host;
    returns their records in rank order.  The kernels are built here
    first, once.  A worker that fails stops the others, and raises."""
    if torch.device(args.device).type == 'cuda':
        resolve_device(args.device)
        from .ops import _build
        _build.build()
    results = torch.multiprocessing.get_context('spawn').SimpleQueue()
    context = torch.multiprocessing.start_processes(
        _mesh_worker, args=(args, mesh, free_port(), results),
        nprocs=mesh.size, join=False, start_method='spawn')
    records = {}
    while True:
        done = context.join(timeout=1.0)
        while not results.empty():
            record = results.get()
            records[record['rank']] = record
        if done:
            return [records[r] for r in sorted(records)]


def _mesh_worker(rank, args, mesh, port, results):
    device = initialize(f'127.0.0.1:{port}', mesh.size, rank, args.device)
    results.put(run_rank(args, MeshGroups(mesh, device)))


def run_rank(args, groups):
    """One rank's run (the only one without a mesh): its loaders, its
    logger and ``run``; returns the rank's record: rank, pid, device,
    steps, samples passed and the kernels' launches."""
    is_main = groups is None or groups.is_main
    if groups is not None:
        dist.barrier()      # every rank has checked the provenance
    if is_main:
        write_execution_info(args.model, collect_execution_info(args))
    trainset = get_trainset_params(args)
    event_image_fn = make_event_image_fn(args)
    if groups is not None:
        trainset.batch_size = args.mbs // groups.mesh.data
        trainset.process_index = groups.data_index
        trainset.process_count = groups.mesh.data

    def read_train(samples_passed):
        loader = get_dataloader(trainset, sample_idx=samples_passed,
                                process_only_once=args.process_only_once,
                                event_image_fn=event_image_fn)
        if (groups is not None and args.is_raw
                and args.preprocessed_dataset_path is not None):
            # the same oversized-batch decisions on every data rank, from
            # the shards' event counts; a dense batch is never skipped
            from .data.preprocessed import per_sample_event_counts
            capacity = min(args.event_capacity, args.max_events_per_batch)
            loader = ShardedBatchSkipper(
                loader, per_sample_event_counts(
                    args.preprocessed_dataset_path),
                global_batch=args.mbs, n_shards=groups.mesh.data,
                capacity_per_shard=shard_capacity(capacity, groups),
                start_sample=samples_passed)
        return loader

    def train_loader_factory(samples_passed):
        if groups is None or groups.mesh.event == 1:
            return read_train(samples_passed)
        # event rank 0 of the data shard reads; its event group receives
        return broadcast_batches(
            read_train(samples_passed) if groups.event_index == 0 else None,
            groups.event_src, groups.event_host_group)

    def val_loader_factory():
        loader = None
        if groups is None or groups.is_main:
            loader = get_dataloader(get_valset_params(args),
                                    event_image_fn=event_image_fn)
        if not sharded_validation(groups):
            return loader
        # every rank splits the batches that rank 0 reads
        return broadcast_batches(loader, 0, groups.world_host_group)

    logger = SummaryWriter(str(args.log_path)) if is_main \
        else NullSummaryWriter()
    # the single-process call keeps run()'s four-argument form
    extra = {} if groups is None else {'groups': groups}
    _, _, state, samples_passed = run(args, train_loader_factory,
                                      val_loader_factory, logger, **extra)
    if groups is not None:
        dist.barrier()      # no rank leaves while another needs the store
        dist.destroy_process_group()
    return {'rank': 0 if groups is None else groups.rank,
            'pid': os.getpid(),
            'device': str(resolve_device(args.device) if groups is None
                          else groups.device),
            'step': state.step, 'samples_passed': samples_passed,
            'launches': launch_counts()}


if __name__ == '__main__':
    main()
