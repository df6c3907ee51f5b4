#!/usr/bin/env python3
"""Training CLI of the port, for one process on one device.

Counterpart of the JAX package's composition root ``train_flownet.py``:
it parses the shared option groups, builds the plugin's model
(``--flownet_path``: EVFlowNet, RecurrentFlowNet, DummyFlowNet or a torch
plugin directory, ``models/loader.py``), the optimizer, the loss, the
serializer and the hooks, resumes from the
newest checkpoint (parameters, optimizer state, step, samples passed and
the data stream's position) or writes step 0, validates, trains,
validates again and writes the final checkpoint.

    python -m dvs_of_training_framework_tpu_torch.train -m OUT [options]

``main`` parses, writes and checks the run's provenance and builds the
data loaders over the dataset; ``run`` does the rest for any loaders, so
a caller with batches in memory can drive it without a dataset.  With
``--ev_images`` the model trains on dense batches: baked shards
(``tools/quantize_preprocessed.py``) through
``--preprocessed-dataset-path``, or raw data turned into images on the
host by the plugin's ``compute_event_image``; validation stays raw.  ``run``
turns cuDNN's nondeterministic algorithms off, so that a resumed run
repeats the uninterrupted one.  The device defaults to ``cuda``; ``-d
cuda`` without a card raises.  Flags of
features the port does not have yet raise an error naming their ROADMAP
item; the TPU-only flags are accepted and ignored with one line each.
"""
from argparse import ArgumentParser
import sys

import torch

from .data.dataloader import (choose_data_path, get_dataloader,
                              get_trainset_params, get_valset_params)
from .losses import LOSS_PRECISIONS, MultiScaleLoss
from .models import init_model, load_model_class
from .training import (construct_optimizer, create_train_state,
                       current_learning_rates, make_eval_step,
                       make_train_step)
from .training.hooks import SerializationHook, ValidationHook
from .training.serializer import Serializer
from .training.train import make_hook_periodic, shapes2tags, train
from .utils.common import (check_execution_info, collect_execution_info,
                           write_execution_info)
from .utils.options import (add_preprocessed_dataset_arguments,
                            add_train_arguments, resolve_event_capacity,
                            validate_train_args)
from .utils.tb import SummaryWriter

# (flag, whether the parsed arguments use it, ROADMAP queue 1 item)
UNPORTED = (
    ('--mesh', lambda a: a.mesh is not None, 14),
    ('--coordinator-address', lambda a: a.coordinator_address is not None,
     14),
    ('--num-processes', lambda a: a.num_processes is not None, 14),
    ('--process-id', lambda a: a.process_id is not None, 14),
    ('--timers', lambda a: a.timers, 13),
    ('--profiling', lambda a: a.profiling != 'None', 13),
)
# TPU and tunnel workarounds the port leaves out (ROADMAP "Not to port")
TPU_ONLY = ('wire_timestamps', 'wire_events', 'wire_data',
            'device_queue_window', 'validation_window', 'split_decoder',
            'flat_optimizer')


def parse_args(argv):
    """The shared training options, checked; no file is touched."""
    parser = ArgumentParser()
    add_train_arguments(parser)
    add_preprocessed_dataset_arguments(parser)
    parser.set_defaults(device='cuda')
    args = parser.parse_args(argv)
    for flag, used, item in UNPORTED:
        if used(args):
            raise ValueError(f'{flag} is not ported yet (ROADMAP queue 1 '
                             f'item {item})')
    for dest in TPU_ONLY:
        if getattr(args, dest) != parser.get_default(dest):
            print(f'--{dest.replace("_", "-")} {getattr(args, dest)}: '
                  'a TPU-only option, ignored')
    return validate_train_args(args)


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


def run(args, train_loader_factory, val_loader_factory, logger,
        timers=None):
    """Build, resume or start, validate, train, checkpoint, validate.

    Args:
        args: ``parse_args`` output with ``event_capacity`` resolved to a
            number.
        train_loader_factory: ``samples_passed -> iterable of host
            batches``, the training stream from that position on.
        val_loader_factory: zero-argument callable giving a fresh finite
            validation loader.
        logger: SummaryWriter; closed at the end.
        timers: the JAX package's timer interface, for ``train``.

    Returns:
        (model, optimizer, train state, samples passed)
    """
    device = resolve_device(args.device)
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
    train_step = make_train_step(model, evaluator, optimizer,
                                 args.loss_weights, args.accum_step,
                                 is_raw=args.is_raw)

    hooks = {'serialization': SerializationHook(serializer, model,
                                                optimizer, logger)}
    periods = {'serialization': args.checkpointing_interval}
    if not args.skip_validation:
        hooks['validation'] = ValidationHook(
            make_eval_step(model, evaluator, args.loss_weights),
            val_loader_factory, logger, tags, device,
            event_capacity=args.event_capacity,
            sequence_length=sequence_length)
        periods['validation'] = args.vp

    if not args.do_not_continue and serializer.has_checkpoints():
        global_step, _, _, extra = serializer.load_checkpoint(
            serializer.list_known_steps()[-1], model=model,
            optimizer=optimizer)
        samples_passed = int(extra.get('samples_passed',
                                       global_step * args.bs))
    else:
        global_step = samples_passed = 0
        hooks['serialization'](global_step, samples_passed)
    if not args.skip_validation:
        hooks['validation'](global_step, samples_passed)

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
        hooks={k: make_hook_periodic(hooks[k], periods[k]) for k in periods},
        init_step=global_step,
        init_samples_passed=samples_passed,
        max_events_per_batch=args.max_events_per_batch,
        sequence_length=sequence_length,
        is_raw=args.is_raw)

    hooks['serialization'](args.training_steps, samples_passed)
    if not args.skip_validation:
        hooks['validation'](args.training_steps, samples_passed)
    logger.close()
    return model, optimizer, state, samples_passed


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    args = choose_data_path(args)
    args.model.mkdir(exist_ok=True, parents=True)
    args.log_path = args.model / 'log'
    resolve_event_capacity(args)
    execution_info = collect_execution_info(args)
    check_execution_info(args.model, execution_info, args)
    write_execution_info(args.model, execution_info)

    trainset = get_trainset_params(args)
    event_image_fn = make_event_image_fn(args)

    def train_loader_factory(samples_passed):
        return get_dataloader(trainset, sample_idx=samples_passed,
                              process_only_once=args.process_only_once,
                              event_image_fn=event_image_fn)

    def val_loader_factory():
        return get_dataloader(get_valset_params(args),
                              event_image_fn=event_image_fn)

    run(args, train_loader_factory, val_loader_factory,
        SummaryWriter(str(args.log_path)))


if __name__ == '__main__':
    main()
