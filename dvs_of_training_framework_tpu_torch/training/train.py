"""Host-side training loop: batching, skipping, logging, hooks, validation.

Counterpart of ``dvs_of_training_framework_tpu/training/train.py``
(``train``, ``validate``, ``make_hook_periodic``, ``shapes2tags``,
``add_loss``, ``batch_num_events``), on the single-batch path: oversized
raw batches are skipped and counted (a dense batch has no events and is
never skipped), per-scale losses are logged against
samples passed, periodic hooks run at optimizer-step boundaries, and a
validation pass logs the mean loss terms.  The TensorBoard tags and
values are the JAX loop's.  A rank of a multi-process run hands both a
``prepare_batch`` that cuts its piece out of each host batch
(``parallel/mesh.py``), and counts samples globally (``samples_scale``).

The step is host-bound, so the loop never waits on the card for a
metric: losses stay on the device and are fetched with one stacked
``.cpu()`` every ``metric_flush_steps`` optimizer steps, and before any
hook fires, so the logs stay aligned with the checkpoints.
"""
import torch

from ..data.prefetch import prefetch_to_device
from ..data.schema import pad_batch
from ..utils.timer import (FakeTimer, SynchronizedWallClockTimer,
                           ThroughputTimer)


def make_hook_periodic(hook, interval):
    wrapper = lambda step, *args: (None if step % interval  # noqa: E731
                                   else hook(step, *args))
    # read by the loop, which flushes the deferred metrics before a hook
    # fires (the logs must stay aligned with the checkpoints)
    wrapper.interval = interval
    return wrapper


def shapes2tags(shapes):
    return [f'{h}x{w}' for h, w in shapes]


def add_loss(loss_sum, loss_values):
    if len(loss_sum) == 0:
        return [float(v) for v in loss_values]
    return [x + float(y) for x, y in zip(loss_sum, loss_values)]


def batch_num_events(batch, is_raw=True):
    if not is_raw:
        return 0
    return int(batch['events']['x'].size)


def _fetch(records):
    """Every ``(loss, (smoothness, photometric, out_reg))`` of ``records``
    as host floats, through one device-to-host copy."""
    scalars = [t.float() for loss, terms in records
               for t in (loss, *terms[0], *terms[1], *terms[2])]
    if not scalars:
        return []
    values = torch.stack(scalars).cpu().tolist()
    out, i = [], 0
    for _, terms in records:
        n = len(terms[0])
        loss, flat = values[i], values[i + 1:i + 1 + 3 * n]
        out.append((loss, (flat[:n], flat[n:2 * n], flat[2 * n:])))
        i += 1 + 3 * n
    return out


def train(train_step,
          state,
          loader,
          num_steps: int,
          logger,
          tags,
          device,
          lr_fn=None,
          accumulation_steps=1,
          event_capacity=2 ** 18,
          timers=None,
          hooks={},
          init_step=0,
          init_samples_passed=0,
          max_events_per_batch: int = 350000,
          on_state_update=None,
          metric_flush_steps: int = 16,
          sequence_length=None,
          is_raw=True,
          prepare_batch=None,
          samples_scale: int = 1):
    """Run the training loop.

    Args:
        train_step: ``(state, device Batch) -> (state, (loss, terms))``
            (``state.make_train_step``).
        state: the TrainState.
        loader: iterable of host-collated ragged batch dicts.
        num_steps: total optimizer steps to reach.
        logger: SummaryWriter-compatible object.
        tags: per-scale tag strings (e.g. '32x32') for metric names.
        device: the torch device the batches go to.
        lr_fn: ``step -> [lr_i]`` for learning-rate logging.
        event_capacity: fixed event-buffer size; with
            ``max_events_per_batch`` it bounds the batches taken, larger
            ones are skipped (the reference's oversized-batch breaker).
        timers: ``utils/timer.py``'s interface; ``FakeTimer`` if None.
            A ``SynchronizedWallClockTimer`` also reports samples/s
            (``ThroughputTimer``).
        hooks: dict of periodic hooks called with (step, samples_passed).
        on_state_update: optional callback receiving the latest state.
        metric_flush_steps: optimizer steps between metric fetches.
        sequence_length: per-sample slot count for dynamic sample
            lengths (``pad_batch``), None for static lengths.
        is_raw: the loader gives raw event batches; False for dense ones
            (``--ev_images``), which take no event capacity.
        prepare_batch: ``(collated, capacity) -> host Batch`` in place of
            the padding (a rank's piece of the batch; an ``OverflowError``
            skips the batch).
        samples_scale: multiplier of every host batch's ``size`` in
            samples_passed: a rank reads ``1/samples_scale`` of each
            global batch, and samples_passed (LR schedule, metrics x-axis,
            resume position) counts GLOBAL samples.

    Returns:
        (state, samples_passed)
    """
    if timers is None:
        timers = FakeTimer()
    throughput = None
    if isinstance(timers, SynchronizedWallClockTimer):
        throughput = ThroughputTimer(batch_size=None, device=device)
    samples_passed = init_samples_passed
    pending_micro = []       # device (loss, terms) since the last boundary
    pending_boundaries = []  # (step, samples_passed, micro records)
    init_batch = init_step * accumulation_steps
    global_step = init_batch
    num_skipped = 0
    capacity = min(event_capacity, max_events_per_batch)

    def make_batch(host_batch):
        num_events = batch_num_events(host_batch, is_raw)
        if num_events > capacity:
            raise OverflowError(f'{num_events} events > capacity {capacity}')
        if prepare_batch is not None:
            return prepare_batch(host_batch, capacity)
        return pad_batch(host_batch, capacity if is_raw else None,
                         sequence_length=sequence_length)

    def flush_metrics():
        nonlocal pending_boundaries
        if not pending_boundaries:
            return
        fetched = iter(_fetch([r for _, _, micro in pending_boundaries
                               for r in micro]))
        for b_step, b_samples, micro in pending_boundaries:
            loss_sum = 0.0
            smooth_sum, photo_sum, out_reg_sum = [], [], []
            for _ in micro:
                p_loss, (smoothness, photometric, out_reg) = next(fetched)
                photo_sum = add_loss(photo_sum, photometric)
                smooth_sum = add_loss(smooth_sum, smoothness)
                out_reg_sum = add_loss(out_reg_sum, out_reg)
                loss_sum += float(p_loss)
            for tag, s, p, o in zip(tags, smooth_sum, photo_sum,
                                    out_reg_sum):
                logger.add_scalar(f'Train/photometric loss/{tag}',
                                  p / accumulation_steps, b_samples)
                logger.add_scalar(f'Train/smoothness loss/{tag}',
                                  s / accumulation_steps, b_samples)
                logger.add_scalar(f'Train/out regularization/{tag}',
                                  o / accumulation_steps, b_samples)
            logger.add_scalar('General/Train loss', loss_sum, b_samples)
            if lr_fn is not None:
                for i, lr in enumerate(lr_fn(b_step)):
                    logger.add_scalar(f'General/learning rate/{i}', lr,
                                      b_samples)
        pending_boundaries = []

    def report_skip(host_batch):
        nonlocal num_skipped
        num_skipped += 1
        num_events = batch_num_events(host_batch, is_raw)
        num_processed = global_step - init_batch
        print(f'Skipping batch with {num_events} events')
        if num_events > capacity:
            print('Augmentation parameters '
                  f'{host_batch.get("augmentation_params")}')
        rate = num_processed / max(num_processed + num_skipped, 1)
        print(f'Processing rate is {rate:.2f}')
        logger.add_scalar('General/skipped batches', num_skipped,
                          samples_passed)

    def run_step(host_batch, device_batch):
        nonlocal state, global_step, samples_passed, pending_micro
        global_step += 1
        samples_passed += host_batch['size'] * samples_scale
        if throughput is not None:
            throughput.batch_size = host_batch['size']
            throughput.start()
        timers('train_step').start()
        state, (loss, terms) = train_step(state, device_batch)
        timers('train_step').stop()
        if throughput is not None:
            throughput.stop()

        is_step_boundary = global_step % accumulation_steps == 0

        timers('logging').start()
        pending_micro.append((loss, terms))
        if is_step_boundary:
            step = global_step // accumulation_steps
            pending_boundaries.append((step, samples_passed, pending_micro))
            pending_micro = []
            hook_fires = any(step % getattr(h, 'interval', 1) == 0
                             for h in hooks.values())
            if hook_fires or len(pending_boundaries) >= metric_flush_steps:
                flush_metrics()
        timers('logging').stop()

        if is_step_boundary:
            step = global_step // accumulation_steps
            if on_state_update is not None:
                on_state_update(state)
            for k, hook in hooks.items():
                timers(k).start()
                hook(step, samples_passed)
                timers(k).stop()

        # 'all_reduce': the sharded steps' collectives, inside train_step
        timers.log(names=['batch_construction', 'train_step', 'logging',
                          'all_reduce'] + list(hooks))

    stream = prefetch_to_device(iter(loader), make_batch, device)
    timers('batch_construction').start()
    for batch, device_batch in stream:
        if global_step == num_steps * accumulation_steps:
            break
        if device_batch is None:
            report_skip(batch)
            continue
        timers('batch_construction').stop()
        run_step(batch, device_batch)
        timers('batch_construction').start()
    timers('batch_construction').stop()
    stream.close()
    flush_metrics()
    return state, samples_passed


def _emit_validation(logger, tags, samples_passed, n, loss_sum, smooth_sum,
                     photo_sum, out_reg_sum):
    n = max(n, 1)
    logger.add_scalar('General/Validation loss', loss_sum / n,
                      samples_passed)
    for tag, s, p, o in zip(tags, smooth_sum, photo_sum, out_reg_sum):
        logger.add_scalar(f'Validation/smoothness loss/{tag}', s / n,
                          samples_passed)
        logger.add_scalar(f'Validation/photometric loss/{tag}', p / n,
                          samples_passed)
        logger.add_scalar(f'Validation/out regularization loss/{tag}',
                          o / n, samples_passed)
    return loss_sum / n


def validate(eval_step, loader, samples_passed, logger, tags, device,
             event_capacity=2 ** 18, sequence_length=None,
             prepare_batch=None):
    """Validation pass (reference utils/training.py:244-271): the mean
    loss terms over the batches that fit ``event_capacity``, fetched from
    the device once at the end; ``sequence_length`` as in ``train``.

    ``prepare_batch(collated, capacity) -> host Batch`` overrides the
    padding: a mesh run passes its split, so that validation runs sharded
    (``parallel.make_sharded_eval_step``).  A batch it refuses, one whose
    size the shards do not divide (``ValueError``) or with a shard over
    capacity (``OverflowError``), is dropped and counted.
    """
    n = 0
    n_dropped = 0
    photo_sum, smooth_sum, out_reg_sum = [], [], []
    loss_sum = 0.0
    pending = []
    for batch in loader:
        if batch_num_events(batch) > event_capacity:
            continue
        if prepare_batch is not None:
            try:
                host_batch = prepare_batch(batch, event_capacity)
            except (ValueError, OverflowError):
                n_dropped += 1
                continue
        else:
            host_batch = pad_batch(batch, event_capacity,
                                   sequence_length=sequence_length)
        pending.append(eval_step(host_batch.to(device)))
        n += 1
    if n_dropped:
        print(f'validate: dropped {n_dropped} batches the mesh split '
              'refused (indivisible remainder or a shard over capacity)')
    for loss, (smoothness, photometric, out_reg) in _fetch(pending):
        photo_sum = add_loss(photo_sum, photometric)
        smooth_sum = add_loss(smooth_sum, smoothness)
        out_reg_sum = add_loss(out_reg_sum, out_reg)
        loss_sum += float(loss)
    return _emit_validation(logger, tags, samples_passed, n, loss_sum,
                            smooth_sum, photo_sum, out_reg_sum)
