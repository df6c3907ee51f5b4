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
(``parallel/mesh.py``), and counts samples globally (``samples_scale``);
the ranks drop together a batch whose piece overflowed on any of them
(``agree``).
A batch that the reader skipped unread arrives as a record of its
recorded event count (``data.schema.SKIPPED_EVENTS``) and is reported as
a decoded oversized batch is.

The step is host-bound, so the loop never waits on the card for a
metric: losses stay on the device and are fetched with one stacked
``.cpu()`` every ``metric_flush_steps`` optimizer steps, and before any
hook fires, so the logs stay aligned with the checkpoints.

With ``window = K`` (``--device-queue-window``) the loop reads its batches
as staged windows of K (``data/device_queue.py``) and runs a window that
covers whole optimizer steps, with no hook due inside it, as one call of
``train_step_fused`` (``state.make_fused_window_step``: one CUDA graph
replay on a card); any other window, a partial one at the end or one a
hook cuts, runs ``train_step`` slot by slot.  The host stages the next
window while the card runs the current one: a window's work is enqueued
(the fused call, or its last slot's step), then the next window is
read, padded, stacked and uploaded, then the metrics are flushed, which
blocks on the card, then the hooks run.  So the loop itself holds the
next window while a window runs, and reads the stream with ``depth=1``:
at most two windows are on the device at once, and the loader is read
at most one window beyond the window in flight.  A window's first call
of ``train_step_fused`` captures its graph before it returns, so nothing
is staged during a capture.  A rank of a mesh stages windows of its own
pieces and steps them with the sharded steps (``parallel/mesh.py``); its
ranks stage, and agree on drops, at the same point of every window.
``validate_windowed`` does the same for validation on one device
(``--validation-window``).  The logged values equal the per-batch
loop's.
"""
import itertools

import torch

from ..data.prefetch import prefetch_to_device
from ..data.schema import SKIPPED_EVENTS, pad_batch
from ..utils.timer import FakeTimer
from .state import step_values


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
    if SKIPPED_EVENTS in batch:     # skipped unread: its recorded count
        return int(batch[SKIPPED_EVENTS])
    return int(batch['events']['x'].size)


def _fetch(rows):
    """Rows of ``state.step_values`` (each ``[1 + 3 * scales]`` or a
    stack ``[n, 1 + 3 * scales]``) as ``(loss, (smoothness, photometric,
    out_reg))`` host floats, one a row, through one device-to-host copy."""
    if not rows:
        return []
    values = torch.cat([r.reshape(-1, r.shape[-1]) for r in rows]) \
        .cpu().tolist()
    n = (len(values[0]) - 1) // 3
    return [(v[0], (v[1:1 + n], v[1 + n:1 + 2 * n], v[1 + 2 * n:]))
            for v in values]


def _window_rows(loss_k, terms_k):
    """A fused window's ``(loss[K], terms)`` as K rows of step values."""
    return torch.cat([loss_k[:, None], *terms_k], dim=1)


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
          samples_scale: int = 1,
          window: int = 0,
          train_step_fused=None,
          window_check=None,
          agree=None):
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
        timers: ``utils/timer.py``'s interface, of which the loop calls
            ``timers(name).start()``, ``.stop()`` and ``timers.log()``;
            ``FakeTimer`` if None.  Inside the loop's regions
            (``batch_construction``, ``train_step``, ``logging``, the
            hooks') it opens ``read``, ``pad``, ``stack``, ``upload`` and
            ``fetch``; with ``window``, ``ahead`` inside each
            ``batch_construction`` that stages a window behind one in
            flight (all but the first).
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
        window: device-queue window K (0 = off): K batches are staged
            a window and ``train_step`` (built with the same ``window``,
            ``state.make_train_step``) steps slot ``micro_step % K``.
            The state's ``micro_step`` must start at a multiple of K,
            which holds for a fresh or resumed state.  On a mesh a rank's
            window is the stack (``stack_batches``) of its own
            ``prepare_batch`` pieces, uploaded to its own device: in the
            JAX package's terms, the process's local slice of
            ``make_global_batch(window=True)``, so no ``place_window`` is
            needed.
        train_step_fused: optional ``(state, window) -> (state,
            (loss[K], terms))`` (``state.make_fused_window_step``,
            ``parallel.make_sharded_fused_window_step``) that runs a whole
            window in one call.
        window_check: optional ``(n_valid, n_skipped) -> None`` called
            with every staged window before it is stepped; on a mesh
            ``parallel.check_windows_agree`` raises unless every rank
            staged the same, so the ranks' collectives pair the same steps.
        agree: on a mesh, ``parallel.agree_on_drops``: a batch that
            overflowed on any rank is dropped on every rank (one small
            all-reduce a window, or a batch with ``window = 0``), so that
            the ranks step the same batches where nothing else makes
            their decisions agree.

    Returns:
        (state, samples_passed)
    """
    if timers is None:
        timers = FakeTimer()
    samples_passed = init_samples_passed
    pending_micro = []       # device (loss, terms) since the last boundary
    pending_boundaries = []  # deferred metric records (see flush_metrics)
    boundary_count = 0       # optimizer boundaries deferred so far
    init_batch = init_step * accumulation_steps
    global_step = init_batch
    num_skipped = 0
    capacity = min(event_capacity, max_events_per_batch)

    def make_batch(host_batch):
        num_events = batch_num_events(host_batch, is_raw)
        if num_events > capacity:
            raise OverflowError(f'{num_events} events > capacity {capacity}')
        timers('pad').start()
        try:
            if prepare_batch is not None:
                return prepare_batch(host_batch, capacity)
            return pad_batch(host_batch, capacity if is_raw else None,
                             sequence_length=sequence_length)
        finally:
            timers('pad').stop()

    def emit(b_step, b_samples, micro):
        loss_sum = 0.0
        smooth_sum, photo_sum, out_reg_sum = [], [], []
        for p_loss, (smoothness, photometric, out_reg) in micro:
            photo_sum = add_loss(photo_sum, photometric)
            smooth_sum = add_loss(smooth_sum, smoothness)
            out_reg_sum = add_loss(out_reg_sum, out_reg)
            loss_sum += float(p_loss)
        for tag, s, p, o in zip(tags, smooth_sum, photo_sum, out_reg_sum):
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

    def flush_metrics():
        """Every deferred record's values in one device-to-host copy:
        ``('single', step, samples_passed, micro (loss, terms))`` of one
        optimizer step, ``('fused', first step, [samples_passed at each
        boundary], loss[K], terms)`` of a fused window."""
        nonlocal pending_boundaries, boundary_count
        if not pending_boundaries:
            return
        rows = []
        for record in pending_boundaries:
            if record[0] == 'fused':
                rows.append(_window_rows(*record[3:]))
            else:
                rows += [step_values(*r) for r in record[3]]
        timers('fetch').start()
        fetched = iter(_fetch(rows))
        timers('fetch').stop()
        for record in pending_boundaries:
            if record[0] == 'fused':
                _, first_step, samples_list = record[:3]
                for j, b_samples in enumerate(samples_list):
                    emit(first_step + j, b_samples,
                         [next(fetched) for _ in range(accumulation_steps)])
            else:
                _, b_step, b_samples, micro = record
                emit(b_step, b_samples, [next(fetched) for _ in micro])
        pending_boundaries = []
        boundary_count = 0

    def report_skip(host_batch):
        nonlocal num_skipped
        num_skipped += 1
        num_events = batch_num_events(host_batch, is_raw)
        num_processed = global_step - init_batch
        print(f'Skipping batch with {num_events} events')
        if SKIPPED_EVENTS in host_batch:
            print(f'(at sample {host_batch["sample"]}, skipped by its '
                  'recorded event count, unread)')
        elif num_events > capacity:
            print('Augmentation parameters '
                  f'{host_batch.get("augmentation_params")}')
        rate = num_processed / max(num_processed + num_skipped, 1)
        print(f'Processing rate is {rate:.2f}')
        logger.add_scalar('General/skipped batches', num_skipped,
                          samples_passed)

    def run_step(host_batch, device_batch, stage_next=None):
        """One batch's step; ``stage_next``, where given, is called once
        the step is enqueued, before anything waits on the card."""
        nonlocal state, global_step, samples_passed, pending_micro, \
            boundary_count
        global_step += 1
        samples_passed += host_batch['size'] * samples_scale
        timers('train_step').start()
        state, (loss, terms) = train_step(state, device_batch)
        timers('train_step').stop()
        if stage_next is not None:
            stage_next()

        is_step_boundary = global_step % accumulation_steps == 0

        timers('logging').start()
        pending_micro.append((loss, terms))
        if is_step_boundary:
            step = global_step // accumulation_steps
            pending_boundaries.append(('single', step, samples_passed,
                                       pending_micro))
            pending_micro = []
            boundary_count += 1
            hook_fires = any(step % getattr(h, 'interval', 1) == 0
                             for h in hooks.values())
            if hook_fires or boundary_count >= metric_flush_steps:
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

    def hook_inside(first_opt_step, count):
        """Does any hook fire at opt steps (first, first + count]?"""
        for h in hooks.values():
            interval = getattr(h, 'interval', 1)
            if (first_opt_step + count) // interval \
                    != first_opt_step // interval:
                return True
        return False

    def run_fused(host_batches, device_window, stage_next):
        """A whole window in one call of train_step_fused; then
        ``stage_next()`` while the card runs it."""
        nonlocal state, global_step, samples_passed, boundary_count
        assert not pending_micro, \
            'fused window entered with a partial accumulation group'
        timers('train_step').start()
        state, (loss_k, terms_k) = train_step_fused(state, device_window)
        timers('train_step').stop()
        stage_next()
        base_step = global_step // accumulation_steps
        samples_list = []   # samples_passed at each optimizer boundary
        for i, host_batch in enumerate(host_batches):
            samples_passed += host_batch['size'] * samples_scale
            if (global_step + i + 1) % accumulation_steps == 0:
                samples_list.append(samples_passed)
        global_step += len(host_batches)
        timers('logging').start()
        pending_boundaries.append(('fused', base_step + 1, samples_list,
                                   loss_k, terms_k))
        boundary_count += len(samples_list)
        step = global_step // accumulation_steps
        hook_fires = any(step % getattr(h, 'interval', 1) == 0
                         for h in hooks.values())
        if hook_fires or boundary_count >= metric_flush_steps:
            flush_metrics()
        timers('logging').stop()
        if on_state_update is not None:
            on_state_update(state)
        for k, hook in hooks.items():   # periodic wrappers self-gate
            timers(k).start()
            hook(step, samples_passed)
            timers(k).stop()
        timers.log(names=['batch_construction', 'train_step', 'logging',
                          'all_reduce'] + list(hooks))

    if window > 0:
        # the ``micro_step % window`` slot assumes the loop enters
        # window-aligned; a state resumed mid-window would silently step
        # the wrong staged batch
        if state.micro_step % window:
            raise ValueError(
                f'resumed micro_step {state.micro_step} is not aligned to '
                f'the device-queue window {window}; train with a window '
                'that divides the checkpoint cadence or disable the device '
                'queue')
        from ..data.device_queue import prefetch_windows

        # depth 1: the loop holds the next window itself (``stage``)
        stream = prefetch_windows(iter(loader), make_batch, window, depth=1,
                                  device=device, agree=agree, timers=timers)
        timers('batch_construction').start()
        staged = next(stream, None)     # the first, nothing in flight
        timers('batch_construction').stop()

        def stage():
            """The next staged window into ``staged`` (None at the
            stream's end), behind the window in flight.  The stream's
            error is kept, and raised where the loop takes the window:
            after the window in flight is flushed and its hooks ran."""
            nonlocal staged
            timers('batch_construction').start()
            timers('ahead').start()
            try:
                staged = next(stream, None)
            except Exception as error:
                staged = error
            timers('ahead').stop()
            timers('batch_construction').stop()

        done = False
        while staged is not None:
            if isinstance(staged, Exception):
                raise staged
            host_batches, device_window, n_valid, skipped = staged
            if window_check is not None:
                window_check(n_valid, len(skipped))
            for host_batch in skipped:
                report_skip(host_batch)
            remaining = num_steps * accumulation_steps - global_step
            first_opt = global_step // accumulation_steps
            # the whole window in one call only when it covers whole
            # optimizer steps and no hook must fire inside it
            if (train_step_fused is not None and n_valid == window
                    and remaining >= window
                    and window % accumulation_steps == 0
                    and global_step % accumulation_steps == 0
                    and not hook_inside(first_opt,
                                        window // accumulation_steps - 1)):
                run_fused(host_batches, device_window, stage)
            else:
                for i in range(n_valid):
                    if global_step == num_steps * accumulation_steps:
                        done = True
                        break
                    # a window holds at least one batch: its last slot
                    # stages the next window
                    run_step(host_batches[i], device_window,
                             stage if i == n_valid - 1 else None)
            if done:
                break
        stream.close()
        flush_metrics()
        return state, samples_passed

    stream = prefetch_to_device(iter(loader), make_batch, device,
                                agree=agree, timers=timers)
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
    for loss, (smoothness, photometric, out_reg) in _fetch(
            [step_values(*p) for p in pending]):
        photo_sum = add_loss(photo_sum, photometric)
        smooth_sum = add_loss(smooth_sum, smoothness)
        out_reg_sum = add_loss(out_reg_sum, out_reg)
        loss_sum += float(loss)
    return _emit_validation(logger, tags, samples_passed, n, loss_sum,
                            smooth_sum, photo_sum, out_reg_sum)


def runs_of_equal_size(batches):
    """The batches cut into runs of one ``size`` each, lazily: a window
    stacks batches of one static size, and a finite validation stream may
    end with a smaller remainder batch."""
    for _, run in itertools.groupby(batches, key=lambda b: b['size']):
        yield run


def validate_windowed(fused_eval_step, loader, samples_passed, logger, tags,
                      window, device, event_capacity=2 ** 18,
                      sequence_length=None):
    """Validation through the device queue: K batches a window and one
    call of ``fused_eval_step`` (``state.make_fused_eval_step``) each,
    fetched from the device once at the end.  The same scalars as
    ``validate``: the same losses of the same padded batches, summed in
    the same order (reference utils/training.py:244-271)."""
    from ..data.device_queue import prefetch_windows

    def prepare(host_batch):
        if batch_num_events(host_batch) > event_capacity:
            raise OverflowError('oversized validation batch')
        return pad_batch(host_batch, event_capacity,
                         sequence_length=sequence_length)

    n = 0
    photo_sum, smooth_sum, out_reg_sum = [], [], []
    loss_sum = 0.0
    pending = []   # the valid rows of each window's step values
    for run in runs_of_equal_size(loader):
        for _, device_window, n_valid, _ in prefetch_windows(
                run, prepare, window, device=device):
            pending.append(_window_rows(
                *fused_eval_step(device_window, n_valid))[:n_valid])
            n += n_valid
    for loss, (smoothness, photometric, out_reg) in _fetch(pending):
        photo_sum = add_loss(photo_sum, photometric)
        smooth_sum = add_loss(smooth_sum, smoothness)
        out_reg_sum = add_loss(out_reg_sum, out_reg)
        loss_sum += float(loss)
    return _emit_validation(logger, tags, samples_passed, n, loss_sum,
                            smooth_sum, photo_sum, out_reg_sum)
