"""The system under test, driven as its users run it.

The port's training loop (``training/train.py`` ``train``) with the
device queue's windows: the step, the fused window step, the model, the
optimizer and the loss built as the port's ``train.run()`` builds them,
from the configuration's flags parsed by ``train.parse_args``, with
``run()``'s backend settings (TF32 off, deterministic cuDNN).  The loader
is the traffic's pool of collated batches, cycled; the loop pads, stages,
uploads and steps them.  The benchmark gives the loop its own ``timers``
(host-clock spans, no device sync), ``logger`` (the per-step losses) and
one hook, called by the loop once a window, after the window's metric
flush: there it keeps the state after the first window, starts the timed
window at a window's end, ends it at the first window's end after
``seconds``, runs the traced windows, and keeps the state before and
after one more window, the check window, which the loop stages and
replays as it does every window.  The loader ends at the window boundary
after that, and the loop runs out what it has staged.
"""
import time

import torch

from .trace import SPAN_PREFIX, Digest, profiler

PORT = 'dvs_of_training_framework_tpu_torch'
WARM_WINDOWS = 3       # windows before the timed window: capture, steady
TRACE_WINDOWS = 3      # windows under the profiler in a traced run


def argv(config, device):
    """The configuration's flags as a command line of the port's CLI.  Its
    model directory is never written: the loop runs no checkpoint, no
    validation and no TensorBoard writer of the port."""
    out = []
    for flag, value in config['flags'].items():
        if value is True:
            out.append(flag)
        elif value is not False:
            out += [flag, str(value)]
    return out + ['-m', 'build/portbench/model', '-d', device.type]


class Region:

    def __init__(self, spans, name, recorder):
        self.spans, self.name, self.recorder = spans, name, recorder
        self.begin = self.range = None

    def start(self):
        self.begin = time.perf_counter()
        if self.recorder.tracing:
            self.range = torch.autograd.profiler.record_function(
                SPAN_PREFIX + self.name)
            self.range.__enter__()

    def stop(self):
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        self.spans.append((self.begin, time.perf_counter()))


class Recorder:
    """``utils/timer.py``'s interface: every region's host-clock spans,
    no device sync; under the profiler each region is also a
    ``record_function`` range."""

    def __init__(self):
        self.spans = {}
        self.regions = {}
        self.tracing = False

    def __call__(self, name):
        if name not in self.regions:
            self.regions[name] = Region(self.spans.setdefault(name, []),
                                        name, self)
        return self.regions[name]

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False):
        pass

    def seconds(self, name, lo, hi):
        """Seconds of ``name``'s spans that end in ``(lo, hi]``."""
        return sum(b - a for a, b in self.spans.get(name, ())
                   if lo < b <= hi)


class Logger:
    """The loop's SummaryWriter: keeps each optimizer step's loss."""

    def __init__(self):
        self.losses = []
        self.skipped = 0

    def add_scalar(self, tag, value, step):
        if tag == 'General/Train loss':
            self.losses.append(float(value))
        elif tag == 'General/skipped batches':
            self.skipped = int(value)

    def close(self):
        pass


class Phases:
    """The loop's hook and the loader's clock: phases ``warm``,
    ``timed``, ``traced``, ``check``, ``done``.  ``ends`` holds the host
    time of every window's end (after its flush) by the optimizer step it
    ended at.  ``keep(name, step)`` is called at the end of the first
    window (``'first'``), and before (``'check_start'``) and after
    (``'check_end'``) the check window, outside the timed and the traced
    windows."""

    def __init__(self, interval, seconds, trace, keep):
        self.interval = interval    # optimizer steps a window: the loop
        # then runs every window whole and calls the hook after each
        self.seconds, self.trace = seconds, trace
        self.keep = keep
        self.phase = 'warm'
        self.ends = []
        self.t0 = self.t_end = None
        self.profile = None
        self.recorder = None
        self.check_from = None

    def __call__(self, step, samples_passed):
        now = time.perf_counter()
        self.ends.append((step, now))
        if len(self.ends) == 1:
            self.keep('first', step)
        if self.phase == 'warm' and len(self.ends) == WARM_WINDOWS:
            self.phase, self.t0 = 'timed', time.perf_counter()
        elif self.phase == 'timed' and now - self.t0 >= self.seconds:
            self.t_end = now
            if self.trace:
                self.phase = 'traced'
                self.profile = profiler()
                self.profile.__enter__()
                self.recorder.tracing = True
                self.trace_from = (step, time.perf_counter())
            else:
                self.start_check(step)
        elif self.phase == 'traced' and step - self.trace_from[0] \
                >= TRACE_WINDOWS * self.interval:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.trace_to = (step, time.perf_counter())
            self.recorder.tracing = False
            self.profile.__exit__(None, None, None)
            self.start_check(step)
        elif self.phase == 'check':
            self.keep('check_end', step)
            self.phase = 'done'

    def start_check(self, step):
        self.keep('check_start', step)
        self.check_from = step
        self.phase = 'check'

    def digest(self):
        """The traced windows' ``trace.Digest``."""
        return Digest(self.profile.events(),
                      self.trace_to[0] - self.trace_from[0],
                      self.trace_to[1] - self.trace_from[1])


def feed(pool, window, phases):
    """The loader: the pool cycled, ending at the window boundary after
    the hook is done."""
    i = 0
    while not (i % window == 0 and phases.phase == 'done'):
        yield pool[i % len(pool)]
        i += 1


class Program:
    """The port's training objects for one configuration, with the
    benchmark's weights loaded before the optimizer copies them."""

    def __init__(self, config, weights, device):
        import importlib
        cli = importlib.import_module(f'{PORT}.train')
        losses = importlib.import_module(f'{PORT}.losses')
        models = importlib.import_module(f'{PORT}.models')
        training = importlib.import_module(f'{PORT}.training')
        loop = importlib.import_module(f'{PORT}.training.train')
        args = cli.parse_args(argv(config, device))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        self.args, self.device, self.cli, self.loop = args, device, cli, loop
        self.training = training
        self.model = models.init_model(args, device)
        with torch.no_grad():
            self.model.load_state_dict(weights, strict=True)
        self.optimizer = training.construct_optimizer(args, self.model)
        self.evaluator = losses.MultiScaleLoss(
            cli.flow_shapes(args.shape),
            bf16x2=losses.LOSS_PRECISIONS[args.loss_precision])
        self.window = args.device_queue_window
        self.train_step = training.make_train_step(
            self.model, self.evaluator, self.optimizer, args.loss_weights,
            args.accum_step, is_raw=args.is_raw, window=self.window)
        self.fused = training.make_fused_window_step(
            self.model, self.evaluator, self.optimizer, args.loss_weights,
            args.accum_step, self.window, is_raw=args.is_raw)

    def state(self):
        """The model's and the optimizer's state, copied to the CPU:
        ``{'params': {name: tensor}, 'mu', 'nu', 'slow': {name: tensor},
        'count': updates made}``."""
        def copy(t):
            return t.detach().to('cpu', copy=True)

        out = {'params': {k: copy(p)
                          for k, p in self.model.named_parameters()}}
        counts = set()
        for group in self.optimizer.groups.values():
            saved = group.state_dict()
            counts.add(saved.pop('count'))
            for key, tensors in saved.items():
                out.setdefault(key, {}).update(
                    {n: copy(t) for n, t in tensors.items()})
        (out['count'],) = counts
        return out

    def run(self, pool, phases, recorder, logger):
        args = self.args
        phases.recorder = recorder
        self.loop.train(
            self.train_step, self.training.create_train_state(0),
            feed(pool, self.window, phases), args.training_steps,
            logger=logger, tags=self.loop.shapes2tags(self.evaluator.shapes),
            device=self.device,
            lr_fn=lambda step: self.training.current_learning_rates(
                args, step, self.optimizer.groups),
            accumulation_steps=args.accum_step,
            event_capacity=args.event_capacity, timers=recorder,
            hooks={'portbench': phases},
            max_events_per_batch=args.max_events_per_batch,
            sequence_length=self.cli.pad_sequence_length(args),
            is_raw=args.is_raw, window=self.window,
            train_step_fused=self.fused)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
