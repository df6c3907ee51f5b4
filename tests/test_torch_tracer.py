"""The port's tracer (``utils/timer.py`` ``Timers``).

- Nested regions record spans inside their outer regions' edges, and no
  region synchronises the device.
- ``FakeTimer`` hands out one shared region.
- The windowed loop through ``prefetch_windows``: each window's line
  counts one ``stack`` and one ``upload`` span, a ``pad`` span a batch
  and one ``fetch`` span, each inside the loop's ``batch_construction``
  or ``logging`` region, and the losses equal those with ``FakeTimer``.
- Device regions take their CUDA events from a reused pool and become
  device spans only once the events completed (stand-in events here;
  the real ones in the ``cuda`` test).
- ``log()`` prints device ms and span counts and drains them; past the
  cap the oldest spans go and the line counts them; samples/s follows
  the padded batches.

No JAX: the ``cuda`` test runs on the card's machine with
``--noconftest``.
"""
import re
import time
from types import SimpleNamespace

import pytest
import torch

from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_fused_window_step,
    make_train_step)
from dvs_of_training_framework_tpu_torch.training import train as port_train
from dvs_of_training_framework_tpu_torch.utils import timer
from tests.test_torch_device_queue import card_batch

CPU = torch.device('cpu')
WINDOW = 4
SHAPES = [(32 >> s, 32 >> s) for s in (3, 2, 1, 0)]
ARGS = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                       half_life=100000, num_warmup_steps=0,
                       training_steps=10, rs=0.3, grad_clip_norm=1.0,
                       ema_decay=0.9)
STAGING = ('read', 'pad', 'stack', 'upload')


def refuse(*args, **kwargs):
    raise AssertionError('the tracer synchronised the device')


def inside(span, outer):
    """Is ``span`` within the edges of one of the ``outer`` spans?"""
    return any(o.start <= span.start <= span.end <= o.end for o in outer)


def test_tracer_records_nested_spans_without_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'synchronize', refuse)
    monkeypatch.setattr(torch.cuda.Event, 'synchronize', refuse)
    timers = timer.Timers()
    for _ in range(2):
        with timers('batch_construction'):
            for name in STAGING:
                with timers(name):
                    pass
        with timers('train_step'):
            pass
        with timers('logging'):
            with timers('fetch'):
                time.sleep(0.001)
    spans = list(timers.spans)
    assert [s.name for s in spans] == 2 * [
        *STAGING, 'batch_construction', 'train_step', 'fetch', 'logging']
    by_name = {}
    for span in spans:
        assert span.start <= span.end
        by_name.setdefault(span.name, []).append(span)
    for name in STAGING:
        assert all(inside(s, by_name['batch_construction'])
                   for s in by_name[name])
        assert not any(inside(s, by_name['logging']) for s in by_name[name])
    assert all(inside(s, by_name['logging']) for s in by_name['fetch'])
    assert all(s.end - s.start >= 1e6 for s in by_name['fetch'])    # ns
    assert timers('fetch').elapsed() >= 2e-3     # both fetches, seconds
    assert not timers.device_spans and not timers._pending


def test_fake_timer_hands_out_one_shared_region():
    fake = timer.FakeTimer()
    assert fake('read') is fake('upload') is timer.FakeTimer()('fetch')


def small_loop(timers):
    """Two windows of ``WINDOW`` through the windowed loop on the CPU;
    returns the logged losses."""
    torch.manual_seed(0)
    model = evflownet.Model(event_representation_depth=4, base_channels=8,
                            dtype='float32', device=CPU)
    evaluator = MultiScaleLoss(SHAPES)
    optimizer = construct_optimizer(ARGS, model)
    weights = [0.5, 1, 1]
    step = make_train_step(model, evaluator, optimizer, weights, 1,
                           window=WINDOW)
    fused = make_fused_window_step(model, evaluator, optimizer, weights, 1,
                                   WINDOW)

    class Logger:
        def __init__(self):
            self.losses = []

        def add_scalar(self, tag, value, step):
            if tag == 'General/Train loss':
                self.losses.append(float(value))

    logger = Logger()
    port_train.train(step, create_train_state(),
                     [card_batch(s) for s in range(2 * WINDOW)], 2 * WINDOW,
                     logger, port_train.shapes2tags(SHAPES), CPU,
                     event_capacity=1024, timers=timers,
                     metric_flush_steps=WINDOW, window=WINDOW,
                     train_step_fused=fused)
    return logger.losses


class Kept:
    """The tracer, keeping each line's spans before ``log()`` drains
    them."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.lines = []

    def __call__(self, name):
        return self.tracer(name)

    def log(self, names, **kwargs):
        self.lines.append(list(self.tracer.spans))
        self.tracer.log(names, **kwargs)


def test_windowed_loop_spans(capsys):
    kept = Kept(timer.Timers())
    losses = small_loop(kept)
    assert losses == small_loop(timer.FakeTimer()) and len(losses) == 8
    out = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith('rank=0 time (ms)')]
    counts = [dict((k, int(n)) for k, n in re.findall(
        r'([a-z_]+)=(\d+)', line.split(' | spans ')[1])) for line in out]
    # two windows staged before the first runs; before the second, the
    # loader's end is read
    assert counts == [
        {'read': WINDOW * 2, 'pad': WINDOW * 2, 'stack': 2, 'upload': 2,
         'batch_construction': 1, 'train_step': 1, 'fetch': 1,
         'logging': 1},
        {'read': 1, 'batch_construction': 1, 'train_step': 1, 'fetch': 1,
         'logging': 1}]
    spans = [s for line in kept.lines for s in line] \
        + list(kept.tracer.spans)        # the stream's end, after the last
    outer = {name: [s for s in spans if s.name == name]
             for name in ('batch_construction', 'logging')}
    assert len(outer['batch_construction']) == 3
    for span in spans:
        if span.name in STAGING:
            assert inside(span, outer['batch_construction'])
        elif span.name == 'fetch':
            assert inside(span, outer['logging'])


@pytest.fixture
def stand_in_card(monkeypatch):
    """CUDA events on a device clock the test sets (ms), which complete
    when the test says; every synchronisation refuses."""
    class Event:
        made, clock = [], [0.0]

        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t, self.done = None, False
            Event.made.append(self)

        def record(self, stream=None):
            self.t, self.done = Event.clock[0], False

        def query(self):
            return self.done

        synchronize = refuse

        def elapsed_time(self, other):
            assert self.done and other.done
            return other.t - self.t

        @classmethod
        def finish(cls):
            for event in cls.made:
                event.done = True

    monkeypatch.setattr(torch.cuda, 'Event', Event)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device: None)
    monkeypatch.setattr(torch.cuda, 'synchronize', refuse)
    return Event


def device_window(timers, card, t0):
    """One window's regions, the device clock at ``t0`` + 0, 3, 5, 25."""
    with timers('batch_construction'):
        card.clock[0] = t0
        timers('upload').start()
        card.clock[0] = t0 + 3
        timers('upload').stop()
    card.clock[0] = t0 + 5
    timers('train_step').start()
    card.clock[0] = t0 + 25
    timers('train_step').stop()


def test_device_regions_resolve_when_done_from_a_pool(stand_in_card):
    card = stand_in_card
    timers = timer.Timers('cuda')
    assert not card.made                  # nothing recorded at the start
    device_window(timers, card, 100.0)
    timers.resolve()
    assert not timers.device_spans                # nothing completed yet
    card.finish()
    timers.resolve()
    assert list(timers.device_spans) == [
        timer.DeviceSpan('upload', 3.0), timer.DeviceSpan('train_step', 20.0)]
    for k in range(1, 50):
        device_window(timers, card, 100.0 + 30 * k)
        card.finish()
    timers.resolve()
    assert len(timers.device_spans) == 100
    # a window's two pairs, recorded again window after window
    assert len(card.made) == 4
    assert len(timers.spans) == 150


def test_log_reports_device_ms_and_counts_then_drains(stand_in_card,
                                                      capsys):
    card = stand_in_card
    timers = timer.Timers('cuda')
    device_window(timers, card, 0.0)
    with timers('logging'):
        with timers('fetch'):
            card.finish()
    timers.log(['batch_construction', 'train_step', 'logging'])
    line = capsys.readouterr().out.strip()
    parts = line.split(' | ')
    assert parts[0] == 'rank=0 time (ms)'
    assert [p.split(':')[0] for p in parts[1:4]] == \
        ['batch_construction', 'train_step', 'logging']
    assert parts[4] == 'device ms upload=3.00 train_step=20.00'
    assert parts[5] == ('spans upload=1 batch_construction=1 '
                        'train_step=1 fetch=1 logging=1')
    assert len(parts) == 6
    assert not timers.spans and not timers.device_spans
    timers.log(['logging'])
    assert capsys.readouterr().out.strip() == \
        'rank=0 time (ms) | logging: 0.00'


def test_span_cap_drops_the_oldest_and_the_line_counts_them(capsys):
    timers = timer.Timers()
    timers.max_spans = 3
    for name in ('read', 'pad', 'stack', 'upload', 'fetch'):
        with timers(name):
            pass
    assert [s.name for s in timers.spans] == ['stack', 'upload', 'fetch']
    timers.log([])
    assert capsys.readouterr().out.strip() == (
        'rank=0 time (ms) | spans stack=1 upload=1 fetch=1 | dropped 2')
    with timers('read'):
        pass
    timers.log([])
    assert capsys.readouterr().out.strip() == \
        'rank=0 time (ms) | spans read=1'


def test_samples_per_sec_follows_the_padded_batches(monkeypatch, capsys):
    clock = SimpleNamespace(ns=0)
    monkeypatch.setattr(timer, 'time',
                        SimpleNamespace(perf_counter_ns=lambda: clock.ns))
    timers = timer.Timers(batch_size=8)

    def line(pads, at_s):
        for _ in range(pads):
            with timers('pad'):
                pass
        clock.ns = int(at_s * 1e9)
        timers.log([])
        return capsys.readouterr().out.strip()

    assert 'SamplesPerSec' not in line(32, 1.0)      # no line before it
    # a step of the window staged already: nothing padded
    assert 'SamplesPerSec' not in line(0, 1.1)
    # 16 batches of 8 since the line at 1 s
    assert line(16, 1.5).endswith(' | SamplesPerSec=256.00')
    assert line(16, 2.0).endswith(' | SamplesPerSec=256.00')
    untold = timer.Timers()
    with untold('pad'):
        pass
    untold.log([])
    untold.log([])
    assert 'SamplesPerSec' not in capsys.readouterr().out


@pytest.mark.cuda
def test_device_spans_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    device = torch.device('cuda')
    timers = timer.Timers(device)
    monkeypatch.setattr(torch.cuda, 'synchronize', refuse)
    monkeypatch.setattr(torch.cuda.Event, 'synchronize', refuse)
    host = torch.ones(64 << 20, dtype=torch.uint8).pin_memory()
    a = torch.randn(2048, 2048, device=device)
    t0 = time.perf_counter_ns()
    with timers('batch_construction'):
        with timers('upload'):
            staged = host.to(device, non_blocking=True)
    with timers('train_step'):
        for _ in range(50):
            a = a @ a
            a = a / a.norm()
    # the replayed work outlasts its host region: nothing waited for it
    timers.resolve()
    assert len(timers.device_spans) < 2
    deadline = time.monotonic() + 60
    while len(timers.device_spans) < 2:
        assert time.monotonic() < deadline
        timers.resolve()
    wall_ms = (time.perf_counter_ns() - t0) / 1e6
    upload, step = timers.device_spans
    assert (upload.name, step.name) == ('upload', 'train_step')
    assert 0 < upload.ms and 0 < step.ms and upload.ms + step.ms <= wall_ms
    assert int(staged.sum()) == 64 << 20
