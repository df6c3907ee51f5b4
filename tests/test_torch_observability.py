"""The port's timers, profiler, device monitor, logger and iterable
timing (``utils/{timer,profiling,monitor,logging,performance}.py``)
against the JAX package's originals, and the training CLI with
``--timers --profiling JAX`` on the CPU: it prints the region lines of
the JAX loop (``training/train.py:261-263``), followed by the port's
span counts, and writes a trace.
"""
import json
import logging
import re
import sys
import time

import pytest
import torch

from dvs_of_training_framework_tpu.utils import logging as jax_logging
from dvs_of_training_framework_tpu.utils import performance as \
    jax_performance
from dvs_of_training_framework_tpu.utils import profiling as jax_profiling
from dvs_of_training_framework_tpu.utils import timer as jax_timer
from dvs_of_training_framework_tpu_torch import train as cli
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from dvs_of_training_framework_tpu_torch.utils import (logging as
                                                       port_logging)
from dvs_of_training_framework_tpu_torch.utils import monitor, performance
from dvs_of_training_framework_tpu_torch.utils import profiling, timer
from dvs_of_training_framework_tpu_torch.utils.tb import read_events
from tests.helpers import data_path

REGION = re.compile(r'^rank=0 time \(ms\)( \| [a-z_]+: \d+\.\d\d)+'
                    r'( \| device ms( [a-z_]+=\d+\.\d\d)+)?'
                    r'( \| spans( [a-z_]+=\d+)+)?( \| dropped \d+)?'
                    r'( \| SamplesPerSec=\d+\.\d\d)?$')


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_main_prints_timer_lines_and_writes_a_trace(tmp_path, monkeypatch,
                                                     capsys,
                                                     one_torch_thread):
    mvsec = tmp_path / 'mvsec'
    mvsec.mkdir()
    for split in ('outdoor_day1', 'outdoor_day2'):
        (mvsec / split).symlink_to(data_path)
    monkeypatch.setenv('DVS_DATA_PATH', str(mvsec))
    run = tmp_path / 'run'
    cli.main(['-m', str(run), '-d', 'cpu', '-bs', '2', '-mbs', '2', '-ne',
              '2', '--num_workers', '0', '--height', '64', '--width', '64',
              '--flownet_path', 'DummyFlowNet', '--checkpointing_interval',
              '1', '-vp', '2', '--event-capacity', '16384', '--timers',
              '--profiling', 'JAX'])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith('rank=')]
    assert len(lines) == 2 and all(REGION.match(line) for line in lines)
    names = [re.findall(r'\| ([a-z_]+):', line) for line in lines]
    # the JAX loop's regions: batch construction, step, logging, hooks
    assert names[0] == ['batch_construction', 'train_step', 'logging',
                        'serialization', 'validation']
    # each step's span counts (the CPU has no device regions): two windows
    # of 16 (the default) staged before the first step, then each step
    # one train step and one blocking fetch before its hooks
    counts = [dict(re.findall(r'([a-z_]+)=(\d+)', line.split(' | spans ')[1]))
              for line in lines]
    assert [tuple(c.get(k) for k in ('read', 'pad', 'stack', 'upload',
                                     'train_step', 'fetch'))
            for c in counts] == [('32', '32', '2', '2', '1', '1'),
                                 (None, None, None, None, '1', '1')]
    assert 'device ms' not in lines[0]
    # samples/s only on a line after a line that padded batches
    assert not any('SamplesPerSec' in line for line in lines)
    assert Serializer(run).list_known_steps() == [0, 1, 2]
    (trace,) = (run / 'profiling').glob('trace.*.json')
    events = json.loads(trace.read_text())['traceEvents']
    assert any(e.get('name', '').startswith('aten::') for e in events)
    # rank 0's monitor keeps a log of its own beside the logger's
    assert len(list((run / 'log').glob('*.monitor'))) == 1


@pytest.mark.parametrize('module', [jax_timer, timer])
def test_region_timer_line_matches_jax(module, capsys):
    timers = timer.Timers() if module is timer \
        else module.SynchronizedWallClockTimer()
    for name in ('batch_construction', 'train_step'):
        with timers(name):
            time.sleep(0.002)
    timers('train_step').start()          # a running region is read live
    timers.log(['batch_construction', 'train_step', 'absent'],
               normalizer=2.0)
    line = capsys.readouterr().out.strip()
    assert REGION.match(line), line
    assert [n for n in re.findall(r'\| ([a-z_]+):', line)] == \
        ['batch_construction', 'train_step']
    if module is timer:
        assert line.endswith(' | spans batch_construction=1 train_step=1')
    ms = [float(v) for v in re.findall(r': (\d+\.\d\d)', line)]
    assert ms[0] >= 1.0                   # 2 ms over the normalizer 2
    timers('train_step').stop()
    assert timers('batch_construction').elapsed() == 0.0   # reset by log
    with pytest.raises(AssertionError, match='not started'):
        timers('train_step').stop()


@pytest.mark.parametrize('module', [jax_timer, timer])
def test_fake_timer_matches_jax(module, capsys):
    fake = module.FakeTimer()
    with fake('x'):
        fake('x').start()
    fake.log(['x'], memory_breakdown=True)
    assert fake('x').elapsed() == 0 and fake.memory_usage() == ''
    assert capsys.readouterr().out == ''
    assert module.get_rank() == 0


def test_host_memory_matches_psutil():
    psutil = pytest.importorskip('psutil')
    vm, swap = timer.host_memory_percent()
    assert vm == pytest.approx(psutil.virtual_memory().percent, abs=5)
    assert swap == pytest.approx(psutil.swap_memory().percent, abs=5)


def test_device_monitor_writes_scalars(tmp_path):
    with monitor.DeviceMonitor(tmp_path, period=0.05,
                               device=torch.device('cpu')):
        time.sleep(0.4)
    (path,) = tmp_path.glob('events.out.tfevents.*.monitor')
    scalars = {}
    for event in read_events(path):
        for tag, value in event['scalars'].items():
            scalars.setdefault(tag, []).append(value)
    assert set(scalars) == {'Monitoring/host/vm percent',
                            'Monitoring/host/cpu percent'}
    assert len(scalars['Monitoring/host/vm percent']) >= 2
    assert all(0 <= v <= 100 for values in scalars.values() for v in values)


@pytest.mark.parametrize('kind', ['JAX', 'CPU', 'None', 'Bogus'])
def test_profiler_choices(tmp_path, kind):
    if kind == 'Bogus':
        for module in (jax_profiling, profiling):
            with pytest.raises(AssertionError, match='Unknown profiler'):
                module.Profiler(kind, tmp_path)
        return
    with profiling.Profiler(kind, tmp_path / 'trace') as prof:
        torch.ones(3).add(1)
    written = list((tmp_path / 'trace').glob('trace.*.json'))
    if kind == 'None':
        assert not written
        return
    assert written == [prof.trace_path]
    names = {e.get('name') for e in
             json.loads(written[0].read_text())['traceEvents']}
    assert 'aten::add' in names


@pytest.mark.parametrize('module', [jax_performance, performance])
def test_get_iterable_performance_matches_jax(module):
    assert module.get_iterable_performance(range(100), start=5,
                                           num_iters=20) > 0
    with pytest.raises(AssertionError, match='exhausted'):
        module.get_iterable_performance(range(10), start=5, num_iters=20)
    with pytest.raises(AssertionError):
        module.get_iterable_performance(range(10), start=0, num_iters=0)


def test_create_logger_matches_jax():
    made = {}
    for name, module in (('jax', jax_logging), ('port', port_logging)):
        with pytest.raises(ValueError):
            module.create_logger(None)
        logger = module.create_logger(f'observability-{name}',
                                      level=logging.DEBUG)
        assert module.create_logger(f'observability-{name}') is logger
        (handler,) = logger.handlers
        made[name] = (logger.level, logger.propagate, handler.level,
                      handler.stream is sys.stdout,
                      handler.formatter._fmt)
    assert made['port'] == made['jax']
    assert port_logging.logger.name == jax_logging.logger.name
