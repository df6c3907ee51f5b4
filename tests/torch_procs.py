"""Run a group of processes of the port under one wall-clock limit.

Every process starts in a session of its own with its output in a file;
when one fails, or the group outlives its limit, every process of every
session (a ``--mesh`` run's spawned workers too) is killed and the test
fails with the outputs.  A rank that dies leaves the others waiting in a
collective, so no group may be left to the test runner's own limit.
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def env(**extra):
    """The environment of a child: the repo importable, one torch thread
    (the test workers share the cores)."""
    out = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
    out.update(extra)
    return out


def run_group(commands, log_dir, timeout, environ=None, cwd=REPO):
    """Run ``commands`` (argument lists) together; returns their outputs
    once all have exited 0.  Raises AssertionError with the outputs when
    one fails or ``timeout`` seconds pass first."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    logs = [log_dir / f'proc{i}.log' for i in range(len(commands))]
    procs = []
    for cmd, log in zip(commands, logs):
        with open(log, 'w') as out:
            procs.append(subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT, cwd=cwd,
                env=environ or env(), start_new_session=True))
    deadline = time.monotonic() + timeout
    failure = None
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                failure = 'a process failed'
                break
            if time.monotonic() > deadline:
                failure = f'the group outlived its {timeout} s'
                break
            time.sleep(0.1)
        else:
            if any(p.returncode for p in procs):
                failure = 'a process failed'
    finally:
        for p in procs:
            if p.poll() is None or failure:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        for p in procs:
            p.wait()
    outputs = [log.read_text() for log in logs]
    if failure:
        raise AssertionError(failure + ':\n' + '\n'.join(
            f'--- process {i} (exit {p.returncode}):\n{out[-6000:]}'
            for i, (p, out) in enumerate(zip(procs, outputs))))
    return outputs


def python(*args):
    return [sys.executable, *map(str, args)]
