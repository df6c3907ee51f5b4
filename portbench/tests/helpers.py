"""Tiny cells for the CPU tests, in a checkout of their own."""
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for path in (str(HERE), str(HERE.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY = {'--height': 32, '--width': 32, '-bs': 2, '-mbs': 2,
        '--device-queue-window': 2, '--event-capacity': 8192,
        '--precision': 'float32'}


def tiny_checkout(tmp_path, precision='float32'):
    """A checkout holding ``BENCHMARK.json`` and a copy of the benchmark's
    folder in which every configuration is cut to a CPU's size (fp32
    unless ``precision``): 32x32, batch 2, windows of 2, and every
    traffic to 2048 events an element."""
    root = Path(tmp_path) / 'checkout'
    folder = root / HERE.name
    shutil.copytree(HERE, folder, ignore=shutil.ignore_patterns(
        '__pycache__', 'tests'))
    shutil.copy(HERE.parent / 'BENCHMARK.json', root / 'BENCHMARK.json')
    for path in (folder / 'configs').glob('*.json'):
        config = json.loads(path.read_text())
        config['flags'].update(TINY, **{'--precision': precision})
        path.write_text(json.dumps(config))
    for path in (folder / 'traffic').glob('*.json'):
        traffic = json.loads(path.read_text())
        traffic['events_per_element_cap'] = 2048
        traffic['pool_windows'] = 2
        path.write_text(json.dumps(traffic))
    return root


def run(root, workload, monkeypatch, capsys, seed=5, seconds=0.01,
        trace=0):
    """``harness.cli.main`` on the CPU in ``root``: ``(exit code, the last
    stdout line as JSON or None, stderr)``.  The repository's root
    conftest has loaded JAX into this process, so the run's look for it
    is off here; ``test_portbench_no_jax.py`` holds the harness to it."""
    import torch

    from harness import cli
    monkeypatch.setattr(cli, 'forbidden_modules', lambda: [])
    code = cli.main(['--workload', workload, '--seed', str(seed),
                     '--seconds', str(seconds), '--trace', str(trace)],
                    device=torch.device('cpu'), root=root)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else None), err
