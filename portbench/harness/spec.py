"""What a run reads from the checkout: ``BENCHMARK.json`` and the files
that its names lead to.  Everything of one configuration, one traffic
mix or one per-layer metric sits in files of its own, found by name:

- ``configs/<config>.json`` (flags, sizes, limits) and
  ``configs/<config>.py`` (its plain reference, ``build(config, rnd)``);
- ``traffic/<traffic>.json`` (``traffic.py``'s parameters);
- ``metrics/<metric>.py`` (``read(records) -> number or None``).
"""
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]      # the benchmark's folder


def checkout():
    """The checkout's root: the folder that holds ``BENCHMARK.json``."""
    return ROOT.parent


def load_benchmark(root=None):
    root = checkout() if root is None else Path(root)
    return json.loads((root / 'BENCHMARK.json').read_text())


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and
    metrics, read from ``folder`` (the benchmark's folder)."""

    def __init__(self, benchmark, name, folder=ROOT):
        cells = {w['name']: w for w in benchmark['workloads']}
        if name not in cells:
            raise KeyError(f'no workload {name!r}; the benchmark has '
                           f'{sorted(cells)}')
        self.folder = Path(folder)
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload['chips'])
        configs = {c['name']: c for c in benchmark['configs']}
        entry = configs[self.workload['config']]
        self.config = json.loads((self.folder.parent / entry['file'])
                                 .read_text())
        self.config_name = entry['name']
        self.traffic = json.loads(
            (self.folder / 'traffic' / f'{self.workload["traffic"]}.json')
            .read_text())
        self.end_to_end = [m for m in benchmark['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in benchmark['per_layer']
                          if name in m.get('workloads', [name])]

    def reference(self):
        """The configuration's plain reference module."""
        path = self.folder / 'configs' / f'{self.config_name}.py'
        return _module(path, f'portbench_reference_{self.config_name}')

    def readers(self):
        """``{metric name: read}`` of the cell's per-layer metrics."""
        return {m['name']: _module(self.folder / 'metrics' / f'{m["name"]}.py',
                                   f'portbench_metric_{m["name"]}').read
                for m in self.per_layer}
