"""A configuration, a traffic mix and a per-layer metric added as new
files with entries in BENCHMARK.json, no file edited: the harness finds
them by name."""
import json
import shutil

import helpers


def test_new_files_are_found(tmp_path, capsys, monkeypatch):
    root = helpers.tiny_checkout(tmp_path)
    folder = root / 'portbench'
    shutil.copy(folder / 'configs' / 'evflownet.json',
                folder / 'configs' / 'evflownet_mish.json')
    config = json.loads((folder / 'configs' / 'evflownet_mish.json')
                        .read_text())
    config['flags']['--num-warmup-steps'] = 0
    (folder / 'configs' / 'evflownet_mish.json').write_text(
        json.dumps(config))
    shutil.copy(folder / 'configs' / 'evflownet.py',
                folder / 'configs' / 'evflownet_mish.py')
    traffic = json.loads((folder / 'traffic' / 'recipe_b8.json').read_text())
    traffic['events_per_element_cap'] = 1000
    (folder / 'traffic' / 'sparse_b8.json').write_text(json.dumps(traffic))
    (folder / 'metrics' / 'windows_timed.py').write_text(
        'def read(rec):\n    return len(rec.windows)\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append(dict(bench['configs'][0], name='evflownet_mish',
                                 file='portbench/configs/'
                                      'evflownet_mish.json'))
    bench['workloads'].append({'name': 'evflownet_mish.sparse_b8',
                               'config': 'evflownet_mish',
                               'traffic': 'sparse_b8', 'chips': 1,
                               'why': 'test'})
    bench['per_layer'].append({'name': 'windows_timed', 'unit': 'count',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'loop and device queue',
                               'moves': 'samples_per_s',
                               'workloads': ['evflownet_mish.sparse_b8']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    code, result, _ = helpers.run(root, 'evflownet_mish.sparse_b8', trace=1,
                                  monkeypatch=monkeypatch, capsys=capsys)
    assert code == 0 and result['correct'] is True
    assert result['metrics']['windows_timed']['value'] >= 1
