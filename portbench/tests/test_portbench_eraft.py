"""The E-RAFT cell on the CPU: its configuration, traffic and metrics are
found by name, the port's ``ERAFT`` plugin runs through the unmodified
``Program`` and loop, and the plain reference agrees with it in float32.
``helpers.tiny_checkout`` cuts every configuration to 32x32, under which
E-RAFT's fourth correlation level would be empty: the cell runs here at
64x64."""
import json

import pytest

import helpers


@pytest.mark.parametrize('trace', [0, 1])
def test_eraft_cell_runs_and_is_correct(tmp_path, capsys, monkeypatch,
                                        trace):
    root = helpers.tiny_checkout(tmp_path)
    path = root / 'portbench' / 'configs' / 'eraft.json'
    config = json.loads(path.read_text())
    config['flags'].update({'--height': 64, '--width': 64})
    path.write_text(json.dumps(config))
    code, result, err = helpers.run(root, 'eraft.pair_b8', trace=trace,
                                    monkeypatch=monkeypatch, capsys=capsys)
    assert code == 0, err[-2000:]
    assert result['correct'] is True, err[-2000:]
    assert result['attempted'] > 0 and result['failed'] == 0
    if trace:
        # no device op runs on the CPU: the device readers say nothing
        assert set(result['metrics']) <= {'eraft_mfu', 'lookup_fwd_roofline',
                                          'lookup_bwd_roofline',
                                          'eraft_conv_ms_a_step'}
    else:
        assert set(result['metrics']) == {'samples_per_s', 'window_ms_p90',
                                          'peak_mem_gib', 'setup_s'}
