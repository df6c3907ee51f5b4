"""A whole run on the CPU at a tiny size, the look for a chip skipped:
the result line's exact keys, and the compared numbers last on stderr."""
import helpers
from harness import check


def test_result_line_keys(tmp_path, capsys, monkeypatch):
    root = helpers.tiny_checkout(tmp_path)
    code, result, err = helpers.run(root, 'evflownet.recipe_b8',
                                    monkeypatch=monkeypatch, capsys=capsys,
                                    seconds=0.5)
    assert code == 0
    assert list(result) == ['correct', 'attempted', 'failed', 'metrics',
                            'device', 'compared']
    assert result['correct'] is True
    assert set(result['metrics']) == {'samples_per_s', 'window_ms_p90',
                                      'peak_mem_gib', 'setup_s'}
    assert set(result['device']) == {'platform', 'kind', 'count',
                                     'memory_peak_bytes'}
    assert list(result['compared']) == list(check.NAMES)
    last = err.strip().splitlines()[-len(check.NAMES):]
    assert [line.split()[0] for line in last] == list(result['compared'])
    assert all(' limit ' in line for line in last)


def test_traced_result_line_keys(tmp_path, capsys, monkeypatch):
    root = helpers.tiny_checkout(tmp_path)
    code, result, _ = helpers.run(root, 'evflownet.recipe_b8', trace=1,
                                  monkeypatch=monkeypatch, capsys=capsys)
    assert code == 0
    assert list(result) == ['correct', 'attempted', 'failed', 'metrics',
                            'device', 'breakdown', 'compared']
    assert {'busy_s', 'window_s'} <= set(result['device'])
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    # the host spans' readers read on any device; the trace's find no
    # device op on the CPU and stay silent
    assert {'stage_ms_a_window', 'wait_ms_a_window'} \
        <= set(result['metrics'])
    assert 'mfu' not in result['metrics']
