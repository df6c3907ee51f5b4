"""The plain reference against the port's plain path at a tiny size on
the CPU: the first and the check window's losses, the parameters' change
and the first moment agree to float32 rounding."""
import torch

import helpers
from harness import check, cli, spec


def test_reference_agrees_with_the_port_in_fp32(tmp_path):
    root = helpers.tiny_checkout(tmp_path)
    cell = spec.Cell(spec.load_benchmark(root), 'evflownet.recipe_b8',
                     root / spec.ROOT.name)
    device = torch.device('cpu')
    kept, records = cli.measure(cell, 2 ** 31 + 3, 0.0, False, device)
    window = records['program'].window
    values = cli.compare(cell, kept, records['pool'], device, window)
    assert kept['check_start']['step'] > window
    assert kept['check_start']['count'] == kept['check_start']['step']
    assert set(check.NAMES) <= set(values)
    for prefix in ('', 'late_'):
        assert values[prefix + 'loss_gap'] < 1e-5
        assert values[prefix + 'change_gap'] < 1e-4
        assert values[prefix + 'moment_gap'] < 1e-4
