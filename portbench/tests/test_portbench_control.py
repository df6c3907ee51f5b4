"""On the card, at the cell's own size and window length: the program's
first and check windows are correct on three fresh seeds, and the
control (the reference a step below the configuration's precision) and
each fault planted in the reference in the program's place are not.
Run on the card with

    python -m pytest --noconftest -m cuda portbench/tests
"""
import pytest

import helpers  # noqa: F401
from harness import calibrate, check, spec
from harness.reference import FAULTS


@pytest.mark.cuda
def test_the_control_and_the_faults_are_not_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the control runs at the cell\'s '
                    'own size')
    benchmark = spec.load_benchmark()
    cell = spec.Cell(benchmark, 'evflownet.recipe_b8')
    limits = cell.config['correct']
    for i in range(3):
        got = calibrate.readings(cell, 4000000000 + 104729 * i,
                                 torch.device('cuda', 0), control=True,
                                 seconds=benchmark['run_seconds'])
        assert check.verdict(got['program'], limits), got['program']
        for kind in ('control', *FAULTS):
            assert not check.verdict(got[kind], limits), (kind, got[kind])
