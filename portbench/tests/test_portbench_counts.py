"""The benchmark's work counts against hand counts at small shapes."""
import pytest
import torch.nn as nn

import helpers  # noqa: F401  (puts the benchmark on the path)
from harness import flops, peaks
from harness.reference.layers import Conv


def test_bound_takes_the_slowest_unit_at_the_published_peaks():
    assert peaks.bound(nbytes=3.35e12) == pytest.approx(1.0)
    assert peaks.bound(flops=67e12) == pytest.approx(1.0)
    assert peaks.bound(mma_flops=495e12 / 3) == pytest.approx(1.0)
    assert peaks.bound(sfu_ops=67e12 / 16) == pytest.approx(1.0)
    assert peaks.bound(nbytes=3.35e12, flops=2 * 67e12) \
        == pytest.approx(2.0)


def test_k1_bytes():
    # 10 rows (4 valid) into 2 planes of 2x3 cells, depth 2, bf16 weights
    work = peaks.k1_work(capacity=10, n_valid=4, n_cells=3, planes=2,
                         height=2, width=3, depth=2, weight_bytes=2)
    assert work['fwd']['nbytes'] == 13 * 10 + 2 * 4 * 2 + 4 * 2 * 2 * 3 * 2
    assert work['fwd']['flops'] == 4 * 2
    assert work['bwd']['nbytes'] == 13 * 10 + 4 * 3 * 2 + 2 * 10 * 2


def test_k2_counts():
    work = peaks.k2_work(points=10, hd=3)
    assert work['fwd'] == dict(flops=10 * 16, mma_flops=10 * 18,
                               sfu_ops=10 * 6, nbytes=80)
    assert work['bwd'] == dict(flops=10 * 56, mma_flops=3 * 10 * 18,
                               sfu_ops=10 * 6, nbytes=120)


def test_k3_bytes():
    work = peaks.k3_work(frames=2, height=4, width=5)
    points = 2 * 4 * 5
    assert work['fwd']['nbytes'] == 4 * points + 12 * points
    assert work['bwd']['nbytes'] == 4 * points + 20 * points


class _TwoConvs(nn.Module):

    def __init__(self):
        super().__init__()
        self.a = Conv(3, 5, 3, stride=2)
        self.b = Conv(5, 2, 1)

    def dense(self, x):
        return self.b(self.a(x))


def test_conv_flops_by_hand():
    # a: 3 -> 5, 3x3, stride 2 on 8x8 -> 4x4; b: 5 -> 2, 1x1 on 4x4
    want = 2 * 3 * 9 * 5 * 4 * 4 * 2 + 2 * 5 * 1 * 2 * 4 * 4 * 2
    assert flops.conv_flops(_TwoConvs(), 2, 3, (8, 8)) == want


def test_mlp_and_step_flops_by_hand():
    assert flops.mlp_flops(7, 3) == 2 * 7 * (3 + 9 + 3)
    assert flops.step_flops(100, 7, 3) == 3 * (100 + 210)


def test_evflownet_forward_flops_by_hand():
    from harness import spec
    cell = spec.Cell(spec.load_benchmark(), 'evflownet.recipe_b8')
    model = cell.reference().build(cell.config, lambda x: x)
    b, s = 64, 16                         # base 64 at 16x16, batch 1
    convs = [(9, b, 3, 8), (b, 2 * b, 3, 4), (2 * b, 4 * b, 3, 2),
             (4 * b, 8 * b, 3, 1)] + [(8 * b, 8 * b, 3, 1)] * 4 \
        + [(8 * b + 4 * b, 4 * b, 3, 2), (4 * b, 2, 1, 2),
           (4 * b + 2 * b + 2, 2 * b, 3, 4), (2 * b, 2, 1, 4),
           (2 * b + b + 2, b, 3, 8), (b, 2, 1, 8),
           (b + 2, b // 2, 3, 16), (b // 2, 2, 1, 16)]
    want = sum(2 * cin * k * k * cout * hw * hw
               for cin, cout, k, hw in convs)
    assert flops.conv_flops(model, 1, 9, (s, s)) == want
