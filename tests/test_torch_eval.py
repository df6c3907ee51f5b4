"""The port's evaluation modules against the JAX package's originals.

``evaluation/flow_metrics.py`` and ``evaluation/testing.py`` are copies;
on the same seeded inputs each function gives what its original gives,
at the rtol 1e-6 of tests/ops/test_eval_metrics.py
(test_flow_error_dense_analytic, test_evaluate_batched_matches_single):

- the metric functions (masks, endpoint statistics, the constant-flow
  oracle, the nearest remap and the GT propagation);
- ``evaluate`` with one fixed stub predictor: the mean AEE, %AEE, mean
  median EE and every per-window record, with a partial final block;
- the JSON twins of the synthetic test configs equal ``yaml.safe_load``
  of the originals, and ``read_config`` and ``ravel_config`` expand them
  alike.
"""
from pathlib import Path

import numpy as np
import pytest
import yaml

import dvs_of_training_framework_tpu.evaluation.flow_metrics as jax_metrics
import dvs_of_training_framework_tpu.evaluation.testing as jax_testing
import dvs_of_training_framework_tpu_torch.evaluation.flow_metrics as \
    port_metrics
import dvs_of_training_framework_tpu_torch.evaluation.testing as port_testing

REPO = Path(__file__).resolve().parents[1]
PORT_CONFIG = REPO / 'dvs_of_training_framework_tpu_torch' / 'config'
RTOL = 1e-6


def assert_same(got, want):
    """Equal structure; numbers within RTOL, everything else equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            assert_same(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, (np.ndarray, float, np.floating)):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    else:
        assert got == want


def metric_case(seed, H=40, W=56):
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 2, (H, W, 2)).astype(np.float32)
    gt[rng.uniform(size=(H, W)) < 0.05] = 0.0
    gt[3, 4, 0] = np.inf
    pred = (gt + rng.normal(0, 1.5, (H, W, 2))).astype(np.float32)
    events = rng.poisson(0.7, (H, W)).astype(np.float64)
    return gt, pred, events


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('is_car', [False, True])
def test_metrics_match_jax(seed, is_car):
    gt, pred, events = metric_case(seed, H=260 if is_car else 40)
    for name in ('flow_error_dense', 'endpoint_error_stats'):
        for dense in (False, True):
            assert_same(getattr(port_metrics, name)(gt, pred, events, is_car,
                                                    dense),
                        getattr(jax_metrics, name)(gt, pred, events, is_car,
                                                   dense))
    got_gt, got_apply = port_metrics.masked_gt(gt, events, is_car)
    want_gt, want_apply = jax_metrics.masked_gt(gt, events, is_car)
    assert_same(got_gt, want_gt)
    assert_same(got_apply(pred), want_apply(pred))
    assert_same(port_metrics.constant_flow_oracle(gt, events, is_car),
                jax_metrics.constant_flow_oracle(gt, events, is_car))
    points = np.random.default_rng(seed).normal(size=(300, 2))
    assert_same(port_metrics.geometric_median(points),
                jax_metrics.geometric_median(points))


def test_gt_propagation_matches_jax():
    rng = np.random.default_rng(2)
    H, W = 24, 32
    src = rng.normal(size=(H, W)).astype(np.float32)
    mapx = rng.uniform(-3, W + 2, (H, W)).astype(np.float32)
    mapy = rng.uniform(-3, H + 2, (H, W)).astype(np.float32)
    assert_same(port_metrics._remap_nearest(src, mapx, mapy),
                jax_metrics._remap_nearest(src, mapx, mapy))
    gt_ts = np.arange(0.0, 2.0, 0.25)
    x_flow = rng.normal(0, 1.5, (gt_ts.size, H, W)).astype(np.float32)
    y_flow = rng.normal(0, 1.5, (gt_ts.size, H, W)).astype(np.float32)
    x_flow[:, 5, 5] = 0.0
    for start, stop in ((0.1, 0.2), (0.1, 0.9), (0.3, 1.6)):
        assert_same(port_metrics.estimate_corresponding_gt_flow(
                        x_flow, y_flow, gt_ts, start, stop),
                    jax_metrics.estimate_corresponding_gt_flow(
                        x_flow, y_flow, gt_ts, start, stop))


def stub_predictor(H, W):
    """A fixed flow for each window: a field that depends on the window's
    events and times, so that a wrong window order would show."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)

    def of(events, start, stop):
        flows = []
        for e, t0, t1 in zip(events, start, stop):
            e = np.asarray(e)
            mean = e[:2].mean(axis=1) if e.shape[1] else np.zeros(2)
            u = 0.05 * (xs - mean[0]) + 10 * (t1 - t0)
            v = 0.03 * (ys - mean[1]) - 5 * (t1 - t0)
            flows.append(np.stack([u, v], axis=-1))
        return np.stack(flows)
    return of


@pytest.mark.parametrize('batch_windows', [1, 3])
def test_evaluate_matches_jax(batch_windows):
    rng = np.random.default_rng(4)
    H, W, n = 36, 44, 3000
    events = [rng.integers(0, W, n).astype(np.float64),
              rng.integers(0, H, n).astype(np.float64),
              np.sort(rng.uniform(0, 3.0, n)),
              rng.choice([-1.0, 1.0], n)]
    frames = [(0.1 + 0.3 * i, 0.35 + 0.3 * i) for i in range(7)]
    gt = {'timestamps': np.arange(0, 4.0, 0.25),
          'x_flow_dist': rng.uniform(-2, 2, (16, H, W)).astype(np.float32),
          'y_flow_dist': rng.uniform(-2, 2, (16, H, W)).astype(np.float32)}
    results = {}
    for name, module in (('port', port_testing), ('jax', jax_testing)):
        stats = {}
        means = module.evaluate(stub_predictor(H, W), events, frames, gt,
                                batch_windows=batch_windows, stats_out=stats)
        results[name] = (means, stats)
    assert_same(results['port'], results['jax'])
    assert len(results['port'][1]['windows']) == len(frames)


@pytest.mark.parametrize('name', ['synth_testing', 'synth_val',
                                  'synth_train_datasets'])
def test_json_configs_equal_the_yaml_originals(name):
    want = yaml.safe_load((REPO / 'config' / f'{name}.yml').read_text())
    got = port_testing.read_config(PORT_CONFIG / f'{name}.json')
    assert got == want
    assert port_testing.read_config(REPO / 'config' / f'{name}.yml') == want
    for ds_config in want.values():
        for seq_config in ds_config.values():
            if 'step' in seq_config:
                assert [vars(c) for c in port_testing.ravel_config(
                    seq_config)] == [vars(c) for c in jax_testing.
                                     ravel_config(seq_config)]
