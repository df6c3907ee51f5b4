"""Port parity: the multi-scale loss against the JAX package's goldens and
its gradients.

Loss values take the 5e-6 of tests/loss/test_loss.py:62-77
(GOLDEN_ZERO_FLOW, GOLDEN_PRED_FLOW, on the repository's fixtures) and
the 5e-5 per scale of test_loss.py::test_multi_scale_matching.  Flow
gradients against ``jax.grad`` take rtol 1e-4 / atol 1e-7: the smoothness
and out-of-border gradients are exact formulas, the photometric one goes
through bilinear weights that the two frameworks round differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.losses import (
    MultiScaleLoss as JaxMultiScaleLoss, combined_loss as jax_combined_loss)
from dvs_of_training_framework_tpu_torch.losses import (
    MultiScaleLoss, combined_loss, match_predictions_to_images)
from tests.loss.test_loss import (GOLDEN_PRED_FLOW, GOLDEN_ZERO_FLOW,
                                  _fixture_case)


def _evaluate(images, timestamps, flow):
    """One-sample single-scale evaluation, as test_loss._evaluate."""
    H, W = images.shape[-2:]
    evaluator = MultiScaleLoss([(H, W)])
    ts = torch.as_tensor(timestamps, dtype=torch.float32)
    terms = evaluator([torch.from_numpy(flow)], ts.reshape(1, 2),
                      torch.zeros(1, dtype=torch.int32),
                      torch.from_numpy(images), ts,
                      torch.zeros(2, dtype=torch.int32))
    return [float(term[0]) for term in terms]


def test_no_changes():
    images = np.zeros((2, 1, 5, 6), np.float32)
    flow = np.zeros((1, 2, 5, 6), np.float32)
    got = _evaluate(images, np.array([0, 0.4]), flow)
    for value, gt in zip(got, [0.002, 0.002, 0]):
        assert abs(value - gt) < 5e-6


@pytest.mark.parametrize('read_pred,golden', [(False, GOLDEN_ZERO_FLOW),
                                              (True, GOLDEN_PRED_FLOW)])
def test_fixture_goldens(read_pred, golden):
    images, timestamps, flow = _fixture_case(read_pred=read_pred)
    got = _evaluate(images, timestamps, flow)
    for i, (value, gt) in enumerate(zip(got, golden)):
        assert abs(value - gt) < 5e-6, f'[{i}] {value} vs {gt}'


def _multi_scale_case():
    rng = np.random.default_rng(11)
    H, W = 32, 48
    images = rng.uniform(0, 255, size=(4, 1, H, W)).astype(np.float32)
    timestamps = np.array([0.0, 0.05, 0.0, 0.04], np.float32)
    sample_idx = np.array([0, 0, 1, 1], np.int32)
    flow_ts = np.array([[0.0, 0.05], [0.0, 0.04]], np.float32)
    flow_sample_idx = np.array([0, 1], np.int32)
    # large flows push part of the grid out of the border
    flows = [rng.normal(scale=4.0, size=(2, 2, H // 4, W // 4))
             .astype(np.float32),
             rng.normal(scale=4.0, size=(2, 2, H // 2, W // 2))
             .astype(np.float32),
             rng.normal(scale=4.0, size=(2, 2, H, W)).astype(np.float32)]
    shapes = [f.shape[-2:] for f in flows]
    return (flows, flow_ts, flow_sample_idx, images, timestamps,
            sample_idx), shapes


def test_match_predictions_to_images():
    (_, flow_ts, flow_sample_idx, _, timestamps, sample_idx), _ = \
        _multi_scale_case()
    start, stop = match_predictions_to_images(
        *(torch.from_numpy(a) for a in (flow_ts, flow_sample_idx,
                                        timestamps, sample_idx)))
    assert start.tolist() == [0, 2] and stop.tolist() == [1, 3]


def test_multi_scale_loss_and_flow_grads_match_jax():
    case, shapes = _multi_scale_case()
    flows, *rest = case

    def jax_loss(fl):
        loss, terms = jax_combined_loss(JaxMultiScaleLoss(shapes), fl,
                                        *(jnp.asarray(a) for a in rest))
        return loss, terms

    (want_loss, want_terms), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)([jnp.asarray(f) for f in flows])

    flows_t = [torch.from_numpy(f).requires_grad_(True) for f in flows]
    loss, terms = combined_loss(MultiScaleLoss(shapes), flows_t,
                                *(torch.from_numpy(a) for a in rest))
    loss.backward()
    assert terms[2][2].item() > 0     # the out-of-border term is live
    for term_got, term_want in zip(terms, want_terms):
        for scale_got, scale_want in zip(term_got, term_want):
            assert abs(scale_got.item() - float(scale_want)) < 5e-5
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for f, want in zip(flows_t, want_grads):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-7)
