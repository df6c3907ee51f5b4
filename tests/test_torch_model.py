"""Port parity: EVFlowNet's QuantizationLayer, Predictor and Model against
flax, plus the parameter converter and the initialisers.

The JAX side runs the Pallas kernels in interpret mode: ``kernel_mlp=
'interpret'``, and ``voxelize_pallas`` patched to interpret as in
tests/training/test_models.py::test_pallas_scatter_method_matches_default,
whose tolerance (1e-5) the voxel grid takes.  Conv outputs take
rtol 1e-4 / atol 1e-5 (flows 1e-6: the heads are initialised at 1e-3):
the two frameworks sum each convolution in another order, and the error
grows through eleven fp32 convolutions.  Parameter gradients take the
rtol 1e-3 of tests/ops/test_voxel_pallas.py::test_vjp_matches_scatter,
with atol 1e-4 times the leaf's largest gradient.
"""
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.data.schema import \
    pad_events as jax_pad_events
from dvs_of_training_framework_tpu.models import load_model_class
from dvs_of_training_framework_tpu.ops import voxel_pallas
from dvs_of_training_framework_tpu_torch.data.schema import pad_events
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.models.loader import output_axes
from dvs_of_training_framework_tpu_torch.utils.convert import (
    flax_to_torch, load_flax_params, torch_to_flax)

REPO = Path(__file__).resolve().parents[1]
DEPTH, BASE, IMSIZE, B = 4, 8, (32, 32), 2


def make_raw(seed=0, n_events=200, capacity=256):
    """One raw batch, padded for both frameworks (events sorted by
    sample, as collation leaves them)."""
    rng = np.random.default_rng(seed)
    H, W = IMSIZE
    ev = {
        'x': rng.integers(0, W, n_events),
        'y': rng.integers(0, H, n_events),
        'timestamp': rng.uniform(-0.005, 0.045, n_events).astype(np.float32),
        'polarity': rng.choice([-1.0, 1.0], n_events),
        'element_index': np.zeros(n_events, np.int64),
        'sample_index': np.sort(rng.integers(0, B, n_events)),
    }
    timestamps = np.array([0.0, 0.04, 0.0, 0.03], np.float32)
    sample_idx = np.repeat(np.arange(B), 2).astype(np.int32)
    jax_inputs = (jax_pad_events(ev, B, capacity), jnp.asarray(timestamps),
                  jnp.asarray(sample_idx))
    torch_inputs = (pad_events(ev, B, capacity).to('cpu'),
                    torch.from_numpy(timestamps),
                    torch.from_numpy(sample_idx))
    return jax_inputs, torch_inputs


@pytest.fixture(autouse=True)
def interpret_voxelize():
    orig = voxel_pallas.voxelize_pallas

    def interp(x, y, plane, w, valid, P, H, W, chunk=256, interpret=False):
        return orig(x, y, plane, w, valid, P, H, W, 32, True)

    with mock.patch.object(voxel_pallas, 'voxelize_pallas', interp):
        yield


def jax_model():
    module = load_model_class(REPO / 'EVFlowNet')
    return module.Model(event_representation_depth=DEPTH, base_channels=BASE,
                        scatter_method='pallas', kernel_mlp='interpret')


def init_pair(seed=0):
    model = jax_model()
    (events, timestamps, sample_idx), torch_inputs = make_raw(seed)
    params = model.init(jax.random.PRNGKey(seed), events, timestamps,
                        sample_idx, IMSIZE)['params']
    port = evflownet.Model(event_representation_depth=DEPTH,
                           base_channels=BASE)
    load_flax_params(port, params)
    return model, params, port


@pytest.mark.parametrize('seed,capacity', [(0, 256), (1, 64)])
def test_quantization_layer_matches_flax(seed, capacity):
    model, params, port = init_pair()
    (events, timestamps, sample_idx), torch_inputs = make_raw(
        seed, n_events=min(200, capacity), capacity=capacity)
    want = model.apply({'params': params}, events, timestamps, sample_idx,
                       IMSIZE, method=model.quantize)
    got = port.quantization_layer(*torch_inputs, IMSIZE, 1, B)
    assert got.shape == (B, DEPTH, *IMSIZE)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_predictor_matches_flax():
    model, params, port = init_pair()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, *IMSIZE, DEPTH)).astype(np.float32)
    module = load_model_class(REPO / 'EVFlowNet')
    predictor = module.Predictor(base_channels=BASE)
    flows, features = predictor.apply(
        {'params': params['predictor']}, jnp.asarray(x))
    got_flows, got_features = port.predictor(
        torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for want, got in zip(features, got_features):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-4, atol=1e-5)
    for want, got in zip(flows, got_flows):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-4, atol=1e-6)


def test_model_forward_and_gradients_match_flax():
    model, params, port = init_pair()
    (events, timestamps, sample_idx), torch_inputs = make_raw(3)
    rng = np.random.default_rng(4)
    cots = [rng.normal(size=(B, 2, IMSIZE[0] >> s, IMSIZE[1] >> s))
            .astype(np.float32) for s in (3, 2, 1, 0)]

    def objective(p):
        flows, flow_ts, flow_sample_idx, _ = model.apply(
            {'params': p}, events, timestamps, sample_idx, IMSIZE,
            intermediate=True)
        value = sum(jnp.sum(f * c) for f, c in zip(flows, cots))
        return value, (flows, flow_ts, flow_sample_idx)

    (value, (flows, flow_ts, flow_sample_idx)), grads = \
        jax.value_and_grad(objective, has_aux=True)(params)

    got_flows, got_ts, got_sidx, features = port(
        *torch_inputs, IMSIZE, intermediate=True)
    assert len(features) == 4
    for want, got in zip(flows, got_flows):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(flow_ts))
    np.testing.assert_array_equal(got_sidx.numpy(),
                                  np.asarray(flow_sample_idx))

    got_value = sum((f * torch.from_numpy(c)).sum()
                    for f, c in zip(got_flows, cots))
    got_value.backward()
    np.testing.assert_allclose(float(got_value.detach()), float(value),
                               rtol=1e-4)
    want_grads = flax_to_torch(grads)
    for name, p in port.named_parameters():
        want = want_grads[name].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


def test_converter_round_trip_is_exact():
    _, params, port = init_pair()
    back = torch_to_flax(port.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        got = flat_got[path]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        np.testing.assert_array_equal(got, np.asarray(leaf))


def test_init_matches_flax_shapes_and_scale():
    """Same tree and shapes as flax; per-leaf std within 15% of flax's
    (leaves of at least 500 values, where a sample std is stable) and
    biases exactly zero."""
    module = load_model_class(REPO / 'EVFlowNet')
    model = module.Model(event_representation_depth=9, base_channels=32)
    (events, timestamps, sample_idx), _ = make_raw(0)
    params = model.init(jax.random.PRNGKey(0), events, timestamps,
                        sample_idx, IMSIZE)['params']
    port = evflownet.Model(event_representation_depth=9, base_channels=32,
                           generator=torch.Generator().manual_seed(0))
    want = flax_to_torch(params)
    got = port.state_dict()
    assert set(got) == set(want)
    assert set(output_axes(port)) == set(want)
    for name, tensor in got.items():
        assert tensor.shape == want[name].shape, name
        if name.endswith('.bias'):
            assert not tensor.any(), name
        elif tensor.numel() >= 500:
            ratio = float(tensor.std()) / float(want[name].std())
            assert 0.85 < ratio < 1.15, (name, ratio)
