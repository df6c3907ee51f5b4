"""Port parity: the K2 twin (``kernel_mlp_cuda.plain``) against the JAX
package's ``kernel_mlp_pallas`` in interpret mode.

Tolerances are those of tests/ops/test_kernel_mlp.py: forward 2e-6
(test_forward_matches_reference), the seven gradients 1e-5 * scale with
scale = max(1, max|grad|) (:72-73, test_gradients_match_reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.ops.kernel_mlp_pallas import \
    kernel_mlp_pallas
from dvs_of_training_framework_tpu_torch.ops import kernel_mlp_cuda

NAMES = ['delta', 'w1', 'b1', 'w2', 'b2', 'w3', 'b3']


def make_args(seed, shape, hd=30):
    rng = np.random.default_rng(seed)
    delta = rng.uniform(-1.2, 1.2, size=shape).astype(np.float32)
    w1 = rng.normal(size=(1, hd)).astype(np.float32)
    b1 = rng.normal(size=(hd,)).astype(np.float32) * 0.1
    w2 = (rng.normal(size=(hd, hd)) / np.sqrt(hd)).astype(np.float32)
    b2 = rng.normal(size=(hd,)).astype(np.float32) * 0.1
    w3 = (rng.normal(size=(hd, 1)) / np.sqrt(hd)).astype(np.float32)
    b3 = rng.normal(size=(1,)).astype(np.float32) * 0.1
    return delta, w1, b1, w2, b2, w3, b3


@pytest.mark.parametrize('shape', [(7,), (9, 455), (5000,)])
def test_twin_forward_matches_pallas(shape):
    args = make_args(0, shape)
    want = kernel_mlp_pallas(*(jnp.asarray(a) for a in args), 512, True)
    got = kernel_mlp_cuda.plain(*(torch.from_numpy(a) for a in args))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize('hd', [30, 17])
def test_twin_gradients_match_pallas(hd):
    args = make_args(2, (9, 333), hd)
    cot = np.random.default_rng(3).normal(size=(9, 333)).astype(np.float32)

    def loss_pallas(*a):
        return jnp.sum(kernel_mlp_pallas(*a, 512, True) * cot)

    want = jax.grad(loss_pallas, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in args))
    tensors = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (kernel_mlp_cuda.plain(*tensors) * torch.from_numpy(cot)).sum() \
        .backward()
    for name, t, gw in zip(NAMES, tensors, want):
        gw = np.asarray(gw)
        scale = max(1.0, float(np.abs(gw).max()))
        assert t.grad.shape == gw.shape, name
        np.testing.assert_allclose(t.grad.numpy(), gw, rtol=1e-5,
                                   atol=1e-5 * scale,
                                   err_msg=f'grad mismatch: {name}')


def test_wrapper_routes_cpu_tensors_to_twin():
    args = [torch.from_numpy(a) for a in make_args(1, (9, 64))]
    before = dict(kernel_mlp_cuda.launches)
    got = kernel_mlp_cuda.kernel_mlp(*args)
    assert torch.equal(got, kernel_mlp_cuda.plain(*args))
    assert kernel_mlp_cuda.launches == before
