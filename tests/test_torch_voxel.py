"""Port parity: the K1 twin (``voxelize_scatter``) against the JAX
package's ``voxelize_scatter`` and ``voxelize_pallas`` (interpret mode).

Tolerances are those of tests/ops/test_voxel_pallas.py: forward 1e-5
(:36, test_forward_matches_scatter), weight gradients 1e-3 (:68,
test_vjp_matches_scatter), and for bf16 weights a forward at 1e-5 with a
bf16 weight gradient at 1e-2 (test_bf16_weights_single_pass).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.ops.voxel import \
    voxelize_scatter as jax_scatter
from dvs_of_training_framework_tpu.ops.voxel_pallas import voxelize_pallas
from dvs_of_training_framework_tpu_torch.ops import voxel_cuda
from dvs_of_training_framework_tpu_torch.ops.voxel import voxelize_scatter


def make_case(seed=0, E=700, P=4, H=16, W=24, C=5, capacity=768):
    """Plane-major sorted events with tail padding (the collation
    invariant the Pallas kernel needs)."""
    rng = np.random.default_rng(seed)
    plane = np.sort(rng.integers(0, P, E)).astype(np.int32)
    x = rng.integers(0, W, E).astype(np.int32)
    y = rng.integers(0, H, E).astype(np.int32)
    weights = rng.normal(size=(E, C)).astype(np.float32)
    pad = capacity - E
    plane = np.concatenate([plane, np.full(pad, P - 1, np.int32)])
    x = np.concatenate([x, np.zeros(pad, np.int32)])
    y = np.concatenate([y, np.zeros(pad, np.int32)])
    # padding rows carry non-zero weights: the mask, not the values,
    # must drop them
    weights = np.concatenate([weights, rng.normal(size=(pad, C))
                              .astype(np.float32)])
    valid = np.arange(capacity) < E
    return x, y, plane, weights, valid, P, H, W


def _torch(case):
    x, y, plane, weights, valid = (torch.from_numpy(a) for a in case[:5])
    return (x, y, plane, weights.requires_grad_(True), valid) + case[5:]


def _jax_reference(case, method):
    x, y, plane, weights, valid, P, H, W = case
    x, y, plane, valid = (jnp.asarray(a) for a in (x, y, plane, valid))

    def f(w):
        if method == 'pallas':
            return voxelize_pallas(x, y, plane, w, valid, P, H, W, 32, True)
        return jax_scatter(x, y, plane, w, valid,
                           num_planes=P, height=H, width=W)

    grid, vjp = jax.vjp(f, jnp.asarray(weights))
    (dw,) = vjp(2.0 * grid)                      # d/dw of sum(grid ** 2)
    return np.asarray(grid), np.asarray(dw)


@pytest.mark.parametrize('method', ['scatter', 'pallas'])
@pytest.mark.parametrize('seed', [0, 5])
def test_twin_matches_jax(method, seed):
    case = make_case(seed=seed)
    want_grid, want_dw = _jax_reference(case, method)
    x, y, plane, w, valid, P, H, W = _torch(case)
    grid = voxelize_scatter(x, y, plane, w, valid, P, H, W)
    np.testing.assert_allclose(grid.detach().numpy(), want_grid,
                               rtol=1e-5, atol=1e-5)
    (grid ** 2).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), want_dw, rtol=1e-3,
                               atol=1e-3)
    assert np.abs(w.grad.numpy()[700:]).max() == 0.0


@pytest.mark.parametrize('seed', [9, 10])
def test_twin_bf16_weights_match_jax(seed):
    """The bf16 recipe feeds bf16 weights: the grid stays float32 and the
    weights' gradient comes back in bf16, as the JAX kernel returns it."""
    x, y, plane, weights, valid, P, H, W = make_case(seed=seed)
    w16 = jnp.asarray(weights).astype(jnp.bfloat16)
    args = tuple(jnp.asarray(a) for a in (x, y, plane))

    def f(w):
        return voxelize_pallas(*args, w, jnp.asarray(valid), P, H, W, 32,
                               True)

    want_grid, vjp = jax.vjp(f, w16)
    (want_dw,) = vjp(2.0 * want_grid)
    assert want_dw.dtype == jnp.bfloat16

    tw = torch.tensor(np.asarray(w16.astype(jnp.float32))) \
        .bfloat16().requires_grad_(True)
    grid = voxel_cuda.voxelize(*(torch.from_numpy(a) for a in (x, y, plane)),
                               tw, torch.from_numpy(valid), P, H, W)
    assert grid.dtype == torch.float32
    np.testing.assert_allclose(grid.detach().numpy(), np.asarray(want_grid),
                               rtol=1e-5, atol=1e-5)
    (grid ** 2).sum().backward()
    assert tw.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tw.grad.float().numpy(),
                               np.asarray(want_dw.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_twin_unsorted_events_match_jax_scatter():
    """The twin, like the CUDA kernel, needs no plane-sorted events."""
    x, y, plane, weights, valid, P, H, W = make_case(seed=3)
    perm = np.random.default_rng(4).permutation(len(x))
    case = (x[perm], y[perm], plane[perm], weights[perm], valid[perm],
            P, H, W)
    want_grid, want_dw = _jax_reference(case, 'scatter')
    x, y, plane, w, valid, P, H, W = _torch(case)
    grid = voxelize_scatter(x, y, plane, w, valid, P, H, W)
    np.testing.assert_allclose(grid.detach().numpy(), want_grid,
                               rtol=1e-5, atol=1e-5)
    (grid ** 2).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), want_dw, rtol=1e-3,
                               atol=1e-3)


def test_wrapper_routes_cpu_tensors_to_twin():
    case = _torch(make_case(seed=1))
    before = dict(voxel_cuda.launches)
    got = voxel_cuda.voxelize(*case)
    want = voxelize_scatter(*case)
    assert torch.equal(got, want)
    assert voxel_cuda.launches == before
