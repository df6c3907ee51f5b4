"""Port parity: the K1 twin (``voxelize_scatter``) against the JAX
package's ``voxelize_scatter`` and ``voxelize_pallas`` (interpret mode).

Tolerances are those of tests/ops/test_voxel_pallas.py: forward 1e-5
(:36, test_forward_matches_scatter), weight gradients 1e-3 (:68,
test_vjp_matches_scatter), and for bf16 weights a forward at 1e-5 with a
bf16 weight gradient at 1e-2 (test_bf16_weights_single_pass).

The twin adds each bin's contributions in ascending event order, bit for
bit as a Python loop does, and the card's K1 is held to that order: on a
card (tests marked ``cuda``) its grid repeats exactly and equals the
twin's on the CPU.  The card's machine has no JAX, so the JAX imports are
optional there; run the card's tests with ``python -m pytest --noconftest
-m cuda tests/test_torch_voxel.py``.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from dvs_of_training_framework_tpu.ops.voxel import \
        voxelize_scatter as jax_scatter
    from dvs_of_training_framework_tpu.ops.voxel_pallas import \
        voxelize_pallas
except ModuleNotFoundError:     # a card's machine: the cuda tests only
    jax = None
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


def crowded_case(seed, E=600, P=2, H=3, W=4, C=5):
    """Many events in a few cells (up to ~100 a cell), rows in no order,
    a tenth of them invalid, weights over six decades so that the order
    of the adds shows in the bits."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, W, E).astype(np.int32)
    y = rng.integers(0, H, E).astype(np.int32)
    plane = rng.integers(0, P, E).astype(np.int32)
    weights = (rng.normal(size=(E, C))
               * 10.0 ** rng.integers(-3, 3, (E, 1))).astype(np.float32)
    valid = rng.uniform(size=E) > 0.1
    return x, y, plane, weights, valid, P, H, W


def event_order_sum(x, y, plane, weights, valid, P, H, W):
    """The grid as a float32 loop over the events in ascending order."""
    grid = np.zeros((P, H, W, weights.shape[1]), np.float32)
    for e in np.flatnonzero(valid):
        grid[plane[e], y[e], x[e]] += weights[e]
    return grid


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('seed', [0, 1])
def test_twin_adds_in_event_order(seed, dtype):
    x, y, plane, weights, valid, P, H, W = crowded_case(seed)
    w = torch.from_numpy(weights).to(dtype)
    want = event_order_sum(x, y, plane, w.float().numpy(), valid, P, H, W)
    got = voxelize_scatter(*(torch.from_numpy(a) for a in (x, y, plane)), w,
                           torch.from_numpy(valid), P, H, W)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # the order matters at these magnitudes: the reverse order differs
    rev = slice(None, None, -1)
    backwards = event_order_sum(x[rev], y[rev], plane[rev],
                                w.float().numpy()[rev], valid[rev], P, H, W)
    assert not np.array_equal(backwards, want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_repeats_and_equals_the_cpu_twin(cuda, dtype):
    """Crowded cells (the kernel's list of hot cells) and sparse ones:
    20 launches give the same grid, bit for bit the twin's on the CPU."""
    x, y, plane, weights, valid, P, H, W = crowded_case(2, E=40000, P=8,
                                                        H=40, W=50)
    x[:3000], y[:3000] = 7, 9                   # one pixel of 3000 events
    inputs = [torch.from_numpy(a) for a in (x, y, plane, weights, valid)]
    inputs[3] = inputs[3].to(dtype)
    want = voxelize_scatter(*inputs, P, H, W)
    on_card = [t.to(cuda) for t in inputs]
    grids = [voxel_cuda.voxelize(*on_card, P, H, W) for _ in range(20)]
    torch.cuda.synchronize()
    for grid in grids:
        assert torch.equal(grid.cpu().view(torch.int32),
                           want.view(torch.int32))
