"""Port parity: the K3 twin (``ops.warp.corner_values``) and
``grid_sample_onehot`` against the JAX package.

- The twin against JAX ``_corner_values(..., bf16x2=False)``: exact, since
  a one-hot contraction of one non-zero term is exact.
- The twin against ``corner_values_pallas(..., interpret=True,
  bf16x2=True)`` at atol 255 * 2^-15, the bound of
  tests/ops/test_warp_parity.py::test_pallas_bf16x2_close_to_fp32.
- ``grid_sample_onehot``'s value and grid gradient against JAX
  ``grid_sample_onehot(..., 64, False, False)`` at 1e-5 / 1e-4
  (test_warp_parity.py::test_onehot_variant_matches_values_and_grads), and
  against the port's own ``F.grid_sample`` path at the same tolerances.
- Points far outside the frame (+-1e6 px) and NaN points give zero corners.
- The fused warp's wrapper (``ops.warp_cuda.grid_sample_onehot``), fed a
  permuted ``[N, 2, H, W]`` grid as the loss feeds it, with far and NaN
  points, against JAX at the same 1e-5 / 1e-4; on a card (tests marked
  ``cuda``) its kernels against the corner twin at 1e-5 / 1e-4.

The card's machine has no JAX, so the JAX imports are optional there; run
the card's tests with ``python -m pytest --noconftest -m cuda
tests/test_torch_warp.py``.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from dvs_of_training_framework_tpu.ops.warp import (
        _corner_values as jax_corner_values, grid_sample_onehot as jax_gso)
    from dvs_of_training_framework_tpu.ops.warp_pallas import \
        corner_values_pallas
except ModuleNotFoundError:     # a card's machine: the cuda tests only
    jax = None
from dvs_of_training_framework_tpu_torch.losses import (LOSS_PRECISIONS,
                                                        SingleScaleLoss)
from dvs_of_training_framework_tpu_torch.ops import warp_cuda
from dvs_of_training_framework_tpu_torch.ops.warp import (
    corner_values, grid_sample, grid_sample_corners, grid_sample_onehot)

# (N, C, H, W, P): odd sizes, a ragged chunk, and a multi-channel frame
SHAPES = [(2, 1, 12, 18, 140), (3, 1, 16, 24, 221), (2, 3, 9, 7, 50)]


def make_points(rng, N, H, W, P):
    """Coordinates spanning the frame and a border of a few pixels."""
    iy = rng.uniform(-3, H + 2, size=(N, P)).astype(np.float32)
    ix = rng.uniform(-3, W + 2, size=(N, P)).astype(np.float32)
    # some points exactly on pixel centres and on the last row/column
    iy[:, :4] = [0, H - 1, H - 2, -1]
    ix[:, :4] = [W - 1, 0, -1, W - 2]
    return iy, ix


def _corners(images, iy, ix):
    return corner_values(torch.from_numpy(images), torch.from_numpy(iy),
                         torch.from_numpy(ix)).numpy()


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('shape', SHAPES)
def test_corner_twin_matches_jax(seed, shape):
    N, C, H, W, P = shape
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(N, C, H, W)).astype(np.float32)
    iy, ix = make_points(rng, N, H, W, P)
    want = np.asarray(jax_corner_values(jnp.asarray(images), jnp.asarray(iy),
                                        jnp.asarray(ix), 64, bf16x2=False))
    got = _corners(images, iy, ix)
    assert got.shape == (2, 2, N, P, C)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('seed', [0, 1])
def test_corner_twin_matches_pallas_bf16x2(seed):
    N, H, W, P = 2, 16, 24, 300
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, size=(N, 1, H, W)).astype(np.float32)
    iy, ix = make_points(rng, N, H, W, P)
    want = np.asarray(corner_values_pallas(
        jnp.asarray(images), jnp.asarray(iy), jnp.asarray(ix),
        interpret=True, bf16x2=True))
    np.testing.assert_allclose(_corners(images, iy, ix), want, rtol=0,
                               atol=255 * 2 ** -15)


@pytest.mark.parametrize('bf16x2', [False, True, 'x1'])
@pytest.mark.parametrize('seed', [0, 2])
def test_grid_sample_onehot_matches_jax(seed, bf16x2):
    rng = np.random.default_rng(seed)
    N, C, H, W = 2, 1, 12, 18
    Ho, Wo = 10, 14
    images = rng.normal(size=(N, C, H, W)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(N, Ho, Wo, 2)).astype(np.float32)
    cot = rng.normal(size=(N, C, Ho, Wo)).astype(np.float32)

    want = np.asarray(jax_gso(jnp.asarray(images), jnp.asarray(grid), 64,
                              False, False))
    want_grad = np.asarray(jax.grad(
        lambda g: (jax_gso(jnp.asarray(images), g, 64, False, False)
                   * jnp.asarray(cot)).sum())(jnp.asarray(grid)))

    results = []
    for fn in (lambda i, g: grid_sample_onehot(i, g, bf16x2), grid_sample):
        tgrid = torch.tensor(grid, requires_grad=True)
        out = fn(torch.from_numpy(images), tgrid)
        (out * torch.from_numpy(cot)).sum().backward()
        results.append((out.detach().numpy(), tgrid.grad.numpy()))
    (got, got_grad), (plain, plain_grad) = results
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-4, atol=1e-4)
    # and against the port's F.grid_sample path
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_grad, plain_grad, rtol=1e-4, atol=1e-4)


def test_far_and_nan_points_give_zero_corners():
    rng = np.random.default_rng(3)
    N, H, W = 2, 8, 10
    images = rng.uniform(1, 255, size=(N, 1, H, W)).astype(np.float32)
    far = np.array([1e6, -1e6, 3e9, -3e9, np.nan, np.inf, -np.inf],
                   np.float32)
    inside = np.full(far.shape, 3.25, np.float32)
    iy = np.tile(np.concatenate([far, inside]), (N, 1))
    ix = np.tile(np.concatenate([inside, far]), (N, 1))
    got = _corners(images, iy, ix)
    assert not got.any() and not np.isnan(got).any()
    # the JAX package agrees on the finite far points (+-1e6 px)
    sel = np.r_[0:2, 7:9]
    want = np.asarray(jax_corner_values(
        jnp.asarray(images), jnp.asarray(iy[:, sel]), jnp.asarray(ix[:, sel]),
        64, bf16x2=False))
    np.testing.assert_array_equal(got[:, :, :, sel], want)


@pytest.mark.parametrize('precision', sorted(LOSS_PRECISIONS))
def test_loss_warp_forms_agree(precision):
    """The loss's photometric term through the corner warp equals the
    ``F.grid_sample`` form, in every loss precision."""
    rng = np.random.default_rng(5)
    N, H, W = 2, 16, 20
    prev = torch.from_numpy(rng.uniform(0, 255, (N, 1, H, W))
                            .astype(np.float32))
    nxt = torch.from_numpy(rng.uniform(0, 255, (N, 1, H, W))
                           .astype(np.float32))
    flow = rng.normal(0, 3, (N, 2, H, W)).astype(np.float32)
    values, grads = [], []
    for use_mxu_warp in (True, False):
        loss = SingleScaleLoss((H, W), use_mxu_warp=use_mxu_warp,
                               bf16x2=LOSS_PRECISIONS[precision])
        f = torch.tensor(flow, requires_grad=True)
        term = loss.photometric_loss(prev, nxt, loss._warp_grid(f))
        term.backward()
        values.append(term.item())
        grads.append(f.grad)
    assert values[0] == pytest.approx(values[1], rel=1e-6)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-6)
    # on CPU frames the automatic choice is F.grid_sample, as in JAX
    auto = SingleScaleLoss((H, W), bf16x2=LOSS_PRECISIONS[precision])
    assert not auto._corner_warp(prev)


def test_bf16x2_must_be_a_loss_precision():
    with pytest.raises(ValueError):
        grid_sample_onehot(torch.zeros(1, 1, 4, 4), torch.zeros(1, 2, 2, 2),
                           'bf16x3')


def loss_grid(rng, N, H, W, Ho, Wo):
    """The photometric loss's grid for flows of a few px, as the loss
    builds it (``SingleScaleLoss._warp_grid``): ``[N, 2, Ho, Wo]``, read
    through its permuted ``[N, Ho, Wo, 2]`` view.  Some points are +-1e6
    px away, some NaN."""
    flow = rng.normal(0, 3, (N, 2, Ho, Wo)).astype(np.float32)
    flow[:, 0, 0, :2] = [1e6, -1e6]
    flow[:, 1, 1, :2] = [1e6, -1e6]
    flow[:, :, 2, :2] = np.nan
    grid = SingleScaleLoss((Ho, Wo))._warp_grid(torch.from_numpy(flow))
    # the frames are H x W, the grid's points pixel coordinates of them
    scale = torch.tensor([(Wo - 1) / (W - 1), (Ho - 1) / (H - 1)])
    return ((grid + 1) * scale[None, :, None, None] - 1).contiguous()


@pytest.mark.parametrize('seed', [0, 3])
def test_fused_warp_wrapper_on_the_loss_grid_matches_jax(seed):
    rng = np.random.default_rng(seed)
    N, H, W, Ho, Wo = 2, 12, 18, 10, 14
    images = rng.uniform(0, 255, (N, 1, H, W)).astype(np.float32)
    grid = loss_grid(rng, N, H, W, Ho, Wo).requires_grad_(True)
    view = grid.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    cot = rng.normal(size=(N, 1, Ho, Wo)).astype(np.float32)

    nhwc = jnp.asarray(view.detach().numpy())
    want = np.asarray(jax_gso(jnp.asarray(images), nhwc, 64, False, False))
    want_grad = np.asarray(jax.grad(
        lambda g: (jax_gso(jnp.asarray(images), g, 64, False, False)
                   * jnp.asarray(cot)).sum())(nhwc))

    before = dict(warp_cuda.launches)
    out = warp_cuda.grid_sample_onehot(torch.from_numpy(images), view)
    (out * torch.from_numpy(cot)).sum().backward()
    assert warp_cuda.launches == before         # the CPU takes the twin
    got, got_grad = out.detach().numpy(), grid.grad.permute(0, 2, 3, 1)
    assert np.isnan(got).sum() == 2 * N * 1      # the NaN points
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-4)
    assert not got[:, :, :2, :2].any()           # the far points


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('size', [32, 64, 256])
@pytest.mark.parametrize('layout', ['loss view', 'contiguous'])
def test_fused_warp_matches_the_corner_twin(cuda, size, layout):
    """The fused kernels against ``grid_sample_corners``: values 1e-5,
    grid gradient 1e-4 (test_warp_parity.py:128,146), NaN where the twin
    has NaN; one forward and one backward launch, no corner tensor."""
    rng = np.random.default_rng(size)
    N = 8
    images = torch.from_numpy(rng.uniform(0, 255, (N, 1, size, size))
                              .astype(np.float32)).to(cuda)
    grid = loss_grid(rng, N, size, size, size, size).to(cuda)
    cot = torch.randn(N, 1, size, size, device=cuda)
    results = []
    for fn in (warp_cuda.grid_sample_onehot, grid_sample_corners):
        leaf = grid.clone().requires_grad_(True)
        view = leaf.permute(0, 2, 3, 1)
        if layout == 'contiguous':
            view = view.contiguous()
        before = dict(warp_cuda.launches)
        out = fn(images, view)
        (dgrid,) = torch.autograd.grad(out, leaf, cot)
        torch.cuda.synchronize()
        results.append((out, dgrid))
        launched = {k: warp_cuda.launches[k] - before[k] for k in before}
        if fn is warp_cuda.grid_sample_onehot:
            assert launched == {'corners': 0, 'fwd': 1, 'bwd': 1}
    (out, dgrid), (want, want_grad) = results
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    torch.testing.assert_close(dgrid, want_grad, rtol=1e-4, atol=1e-4,
                               equal_nan=True)
    assert out.isnan().sum() == 2 * N
