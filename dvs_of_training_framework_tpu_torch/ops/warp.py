"""Bilinear image warping (grid_sample) with align_corners=True semantics.

Counterpart of ``grid_sample`` and ``grid_sample_onehot`` in
``dvs_of_training_framework_tpu/ops/warp.py``: bilinear, zero padding for
out-of-border corners, differentiable with respect to the grid.  The
photometric loss treats the frames as constants.

``grid_sample`` is ``F.grid_sample``.  ``grid_sample_onehot`` is the
corner-value formulation that the bf16x2 loss recipe selects.  Its plain
twin, ``grid_sample_corners``, takes the four corner values of every
point from one gather (``corner_values``) and runs the bilinear blend and
the analytic grid gradient as plain ops on the saved corners; on the card
the fused K3 kernels of ``ops/warp_cuda.py`` do all of it, one forward
and one backward launch.
"""
import torch
import torch.nn.functional as F

BF16X2_MODES = (False, True, 'x1')


def grid_sample(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``images`` ``[N, C, H, W]`` at ``grid`` ``[N, Ho, Wo, 2]``.

    The grid's last axis is ``(x, y)`` in ``[-1, 1]``; returns
    ``[N, C, Ho, Wo]``.
    """
    return F.grid_sample(images.detach(), grid, mode='bilinear',
                         padding_mode='zeros', align_corners=True)


def corner_values(images: torch.Tensor, iy: torch.Tensor,
                  ix: torch.Tensor) -> torch.Tensor:
    """Corner values ``V[a, b, n, p, c] = images[n, c, y0 + a, x0 + b]``.

    The plain twin of the K3 kernel: ``y0 = floor(iy)``, ``x0 =
    floor(ix)``, and a corner outside the image (or a NaN coordinate)
    gives 0.  The range is tested in float before any cast to an index, so
    a coordinate of any size never wraps into the image.

    Args:
        images: ``[N, C, H, W]`` float32 frames.
        iy, ix: ``[N, P]`` float32 unnormalised sampling coordinates.

    Returns:
        float32 ``[2, 2, N, P, C]`` (a = y-corner, b = x-corner).
    """
    N, C, H, W = images.shape
    flat = images.reshape(N, C, H * W)
    y0 = torch.floor(iy)
    x0 = torch.floor(ix)
    rows = []
    for a in (0, 1):
        cols = []
        for b in (0, 1):
            yy, xx = y0 + a, x0 + b
            inside = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
            idx = torch.where(inside, yy * W + xx, 0.0).long()
            v = torch.gather(flat, 2, idx[:, None, :].expand(N, C, -1))
            cols.append(torch.where(inside[:, None, :], v, 0.0)
                        .transpose(1, 2))                       # [N, P, C]
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def _unnormalize(grid, H, W):
    """``[..., 2]`` grid in ``[-1, 1]`` -> pixel coordinates ``(iy, ix)``."""
    ix = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    iy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    return iy, ix


def _blend(V, iy, ix):
    """Bilinear blend of the corners ``V`` ``[2, 2, N, P, C]``: ``[N, P, C]``."""
    y0 = torch.floor(iy)
    x0 = torch.floor(ix)
    wy1 = (iy - y0)[None, None, :, :, None]   # weight of the +1 row
    wx1 = (ix - x0)[None, None, :, :, None]
    wy = torch.cat([1.0 - wy1, wy1], dim=0)   # [2, 1, N, P, 1]
    wx = torch.cat([1.0 - wx1, wx1], dim=1)   # [1, 2, N, P, 1]
    return (V * wy * wx).sum(dim=(0, 1))


class _GridSampleOnehot(torch.autograd.Function):

    @staticmethod
    def forward(ctx, images, grid, corners):
        N, C, H, W = images.shape
        Ho, Wo = grid.shape[1:3]
        iy, ix = _unnormalize(grid.reshape(N, Ho * Wo, 2), H, W)
        iy, ix = iy.contiguous(), ix.contiguous()
        V = corners(images.contiguous(), iy, ix)
        out = _blend(V, iy, ix)                                 # [N, P, C]
        ctx.save_for_backward(V, iy, ix)
        ctx.shape = (N, C, H, W, Ho, Wo)
        return out.transpose(1, 2).reshape(N, C, Ho, Wo)

    @staticmethod
    def backward(ctx, g):
        V, iy, ix = ctx.saved_tensors
        N, C, H, W, Ho, Wo = ctx.shape
        g2 = g.reshape(N, C, Ho * Wo).transpose(1, 2)          # [N, P, C]
        y0 = torch.floor(iy)
        x0 = torch.floor(ix)
        wy1 = iy - y0
        wx1 = ix - x0
        wy0 = 1.0 - wy1
        wx0 = 1.0 - wx1
        # d out / d ix = sum_a wy_a * (V_a1 - V_a0); likewise for iy
        dV_dx = (wy0[..., None] * (V[0, 1] - V[0, 0])
                 + wy1[..., None] * (V[1, 1] - V[1, 0]))
        dV_dy = (wx0[..., None] * (V[1, 0] - V[0, 0])
                 + wx1[..., None] * (V[1, 1] - V[0, 1]))
        dix = (g2 * dV_dx).sum(-1)                             # [N, P]
        diy = (g2 * dV_dy).sum(-1)
        # chain through the [-1, 1] normalisation
        dgrid = torch.stack([dix * ((W - 1) * 0.5), diy * ((H - 1) * 0.5)],
                            dim=-1)
        return None, dgrid.reshape(N, Ho, Wo, 2), None


def grid_sample_corners(images: torch.Tensor, grid: torch.Tensor,
                        corners=corner_values) -> torch.Tensor:
    """``grid_sample`` through the corner values ``corners(images, iy,
    ix)`` (``corner_values`` by default, the K3 gather
    ``ops.warp_cuda.corner_values`` on the card), the blend and the
    analytic grid VJP as plain ops; differentiable with respect to ``grid``
    only.  The plain twin of the fused kernels in ``ops/warp_cuda.py``."""
    return _GridSampleOnehot.apply(images.detach(), grid, corners)


def grid_sample_onehot(images: torch.Tensor, grid: torch.Tensor,
                       bf16x2=False, plain_ops: bool = False):
    """``grid_sample`` through the corner values, differentiable with
    respect to ``grid`` only (``images`` are constants).

    ``ops.warp_cuda.grid_sample_onehot`` runs it: the fused K3 kernels on
    a CUDA tensor, ``grid_sample_corners`` on a CPU tensor.
    ``plain_ops=True`` takes ``grid_sample_corners`` on every device, as
    the reference path a kernel run is compared with.

    ``bf16x2`` (False, True or ``'x1'``) is the JAX package's loss
    precision.  There it picks how the TPU's matrix unit contracts one-hot
    matrices with the frames: fp32, a hi+lo bf16 split (~2^-16 relative)
    or the hi part alone (~2^-8).  On Hopper the corners are a direct
    gather, exact in every mode, so all three give the same fp32 corners.
    """
    if bf16x2 not in BF16X2_MODES:
        raise ValueError(f'bf16x2 must be one of {BF16X2_MODES}, '
                         f'got {bf16x2!r}')
    if plain_ops:
        return grid_sample_corners(images, grid)
    # imported here: ops/warp_cuda.py imports this module's twins
    from .warp_cuda import grid_sample_onehot as fused
    return fused(images, grid)
