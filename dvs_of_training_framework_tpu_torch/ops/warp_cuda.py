"""K3: the photometric warp's corner gather, alone and fused with the
warp, as CUDA kernels (``csrc/warp_corners.cu``).

Counterpart of ``corner_values_pallas`` in
``dvs_of_training_framework_tpu/ops/warp_pallas.py`` and of the blend and
grid VJP that ``grid_sample_onehot`` in
``dvs_of_training_framework_tpu/ops/warp.py`` runs on its corners.

- ``corner_values`` takes the arguments of ``ops.warp.corner_values``, its
  plain twin, for single-channel frames, and returns the corners.
- ``grid_sample_onehot`` takes the arguments of
  ``ops.warp.grid_sample_corners``, its plain twin: the warp in one
  forward kernel and one backward kernel, which gather the same corners
  (one device function) and save none.  The grid may be any strided view,
  such as the permuted ``[N, 2, Ho, Wo]`` grid the loss builds.

A CUDA tensor always goes through the kernels, which raise on what they
do not take; a CPU tensor goes to the twin.
"""
import torch

from . import _build
from .warp import corner_values as plain
from .warp import grid_sample_corners as plain_warp

# kernel launches, counted where the wrappers launch them
launches = {'corners': 0, 'fwd': 0, 'bwd': 0}

_INT_MAX = 2 ** 31 - 1


def _check_images(images):
    if images.dtype != torch.float32 or images.dim() != 4 \
            or images.shape[1] != 1:
        raise ValueError(f'images must be float32 [N, 1, H, W], got '
                         f'{images.dtype} {tuple(images.shape)}')
    if not images.is_contiguous():
        raise ValueError('images must be contiguous')
    N, _, H, W = images.shape
    if N * H * W == 0 or H * W > _INT_MAX:
        raise ValueError(f'unsupported frames N {N}, H {H}, W {W}')


def _check_inputs(images, iy, ix):
    _check_images(images)
    N = images.shape[0]
    if iy.dim() != 2 or iy.shape[0] != N or iy.shape[1] == 0:
        raise ValueError(f'iy must be [{N}, P] with P > 0, got '
                         f'{tuple(iy.shape)}')
    P = iy.shape[1]
    if 4 * N * P > _INT_MAX:
        raise ValueError(f'corner_values: unsupported sizes N {N}, P {P}')
    for name, t in (('iy', iy), ('ix', ix)):
        if t.dtype != torch.float32 or tuple(t.shape) != (N, P):
            raise ValueError(f'{name} must be float32 [{N}, {P}], got '
                             f'{t.dtype} {tuple(t.shape)}')
        if t.device != images.device:
            raise ValueError(f'{name} is on {t.device}, images on '
                             f'{images.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def corner_values(images, iy, ix):
    """Corner values ``V[a, b, n, p, 0] = images[n, 0, y0 + a, x0 + b]``,
    0 outside the frame.

    Args:
        images: float32 ``[N, 1, H, W]`` frames.
        iy, ix: float32 ``[N, P]`` unnormalised sampling coordinates.

    Returns:
        float32 ``[2, 2, N, P, 1]``.  No gradient flows through it: the
        frames are constants and the corners are piecewise constant in
        the coordinates (``grid_sample_onehot`` owns the VJP).
    """
    if images.is_cuda:
        _check_inputs(images, iy, ix)
        N, _, H, W = images.shape
        P = iy.shape[1]
        with torch.cuda.device(images.device):
            out = torch.empty((2, 2, N, P, 1), dtype=torch.float32,
                              device=images.device)
            stream = torch.cuda.current_stream(images.device).cuda_stream
            status = _build.library().warp_corners(
                images.data_ptr(), iy.data_ptr(), ix.data_ptr(),
                out.data_ptr(), N, P, H, W, stream)
            _build.check(status, 'warp_corners')
        _build.count(launches, 'corners')
        return out
    if images.device.type == 'cpu':
        return plain(images, iy, ix)
    raise ValueError(f'corner_values: unsupported device {images.device}')


class _GridSample(torch.autograd.Function):

    @staticmethod
    def forward(ctx, images, grid):
        N, _, H, W = images.shape
        Ho, Wo = grid.shape[1:3]
        out = torch.empty((N, 1, Ho, Wo), dtype=torch.float32,
                          device=images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        status = _build.library().warp_fwd(
            images.data_ptr(), grid.data_ptr(), out.data_ptr(), N, H, W, Ho,
            Wo, *grid.stride(), stream)
        _build.check(status, 'warp_fwd')
        _build.count(launches, 'fwd')
        ctx.save_for_backward(images, grid)
        return out

    @staticmethod
    def backward(ctx, g):
        images, grid = ctx.saved_tensors
        N, _, H, W = images.shape
        Ho, Wo = grid.shape[1:3]
        g = g.contiguous()
        dgrid = torch.empty((N, Ho, Wo, 2), dtype=torch.float32,
                            device=images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        status = _build.library().warp_bwd(
            images.data_ptr(), grid.data_ptr(), g.data_ptr(), dgrid.data_ptr(),
            N, H, W, Ho, Wo, *grid.stride(), stream)
        _build.check(status, 'warp_bwd')
        _build.count(launches, 'bwd')
        return None, dgrid


def grid_sample_onehot(images, grid):
    """``grid_sample`` (bilinear, zero padding, align_corners) of
    single-channel ``images`` ``[N, 1, H, W]`` at ``grid`` ``[N, Ho, Wo,
    2]`` (x, y in ``[-1, 1]``), differentiable with respect to ``grid``
    only.  On the card: float32, contiguous frames, a grid of any strides.
    Returns ``[N, 1, Ho, Wo]``.
    """
    if images.is_cuda:
        _check_images(images)
        N = images.shape[0]
        if grid.dtype != torch.float32 or grid.dim() != 4 \
                or grid.shape[0] != N or grid.shape[3] != 2:
            raise ValueError(f'grid must be float32 [{N}, Ho, Wo, 2], got '
                             f'{grid.dtype} {tuple(grid.shape)}')
        if grid.device != images.device:
            raise ValueError(f'grid is on {grid.device}, images on '
                             f'{images.device}')
        Ho, Wo = grid.shape[1:3]
        if Ho * Wo == 0 or N * Ho * Wo > _INT_MAX:
            raise ValueError(f'unsupported grid {tuple(grid.shape)}')
        with torch.cuda.device(images.device):
            return _GridSample.apply(images.detach(), grid)
    if images.device.type == 'cpu':
        return plain_warp(images, grid)
    raise ValueError(f'grid_sample_onehot: unsupported device '
                     f'{images.device}')
