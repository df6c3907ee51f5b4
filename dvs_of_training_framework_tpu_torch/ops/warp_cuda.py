"""K3: the photometric warp's corner values as a CUDA kernel
(``csrc/warp_corners.cu``).

Counterpart of ``corner_values_pallas`` in
``dvs_of_training_framework_tpu/ops/warp_pallas.py``.  ``corner_values``
takes the arguments of ``ops.warp.corner_values``, its plain twin, for
single-channel frames.  A CUDA tensor always goes through the kernel,
which raises on what it does not take; a CPU tensor goes to the twin.
"""
import torch

from . import _build
from .warp import corner_values as plain

# kernel launches, counted where the wrapper launches them
launches = {'fwd': 0}

_INT_MAX = 2 ** 31 - 1


def _check_inputs(images, iy, ix):
    if images.dtype != torch.float32 or images.dim() != 4 \
            or images.shape[1] != 1:
        raise ValueError(f'images must be float32 [N, 1, H, W], got '
                         f'{images.dtype} {tuple(images.shape)}')
    N, _, H, W = images.shape
    if iy.dim() != 2 or iy.shape[0] != N or iy.shape[1] == 0:
        raise ValueError(f'iy must be [{N}, P] with P > 0, got '
                         f'{tuple(iy.shape)}')
    P = iy.shape[1]
    if N * H * W == 0 or 4 * N * P > _INT_MAX or H * W > _INT_MAX:
        raise ValueError(f'corner_values: unsupported sizes N {N}, P {P}, '
                         f'H {H}, W {W}')
    for name, t in (('images', images), ('iy', iy), ('ix', ix)):
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
        if name != 'images' and tuple(t.shape) != (N, P):
            raise ValueError(f'{name} must be [{N}, {P}], got '
                             f'{tuple(t.shape)}')
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
        the coordinates (``ops.warp.grid_sample_onehot`` owns the VJP).
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
        launches['fwd'] += 1
        return out
    if images.device.type == 'cpu':
        return plain(images, iy, ix)
    raise ValueError(f'corner_values: unsupported device {images.device}')
