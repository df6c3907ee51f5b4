"""K1: event -> voxel-grid binning as a CUDA kernel (``csrc/voxelize.cu``).

Counterpart of ``voxelize_pallas`` in
``dvs_of_training_framework_tpu/ops/voxel_pallas.py``.  ``voxelize`` takes
the same arguments as ``voxelize_scatter``, its plain twin.  A CUDA tensor
always goes through the kernel, which raises on what it does not take; a
CPU tensor goes to the twin.  Unlike the TPU kernel this one needs no
plane-sorted events.  The weights are float32, or bfloat16 in the bf16
recipe; the grid is float32 either way, and the weights' gradient comes
back in the weights' dtype, as the JAX kernel returns it.
"""
import torch

from . import _build
from .voxel import voxelize_scatter

# kernel launches, counted where the wrapper launches them
launches = {'fwd': 0, 'bwd': 0}

plain = voxelize_scatter

_WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(x, y, plane, weights, valid):
    if weights.dtype not in _WEIGHT_DTYPES or weights.dim() != 2:
        raise ValueError(f'weights must be float32 or bfloat16 [E, C], got '
                         f'{weights.dtype} {tuple(weights.shape)}')
    E = weights.shape[0]
    if E == 0 or weights.shape[1] == 0:
        raise ValueError('voxelize needs at least one event and channel')
    for name, t, dtype in (('x', x, torch.int32), ('y', y, torch.int32),
                           ('plane', plane, torch.int32),
                           ('valid', valid, torch.bool)):
        if t.dtype != dtype or tuple(t.shape) != (E,):
            raise ValueError(f'{name} must be {dtype} [{E}], got '
                             f'{t.dtype} {tuple(t.shape)}')
        if t.device != weights.device:
            raise ValueError(f'{name} is on {t.device}, weights on '
                             f'{weights.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if not weights.is_contiguous():
        raise ValueError('weights must be contiguous')


class _Voxelize(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, plane, weights, valid, num_planes, height, width):
        E, C = weights.shape
        out = torch.zeros((num_planes, height, width, C), dtype=torch.float32,
                          device=weights.device)
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        status = _build.library().voxelize_fwd(
            x.data_ptr(), y.data_ptr(), plane.data_ptr(), weights.data_ptr(),
            valid.data_ptr(), out.data_ptr(), E, C, num_planes, height,
            width, weights.dtype == torch.bfloat16, stream)
        _build.check(status, 'voxelize_fwd')
        launches['fwd'] += 1
        ctx.save_for_backward(x, y, plane, valid)
        ctx.weight_dtype = weights.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, plane, valid = ctx.saved_tensors
        P, H, W, C = g.shape
        g = g.contiguous().float()
        dw = torch.empty((x.shape[0], C), dtype=ctx.weight_dtype,
                         device=g.device)
        stream = torch.cuda.current_stream(g.device).cuda_stream
        status = _build.library().voxelize_bwd(
            x.data_ptr(), y.data_ptr(), plane.data_ptr(), valid.data_ptr(),
            g.data_ptr(), dw.data_ptr(), x.shape[0], C, P, H, W,
            ctx.weight_dtype == torch.bfloat16, stream)
        _build.check(status, 'voxelize_bwd')
        launches['bwd'] += 1
        return None, None, None, dw, None, None, None, None


def voxelize(x, y, plane, weights, valid,
             num_planes: int, height: int, width: int):
    """Voxelize events: ``grid[p, y_e, x_e, c] += weights[e, c]``.

    Args match ``ops.voxel.voxelize_scatter``; on CUDA, x, y and plane are
    int32, valid bool and weights float32 or bfloat16 ``[E, C]``, all
    contiguous.  Returns float32 ``[num_planes, height, width, C]``; the
    gradient flows to ``weights`` only, in their dtype.
    """
    if weights.is_cuda:
        _check_inputs(x, y, plane, weights, valid)
        with torch.cuda.device(weights.device):
            return _Voxelize.apply(x, y, plane, weights, valid,
                                   num_planes, height, width)
    if weights.device.type == 'cpu':
        return plain(x, y, plane, weights, valid,
                     num_planes, height, width)
    raise ValueError(f'voxelize: unsupported device {weights.device}')
