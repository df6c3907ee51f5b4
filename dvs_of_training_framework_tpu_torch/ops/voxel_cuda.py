"""K1: event -> voxel-grid binning as a CUDA kernel (``csrc/voxelize.cu``).

Counterpart of ``voxelize_pallas`` in
``dvs_of_training_framework_tpu/ops/voxel_pallas.py``.  ``voxelize`` takes
the same arguments as ``voxelize_scatter``, its plain twin.  A CUDA tensor
always goes through the kernel, which raises on what it does not take; a
CPU tensor goes to the twin.  Unlike the TPU kernel this one needs no
plane-sorted events.  The forward adds each cell's events in ascending
event order, as the twin does, so its grid is the same on every launch
and equals the twin's on the CPU bit for bit, for any number of channels
(the forward sums them 32 at a time).  The weights are float32,
or bfloat16 in the bf16 recipe; the grid is float32 either way, and the
weights' gradient comes back in the weights' dtype, as the JAX kernel
returns it.
"""
import torch

from . import _build
from .voxel import voxelize_scatter

# kernel launches, counted where the wrapper launches them
launches = {'fwd': 0, 'bwd': 0}

plain = voxelize_scatter

_WEIGHT_DTYPES = (torch.float32, torch.bfloat16)
TILE_CELLS = 256     # cells of one image row that the forward sums on chip
MAX_TILES = 49152    # tiles whose counts one block holds in shared memory


def _check_inputs(x, y, plane, weights, valid):
    if weights.dtype not in _WEIGHT_DTYPES or weights.dim() != 2:
        raise ValueError(f'weights must be float32 or bfloat16 [E, C], got '
                         f'{weights.dtype} {tuple(weights.shape)}')
    E = weights.shape[0]
    if E == 0 or weights.shape[1] == 0:
        raise ValueError(f'voxelize needs at least one event and one '
                         f'channel, got {E} and {weights.shape[1]}')
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


def fwd_layout(E: int, P: int, H: int, W: int):
    """``(tiles, key dtype)`` of K1's forward: a tile is up to 256 cells of
    one image row, and a key holds an event's cell in its tile (8 bits)
    above its index (the bits of ``E - 1``), in int32 where that fits and
    in int64 otherwise."""
    tiles = P * H * -(-W // TILE_CELLS)
    event_bits = max(1, (E - 1).bit_length())
    return tiles, torch.int32 if 8 + event_bits <= 32 else torch.int64


class _Voxelize(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, plane, weights, valid, num_planes, height, width):
        E, C = weights.shape
        device = weights.device
        tiles, key_dtype = fwd_layout(E, num_planes, height, width)
        if tiles > MAX_TILES:
            raise ValueError(f'voxelize: {tiles} tiles of a row\'s 256 cells, '
                             f'at most {MAX_TILES}')
        lib = _build.library()
        # a row a bucket block: where each tile's group starts in its
        # region, then its count; the keys: the blocks' regions, then
        # scratch for tiles of many events; the top of that scratch
        blocks = lib.voxelize_fwd_blocks(E)
        offsets = torch.empty((blocks, tiles + 1), dtype=torch.int32,
                              device=device)
        keys = torch.empty(3 * E, dtype=key_dtype, device=device)
        top = torch.empty(1, dtype=torch.int32, device=device)
        out = torch.empty((num_planes, height, width, C), dtype=torch.float32,
                          device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.voxelize_fwd(
            x.data_ptr(), y.data_ptr(), plane.data_ptr(), weights.data_ptr(),
            valid.data_ptr(), offsets.data_ptr(), keys.data_ptr(),
            top.data_ptr(), out.data_ptr(), E, C, num_planes, height, width,
            weights.dtype == torch.bfloat16, key_dtype == torch.int64,
            stream)
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
