"""Tensor ops of the port: the plain ops and the CUDA kernels' wrappers."""
from . import kernel_mlp_cuda, voxel_cuda, warp_cuda
from .charbonnier import charbonnier_loss, charbonnier_value
from .kernel_mlp_cuda import kernel_mlp
from .resize import resize_bilinear
from .segment import get_local_idx, segment_starts
from .voxel import voxelize_scatter
from .voxel_cuda import voxelize
from .warp import grid_sample, grid_sample_onehot
from .warp_cuda import corner_values

__all__ = ['charbonnier_loss', 'charbonnier_value', 'corner_values',
           'get_local_idx', 'grid_sample', 'grid_sample_onehot',
           'kernel_mlp', 'launch_counts', 'resize_bilinear',
           'segment_starts', 'voxelize', 'voxelize_scatter']


def launch_counts() -> dict:
    """Launches of each CUDA kernel in this process so far, by the names
    of the kernels' entry points (``voxelize_fwd`` ... ``warp_bwd``)."""
    return {f'{prefix}_{key}' if key != 'corners' else 'corner_values': n
            for prefix, module in (('voxelize', voxel_cuda),
                                   ('kernel_mlp', kernel_mlp_cuda),
                                   ('warp', warp_cuda))
            for key, n in module.launches.items()}
