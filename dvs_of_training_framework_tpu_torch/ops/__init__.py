"""Tensor ops of the port: the plain ops and the CUDA kernels' wrappers."""
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
           'kernel_mlp', 'resize_bilinear', 'segment_starts', 'voxelize',
           'voxelize_scatter']
