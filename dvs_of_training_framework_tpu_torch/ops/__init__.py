"""Tensor ops of the port: the plain ops and the CUDA kernels' wrappers."""
from . import flow_head_cuda, kernel_mlp_cuda, voxel_cuda, warp_cuda
from .charbonnier import charbonnier_loss, charbonnier_value
from .kernel_mlp_cuda import kernel_mlp
from .resize import resize_bilinear
from .segment import get_local_idx, segment_starts
from .voxel import voxelize_scatter
from .voxel_cuda import voxelize
from .warp import grid_sample, grid_sample_onehot
from .warp_cuda import corner_values

__all__ = ['charbonnier_loss', 'charbonnier_value', 'corner_values',
           'count_launches', 'get_local_idx', 'grid_sample',
           'grid_sample_onehot',
           'kernel_mlp', 'launch_counts', 'resize_bilinear',
           'segment_starts', 'voxelize', 'voxelize_scatter']


def _counters():
    """``(name, counter dict, key)`` of every kernel's launch counter."""
    return [(f'{prefix}_{key}' if key != 'corners' else 'corner_values',
             module.launches, key)
            for prefix, module in (('voxelize', voxel_cuda),
                                   ('kernel_mlp', kernel_mlp_cuda),
                                   ('warp', warp_cuda),
                                   ('flow_head', flow_head_cuda))
            for key in module.launches]


def launch_counts() -> dict:
    """Launches of each CUDA kernel in this process so far, by the names
    of the kernels' entry points (``voxelize_fwd`` ... ``flow_head_bwd``)."""
    return {name: counter[key] for name, counter, key in _counters()}


def count_launches(launches: dict, sign: int = 1):
    """Add ``sign`` times ``launches`` (``launch_counts()``'s names) to the
    counters.  A CUDA graph's capture records kernels and launches none,
    so it takes back what its wrappers counted, and each replay, which
    launches them all, counts them again (``training/state.py``)."""
    for name, counter, key in _counters():
        counter[key] += sign * launches.get(name, 0)
