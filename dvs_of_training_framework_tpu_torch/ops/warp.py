"""Bilinear image warping (grid_sample) with align_corners=True semantics.

Counterpart of ``grid_sample`` in ``dvs_of_training_framework_tpu/ops/warp.py``:
bilinear, zero padding for out-of-border corners, differentiable with
respect to the grid.  The photometric loss treats the frames as constants.
"""
import torch
import torch.nn.functional as F


def grid_sample(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``images`` ``[N, C, H, W]`` at ``grid`` ``[N, Ho, Wo, 2]``.

    The grid's last axis is ``(x, y)`` in ``[-1, 1]``; returns
    ``[N, C, Ho, Wo]``.
    """
    return F.grid_sample(images.detach(), grid, mode='bilinear',
                         padding_mode='zeros', align_corners=True)
