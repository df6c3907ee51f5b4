"""Bilinear resize with align_corners=True.

Counterpart of ``dvs_of_training_framework_tpu/ops/resize.py``, whose
interpolation-matrix form is pinned against ``F.interpolate`` in the JAX
package's own tests.
"""
import torch
import torch.nn.functional as F


def resize_bilinear(images: torch.Tensor, out_shape) -> torch.Tensor:
    """Resize ``[N, C, H, W]`` images to ``[N, C, Ho, Wo]`` in float32."""
    Ho, Wo = int(out_shape[0]), int(out_shape[1])
    if (Ho, Wo) == tuple(images.shape[-2:]):
        return images
    return F.interpolate(images.float(), size=(Ho, Wo), mode='bilinear',
                         align_corners=True)
