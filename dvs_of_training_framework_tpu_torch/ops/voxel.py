"""Event voxelization by scatter-add: the plain twin of the K1 kernel.

Counterpart of ``voxelize_scatter`` in
``dvs_of_training_framework_tpu/ops/voxel.py``.  ``ops/voxel_cuda.py``
holds the CUDA kernel that replaces it on the card.
"""
import torch


def voxelize_scatter(x, y, sample_elem, weights, valid,
                     num_planes: int, height: int, width: int):
    """Scatter-add voxelization.

    Args:
        x, y: int ``[E]`` pixel coordinates (inside the grid).
        sample_elem: int ``[E]`` flattened (sample * L + element) plane id.
        weights: ``[E, C]`` per-channel contribution of each event.
        valid: bool ``[E]`` mask (False rows are dropped).
        num_planes: B * L.
        height, width: grid shape.

    Returns:
        float32 ``[num_planes, height, width, C]``.  The gradient with
        respect to ``weights`` is zero on invalid rows.
    """
    C = weights.shape[1]
    n_bins = num_planes * height * width * C
    pix = (sample_elem.long() * height + y.long()) * width + x.long()
    flat = pix[:, None] * C + torch.arange(C, device=weights.device)[None, :]
    # invalid rows add an exact zero to bin 0 (no host sync for a mask)
    flat = torch.where(valid[:, None], flat, 0)
    values = torch.where(valid[:, None], weights.float(), 0.0)
    grid = torch.zeros(n_bins, dtype=torch.float32, device=weights.device)
    grid = grid.index_add(0, flat.reshape(-1), values.reshape(-1))
    return grid.reshape(num_planes, height, width, C)
