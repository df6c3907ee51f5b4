"""Segment-index utilities for ragged data under fixed shapes.

Counterpart of ``dvs_of_training_framework_tpu/ops/segment.py``.  Integer
outputs match the JAX functions exactly.
"""
import torch


def segment_starts(segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """First position of each segment id in a sorted segment vector.

    Args:
        segment_ids: int ``[N]`` non-decreasing segment ids (padding may use
            ``num_segments``, which is dropped).
        num_segments: number of segments.

    Returns:
        int32 ``[num_segments]`` index of the first element of each segment
        (N for empty segments).
    """
    n = segment_ids.shape[0]
    device = segment_ids.device
    positions = torch.arange(n, dtype=torch.int32, device=device)
    # padding goes to one spare slot, dropped after: no boolean mask, so
    # no shape that depends on the data and no sync (a CUDA graph
    # captures it)
    ids = torch.where(segment_ids < num_segments, segment_ids,
                      num_segments).long()
    starts = torch.full((num_segments + 1,), n, dtype=torch.int32,
                        device=device)
    return starts.scatter_reduce(0, ids, positions,
                                 reduce='amin')[:num_segments]


def get_local_idx(segment_ids: torch.Tensor, num_segments: int):
    """Local index within each segment and segment sizes.

    Example::

        segment_ids [0, 0, 1, 1, 2]  (sorted)
        local_idx   [0, 1, 0, 1, 0]
        sizes       [2, 2, 1]
    """
    starts = segment_starts(segment_ids, num_segments)
    safe_ids = segment_ids.clamp(0, num_segments - 1).long()
    local = torch.arange(segment_ids.shape[0], dtype=torch.int32,
                         device=segment_ids.device) - starts[safe_ids]
    kept = segment_ids[segment_ids < num_segments].long()
    sizes = torch.bincount(kept, minlength=num_segments).to(torch.int32)
    return local, sizes
