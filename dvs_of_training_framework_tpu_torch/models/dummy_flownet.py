"""DummyFlowNet: the smallest plugin, zero flows at four scales.

Counterpart of ``DummyFlowNet/net.py`` (``Model``) and of its plugin's
``OpticalFlow`` (``DummyFlowNet/of.py``): the flows are a learnable (2,)
``flow_bias``, initialised to zero, broadcast over each scale, so that a
training step still has a gradient to follow.  The model reads neither
events nor dense grids; it has no ``quantization_layer``, so the
optimizer trains its one parameter as one group.  ``quantize`` gives
zeros and ``compute_event_image`` the signed count image, as the JAX
plugin's do; ``vis_flow`` (``DummyFlowNet/test.py``) is EVFlowNet's.
"""
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from .evflownet import batch_size_of, predicted_windows
from .evflownet import vis_flow  # noqa: F401
from .optical_flow import BaseOpticalFlow


class Model(nn.Module):

    def __init__(self, prefix_length=0, suffix_length=0,
                 max_sequence_length=1, generator=None, device=None):
        super().__init__()
        self.prefix_length = prefix_length
        self.suffix_length = suffix_length
        self.max_sequence_length = max_sequence_length
        self.flow_bias = nn.Parameter(torch.zeros(2, device=device))

    def quantize(self, events, timestamps, sample_idx,
                 imsize: Tuple[int, int]):
        """Zeros ``[B, L, H, W]`` float32: L channels, not L*C, as the JAX
        plugin's ``quantize`` gives (this model ignores events)."""
        batch_size = batch_size_of(timestamps, self.max_sequence_length)
        H, W = imsize
        return torch.zeros(batch_size, self.max_sequence_length, H, W,
                           device=self.flow_bias.device)

    def forward(self, events, timestamps, sample_idx,
                imsize: Tuple[int, int], raw: bool = True,
                intermediate: bool = False):
        batch_size = batch_size_of(timestamps, self.max_sequence_length)
        H, W = imsize
        # scales imsize // 2^i for i = 3..0 (smallest first)
        flows = tuple(
            torch.zeros(batch_size, 2, H >> i, W >> i,
                        device=self.flow_bias.device)
            + self.flow_bias[None, :, None, None]
            for i in (3, 2, 1, 0))
        flow_ts, flow_sample_idx = predicted_windows(
            timestamps, sample_idx, batch_size, self.prefix_length)
        if intermediate:
            return flows, flow_ts, flow_sample_idx, tuple()
        return flows, flow_ts, flow_sample_idx


def compute_event_image(events, start_ts, stop_ts, shape, depth=9,
                        **_ignored):
    """Host-side event->image conversion for the --ev_images pipeline
    (``DummyFlowNet/net.py`` ``compute_event_image``): the signed
    per-element event count image, broadcast over ``depth`` channels.

    Args:
        events: float32 ``[N, 5]`` rows ``(x, y, t, p, element_index)``.
        start_ts, stop_ts: per-element window bounds, each ``[L]``.
        shape: (H, W).
        depth: channels per element.

    Returns:
        float32 ``[L, depth, H, W]`` dense representation.
    """
    H, W = shape
    L = len(start_ts)
    counts = np.zeros((L, H, W), np.float32)
    if events.shape[0]:
        x = events[:, 0].astype(np.int64)
        y = events[:, 1].astype(np.int64)
        p = events[:, 3].astype(np.float32)
        e = events[:, 4].astype(np.int64)
        np.add.at(counts, (e, y, x), p)
    return np.repeat(counts[:, None], depth, axis=1)


class OpticalFlow(BaseOpticalFlow):
    """Inference wrapper for DummyFlowNet."""

    def __init__(self, imsize, model=None, activation='relu', **kwargs):
        super().__init__(imsize, Model, model=model, activation=activation,
                         **kwargs)
