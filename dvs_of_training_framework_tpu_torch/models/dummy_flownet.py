"""DummyFlowNet: the smallest plugin, zero flows at four scales.

Counterpart of ``DummyFlowNet/net.py`` (``Model``) and of its plugin's
``OpticalFlow`` (``DummyFlowNet/of.py``): the flows are a learnable (2,)
``flow_bias``, initialised to zero, broadcast over each scale, so that a
training step still has a gradient to follow.  The model reads no
events; it has no ``quantization_layer``, so the optimizer trains its
one parameter as one group.  Its ``quantize`` and
``compute_event_image`` belong to dense mode and are not ported yet.
"""
from typing import Tuple

import torch
import torch.nn as nn

from .evflownet import batch_size_of, predicted_windows
from .optical_flow import BaseOpticalFlow


class Model(nn.Module):

    def __init__(self, prefix_length=0, suffix_length=0,
                 max_sequence_length=1, generator=None, device=None):
        super().__init__()
        self.prefix_length = prefix_length
        self.suffix_length = suffix_length
        self.max_sequence_length = max_sequence_length
        self.flow_bias = nn.Parameter(torch.zeros(2, device=device))

    def forward(self, events, timestamps, sample_idx,
                imsize: Tuple[int, int], intermediate: bool = False):
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


class OpticalFlow(BaseOpticalFlow):
    """Inference wrapper for DummyFlowNet."""

    def __init__(self, imsize, model=None, activation='relu', **kwargs):
        super().__init__(imsize, Model, model=model, activation=activation,
                         **kwargs)
