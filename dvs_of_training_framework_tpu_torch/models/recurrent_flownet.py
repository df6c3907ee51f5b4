"""RecurrentFlowNet: a ConvGRU over the elements of a sample.

Counterpart of ``RecurrentFlowNet/net.py`` (``ConvGRUCell``, ``Model``,
``compute_event_image``, which is EVFlowNet's), of its plugin's
``OpticalFlow`` (``RecurrentFlowNet/__init__.py``) and of its ``test.py``
(``vis_flow``, EVFlowNet's), in NCHW.  Each
element's voxel grid (EVFlowNet's ``QuantizationLayer``, channels
``l * C + c``) passes the ``embed`` 3x3 convolution and the activation,
then one ConvGRU step; the state after element
``prefix_length`` goes to EVFlowNet's ``Predictor``.  The loop over the
``max_sequence_length`` elements is unrolled, and the elements after the
prefix are computed as in the reference even where they are unused.
Module names follow the flax tree (``quantization_layer``, ``embed``,
``gru.{update,reset,candidate}``, ``predictor``), so that
``utils/convert.py`` maps one onto the other name by name.  ``dtype`` is
the compute type as in EVFlowNet: the GRU's gates, its state and the
blend run in it.
"""
from typing import Tuple

import torch
import torch.nn as nn

from . import evflownet
# the plugin's host-side image for --ev_images and its flow rendering
# are EVFlowNet's
from .evflownet import compute_event_image, vis_flow  # noqa: F401
from .evflownet import (Conv, Predictor, QuantizationLayer, batch_size_of,
                        compute_dtype, get_activation, predicted_windows)
from .optical_flow import BaseOpticalFlow


class ConvGRUCell(nn.Module):
    """``(h, x) -> (1 - z) h + z tanh(candidate([r h, x]))`` with the
    update gate ``z`` and the reset gate ``r`` 3x3 convolutions of
    ``[h, x]`` through a sigmoid; ``h`` and ``x`` have ``channels`` each."""

    def __init__(self, channels, generator, dtype=torch.float32):
        super().__init__()
        self.update = Conv(2 * channels, channels, 3, generator, dtype=dtype)
        self.reset = Conv(2 * channels, channels, 3, generator, dtype=dtype)
        self.candidate = Conv(2 * channels, channels, 3, generator,
                              dtype=dtype)

    def forward(self, h, x):
        inp = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.update(inp))
        r = torch.sigmoid(self.reset(inp))
        cand = torch.tanh(self.candidate(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * cand


class Model(nn.Module):
    """RecurrentFlowNet on raw padded events or dense grids; ``forward``
    and ``quantize`` as EVFlowNet's ``Model`` (the plugin contract of
    ``models/loader.py``).  A dense ``[B, L*C, H, W]`` input feeds the GRU
    the same per-element slices as the raw path's grid."""

    def __init__(self, prefix_length=0, suffix_length=0,
                 max_sequence_length=2, dynamic_sample_length=False,
                 event_representation_depth=9, activation='relu',
                 base_channels=32, hidden_channels=32, plain_ops=False,
                 generator=None, device=None, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.prefix_length = prefix_length
        self.suffix_length = suffix_length
        self.max_sequence_length = max_sequence_length
        self.dynamic_sample_length = dynamic_sample_length
        self.depth = event_representation_depth
        self.hidden_channels = hidden_channels
        self.act = get_activation(activation)
        self.quantization_layer = QuantizationLayer(
            depth=self.depth, plain_ops=plain_ops, generator=generator,
            dtype=self.dtype)
        self.embed = Conv(self.depth, hidden_channels, 3, generator,
                          dtype=self.dtype)
        self.gru = ConvGRUCell(hidden_channels, generator, dtype=self.dtype)
        self.predictor = Predictor(hidden_channels, base_channels, generator,
                                   dtype=self.dtype, activation=activation,
                                   plain_ops=plain_ops)
        if device is not None:
            self.to(device)

    # the dense [B, L*C, H, W] float32 grid, as EVFlowNet's
    quantize = evflownet.Model.quantize

    def forward(self, events, timestamps, sample_idx,
                imsize: Tuple[int, int], raw: bool = True,
                intermediate: bool = False):
        imsize = tuple(imsize)
        batch_size = batch_size_of(timestamps, self.max_sequence_length)
        L, C = self.max_sequence_length, self.depth
        if raw:
            grid = self.quantization_layer(events, timestamps, sample_idx,
                                           imsize, L, batch_size)
        else:
            grid = events.to(self.dtype)
        h = torch.zeros(batch_size, self.hidden_channels, *imsize,
                        dtype=self.dtype, device=grid.device)
        state = h
        for e in range(L):
            x = self.act(self.embed(grid[:, e * C:(e + 1) * C]))
            h = self.gru(h, x)
            if e == self.prefix_length:
                state = h
        flows, features = self.predictor(state)
        flow_ts, flow_sample_idx = predicted_windows(
            timestamps, sample_idx, batch_size, self.prefix_length)
        if intermediate:
            return tuple(flows), flow_ts, flow_sample_idx, tuple(features)
        return tuple(flows), flow_ts, flow_sample_idx


class OpticalFlow(BaseOpticalFlow):
    """Inference wrapper for RecurrentFlowNet.  Inference windows carry
    one element each, so the recurrence takes a single ConvGRU step."""

    def __init__(self, imsize, model=None, activation='relu',
                 event_representation_depth=9, max_sequence_length=1,
                 **kwargs):
        super().__init__(
            imsize, Model, model=model, activation=activation,
            event_representation_depth=event_representation_depth,
            max_sequence_length=max_sequence_length, **kwargs)
