"""EVFlowNet: a learnable event representation and a conv UNet with four
flow heads.

Counterpart of ``EVFlowNet/net.py`` (``mish``, ``get_activation``,
``DenseParams``, ``QuantizationLayer``, ``ResBlock``, ``Predictor``,
``Model`` with ``quantize`` and dense input, ``compute_event_image``) and
of its plugin's ``OpticalFlow``, in NCHW.
The voxel grid's channel index is ``l * C + c`` for element ``l`` and
temporal channel ``c``, the order of the JAX model's ``[B, H, W, L*C]``.
Parameter names follow the flax tree (``predictor.enc0.weight``,
``quantization_layer.kernel_hidden1.kernel``, ...) so that
``utils/convert.py`` maps one onto the other name by name.  Convolutions
use flax's ``'SAME'`` padding and every initialiser follows flax: a
truncated-normal ``lecun_normal`` (variance 1/fan_in), normal(1e-2) for
``kernel_out``, normal(1e-3) for the flow heads, zero biases.

On CUDA the quantization layer runs the K2 kernel-MLP and the K1 voxelize
kernels; ``plain_ops=True`` runs their plain PyTorch twins instead, as the
reference path that a kernel run is compared with.

``dtype`` ('float32' or 'bfloat16') is the compute type, flax's ``dtype``:
the parameters stay float32 (flax's ``param_dtype``) and are cast where
the JAX model casts them.  Each ``Conv`` casts its input, weight and bias;
the kernel-MLP runs in float32 and its output is cast, as the TPU
kernel's path does; the voxel grid is accumulated in float32 and cast;
the upsampled flow is cast before the decoder's concatenation; the flow
heads stay float32.  The activation ('relu' or 'mish') runs in the
compute type, where flax applies it.
"""
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernel_mlp_cuda, voxel_cuda
from ..ops.segment import segment_starts
from .optical_flow import BaseOpticalFlow

# standard deviation of a standard normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(tensor, fan_in, generator):
    """flax ``lecun_normal``: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def get_activation(name):
    if callable(name):
        return name
    return {'relu': F.relu, 'mish': mish}[name]


def upsample2x_nearest(x):
    """Exact 2x nearest-neighbour upsample of ``[B, C, H, W]``."""
    B, C, H, W = x.shape
    x = x[:, :, :, None, :, None].expand(B, C, H, 2, W, 2)
    return x.reshape(B, C, 2 * H, 2 * W)


def _same_pads(size, kernel, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class DenseParams(nn.Module):
    """The weights of one dense layer, kept in flax's ``[in, out]``
    layout (the K2 kernel reads that layout); the caller does the math."""

    def __init__(self, features_in, features_out, generator, std=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features_out))
        self.bias = nn.Parameter(torch.zeros(features_out))
        with torch.no_grad():
            if std is None:
                lecun_normal_(self.kernel, features_in, generator)
            else:
                nn.init.normal_(self.kernel, 0.0, std, generator=generator)

    def forward(self):
        return self.kernel, self.bias


class Conv(nn.Module):
    """2-D convolution with flax ``nn.Conv``'s 'SAME' padding and init.

    On an even input a stride-2 3x3 convolution pads (0, 1), not (1, 1).
    The input, weight and bias are cast to ``dtype``.  Below float32 the
    bias is added to the rounded convolution, where flax adds it; in
    float32 the convolution adds it itself.
    """

    def __init__(self, features_in, features_out, kernel_size, generator,
                 stride=1, std=None, dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features_out, features_in,
                                               k, k))
        self.bias = nn.Parameter(torch.zeros(features_out))
        with torch.no_grad():
            if std is None:
                lecun_normal_(self.weight, features_in * k * k, generator)
            else:
                nn.init.normal_(self.weight, 0.0, std, generator=generator)

    def forward(self, x):
        k = self.weight.shape[-1]
        x = x.to(self.dtype)
        weight = self.weight.to(self.dtype)
        bias = self.bias.to(self.dtype)
        top, bottom = _same_pads(x.shape[-2], k, self.stride)
        left, right = _same_pads(x.shape[-1], k, self.stride)
        if (top, left) != (bottom, right):
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        if self.dtype == torch.float32:
            return F.conv2d(x, weight, bias, self.stride, padding=(top, left))
        y = F.conv2d(x, weight, None, self.stride, padding=(top, left))
        return y + bias[:, None, None]


class QuantizationLayer(nn.Module):
    """Learnable event -> voxel-grid representation.

    Each event adds ``(tri(delta_c) + mlp(delta_c)) * polarity`` to channel
    ``c`` at its pixel, where ``delta_c = t_norm - c / (C - 1)`` and
    ``t_norm`` places the event in its element's frame window.  Returns
    ``[B, L*C, H, W]``.
    """

    def __init__(self, depth=9, hidden=30, plain_ops=False, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.depth = depth
        self.plain_ops = plain_ops
        self.dtype = dtype
        self.kernel_hidden1 = DenseParams(1, hidden, generator)
        self.kernel_hidden2 = DenseParams(hidden, hidden, generator)
        self.kernel_out = DenseParams(hidden, 1, generator, std=1e-2)

    def forward(self, events, timestamps, sample_idx, imsize,
                num_elements: int, batch_size: int):
        H, W = imsize
        C = self.depth
        L = num_elements
        B = batch_size

        # --- element time windows -------------------------------------
        starts = segment_starts(sample_idx, B)                     # [B]
        valid = events.sample_index < B                            # padding
        safe_sample = events.sample_index.clamp(0, B - 1)
        safe_elem = events.element_index.clamp(0, L - 1)
        ts_base = (starts[safe_sample.long()] + safe_elem).long()
        t0 = timestamps[ts_base]
        t1 = timestamps[ts_base + 1]
        denom = torch.clamp(t1 - t0, min=1e-9)
        t_norm = ((events.timestamp - t0) / denom).clamp(0.0, 1.0)  # [E]

        # --- learnable temporal kernel, channel-major [C, E] ------------
        centers = torch.arange(C, dtype=torch.float32,
                               device=t_norm.device) / max(C - 1, 1)
        delta = t_norm[None, :] - centers[:, None]                 # [C, E]
        w1, b1 = self.kernel_hidden1()
        w2, b2 = self.kernel_hidden2()
        w3, b3 = self.kernel_out()
        mlp = kernel_mlp_cuda.plain if self.plain_ops \
            else kernel_mlp_cuda.kernel_mlp
        k_out = mlp(delta, w1, b1, w2, b2, w3, b3).to(self.dtype)
        # residual triangular kernel: the init stays near the classic
        # voxel grid
        tri = torch.clamp(1.0 - delta.abs() * max(C - 1, 1), min=0.0)
        value = (tri.to(self.dtype) + k_out) \
            * events.polarity[None, :].to(self.dtype)
        value = torch.where(valid[None, :], value, 0.0)
        value = value.T.contiguous()                                # [E, C]

        # --- voxel binning ----------------------------------------------
        plane = safe_sample * L + safe_elem
        vox = voxel_cuda.plain if self.plain_ops else voxel_cuda.voxelize
        grid = vox(events.x, events.y, plane, value, valid, B * L, H, W)
        # [B*L, H, W, C] -> [B, L*C, H, W], channel l*C + c
        grid = grid.reshape(B, L, H, W, C).to(self.dtype) \
            .permute(0, 1, 4, 2, 3)
        return grid.reshape(B, L * C, H, W)


class ResBlock(nn.Module):

    def __init__(self, channels, generator, dtype=torch.float32, act=F.relu):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(channels, channels, 3, generator, dtype=dtype)
        self.Conv_1 = Conv(channels, channels, 3, generator, dtype=dtype)

    def forward(self, x):
        h = self.act(self.Conv_0(x))
        return self.act(x + self.Conv_1(h))


class Predictor(nn.Module):
    """Conv encoder-decoder with flow heads at 1/8, 1/4, 1/2 and full
    resolution (NCHW), computing in ``dtype`` but for the float32 flow
    heads; ``activation`` is 'relu' or 'mish'."""

    def __init__(self, in_channels, base_channels=64, generator=None,
                 dtype=torch.float32, activation='relu'):
        super().__init__()
        self.dtype = dtype
        self.act = get_activation(activation)
        b = base_channels
        enc = (b, 2 * b, 4 * b, 8 * b)
        cin = in_channels
        for i, ch in enumerate(enc):
            setattr(self, f'enc{i}', Conv(cin, ch, 3, generator, stride=2,
                                          dtype=dtype))
            cin = ch
        self.res0 = ResBlock(8 * b, generator, dtype, self.act)
        self.res1 = ResBlock(8 * b, generator, dtype, self.act)
        cin = 8 * b
        for i, ch in enumerate((4 * b, 2 * b, b, b // 2)):
            skip = enc[2 - i] if i < 3 else 0
            flow = 2 if i > 0 else 0
            setattr(self, f'dec{i}',
                    Conv(cin + skip + flow, ch, 3, generator, dtype=dtype))
            setattr(self, f'flow{i}', Conv(ch, 2, 1, generator, std=1e-3))
            cin = ch

    def forward(self, x):
        skips = []
        for i in range(4):
            x = self.act(getattr(self, f'enc{i}')(x))
            skips.append(x)
        x = self.res1(self.res0(x))

        flows, features = [], []
        flow = None
        for i in range(4):
            parts = [upsample2x_nearest(x)]
            if i < 3:
                parts.append(skips[2 - i])        # 1/8, 1/4, 1/2 resolution
            if flow is not None:
                # cast, or the concatenation would promote to float32
                parts.append((upsample2x_nearest(flow) * 2.0).to(self.dtype))
            x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
            x = self.act(getattr(self, f'dec{i}')(x))
            features.append(x)
            flow = getattr(self, f'flow{i}')(x.float())   # heads in fp32
            flows.append(flow)
        return flows, features


def compute_dtype(dtype):
    """The torch compute type of a model's ``dtype`` name."""
    if dtype not in ('float32', 'bfloat16'):
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', got "
                         f'{dtype!r}')
    return getattr(torch, dtype)


def batch_size_of(timestamps, max_sequence_length):
    """Samples in a batch of ``max_sequence_length + 1`` timestamp slots
    each."""
    num_timestamps = max_sequence_length + 1
    if timestamps.shape[0] % num_timestamps:
        raise ValueError('timestamps must hold (sequence_length + 1) '
                         'entries per sample')
    return timestamps.shape[0] // num_timestamps


def predicted_windows(timestamps, sample_idx, batch_size, prefix_length):
    """``(flow_ts, flow_sample_idx)`` of the plugin contract: each
    sample's prediction spans the timestamps at local indices
    ``prefix_length`` and ``prefix_length + 1`` of its block."""
    starts = segment_starts(sample_idx, batch_size).long() + prefix_length
    flow_ts = torch.stack([timestamps[starts], timestamps[starts + 1]],
                          dim=1)
    flow_sample_idx = torch.arange(batch_size, dtype=torch.int32,
                                   device=timestamps.device)
    return flow_ts, flow_sample_idx


class Model(nn.Module):
    """EVFlowNet on raw padded events or on dense voxel grids.

    ``forward`` returns ``(flows, flow_ts, flow_sample_idx)``, plus the
    decoder features when ``intermediate``: flows are ``[B, 2, H/2^i,
    W/2^i]`` for i = 3..0, ``flow_ts`` ``[B, 2]`` the (start, stop)
    timestamps of each prediction (the element after the
    ``prefix_length`` context elements), ``flow_sample_idx``
    ``arange(B)``.  The predictor sees the ``max_sequence_length``
    elements' grids stacked on the channel axis.  With ``raw=False``
    ``events`` is that dense ``[B, L*C, H, W]`` grid already (a baked
    shard's, ``quantize``'s, or ``compute_event_image``'s), cast to the
    compute type on its device; the quantization layer is not run.
    """

    def __init__(self, prefix_length=0, suffix_length=0,
                 max_sequence_length=1, dynamic_sample_length=False,
                 event_representation_depth=9, activation='relu',
                 base_channels=64, plain_ops=False, generator=None,
                 device=None, dtype='float32'):
        super().__init__()
        compute = compute_dtype(dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.prefix_length = prefix_length
        self.suffix_length = suffix_length
        self.max_sequence_length = max_sequence_length
        self.dynamic_sample_length = dynamic_sample_length
        depth = event_representation_depth
        self.quantization_layer = QuantizationLayer(
            depth=depth, plain_ops=plain_ops, generator=generator,
            dtype=compute)
        self.predictor = Predictor(depth * max_sequence_length,
                                   base_channels, generator, dtype=compute,
                                   activation=activation)
        if device is not None:
            self.to(device)

    def quantize(self, events, timestamps, sample_idx,
                 imsize: Tuple[int, int]):
        """The learned representation baked into a dense ``[B, L*C, H, W]``
        float32 grid (``EVFlowNet/net.py`` ``Model.quantize``): the
        quantization layer's output in the compute type, then float32."""
        batch_size = batch_size_of(timestamps, self.max_sequence_length)
        grid = self.quantization_layer(events, timestamps, sample_idx,
                                       tuple(imsize),
                                       self.max_sequence_length, batch_size)
        return grid.float()

    def forward(self, events, timestamps, sample_idx,
                imsize: Tuple[int, int], raw: bool = True,
                intermediate: bool = False):
        batch_size = batch_size_of(timestamps, self.max_sequence_length)
        if raw:
            grid = self.quantization_layer(
                events, timestamps, sample_idx, tuple(imsize),
                self.max_sequence_length, batch_size)
        else:
            grid = events.to(self.predictor.dtype)
        flows, features = self.predictor(grid)
        flow_ts, flow_sample_idx = predicted_windows(
            timestamps, sample_idx, batch_size, self.prefix_length)
        if intermediate:
            return tuple(flows), flow_ts, flow_sample_idx, tuple(features)
        return tuple(flows), flow_ts, flow_sample_idx


class OpticalFlow(BaseOpticalFlow):
    """Inference wrapper for EVFlowNet (``EVFlowNet/__init__.py``)."""

    def __init__(self, imsize, model=None, activation='relu',
                 event_representation_depth=9, **kwargs):
        super().__init__(
            imsize, Model, model=model, activation=activation,
            event_representation_depth=event_representation_depth, **kwargs)


def compute_event_image(events, start_ts, stop_ts, shape, depth=9,
                        **_ignored):
    """Host-side event->image conversion for the --ev_images pipeline.

    The port's copy of ``EVFlowNet/net.py`` ``compute_event_image``: the
    NumPy analogue of the quantization layer with the fixed triangular
    kernel (the representation the learnable kernel is initialised to).

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
    C = depth
    out = np.zeros((L, C, H, W), np.float32)
    x = events[:, 0].astype(np.int64)
    y = events[:, 1].astype(np.int64)
    t = events[:, 2]
    p = events[:, 3]
    e = events[:, 4].astype(np.int64)
    start_ts = np.asarray(start_ts)
    stop_ts = np.asarray(stop_ts)
    denom = np.maximum(stop_ts[e] - start_ts[e], 1e-9)
    t_norm = np.clip((t - start_ts[e]) / denom, 0.0, 1.0)
    centers = np.arange(C, dtype=np.float32) / max(C - 1, 1)
    weight = np.maximum(0.0, 1.0 - np.abs(t_norm[:, None] - centers[None])
                        * max(C - 1, 1))
    values = weight * p[:, None]
    flat = (((e[:, None] * C + np.arange(C)[None]) * H + y[:, None]) * W
            + x[:, None])
    np.add.at(out.reshape(-1), flat.reshape(-1).astype(np.int64),
              values.reshape(-1))
    return out
