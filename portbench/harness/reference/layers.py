"""Plain PyTorch layers of the reference network.

Written from the network's definition (the EV-FlowNet encoder-decoder
and its learnable event representation), with the parameter names of the
port's modules, so that one set of weights loads into both.  No kernel,
no fixed-capacity buffer: the representation sums the real events of a
batch with ``index_add``.  Every layer computes in float32; ``rnd``
rounds where a lower compute type would round (``precision.py``): each
convolution's input, weight and output, a residual sum and the voxel
grid.  The flow heads stay float32, as in the bf16 recipe.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import FP32

# standard deviation of a standard normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978


def same_pads(size, kernel, stride):
    """(before, after) padding of 'SAME' convolution (TensorFlow, flax):
    an even input under a stride-2 3x3 kernel pads (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """'SAME' 2-D convolution, weight ``[out, in, k, k]``."""

    output_axis = 0

    def __init__(self, cin, cout, k, stride=1, std=None, rnd=FP32):
        super().__init__()
        self.stride, self.std, self.rnd = stride, std, rnd
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def init_spec(self):
        """``{leaf: std}``: the weight drawn normal with that std (lecun
        normal, variance 1/fan_in, truncated at two stds, where no std is
        given), the bias zero."""
        w = self.weight
        if self.std is None:
            return {'weight': ('truncated', math.sqrt(
                1.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
                / TRUNCATED_STD), 'bias': ('zeros', 0.0)}
        return {'weight': ('normal', self.std), 'bias': ('zeros', 0.0)}

    def forward(self, x):
        k = self.weight.shape[-1]
        top, bottom = same_pads(x.shape[-2], k, self.stride)
        left, right = same_pads(x.shape[-1], k, self.stride)
        x = F.pad(self.rnd(x), (left, right, top, bottom))
        y = self.rnd(F.conv2d(x, self.rnd(self.weight), None, self.stride))
        return self.rnd(y + self.rnd(self.bias)[:, None, None])


class Dense(nn.Module):
    """A dense layer's weights in ``[in, out]`` layout."""

    output_axis = 1

    def __init__(self, fin, fout, std=None):
        super().__init__()
        self.std = std
        self.kernel = nn.Parameter(torch.zeros(fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout))

    def init_spec(self):
        if self.std is None:
            return {'kernel': ('truncated', math.sqrt(
                1.0 / self.kernel.shape[0]) / TRUNCATED_STD),
                'bias': ('zeros', 0.0)}
        return {'kernel': ('normal', self.std), 'bias': ('zeros', 0.0)}

    def forward(self, x):
        return x @ self.kernel + self.bias


class Representation(nn.Module):
    """The learnable event representation: each event adds ``(tri(d) +
    mlp(d)) * polarity`` to temporal channel ``c`` of its pixel, ``d =
    t_norm - c / (C - 1)``, ``t_norm`` the event's place in its element's
    frame window, ``tri`` the triangular kernel of width ``1 / (C - 1)``
    and ``mlp`` a ``1 -> hidden -> hidden -> 1`` tanh network."""

    def __init__(self, depth, hidden, rnd=FP32):
        super().__init__()
        self.depth, self.rnd = depth, rnd
        self.kernel_hidden1 = Dense(1, hidden)
        self.kernel_hidden2 = Dense(hidden, hidden)
        self.kernel_out = Dense(hidden, 1, std=1e-2)

    def mlp(self, d):
        h = torch.tanh(self.kernel_hidden1(d[..., None]))
        h = torch.tanh(self.kernel_hidden2(h))
        return self.kernel_out(h)[..., 0]

    def forward(self, batch, elements, shape):
        """``[B, L * C, H, W]`` grid, channel ``l * C + c``."""
        H, W = shape
        C, L, B = self.depth, elements, batch['size']
        ev = batch['events']
        first = batch['first']                     # each sample's slot 0
        slot = first[ev['sample_index']] + ev['element_index']
        t0 = batch['timestamps'][slot]
        t1 = batch['timestamps'][slot + 1]
        t_norm = ((ev['timestamp'] - t0)
                  / torch.clamp(t1 - t0, min=1e-9)).clamp(0.0, 1.0)
        centers = torch.arange(C, dtype=torch.float32,
                               device=t_norm.device) / max(C - 1, 1)
        d = t_norm[:, None] - centers[None, :]                 # [E, C]
        tri = torch.clamp(1.0 - d.abs() * max(C - 1, 1), min=0.0)
        value = self.rnd(self.rnd(tri) + self.rnd(self.mlp(d))) \
            * ev['polarity'][:, None]
        plane = ev['sample_index'] * L + ev['element_index']
        cell = (plane * H + ev['y']) * W + ev['x']
        grid = torch.zeros(B * L * H * W, C, device=value.device)
        grid = grid.index_add(0, cell, value)
        grid = self.rnd(grid.reshape(B, L, H, W, C).permute(0, 1, 4, 2, 3))
        return grid.reshape(B, L * C, H, W)


class ResBlock(nn.Module):

    def __init__(self, channels, rnd=FP32):
        super().__init__()
        self.rnd = rnd
        self.Conv_0 = Conv(channels, channels, 3, rnd=rnd)
        self.Conv_1 = Conv(channels, channels, 3, rnd=rnd)

    def forward(self, x):
        h = F.relu(self.Conv_0(x))
        return F.relu(self.rnd(x + self.Conv_1(h)))


def upsample2x(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class Predictor(nn.Module):
    """EV-FlowNet's encoder-decoder: four stride-2 encoders (base, 2, 4
    and 8 times base channels), two residual blocks, four decoders that
    each take the upsampled features, the encoder skip and the previous
    flow upsampled and doubled, and a 1x1 float32 flow head after each:
    flows at 1/8, 1/4, 1/2 and full resolution."""

    def __init__(self, cin, base, rnd=FP32):
        super().__init__()
        self.rnd = rnd
        enc = (base, 2 * base, 4 * base, 8 * base)
        c = cin
        for i, ch in enumerate(enc):
            setattr(self, f'enc{i}', Conv(c, ch, 3, stride=2, rnd=rnd))
            c = ch
        self.res0 = ResBlock(8 * base, rnd)
        self.res1 = ResBlock(8 * base, rnd)
        c = 8 * base
        for i, ch in enumerate((4 * base, 2 * base, base, base // 2)):
            skip = enc[2 - i] if i < 3 else 0
            flow = 2 if i > 0 else 0
            setattr(self, f'dec{i}', Conv(c + skip + flow, ch, 3, rnd=rnd))
            setattr(self, f'flow{i}', Conv(ch, 2, 1, std=1e-3))
            c = ch

    def forward(self, x):
        skips = []
        for i in range(4):
            x = F.relu(getattr(self, f'enc{i}')(x))
            skips.append(x)
        x = self.res1(self.res0(x))
        flows, flow = [], None
        for i in range(4):
            parts = [upsample2x(x)]
            if i < 3:
                parts.append(skips[2 - i])
            if flow is not None:
                parts.append(self.rnd(upsample2x(flow) * 2.0))
            x = F.relu(getattr(self, f'dec{i}')(torch.cat(parts, dim=1)))
            flow = getattr(self, f'flow{i}')(x)
            flows.append(flow)
        return flows


def predicted_windows(batch, prefix):
    """``(flow_ts [B, 2], flow_sample_idx [B])``: each sample's prediction
    spans its timestamps ``prefix`` and ``prefix + 1``."""
    s = batch['first'] + prefix
    ts = batch['timestamps']
    return (torch.stack([ts[s], ts[s + 1]], dim=1),
            torch.arange(batch['size'], device=ts.device))


def init_specs(model):
    """``{parameter name: (kind, std)}`` of every leaf of ``model``."""
    specs = {}
    for prefix, module in model.named_modules():
        if hasattr(module, 'init_spec'):
            for leaf, spec in module.init_spec().items():
                specs[f'{prefix}.{leaf}' if prefix else leaf] = spec
    missing = set(dict(model.named_parameters())) - set(specs)
    if missing:
        raise ValueError(f'no init rule for {sorted(missing)}')
    return specs


def output_axes(model):
    """``{parameter name: output axis or None}``: gradient
    centralisation averages a leaf of two or more dimensions over every
    axis but this one."""
    axes = {}
    for prefix, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f'{prefix}.{leaf}' if prefix else leaf
            axes[name] = module.output_axis if p.dim() >= 2 else None
    return axes
