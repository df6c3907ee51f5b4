"""Plain reference of ``eraft.json``: E-RAFT (Gehrig et al., 3DV 2021,
arXiv:2108.10552), RAFT's correlation pyramid, separable ConvGRU update
and convex upsampling on two event volumes of the learnable event
representation.

The network as the port's ``models/eraft.py`` docstring gives it, with its
parameter names and its departures from E-RAFT (the framework's loss and
representation, the mask head after the last iteration only, batch norm's
scale ``1 + s`` drawn 0, the lookup normalised for ``align_corners=False``).
Batch norm runs on the batch's statistics, as in training; the running
statistics, which no training step reads, are not kept.  ``rnd`` rounds
where the port computes in the configuration's compute type: each
convolution's input, weight, bias and output, each norm's output, the
residual sums, the instance norm's shifted input, the GRU's gates,
products and sums, ``tanh`` of the hidden state and the flow fed to the
GRU.  The correlation, its pyramid, the
lookup, the coordinates and the upsampling stay float32.  Every
convolution is a ``Conv`` of ``layers.py`` (symmetric padding, rectangular
kernels), so ``flops.py`` counts each of every iteration.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from harness.reference.layers import Conv, Representation, predicted_windows


class SymConv(Conv):
    """A convolution with symmetric zero padding and a ``[out, in, kh,
    kw]`` weight drawn normal with std ``std``."""

    def __init__(self, cin, cout, kernel, std, rnd, stride=1, padding=0):
        super().__init__(cin, cout, 1, stride, std, rnd)
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.padding = padding

    def forward(self, x):
        rnd = self.rnd
        return rnd(F.conv2d(rnd(x), rnd(self.weight), rnd(self.bias),
                            self.stride, self.padding))


def _fan(cin, cout, kernel):
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    return cin * kh * kw, cout * kh * kw


def encoder_conv(cin, cout, kernel, rnd, stride=1, padding=0):
    """RAFT's encoder draw: ``kaiming_normal``, fan out, ReLU."""
    std = math.sqrt(2.0 / _fan(cin, cout, kernel)[1])
    return SymConv(cin, cout, kernel, std, rnd, stride, padding)


def update_conv(cin, cout, kernel, rnd, padding=0):
    """The update block's draw: PyTorch's default variance, 1/(3 fan_in)."""
    std = math.sqrt(1.0 / (3 * _fan(cin, cout, kernel)[0]))
    return SymConv(cin, cout, kernel, std, rnd, padding=padding)


class BatchNorm(nn.Module):

    def __init__(self, channels, rnd):
        super().__init__()
        self.rnd = rnd
        self.weight = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def init_spec(self):
        return {'weight': ('zeros', 0.0), 'bias': ('zeros', 0.0)}

    def forward(self, x):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
        y = (x - mean) / torch.sqrt(var + 1e-5) \
            * (1 + self.weight)[None, :, None, None] \
            + self.bias[None, :, None, None]
        return self.rnd(y)


class InstanceNorm(nn.Module):
    """Statistics about each map's first value, as the port takes them: a
    constant map (an empty event volume) normalises to exactly 0."""

    def __init__(self, rnd):
        super().__init__()
        self.rnd = rnd

    def forward(self, x):
        x = self.rnd(x - x[..., :1, :1].detach())
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
        return self.rnd((x - mean) / torch.sqrt(var + 1e-5))


def norm(kind, channels, rnd):
    return BatchNorm(channels, rnd) if kind == 'batch' else InstanceNorm(rnd)


class ResidualBlock(nn.Module):

    def __init__(self, cin, cout, kind, stride, rnd):
        super().__init__()
        self.rnd = rnd
        self.conv1 = encoder_conv(cin, cout, 3, rnd, stride, 1)
        self.conv2 = encoder_conv(cout, cout, 3, rnd, 1, 1)
        self.norm1, self.norm2 = norm(kind, cout, rnd), norm(kind, cout, rnd)
        self.downsample = None
        if stride != 1:
            self.downsample = encoder_conv(cin, cout, 1, rnd, stride)
            self.norm3 = norm(kind, cout, rnd)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(self.rnd(x + y))


class BasicEncoder(nn.Module):

    def __init__(self, cin, out, kind, rnd):
        super().__init__()
        self.conv1 = encoder_conv(cin, 64, 7, rnd, 2, 3)
        self.norm1 = norm(kind, 64, rnd)
        c = 64
        for i, (width, stride) in enumerate(((64, 1), (96, 2), (128, 2))):
            setattr(self, f'layer{i + 1}', nn.Sequential(
                ResidualBlock(c, width, kind, stride, rnd),
                ResidualBlock(width, width, kind, 1, rnd)))
            c = width
        self.conv2 = encoder_conv(128, out, 1, rnd)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class MotionEncoder(nn.Module):

    def __init__(self, corr_planes, rnd):
        super().__init__()
        self.rnd = rnd
        self.convc1 = update_conv(corr_planes, 256, 1, rnd)
        self.convc2 = update_conv(256, 192, 3, rnd, 1)
        self.convf1 = update_conv(2, 128, 7, rnd, 3)
        self.convf2 = update_conv(128, 64, 3, rnd, 1)
        self.conv = update_conv(256, 126, 3, rnd, 1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, self.rnd(flow)], dim=1)


class SepConvGRU(nn.Module):

    def __init__(self, rnd):
        super().__init__()
        self.rnd = rnd
        for axis, (kernel, pad) in enumerate((((1, 5), (0, 2)),
                                              ((5, 1), (2, 0))), 1):
            for gate in 'zrq':
                setattr(self, f'conv{gate}{axis}',
                        update_conv(384, 128, kernel, rnd, pad))

    def forward(self, h, x):
        rnd = self.rnd
        for axis in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z = rnd(torch.sigmoid(getattr(self, f'convz{axis}')(hx)))
            r = rnd(torch.sigmoid(getattr(self, f'convr{axis}')(hx)))
            q = rnd(torch.tanh(getattr(self, f'convq{axis}')(
                torch.cat([rnd(r * h), x], dim=1))))
            h = rnd(rnd(rnd(1 - z) * h) + rnd(z * q))
        return h


class FlowHead(nn.Module):

    def __init__(self, rnd):
        super().__init__()
        self.conv1 = update_conv(128, 256, 3, rnd, 1)
        self.conv2 = update_conv(256, 2, 3, rnd, 1)

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class UpdateBlock(nn.Module):

    def __init__(self, corr_planes, rnd):
        super().__init__()
        self.encoder = MotionEncoder(corr_planes, rnd)
        self.gru = SepConvGRU(rnd)
        self.flow_head = FlowHead(rnd)
        self.mask = nn.Sequential(update_conv(128, 256, 3, rnd, 1),
                                  nn.ReLU(), update_conv(256, 576, 1, rnd))


def lookup(pyramid, coords, radius):
    """Each level sampled at ``coords / 2^k + (d_i, d_j)`` (RAFT's order),
    bilinear, zeros outside: ``[B, levels * (2r + 1)^2, h, w]``."""
    B, _, h, w = coords.shape
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing='ij'), dim=-1)
    centre = coords.permute(0, 2, 3, 1).reshape(B * h * w, 1, 1, 2)
    out = []
    for k, corr in enumerate(pyramid):
        at = centre / 2 ** k + delta[None]
        n_y, n_x = corr.shape[-2:]
        grid = torch.stack([(2 * at[..., 0] + 1) / n_x - 1,
                            (2 * at[..., 1] + 1) / n_y - 1], dim=-1)
        sampled = F.grid_sample(corr, grid, mode='bilinear',
                                padding_mode='zeros', align_corners=False)
        out.append(sampled.reshape(B, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


class Model(nn.Module):

    def __init__(self, config, rnd):
        super().__init__()
        flags, sizes = config['flags'], config['model']
        self.rnd = rnd
        self.depth = flags['--event-representation-depth']
        self.elements = flags['--max-sequence-length']
        self.prefix = flags['--prefix-length']
        self.shape = (flags['--height'], flags['--width'])
        self.iterations = sizes['iterations']
        self.levels, self.radius = sizes['corr_levels'], sizes['corr_radius']
        self.hidden = sizes['hidden']
        self.quantization_layer = Representation(
            self.depth, sizes['kernel_mlp_hidden'], rnd)
        self.fnet = BasicEncoder(self.depth, sizes['feature'], 'instance',
                                 rnd)
        self.cnet = BasicEncoder(self.depth, sizes['hidden']
                                 + sizes['context'], 'batch', rnd)
        self.update_block = UpdateBlock(
            self.levels * (2 * self.radius + 1) ** 2, rnd)

    def dense(self, grid):
        """The network after the representation: flows, coarse first."""
        rnd, C, B = self.rnd, self.depth, grid.shape[0]
        fmap1, fmap2 = self.fnet(torch.cat([grid[:, :C], grid[:, C:]])) \
            .split(B)
        ctx = self.cnet(grid[:, C:])
        net = rnd(torch.tanh(ctx[:, :self.hidden]))
        inp = F.relu(ctx[:, self.hidden:])
        _, D, h, w = fmap1.shape
        corr = torch.matmul(fmap1.reshape(B, D, h * w).transpose(1, 2),
                            fmap2.reshape(B, D, h * w))
        pyramid = [corr.reshape(B * h * w, 1, h, w) / math.sqrt(D)]
        for _ in range(self.levels - 1):
            pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=grid.device),
            torch.arange(w, dtype=torch.float32, device=grid.device),
            indexing='ij')
        coords0 = torch.stack([xs, ys])[None].expand(B, 2, h, w)
        coords1 = coords0
        block = self.update_block
        for _ in range(self.iterations):
            coords1 = coords1.detach()
            corr = lookup(pyramid, coords1, self.radius)
            motion = block.encoder(coords1 - coords0, corr)
            net = block.gru(net, torch.cat([inp, motion], dim=1))
            coords1 = coords1 + block.flow_head(net)
        flow = coords1 - coords0
        mask = torch.softmax((0.25 * block.mask(net))
                             .reshape(B, 1, 9, 8, 8, h, w), dim=2)
        up = F.unfold(8 * flow, (3, 3), padding=1) \
            .reshape(B, 2, 9, 1, 1, h, w)
        up = (mask * up).sum(dim=2).permute(0, 1, 4, 2, 5, 3) \
            .reshape(B, 2, 8 * h, 8 * w)
        return [flow, F.avg_pool2d(up, 4) / 4, F.avg_pool2d(up, 2) / 2, up]

    def forward(self, batch):
        grid = self.quantization_layer(batch, self.elements, self.shape)
        return (self.dense(grid),) + predicted_windows(batch, self.prefix)


def build(config, rnd):
    return Model(config, rnd)
