"""Plain E-RAFT in float32 PyTorch: the reference that the port's
``models/eraft.py`` and the benchmark's ``portbench/configs/eraft.py`` are
tested against.  It imports nothing of the port and no JAX.

Written from RAFT's ``core/{corr,extractor,update,raft}.py`` as E-RAFT
(arXiv:2108.10552) uses them, with the port's parameter names so that one
weight dict loads into all three, and with the departures that
``models/eraft.py``'s docstring lists: the learnable event representation
in front, the framework's multi-scale self-supervised loss behind, the mask
head after the last iteration only, batch norm's scale ``1 + s``, and the
lookup's coordinates normalised for ``align_corners=False``.  A batch is a
dict of the real events alone (``events``: ``x``, ``y``, ``timestamp``,
``polarity``, ``element_index``, ``sample_index``), ``timestamps``,
``sample_idx``, ``images`` ``[slots, 1, H, W]``, ``first`` (each sample's
first slot) and ``size``.  Call ``torch.backends.cuda.matmul.allow_tf32 =
False`` and ``torch.backends.cudnn.allow_tf32 = False`` before running it
on a card.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

ALPHA, EPSILON = 0.45, 1e-3


def conv_leaves(module, cin, cout, kh, kw):
    module.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
    module.bias = nn.Parameter(torch.zeros(cout))


class Conv(nn.Module):

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        conv_leaves(self, cin, cout, kh, kw)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    """Training-mode batch norm: the batch's statistics, scale ``1 + s``."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
        scale = (1 + self.weight)[None, :, None, None]
        return (x - mean) / torch.sqrt(var + 1e-5) * scale \
            + self.bias[None, :, None, None]


class InstanceNorm(nn.Module):
    """Statistics about each map's first value, as the port takes them: a
    constant map normalises to exactly 0."""

    def forward(self, x):
        x = x - x[..., :1, :1].detach()
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5)


def norm(kind, channels):
    return BatchNorm(channels) if kind == 'batch' else InstanceNorm()


class ResidualBlock(nn.Module):

    def __init__(self, cin, cout, kind, stride):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, 1)
        self.conv2 = Conv(cout, cout, 3, 1, 1)
        self.norm1, self.norm2 = norm(kind, cout), norm(kind, cout)
        self.downsample = None
        if stride != 1:
            self.downsample = Conv(cin, cout, 1, stride)
            self.norm3 = norm(kind, cout)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):

    def __init__(self, cin, out, kind):
        super().__init__()
        self.conv1 = Conv(cin, 64, 7, 2, 3)
        self.norm1 = norm(kind, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, kind, 1),
                                    ResidualBlock(64, 64, kind, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, kind, 2),
                                    ResidualBlock(96, 96, kind, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, kind, 2),
                                    ResidualBlock(128, 128, kind, 1))
        self.conv2 = Conv(128, out, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class MotionEncoder(nn.Module):

    def __init__(self, corr_planes):
        super().__init__()
        self.convc1 = Conv(corr_planes, 256, 1)
        self.convc2 = Conv(256, 192, 3, padding=1)
        self.convf1 = Conv(2, 128, 7, padding=3)
        self.convf2 = Conv(128, 64, 3, padding=1)
        self.conv = Conv(256, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):

    def __init__(self):
        super().__init__()
        self.convz1 = Conv(384, 128, (1, 5), padding=(0, 2))
        self.convr1 = Conv(384, 128, (1, 5), padding=(0, 2))
        self.convq1 = Conv(384, 128, (1, 5), padding=(0, 2))
        self.convz2 = Conv(384, 128, (5, 1), padding=(2, 0))
        self.convr2 = Conv(384, 128, (5, 1), padding=(2, 0))
        self.convq2 = Conv(384, 128, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz1(hx))
        r = torch.sigmoid(self.convr1(hx))
        q = torch.tanh(self.convq1(torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz2(hx))
        r = torch.sigmoid(self.convr2(hx))
        q = torch.tanh(self.convq2(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class FlowHead(nn.Module):

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(128, 256, 3, padding=1)
        self.conv2 = Conv(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):

    def __init__(self, corr_planes):
        super().__init__()
        self.encoder = MotionEncoder(corr_planes)
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(Conv(128, 256, 3, padding=1), nn.ReLU(),
                                  Conv(256, 576, 1))


class Dense(nn.Module):

    def __init__(self, fin, fout):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class Representation(nn.Module):
    """Each event adds ``(tri(d) + mlp(d)) * polarity`` to channel ``c`` of
    its pixel, ``d = t_norm - c / (C - 1)``: the grid ``[B, L * C, H, W]``,
    channel ``l * C + c``."""

    def __init__(self, depth, hidden):
        super().__init__()
        self.depth = depth
        self.kernel_hidden1 = Dense(1, hidden)
        self.kernel_hidden2 = Dense(hidden, hidden)
        self.kernel_out = Dense(hidden, 1)

    def forward(self, batch, L, H, W):
        C, B, ev = self.depth, batch['size'], batch['events']
        slot = batch['first'][ev['sample_index']] + ev['element_index']
        t0, t1 = batch['timestamps'][slot], batch['timestamps'][slot + 1]
        t_norm = ((ev['timestamp'] - t0)
                  / torch.clamp(t1 - t0, min=1e-9)).clamp(0.0, 1.0)
        d = t_norm[:, None] - torch.arange(C, dtype=torch.float32,
                                           device=t_norm.device) / (C - 1)
        h = torch.tanh(self.kernel_hidden1(d[..., None]))
        mlp = self.kernel_out(torch.tanh(self.kernel_hidden2(h)))[..., 0]
        tri = torch.clamp(1.0 - d.abs() * (C - 1), min=0.0)
        value = (tri + mlp) * ev['polarity'][:, None]
        plane = ev['sample_index'] * L + ev['element_index']
        cell = (plane * H + ev['y']) * W + ev['x']
        grid = value.new_zeros(B * L * H * W, C) \
            .index_add(0, cell, value)
        return grid.reshape(B, L, H, W, C).permute(0, 1, 4, 2, 3) \
            .reshape(B, L * C, H, W)


def bilinear_sampler(img, coords):
    """RAFT's sampler at pixel coordinates (x, y), zeros outside,
    normalised for ``align_corners=False``."""
    H, W = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    grid = torch.cat([(2 * xgrid + 1) / W - 1, (2 * ygrid + 1) / H - 1],
                     dim=-1)
    return F.grid_sample(img, grid, align_corners=False)


class ERAFT(nn.Module):

    def __init__(self, depth=15, hidden=30, iterations=12, levels=4,
                 radius=4, prefix=1):
        super().__init__()
        self.depth, self.iterations = depth, iterations
        self.levels, self.radius, self.prefix = levels, radius, prefix
        self.quantization_layer = Representation(depth, hidden)
        self.fnet = BasicEncoder(depth, 256, 'instance')
        self.cnet = BasicEncoder(depth, 256, 'batch')
        self.update_block = UpdateBlock(levels * (2 * radius + 1) ** 2)

    def lookup(self, pyramid, coords):
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)
        batch, h1, w1, _ = coords.shape
        out = []
        for i, corr in enumerate(pyramid):
            dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            delta = torch.stack(torch.meshgrid(dy, dx, indexing='ij'),
                                dim=-1)
            centroid = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
            sampled = bilinear_sampler(corr, centroid
                                       + delta.view(1, 2 * r + 1,
                                                    2 * r + 1, 2))
            out.append(sampled.view(batch, h1, w1, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2)

    def dense(self, grid):
        """The four flows, coarse first, of a ``[B, 2 C, H, W]`` grid."""
        C, B = self.depth, grid.shape[0]
        fmap1, fmap2 = self.fnet(torch.cat([grid[:, :C], grid[:, C:]], 0)) \
            .split(B)
        cnet = self.cnet(grid[:, C:])
        net, inp = torch.tanh(cnet[:, :128]), F.relu(cnet[:, 128:])
        _, D, h, w = fmap1.shape
        corr = torch.matmul(fmap1.reshape(B, D, h * w).transpose(1, 2),
                            fmap2.reshape(B, D, h * w))
        pyramid = [corr.reshape(B * h * w, 1, h, w) / math.sqrt(D)]
        for _ in range(self.levels - 1):
            pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
        ys, xs = torch.meshgrid(torch.arange(h, device=grid.device),
                                torch.arange(w, device=grid.device),
                                indexing='ij')
        coords0 = torch.stack([xs, ys]).to(grid.dtype)[None].repeat(B, 1, 1, 1)
        coords1 = coords0.clone()
        block = self.update_block
        for _ in range(self.iterations):
            coords1 = coords1.detach()
            corr = self.lookup(pyramid, coords1)
            flow = coords1 - coords0
            motion = block.encoder(flow, corr)
            net = block.gru(net, torch.cat([inp, motion], dim=1))
            coords1 = coords1 + block.flow_head(net)
        flow = coords1 - coords0
        mask = 0.25 * block.mask(net)
        mask = torch.softmax(mask.view(B, 1, 9, 8, 8, h, w), dim=2)
        up = F.unfold(8 * flow, [3, 3], padding=1).view(B, 2, 9, 1, 1, h, w)
        up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3) \
            .reshape(B, 2, 8 * h, 8 * w)
        return [flow, F.avg_pool2d(up, 4) / 4, F.avg_pool2d(up, 2) / 2, up]

    def forward(self, batch):
        """``(flows, flow_ts [B, 2], flow_sample_idx [B])``."""
        H, W = batch['images'].shape[-2:]
        grid = self.quantization_layer(batch, 2, H, W)
        s = batch['first'] + self.prefix
        ts = batch['timestamps']
        return (self.dense(grid), torch.stack([ts[s], ts[s + 1]], dim=1),
                torch.arange(batch['size'], device=ts.device))


def charbonnier(d):
    return (d * d + EPSILON * EPSILON) ** ALPHA


def scale_terms(prev, nxt, flow):
    """``losses/loss.py``'s smoothness, photometric and out-of-border
    terms at one scale."""
    N, _, h, w = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=flow.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=flow.device), indexing='ij')
    gx = (xs + flow[:, 0]) / ((w - 1) / 2.0) - 1.0
    gy = (ys + flow[:, 1]) / ((h - 1) / 2.0) - 1.0
    grid = torch.stack([gx, gy], dim=-1)
    warped = F.grid_sample(nxt, grid, mode='bilinear', padding_mode='zeros',
                           align_corners=True)
    photometric = charbonnier(warped - prev).mean()
    smoothness = (charbonnier(flow[..., :, 1:] - flow[..., :, :-1]).mean()
                  + charbonnier(flow[..., 1:, :] - flow[..., :-1, :]).mean()
                  + charbonnier(flow[..., 1:, 1:] - flow[..., :-1, :-1])
                  .mean()
                  + charbonnier(flow[..., :-1, 1:] - flow[..., 1:, :-1])
                  .mean()) / 4
    outside = ((grid < -1) | (grid > 1)).any(dim=-1)
    den = outside.reshape(N, -1).sum(dim=1) * 2 * N
    value = charbonnier(flow) / torch.where(den > 0, den, 1)[:, None, None,
                                                             None]
    keep = outside[:, None] & (den > 0)[:, None, None, None]
    return smoothness, photometric, torch.where(keep, value, 0.0).sum()


def multiscale_loss(flows, flow_ts, flow_sample_idx, batch,
                    weights=(0.5, 1.0, 1.0)):
    """``(loss, (smoothness[S], photometric[S], out_border[S]))``: each
    scale's frames resized from the previous scale's (bilinear, aligned
    corners), the start and end frame of each prediction matched by its
    sample and timestamps."""
    same = (batch['sample_idx'][None, :, None]
            == flow_sample_idx[None, None, :]) \
        & (batch['timestamps'][None, :, None] == flow_ts.T[:, None, :])
    start, stop = same.int().argmax(dim=1)
    images = batch['images']
    terms = []
    for flow in flows:
        if tuple(images.shape[-2:]) != tuple(flow.shape[-2:]):
            images = F.interpolate(images, size=flow.shape[-2:],
                                   mode='bilinear', align_corners=True)
        terms.append(scale_terms(images[start], images[stop], flow))
    terms = tuple(zip(*terms))
    return sum(w * (sum(t) / len(t)) for t, w in zip(terms, weights)), terms
