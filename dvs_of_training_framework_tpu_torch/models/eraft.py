"""E-RAFT: dense optical flow from two event volumes with RAFT's
correlation pyramid and iterative update.

Gehrig, Millhaeusler, Gehrig and Scaramuzza, "E-RAFT: Dense Optical Flow
from Event Cameras", 3DV 2021 (arXiv:2108.10552), which is RAFT (Teed and
Deng, ECCV 2020, arXiv:2003.12039) fed with two consecutive event
volumes.  The widths are RAFT's (``core/{extractor,update,raft}.py``):

- the framework's ``QuantizationLayer`` makes the ``[B, 2 * C, H, W]``
  grid of a two-element sample; volume 1 is element 0, volume 2 element 1,
  and the prediction is element 1's window (``--prefix-length 1``);
- ``fnet``, a ``BasicEncoder`` with instance norm (no affine leaves), maps
  both volumes to 256 features at h x w = H/8 x W/8; ``cnet``, the same
  encoder with batch norm, maps volume 2 to ``tanh`` of 128 hidden and
  ``relu`` of 128 context channels;
- the all-pairs correlation ``fmap1^T fmap2 / sqrt(256)`` of shape
  ``[B * h * w, 1, h, w]`` and its pyramid of 4 levels (``avg_pool2d``
  2x2 each) are float32; the lookup samples level k bilinearly at
  ``coords1 / 2^k + (d_i, d_j)``, d in -4..4, zero outside: 324
  channels;
- 12 iterations of the update: the motion encoder, the separable
  ConvGRU (1x5 then 5x1), ``coords1 += FlowHead(h)``, each iteration
  starting from ``coords1.detach()``;
- the convex x8 upsampling of ``8 * (coords1 - coords0)`` with the mask
  head ``0.25 * conv(relu(conv(h)))``, softmaxed over its 9 taps.

The plugin contract's four flows, coarse first: the last iteration's
``coords1 - coords0`` at H/8, the upsampled flow pooled over 4x4 and 2x2
blocks and divided by 4 and by 2 at H/4 and H/2, the upsampled flow at H.

Departures from E-RAFT:

- the framework's learnable representation and its self-supervised
  multi-scale loss replace E-RAFT's fixed voxel grid and its supervised
  sequence loss (gamma 0.8) over every iteration's upsampled flow; the
  iterations before the last get gradient only through the hidden state
  and the correlation features;
- RANGER, the framework's optimizer, replaces AdamW;
- the mask head runs only after the last iteration, the one place a
  result uses it;
- assumed, not checked against E-RAFT's ``standard`` code: the lookup's
  window order (RAFT's: the first offset index moves x), and that the
  context encoder reads volume 2;
- the lookup normalises a coordinate c of a level of size n as
  ``(2c + 1) / n - 1`` for ``align_corners=False``: the same sampling as
  RAFT's ``bilinear_sampler`` (``2c / (n - 1) - 1`` with aligned
  corners), also where a level is one pixel wide (64 x 64 inputs);
- the weights are drawn normal: the encoders' convolutions with RAFT's
  ``kaiming_normal`` (fan out, ReLU), the update block's with the
  variance of PyTorch's default, ``1 / (3 fan_in)``; every bias is 0;
  batch norm's scale is ``1 + s`` with ``s`` a leaf drawn 0.

``dtype`` is the compute type, RAFT's own mixed-precision split under
``bfloat16``: the encoders and the update block's convolutions, their
norms and activations and the GRU's state run in it; the correlation
volume, its pyramid, the lookup, the coordinates, the upsampling and the
loss stay float32.  Batch norm's running statistics are non-persistent
buffers: ``state_dict()`` holds the parameters alone, the window's CUDA
graph updates them in place (``training/state.py`` captures
``model.buffers()``), and a checkpoint stores them beside the parameters
(``training/hooks.py``).
"""
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import evflownet
# the plugin's host-side image for --ev_images and its flow rendering
# are EVFlowNet's
from .evflownet import compute_event_image, vis_flow  # noqa: F401
from .evflownet import (QuantizationLayer, batch_size_of, compute_dtype,
                        predicted_windows)
from .optical_flow import BaseOpticalFlow

ENCODER_WIDTHS = (64, 96, 128)
FEATURES, HIDDEN, CONTEXT = 256, 128, 128
CORR_LEVELS, CORR_RADIUS = 4, 4


class Conv(nn.Conv2d):
    """A convolution with symmetric zero padding, drawn normal with std
    ``std`` (bias 0), computing in ``dtype``: the input, the weight and
    the bias are cast, the bias added inside the convolution."""

    def __init__(self, cin, cout, kernel, std, generator, stride=1,
                 padding=0, dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.compute = dtype
        with torch.no_grad():
            nn.init.normal_(self.weight, 0.0, std, generator=generator)
            self.bias.zero_()

    def reset_parameters(self):
        """The draw is ``__init__``'s, from its generator."""

    def forward(self, x):
        c = self.compute
        return F.conv2d(x.to(c), self.weight.to(c), self.bias.to(c),
                        self.stride, self.padding)


def encoder_conv(cin, cout, kernel, generator, dtype, stride=1, padding=0):
    """RAFT's encoder init: ``kaiming_normal`` over the fan out."""
    k = (kernel, kernel) if isinstance(kernel, int) else kernel
    std = math.sqrt(2.0 / (cout * k[0] * k[1]))
    return Conv(cin, cout, kernel, std, generator, stride, padding, dtype)


def update_conv(cin, cout, kernel, generator, dtype, padding=0):
    """The update block's init: the variance of PyTorch's default draw,
    ``1 / (3 fan_in)``."""
    k = (kernel, kernel) if isinstance(kernel, int) else kernel
    std = math.sqrt(1.0 / (3 * cin * k[0] * k[1]))
    return Conv(cin, cout, kernel, std, generator, padding=padding,
                dtype=dtype)


class BatchNorm(nn.Module):
    """Batch norm with scale ``1 + weight`` (``weight`` drawn 0) and shift
    ``bias``; its running statistics (momentum 0.1) are non-persistent
    buffers, used in eval mode."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels),
                             persistent=False)
        self.register_buffer('running_var', torch.ones(channels),
                             persistent=False)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            1.0 + self.weight, self.bias, self.training,
                            0.1, 1e-5)


class InstanceNorm(nn.Module):
    """Instance norm without affine leaves or running statistics, its
    statistics taken about each map's first value.  The norm does not see
    a shift, so this is the same function; and a constant map (an event
    volume without events) normalises to exactly 0, where the rounding
    residue of an unshifted mean would come out amplified by
    ``1 / sqrt(eps)``, forward and backward, and differ from one
    summation order to the next.  The shift carries no gradient: the
    norm's own is 0 along it."""

    def forward(self, x):
        return F.instance_norm(x - x[..., :1, :1].detach(), eps=1e-5)


def make_norm(kind, channels):
    return BatchNorm(channels) if kind == 'batch' else InstanceNorm()


class ResidualBlock(nn.Module):
    """``relu(x' + relu(n2(c2(relu(n1(c1(x)))))))``, 3x3 convolutions,
    ``c1`` and the 1x1 ``downsample`` (with ``norm3``) taking the
    stride."""

    def __init__(self, cin, cout, norm, stride, generator, dtype):
        super().__init__()
        self.conv1 = encoder_conv(cin, cout, 3, generator, dtype, stride, 1)
        self.conv2 = encoder_conv(cout, cout, 3, generator, dtype, 1, 1)
        self.norm1 = make_norm(norm, cout)
        self.norm2 = make_norm(norm, cout)
        self.downsample = None
        if stride != 1:
            self.downsample = encoder_conv(cin, cout, 1, generator, dtype,
                                           stride)
            self.norm3 = make_norm(norm, cout)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT's ``BasicEncoder``: a 7x7 stride-2 convolution, norm and ReLU,
    three layers of two residual blocks (64, 96 and 128 channels, the
    second and third downsampling), and a 1x1 convolution to ``out``."""

    def __init__(self, cin, out, norm, generator, dtype):
        super().__init__()
        self.conv1 = encoder_conv(cin, ENCODER_WIDTHS[0], 7, generator, dtype,
                                  2, 3)
        self.norm1 = make_norm(norm, ENCODER_WIDTHS[0])
        c = ENCODER_WIDTHS[0]
        for i, (width, stride) in enumerate(zip(ENCODER_WIDTHS, (1, 2, 2))):
            setattr(self, f'layer{i + 1}', nn.Sequential(
                ResidualBlock(c, width, norm, stride, generator, dtype),
                ResidualBlock(width, width, norm, 1, generator, dtype)))
            c = width
        self.conv2 = encoder_conv(c, out, 1, generator, dtype)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class MotionEncoder(nn.Module):
    """RAFT's ``BasicMotionEncoder``: 128 channels of correlation and flow
    features, the flow itself the last two."""

    def __init__(self, corr_planes, generator, dtype):
        super().__init__()
        self.convc1 = update_conv(corr_planes, 256, 1, generator, dtype)
        self.convc2 = update_conv(256, 192, 3, generator, dtype, 1)
        self.convf1 = update_conv(2, 128, 7, generator, dtype, 3)
        self.convf2 = update_conv(128, 64, 3, generator, dtype, 1)
        self.conv = update_conv(64 + 192, 128 - 2, 3, generator, dtype, 1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class SepConvGRU(nn.Module):
    """RAFT's ``SepConvGRU``: a horizontal (1x5) and then a vertical (5x1)
    GRU pass, each ``h = (1 - z) h + z tanh(cq([r h, x]))``."""

    def __init__(self, hidden, inputs, generator, dtype):
        super().__init__()
        cin = hidden + inputs
        for axis, (kernel, pad) in enumerate((((1, 5), (0, 2)),
                                              ((5, 1), (2, 0))), 1):
            for gate in 'zrq':
                setattr(self, f'conv{gate}{axis}', update_conv(
                    cin, hidden, kernel, generator, dtype, pad))

    def forward(self, h, x):
        for axis in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f'convz{axis}')(hx))
            r = torch.sigmoid(getattr(self, f'convr{axis}')(hx))
            q = torch.tanh(getattr(self, f'convq{axis}')(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):

    def __init__(self, generator, dtype):
        super().__init__()
        self.conv1 = update_conv(HIDDEN, 256, 3, generator, dtype, 1)
        self.conv2 = update_conv(256, 2, 3, generator, dtype, 1)

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class UpdateBlock(nn.Module):
    """RAFT's ``BasicUpdateBlock``; the mask head is called apart."""

    def __init__(self, corr_planes, generator, dtype):
        super().__init__()
        self.encoder = MotionEncoder(corr_planes, generator, dtype)
        self.gru = SepConvGRU(HIDDEN, CONTEXT + 128, generator, dtype)
        self.flow_head = FlowHead(generator, dtype)
        self.mask = nn.Sequential(
            update_conv(HIDDEN, 256, 3, generator, dtype, 1), nn.ReLU(),
            update_conv(256, 64 * 9, 1, generator, dtype))

    def forward(self, net, inp, corr, flow):
        """The next hidden state and its flow update (float32)."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net).float()


def correlation_pyramid(fmap1, fmap2, levels):
    """The float32 all-pairs correlation ``[B * h * w, 1, h, w]`` of two
    ``[B, D, h, w]`` feature maps over ``sqrt(D)``, and its
    ``levels - 1`` 2x2 average pools."""
    B, D, h, w = fmap1.shape
    corr = torch.matmul(fmap1.float().reshape(B, D, h * w).transpose(1, 2),
                        fmap2.float().reshape(B, D, h * w))
    pyramid = [corr.reshape(B * h * w, 1, h, w) / math.sqrt(D)]
    for _ in range(levels - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    return pyramid


def window_offsets(radius, device):
    """``[2r + 1, 2r + 1, 2]``: entry (i, j) is ``(d_i, d_j)``, d from -r
    to r, added to a pixel's (x, y): RAFT's order."""
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=device)
    return torch.stack(torch.meshgrid(d, d, indexing='ij'), dim=-1)


def lookup_grids(pyramid, radius):
    """Each level's ``(scale [2], shift [2r + 1, 2r + 1, 2])``: the level's
    sampling grid of pixel coordinates ``c`` is ``c * scale + shift``,
    ``(2 (c / 2^k + d) + 1) / n - 1`` for a level of size n (x by its
    width, y by its height).  Made on the device by kernels alone (fills,
    no copy from the host), so a graph capture may run it."""
    device = pyramid[0].device
    offsets = window_offsets(radius, device)
    grids = []
    for k, corr in enumerate(pyramid):
        size = torch.cat([torch.full((1,), float(n), device=device)
                          for n in (corr.shape[-1], corr.shape[-2])])
        grids.append((2 / (2 ** k * size), (2 * offsets + 1) / size - 1))
    return grids


def lookup(pyramid, grids, coords):
    """``[B, levels * (2r + 1)^2, h, w]`` float32: each level sampled
    bilinearly (zeros outside) in the window around ``coords / 2^k``,
    ``coords`` the ``[B, 2, h, w]`` (x, y) pixel coordinates, ``grids``
    ``lookup_grids``'."""
    B, _, h, w = coords.shape
    centre = coords.permute(0, 2, 3, 1).reshape(B * h * w, 1, 1, 2)
    out = []
    for corr, (scale, shift) in zip(pyramid, grids):
        grid = torch.addcmul(shift, centre, scale)
        sampled = F.grid_sample(corr, grid, mode='bilinear',
                                padding_mode='zeros', align_corners=False)
        out.append(sampled.reshape(B, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def pixel_grid(B, h, w, device):
    """``[B, 2, h, w]`` float32 (x, y) of each pixel."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing='ij')
    return torch.stack([xs, ys])[None].expand(B, 2, h, w)


def convex_upsample(flow, mask):
    """RAFT's ``upsample_flow``: ``[B, 2, 8h, 8w]`` from the flow ``[B, 2,
    h, w]`` and the mask ``[B, 576, h, w]``, both float32."""
    B, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(B, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, (3, 3), padding=1).reshape(B, 2, 9, 1, 1, h, w)
    up = (mask * up).sum(dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(B, 2, 8 * h, 8 * w)


def contract_flows(flow8, up):
    """The plugin contract's four flows from the H/8 flow and the upsampled
    one: H/8, H/4, H/2, H, each in its own scale's pixels."""
    return (flow8, F.avg_pool2d(up, 4) / 4, F.avg_pool2d(up, 2) / 2, up)


class Model(nn.Module):
    """E-RAFT on raw padded events or dense grids, ``forward`` and
    ``quantize`` as EVFlowNet's ``Model`` (the plugin contract of
    ``models/loader.py``).  A sample has two elements; a dense input is
    the ``[B, 2 * C, H, W]`` grid.  No option of the CLI sets
    ``iterations``: the tests take fewer.  The widths are the module's
    constants; ``portbench/configs/eraft.json``'s ``model`` block repeats
    them for the benchmark's reference, and a test holds the two equal."""

    def __init__(self, prefix_length=1, suffix_length=0,
                 max_sequence_length=2, dynamic_sample_length=False,
                 event_representation_depth=15, iterations=12,
                 plain_ops=False, generator=None, device=None,
                 dtype='float32'):
        super().__init__()
        if max_sequence_length != 2:
            raise ValueError('E-RAFT reads two event volumes a sample: '
                             '--max-sequence-length 2, not '
                             f'{max_sequence_length}')
        self.dtype = compute_dtype(dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.prefix_length = prefix_length
        self.suffix_length = suffix_length
        self.max_sequence_length = max_sequence_length
        self.dynamic_sample_length = dynamic_sample_length
        self.depth = event_representation_depth
        self.iterations = iterations
        self.quantization_layer = QuantizationLayer(
            depth=self.depth, plain_ops=plain_ops, generator=generator,
            dtype=self.dtype)
        self.fnet = BasicEncoder(self.depth, FEATURES, 'instance', generator,
                                 self.dtype)
        self.cnet = BasicEncoder(self.depth, HIDDEN + CONTEXT, 'batch',
                                 generator, self.dtype)
        self.update_block = UpdateBlock(
            CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2, generator, self.dtype)
        if device is not None:
            self.to(device)

    # the dense [B, L*C, H, W] float32 grid, as EVFlowNet's
    quantize = evflownet.Model.quantize

    def dense(self, grid):
        """The four flows of a ``[B, 2 * C, H, W]`` grid in the compute
        type, and the last hidden state."""
        B, C = grid.shape[0], self.depth
        fmap1, fmap2 = self.fnet(torch.cat([grid[:, :C], grid[:, C:]])) \
            .split(B)
        net, inp = self.cnet(grid[:, C:]).split([HIDDEN, CONTEXT], dim=1)
        net, inp = torch.tanh(net), F.relu(inp)
        pyramid = correlation_pyramid(fmap1, fmap2, CORR_LEVELS)
        coords0 = pixel_grid(B, *fmap1.shape[-2:], grid.device)
        grids = lookup_grids(pyramid, CORR_RADIUS)
        coords1 = coords0
        for _ in range(self.iterations):
            coords1 = coords1.detach()
            corr = lookup(pyramid, grids, coords1)
            net, delta = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
        flow8 = coords1 - coords0
        mask = 0.25 * self.update_block.mask(net).float()
        return contract_flows(flow8, convex_upsample(flow8, mask)), net

    def forward(self, events, timestamps, sample_idx,
                imsize: Tuple[int, int], raw: bool = True,
                intermediate: bool = False):
        batch_size = batch_size_of(timestamps, self.max_sequence_length)
        if raw:
            grid = self.quantization_layer(
                events, timestamps, sample_idx, tuple(imsize),
                self.max_sequence_length, batch_size)
        else:
            grid = events.to(self.dtype)
        flows, net = self.dense(grid)
        flow_ts, flow_sample_idx = predicted_windows(
            timestamps, sample_idx, batch_size, self.prefix_length)
        if intermediate:
            return flows, flow_ts, flow_sample_idx, (net,)
        return flows, flow_ts, flow_sample_idx


class OpticalFlow(BaseOpticalFlow):
    """Inference wrapper for E-RAFT.  The wrapper collates one event window
    a prediction, and E-RAFT reads two: scoring over pairs of windows is
    not ported yet, so a call raises."""

    def __init__(self, imsize, model=None, event_representation_depth=15,
                 **kwargs):
        kwargs.setdefault('max_sequence_length', 2)
        kwargs.setdefault('prefix_length', 1)
        super().__init__(
            imsize, Model, model=model,
            event_representation_depth=event_representation_depth, **kwargs)

    def __call__(self, events, start, stop, return_all=False):
        raise NotImplementedError(
            'E-RAFT predicts from two event volumes; the inference wrapper '
            'collates one window a prediction')
