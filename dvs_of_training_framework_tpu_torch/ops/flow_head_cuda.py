"""EVFlowNet's flow heads as a CUDA kernel (``csrc/flow_head.cu``), with
its plain twin.

A head is a 1x1 convolution from a decoder's ``C`` feature channels to a
2-channel float32 flow, computed in float32 on the features whatever their
type: flax's ``nn.Conv(2, (1, 1), dtype=float32)`` on ``x.astype(float32)``
in the JAX package (``EVFlowNet/net.py``, ``Predictor``), which XLA
compiles; no Pallas kernel stands behind it.  The kernel reads bf16 or
fp32 features in their own type and returns the features' gradient in
that type, rounded once from float32, as the twin's cast back does.  A
CUDA tensor always goes through the kernel, which raises on what it does
not take; a CPU tensor goes to the twin.
"""
import torch
import torch.nn.functional as F

from . import _build

# kernel launches, counted where the wrapper launches them (a backward
# call launches the pass and the reduction of its partial sums)
launches = {'fwd': 0, 'bwd': 0}

MAX_CHANNELS = 1024    # kMaxChannels in csrc/flow_head.cu


def plain(x, weight, bias):
    """``F.conv2d(x.float(), weight, bias)``: the head in float32."""
    return F.conv2d(x.float(), weight, bias)


def check_inputs(x, weight, bias):
    """Raise unless ``x`` is a contiguous ``[B, C, H, W]`` bf16 or fp32
    tensor with ``0 < C <= MAX_CHANNELS``, and ``weight`` ``[2, C, 1, 1]``
    and ``bias`` ``[2]`` are contiguous float32 on its device."""
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, C, H, W], got '
                         f'{tuple(x.shape)}')
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'x must be bfloat16 or float32, got {x.dtype}')
    C = x.shape[1]
    if C > MAX_CHANNELS:
        raise ValueError(f'at most {MAX_CHANNELS} channels, got {C}')
    shapes = {'weight': (2, C, 1, 1), 'bias': (2,)}
    for name, t in (('weight', weight), ('bias', bias)):
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f'{name} must be {shapes[name]}, got '
                             f'{tuple(t.shape)}')
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, x on {x.device}')
    for name, t in (('x', x), ('weight', weight), ('bias', bias)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _sizes(x):
    B, C, H, W = x.shape
    return B, C, H * W, int(x.dtype == torch.bfloat16)


class _FlowHead(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias):
        B, C, HW, x_bf16 = _sizes(x)
        flow = torch.empty((B, 2, *x.shape[2:]), dtype=torch.float32,
                           device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _build.library().flow_head_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            flow.data_ptr(), B, C, HW, x_bf16, stream)
        _build.check(status, 'flow_head_fwd')
        _build.count(launches, 'fwd')
        ctx.save_for_backward(x, weight)
        return flow

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        B, C, HW, x_bf16 = _sizes(x)
        lib = _build.library()
        blocks = lib.flow_head_blocks(B, C, HW, x_bf16)   # partials' rows
        if blocks < 0:
            _build.check(-blocks, 'flow_head_blocks')
        g = g.contiguous().float()
        dx = torch.empty_like(x) if ctx.needs_input_grad[0] else None
        partials = torch.empty((blocks, 2 * C + 2), dtype=torch.float32,
                               device=x.device)
        grads = torch.empty(2 * C + 2, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.flow_head_bwd(
            x.data_ptr(), g.data_ptr(), weight.data_ptr(),
            None if dx is None else dx.data_ptr(), partials.data_ptr(),
            grads.data_ptr(), B, C, HW, x_bf16, blocks, stream)
        _build.check(status, 'flow_head_bwd')
        _build.count(launches, 'bwd')
        return dx, grads[:2 * C].view(2, C, 1, 1), grads[2 * C:]


def flow_head(x, weight, bias):
    """One flow head: ``plain(x, weight, bias)``, through the kernel on a
    card.

    Args:
        x: ``[B, C, H, W]`` features, bfloat16 or float32, contiguous.
        weight: float32 ``[2, C, 1, 1]``; bias: float32 ``[2]``.

    Returns:
        float32 ``[B, 2, H, W]``.
    """
    if x.is_cuda:
        check_inputs(x, weight, bias)
        with torch.cuda.device(x.device):
            return _FlowHead.apply(x, weight, bias)
    if x.device.type == 'cpu':
        return plain(x, weight, bias)
    raise ValueError(f'flow_head: unsupported device {x.device}')
