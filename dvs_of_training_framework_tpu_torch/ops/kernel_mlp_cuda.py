"""K2: the per-(event, channel) temporal-kernel MLP as a CUDA kernel
(``csrc/kernel_mlp.cu``), with its plain twin.

Counterpart of ``kernel_mlp_pallas`` in
``dvs_of_training_framework_tpu/ops/kernel_mlp_pallas.py``; the twin is the
XLA path of the quantization layer (``EVFlowNet/net.py``, the
``kernel_mlp='xla'`` branch).  A CUDA tensor always goes through the
kernel, which raises on what it does not take; a CPU tensor goes to the
twin.
"""
import torch

from . import _build

# kernel launches, counted where the wrapper launches them
launches = {'fwd': 0, 'bwd': 0}

MAX_HIDDEN = 32        # the kernel pads the hidden axis to this size
_GRADS = 1153          # kernel_mlp_grad_size(): layout in csrc/kernel_mlp.cu


def plain(delta, w1, b1, w2, b2, w3, b3):
    """``w3^T tanh(W2^T tanh(w1 delta + b1) + b2) + b3`` over every
    element of ``delta`` (float32, shaped like ``delta``)."""
    k_in = delta.reshape(-1, 1).float()
    h = torch.tanh(k_in @ w1.float() + b1.float())
    h = torch.tanh(h @ w2.float() + b2.float())
    return (h @ w3.float() + b3.float()).reshape(delta.shape)


def _check_inputs(delta, w1, b1, w2, b2, w3, b3):
    hd = w2.shape[0]
    if not 1 <= hd <= MAX_HIDDEN:
        raise ValueError(f'hidden size must be in [1, {MAX_HIDDEN}], '
                         f'got {hd}')
    if delta.numel() == 0:
        raise ValueError('kernel_mlp needs at least one point')
    shapes = {'w1': (1, hd), 'b1': (hd,), 'w2': (hd, hd), 'b2': (hd,),
              'w3': (hd, 1), 'b3': (1,)}
    for name, t in zip(['delta', *shapes],
                       (delta, w1, b1, w2, b2, w3, b3)):
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
        if name != 'delta' and tuple(t.shape) != shapes[name]:
            raise ValueError(f'{name} must be {shapes[name]}, got '
                             f'{tuple(t.shape)}')
        if t.device != delta.device:
            raise ValueError(f'{name} is on {t.device}, delta on '
                             f'{delta.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


class _KernelMLP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, delta, w1, b1, w2, b2, w3, b3):
        out = torch.empty_like(delta)
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        status = _build.library().kernel_mlp_fwd(
            delta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            delta.numel(), w2.shape[0], stream)
        _build.check(status, 'kernel_mlp_fwd')
        _build.count(launches, 'fwd')
        ctx.save_for_backward(delta, w1, b1, w2, b2, w3, b3)
        return out

    @staticmethod
    def backward(ctx, g):
        delta, w1, b1, w2, b2, w3, b3 = ctx.saved_tensors
        lib = _build.library()
        if lib.kernel_mlp_grad_size() != _GRADS:
            raise RuntimeError('kernel_mlp.cu and its wrapper disagree on '
                               'the gradient layout')
        g = g.contiguous().float()
        n = delta.numel()
        hd = w2.shape[0]
        blocks = lib.kernel_mlp_bwd_blocks(n)    # the rows of the partials
        if blocks < 0:
            _build.check(-blocks, 'kernel_mlp_bwd_blocks')
        d_delta = (torch.empty_like(delta) if ctx.needs_input_grad[0]
                   else None)
        partials = torch.empty((blocks, _GRADS), dtype=torch.float32,
                               device=delta.device)
        grads = torch.empty(_GRADS, dtype=torch.float32, device=delta.device)
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        status = lib.kernel_mlp_bwd(
            delta.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
            None if d_delta is None else d_delta.data_ptr(),
            partials.data_ptr(), grads.data_ptr(), n, hd, blocks, stream)
        _build.check(status, 'kernel_mlp_bwd')
        _build.count(launches, 'bwd')
        h = MAX_HIDDEN
        dw2 = grads[:h * h].view(h, h)[:hd, :hd]
        db2 = grads[h * h:h * h + hd]
        dw1 = grads[h * h + h:h * h + h + hd].view(1, hd)
        db1 = grads[h * h + 2 * h:h * h + 2 * h + hd]
        dw3 = grads[h * h + 3 * h:h * h + 3 * h + hd].view(hd, 1)
        db3 = grads[h * h + 4 * h:]
        return d_delta, dw1, db1, dw2, db2, dw3, db3


def kernel_mlp(delta, w1, b1, w2, b2, w3, b3):
    """tanh MLP ``1 -> hd -> hd -> 1`` over every element of ``delta``.

    Args:
        delta: float32 array of any shape (the per-(event, channel) kernel
            argument ``t_norm - center``).
        w1 ``[1, hd]``, b1 ``[hd]``, w2 ``[hd, hd]``, b2 ``[hd]``,
        w3 ``[hd, 1]``, b3 ``[1]``: the three layers in flax's ``[in, out]``
        layout, hd <= 32.

    Returns:
        float32 shaped like ``delta``.
    """
    if delta.is_cuda:
        _check_inputs(delta, w1, b1, w2, b2, w3, b3)
        with torch.cuda.device(delta.device):
            return _KernelMLP.apply(delta, w1, b1, w2, b2, w3, b3)
    if delta.device.type == 'cpu':
        return plain(delta, w1, b1, w2, b2, w3, b3)
    raise ValueError(f'kernel_mlp: unsupported device {delta.device}')
