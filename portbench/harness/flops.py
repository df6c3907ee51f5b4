"""Model FLOPs of a training step, counted from the reference network's
shapes.

A convolution does ``2 * Cin * k * k * Cout * Ho * Wo`` flop a sample
forward (the decoders' nearest-neighbour upsampling adds none); its
backward does twice that, the input's and the weight's gradients, each as
large as the forward (the first layer's input gradient too: the event
representation learns).  K2's MLP ``1 ->
h -> h -> 1`` does ``2 * (h + h * h + h)`` flop a point forward, a point
an event of the batch and a temporal channel, and twice that backward.
Nothing recomputed is counted, and no elementwise work.
"""
import copy

import torch

from .reference.layers import Conv


def conv_flops(model, batch_size, channels, shape):
    """Forward flop of ``model.dense`` on a ``[batch_size, channels,
    *shape]`` grid, from a pass on the meta device."""
    meta = copy.deepcopy(model).to('meta')
    total = [0]

    def count(module, inputs, output):
        w = module.weight
        total[0] += 2 * w.shape[1] * w.shape[2] * w.shape[3] * w.shape[0] \
            * output.shape[0] * output.shape[2] * output.shape[3]

    for module in meta.modules():
        if isinstance(module, Conv):
            module.register_forward_hook(count)
    with torch.no_grad():
        meta.dense(torch.empty(batch_size, channels, *shape, device='meta'))
    return total[0]


def mlp_flops(points, hidden):
    """Forward flop of K2's MLP at ``points`` points."""
    return 2 * points * (hidden + hidden * hidden + hidden)


def step_flops(conv_forward, points, hidden):
    """A training step's model flop: forward and backward."""
    return 3 * (conv_forward + mlp_flops(points, hidden))
