"""Initial weights from the seed, made on the device in one draw.

The leaves, their shapes and their init rules are the reference's
(``reference.layers.init_specs``): a truncated-normal leaf takes a standard
normal clipped to two stds times its std (lecun normal: variance 1/fan_in
before the truncation's correction), a normal leaf its std times a
standard normal, a bias zeros.  The same dict loads into the program and
into the reference.
"""
import torch

from .reference.layers import init_specs


def make(model, seed, device):
    """``{name: float32 tensor on device}`` for every parameter of the
    reference ``model``, from ``seed``."""
    specs = init_specs(model)
    shapes = {k: p.shape for k, p in model.named_parameters()}
    names = sorted(shapes)
    total = sum(shapes[k].numel() for k in names)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    z = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name in names:
        n = shapes[name].numel()
        kind, std = specs[name]
        part = z[offset:offset + n].view(shapes[name])
        offset += n
        if kind == 'zeros':
            out[name] = torch.zeros_like(part)
        elif kind == 'truncated':
            out[name] = part.clamp(-2.0, 2.0) * std
        else:
            out[name] = part * std
    return out
