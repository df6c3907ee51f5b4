"""Rounding of the reference's tensors to a compute type.

The reference computes in float32.  The benchmark's control computes it a
step below the configuration's precision: fp8 for a bfloat16 recipe,
emulated as OCP FP8 training does it, each tensor scaled by its own
largest magnitude, e4m3 forward and e5m2 for its gradient (``FP8``).
``BF16`` rounds to bfloat16 both ways; ``FP32`` leaves a tensor alone.
"""
import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(x, dtype, top):
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _RoundFP8(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


class _RoundBF16(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def FP32(x):
    return x


def FP8(x):
    return _RoundFP8.apply(x)


def BF16(x):
    return _RoundBF16.apply(x)


ROUNDINGS = {'float32': FP32, 'bfloat16': BF16, 'fp8': FP8}
