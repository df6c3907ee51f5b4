"""Charbonnier penalty ``(delta^2 + eps^2)^alpha``.

Counterpart of ``dvs_of_training_framework_tpu/ops/charbonnier.py``: the
same masked-mean and denominator forms, and the same backward, which
reuses the forward's ``u = s^alpha`` as ``2 alpha delta u / s`` instead of
evaluating a second power.
"""
from typing import Optional

import torch


class _Charbonnier(torch.autograd.Function):

    @staticmethod
    def forward(ctx, delta, alpha, epsilon):
        u = torch.pow(delta * delta + epsilon * epsilon, alpha)
        ctx.save_for_backward(delta, u)
        ctx.alpha = alpha
        ctx.epsilon = epsilon
        return u

    @staticmethod
    def backward(ctx, g):
        delta, u = ctx.saved_tensors
        s = delta * delta + ctx.epsilon * ctx.epsilon
        return g * (2.0 * ctx.alpha) * delta * (u / s), None, None


def charbonnier_value(delta: torch.Tensor, alpha: float,
                      epsilon: float) -> torch.Tensor:
    """Elementwise ``(delta^2 + eps^2)^alpha``."""
    return _Charbonnier.apply(delta, alpha, epsilon)


def charbonnier_loss(delta: torch.Tensor,
                     alpha: float = 0.45,
                     epsilon: float = 1e-3,
                     mask: Optional[torch.Tensor] = None,
                     denominator: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Charbonnier penalty.

    Args:
        delta: residuals of any shape.
        alpha, epsilon: penalty parameters.
        mask: optional bool tensor broadcastable to ``delta``; only masked
            elements contribute.
        denominator: optional per-element divisor.  When given the result
            is ``sum(charb / denominator)`` over masked elements, otherwise
            the mean over masked elements (0 when the mask is empty).
    """
    value = charbonnier_value(delta, alpha, epsilon)
    if denominator is not None:
        positive = denominator > 0
        value = value / torch.where(positive, denominator, 1.0)
        if mask is None:
            return value.sum()
        return torch.where(mask & positive, value, 0.0).sum()
    if mask is None:
        return value.mean() if value.numel() else value.new_zeros(())
    count = mask.sum()
    total = torch.where(mask, value, 0.0).sum()
    return torch.where(count > 0, total / count.clamp(min=1), 0.0)
