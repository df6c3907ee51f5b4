"""Plain RANGER: gradient centralisation, RAdam and Lookahead, with the
learning-rate schedule and the optional clip by global norm.

Written to optax's semantics (``scale_by_radam``: b1 0.9, b2 0.999, eps
1e-8, threshold 5; decoupled weight decay added to the direction before
the ``-lr`` scale; Lookahead syncing every 6 updates with step 0.5, the
slow weights starting as a copy), over two groups: the representation's
parameters, whose schedule is 0 while ``step <= training_steps * rs``,
and the rest.  The per-update scalars are computed in float32 on the
host from the update count, as the schedule is defined.
"""
import numpy as np
import torch

B1, B2, EPS, THRESHOLD = 0.9, 0.999, 1e-8, 5.0
SYNC_PERIOD, SLOW_STEP = 6, 0.5


def schedule(lr, warmup, half_life, delay=0):
    """``step -> learning rate``: linear warm-up, then halving every
    ``half_life`` steps; 0 up to ``delay``."""
    f = np.float32

    def at(step):
        s = f(step)
        if delay > 0 and not s > f(delay):
            return 0.0
        if warmup > 0 and s < f(warmup):
            value = s / f(warmup)
        else:
            value = np.exp2(f(-(s - f(warmup)) / f(half_life)))
        return float(f(value) * f(lr))
    return at


def radam_scalars(count):
    """``(1 - b1^t, 1 - b2^t, r or None)`` after ``count`` updates."""
    f = np.float32
    t = f(count)
    b1t, b2t = f(B1) ** t, f(B2) ** t
    ro_inf = f(2.0 / (1.0 - B2) - 1.0)
    ro = ro_inf - f(2) * t * b2t / (f(1) - b2t)
    r = None
    if ro >= THRESHOLD:
        r = float(np.sqrt((ro - f(4)) * (ro - f(2)) * ro_inf
                          / ((ro_inf - f(4)) * (ro_inf - f(2)) * ro)))
    return float(f(1) - b1t), float(f(1) - b2t), r


class Ranger:
    """RANGER over ``named`` parameters (updated in place).

    ``axes``: each leaf's output axis (``layers.output_axes``);
    ``recipe``: the configuration's optimizer flags (``lr``,
    ``weight_decay``, ``half_life``, ``warmup``, ``training_steps``,
    ``representation_start``, ``grad_clip_norm``); ``state``: where
    given, ``{'mu', 'nu', 'slow': {name: tensor}, 'count': updates
    made}`` to start from, else a fresh start.
    """

    def __init__(self, named, axes, recipe, state=None):
        self.named = dict(named)
        self.axes = axes
        self.wd = recipe['weight_decay']
        self.clip = recipe.get('grad_clip_norm', 0.0)
        delay = int(recipe['training_steps'] * recipe['representation_start'])
        self.schedules = {
            'representation': schedule(recipe['lr'], recipe['warmup'],
                                       recipe['half_life'], delay),
            'predictor': schedule(recipe['lr'], recipe['warmup'],
                                  recipe['half_life'])}
        with torch.no_grad():
            if state is None:
                self.count = 0
                self.mu = {k: torch.zeros_like(p)
                           for k, p in self.named.items()}
                self.nu = {k: torch.zeros_like(p)
                           for k, p in self.named.items()}
                self.slow = {k: p.detach().clone()
                             for k, p in self.named.items()}
            else:
                self.count = int(state['count'])
                self.mu, self.nu, self.slow = (
                    {k: state[key][k].to(p.device, copy=True)
                     for k, p in self.named.items()}
                    for key in ('mu', 'nu', 'slow'))

    def group(self, name):
        return ('representation' if name.startswith('quantization_layer.')
                else 'predictor')

    @torch.no_grad()
    def step(self, grads):
        if self.clip > 0:
            norm = torch.sqrt(sum((g.double() ** 2).sum()
                                  for g in grads.values()))
            if norm >= self.clip:
                grads = {k: g / norm.float() * self.clip
                         for k, g in grads.items()}
        bc1, bc2, r = radam_scalars(self.count + 1)
        sync = (self.count + 1) % SYNC_PERIOD == 0
        for name, p in self.named.items():
            g = grads[name]
            axis = self.axes[name]
            if axis is not None:
                dims = [d for d in range(g.dim()) if d != axis]
                g = g - g.mean(dim=dims, keepdim=True)
            mu, nu = self.mu[name], self.nu[name]
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1 - B2)
            mu_hat = mu / bc1
            u = mu_hat if r is None else r * mu_hat / ((nu / bc2).sqrt()
                                                        + EPS)
            lr = self.schedules[self.group(name)](self.count)
            p.sub_((u + self.wd * p) * lr)
            if sync:
                slow = self.slow[name]
                slow.add_(p - slow, alpha=SLOW_STEP)
                p.copy_(slow)
        self.count += 1
