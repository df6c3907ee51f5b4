"""Optimizers: ADAM, RADAM and RANGER over two parameter groups.

Counterpart of ``dvs_of_training_framework_tpu/training/optimizers.py``
(``make_lr_schedule``, ``lookahead``, ``gradient_centralization``,
``_base_transform``, ``construct_optimizer``), written out by hand to
optax's semantics rather than with ``torch.optim``:

- ADAM is AMSGrad, optax ``scale_by_amsgrad`` (b1 0.9, b2 0.999, eps
  1e-8): the update divides the bias-corrected first moment by the root
  of the running maximum of the *bias-corrected* second moment;
- RAdam is optax ``scale_by_radam`` (b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0, threshold 5): below the threshold the update is the
  bias-corrected first moment;
- decoupled weight decay is added to the direction before the
  ``-lr * schedule`` scale, so the decay is scaled by the learning rate;
- RANGER centralises each gradient over every axis but the parameter's
  output axis, which the model states (``Model.output_axes``), and wraps
  the rest in Lookahead (sync every 6 steps, slow step 0.5, slow weights
  starting as a copy);
- ``quantization_layer`` parameters form the representation group, whose
  schedule is 0 while ``step <= training_steps * rs``; its moments still
  update while it is frozen;
- ``grad_clip_norm > 0`` clips the gradients of both groups together by
  their global norm before anything else, optax
  ``chain(clip_by_global_norm, multi_transform(...))``:
  ``where(norm < max, g, g / norm * max)``.

The per-step scalars (bias corrections, rectification, learning rate) are
computed on the host in float32, so a step needs no device sync.
"""
import numpy as np
import torch

B1, B2, EPS, THRESHOLD = 0.9, 0.999, 1e-8, 5.0
SYNC_PERIOD, SLOW_STEP = 6, 0.5
KINDS = ('ADAM', 'RADAM', 'RANGER')


def make_lr_schedule(lr, num_warmup_steps, half_life, delay_steps=0,
                     rewarmup_steps=0):
    """Warmup + exponential half-life decay, 0 up to ``delay_steps``:
    ``step -> float`` in float32 arithmetic, as the JAX schedule.
    ``rewarmup_steps`` ramps a delayed schedule linearly from 0 over that
    many steps once it unfreezes."""
    def schedule(step):
        step_f = np.float32(step)
        if delay_steps > 0 and not step_f > np.float32(delay_steps):
            return 0.0
        if num_warmup_steps > 0 and step_f < np.float32(num_warmup_steps):
            value = step_f / np.float32(num_warmup_steps)
        else:
            value = np.exp2(np.float32(
                -(step_f - np.float32(num_warmup_steps))
                / np.float32(half_life)))
        value = np.float32(value) * np.float32(lr)
        if delay_steps > 0 and rewarmup_steps > 0:
            ramp = (step_f - np.float32(delay_steps)) \
                / np.float32(rewarmup_steps)
            value = value * np.float32(min(max(ramp, 0.0), 1.0))
        return float(value)
    return schedule


def _radam_scalars(count):
    """(1 / (1 - b1^t), 1 / (1 - b2^t), r or None) after ``count`` updates,
    in float32; r is None below the variance-tractability threshold."""
    f = np.float32
    t = f(count)
    b1t = f(B1) ** t
    b2t = f(B2) ** t
    ro_inf = f(2.0 / (1.0 - B2) - 1.0)
    ro = ro_inf - f(2) * t * b2t / (f(1) - b2t)
    r = None
    if ro >= THRESHOLD:
        r = float(np.sqrt((ro - f(4)) * (ro - f(2)) * ro_inf
                          / ((ro_inf - f(4)) * (ro_inf - f(2)) * ro)))
    return float(f(1) - b1t), float(f(1) - b2t), r


class ParamGroup:
    """One optimizer chain over a list of parameters, with its own state.

    Args:
        params: parameters, updated in place.
        output_axes: output axis of each parameter for gradient
            centralisation, None for parameters it leaves alone.
        schedule: ``step -> learning rate``.
        weight_decay: decoupled weight decay.
        kind: 'ADAM' (AMSGrad), 'RADAM', or 'RANGER' (gradient
            centralisation + Lookahead around RAdam).
    """

    def __init__(self, params, output_axes, schedule, weight_decay,
                 kind='RANGER'):
        if kind not in KINDS:
            raise ValueError(f'unsupported optimizer {kind!r} ({KINDS})')
        self.params = list(params)
        self.output_axes = list(output_axes)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.kind = kind
        self.ranger = kind == 'RANGER'
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = ([torch.zeros_like(p) for p in self.params]
                       if kind == 'ADAM' else None)
        self.slow = ([p.detach().clone() for p in self.params]
                     if self.ranger else None)

    def _centralize(self, g, axis):
        if not self.ranger or axis is None:
            return g
        dims = [d for d in range(g.dim()) if d != axis]
        return g - g.mean(dim=dims, keepdim=True)

    @torch.no_grad()
    def update(self, grads):
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2, r = _radam_scalars(self.count)
        sync = self.ranger and self.count % SYNC_PERIOD == 0
        for i, (p, g) in enumerate(zip(self.params, grads)):
            g = self._centralize(g, self.output_axes[i])
            mu, nu = self.mu[i], self.nu[i]
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            mu_hat = mu / bc1
            if self.nu_max is not None:              # AMSGrad
                torch.maximum(self.nu_max[i], nu / bc2, out=self.nu_max[i])
                u = mu_hat / (self.nu_max[i].sqrt() + EPS)
            elif r is None:
                u = mu_hat
            else:
                u = r * mu_hat / ((nu / bc2).sqrt_() + EPS)
            u = u + self.weight_decay * p
            p.add_(u, alpha=-lr)
            if sync:
                slow = self.slow[i]
                slow.add_(p - slow, alpha=SLOW_STEP)
                p.copy_(slow)


class Optimizer:
    """Named parameter groups updated together, one step per call, after
    an optional clip of all gradients by their global norm (0 = off)."""

    def __init__(self, groups, names, clip_norm=0.0):
        self.groups = groups          # {group name: ParamGroup}
        self.names = names            # {group name: parameter names}
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def clip(self, grads):
        """optax ``clip_by_global_norm``, with no host sync."""
        norm = torch.stack([g.square().sum() for g in grads.values()]) \
            .sum().sqrt()
        keep = norm < self.clip_norm
        return {name: torch.where(keep, g, g / norm * self.clip_norm)
                for name, g in grads.items()}

    def step(self, grads):
        """Apply one update; ``grads`` maps parameter names to gradients."""
        if self.clip_norm > 0.0:
            grads = self.clip(grads)
        for key, group in self.groups.items():
            group.update([grads[name] for name in self.names[key]])


def construct_optimizer(args, model) -> Optimizer:
    """ADAM, RADAM or RANGER over the model's two groups.

    ``args`` carries ``optimizer``, ``lr``, ``wdw`` (weight decay),
    ``half_life``, ``num_warmup_steps``, ``training_steps`` and ``rs``;
    the representation group's schedule is delayed by
    ``training_steps * rs`` steps and, with
    ``representation_warmup_steps``, ramped up after.  ``grad_clip_norm`` (0 or absent = off)
    clips by global norm.  The parameter-EMA rider (``ema_decay``) is not
    ported yet and is refused.
    """
    name = args.optimizer.upper()
    if name not in KINDS:
        raise ValueError(f'unsupported optimizer {args.optimizer!r} '
                         f'({", ".join(KINDS)} are ported)')
    if float(getattr(args, 'ema_decay', 0.0) or 0.0) > 0.0:
        raise ValueError('the parameter-EMA rider (ema_decay) is not '
                         'ported yet')
    warmup = getattr(args, 'num_warmup_steps', 0)
    delay = int(getattr(args, 'training_steps', 0) * getattr(args, 'rs', 0))
    schedules = {
        'representation': make_lr_schedule(
            args.lr, warmup, args.half_life, delay_steps=delay,
            rewarmup_steps=getattr(args, 'representation_warmup_steps', 0)),
        'predictor': make_lr_schedule(args.lr, warmup, args.half_life),
    }
    axes = model.output_axes()
    named = dict(model.named_parameters())
    names = {'representation': [], 'predictor': []}
    for pname in named:
        key = ('representation' if pname.startswith('quantization_layer.')
               else 'predictor')
        names[key].append(pname)
    groups = {key: ParamGroup([named[n] for n in names[key]],
                              [axes[n] for n in names[key]],
                              schedules[key], args.wdw, kind=name)
              for key in names}
    return Optimizer(groups, names,
                     float(getattr(args, 'grad_clip_norm', 0.0) or 0.0))
