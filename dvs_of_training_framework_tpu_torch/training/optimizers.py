"""Optimizers: ADAM, RADAM and RANGER over one or two parameter groups.

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
  output axis (``models.loader.output_axes``), and wraps
  the rest in Lookahead (sync every 6 steps, slow step 0.5, slow weights
  starting as a copy);
- ``quantization_layer`` parameters form the representation group, whose
  schedule is 0 while ``step <= training_steps * rs``; its moments still
  update while it is frozen.  A model without a ``quantization_layer``
  (DummyFlowNet) trains as one group, ``predictor``, on the predictor's
  schedule;
- ``grad_clip_norm > 0`` clips the gradients of all groups together by
  their global norm before anything else, optax
  ``chain(clip_by_global_norm, multi_transform(...))``:
  ``where(norm < max, g, g / norm * max)``;
- ``ema_decay > 0`` keeps an exponential moving average of the parameters
  after each complete update (after the Lookahead jump on a sync step),
  the JAX rider ``with_param_ema``: ``e = decay * e + (1 - decay) * p``,
  starting as a copy of the parameters.

The optimizer's state (counts, moments, Lookahead slow weights and the
EMA) is keyed by parameter name in ``state_dict()``, so a checkpoint
restores it exactly with ``load_state_dict()``.

The per-step scalars (learning rate, bias corrections, RAdam's
rectification and whether Lookahead syncs) are computed on the host in
float32 from the host's update count, as one row of six a group
(``SCALARS``), and reach the update as a tensor on the parameters'
device; the update selects with ``torch.where``, never a Python branch.
So a step needs no device sync, and a captured CUDA graph of K updates
(``training/state.py``) replays with the next K rows copied into its
table: ``Optimizer.step`` uploads one row and calls ``apply``, the op
sequence that the graph captures.
"""
import numpy as np
import torch

from ..models.loader import output_axes

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
    """(1 - b1^t, 1 - b2^t, r or None) after ``count`` updates, in
    float32; r is None below the variance-tractability threshold."""
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


# one group's per-update scalars, in this order, in a row of float32
SCALARS = ('lr', 'bc1', 'bc2', 'r', 'rectified', 'sync')


def _copy_into(name, targets, saved):
    """Copy the name-keyed tensors ``saved`` into ``targets`` in place;
    the names must match exactly."""
    if set(targets) != set(saved):
        raise KeyError(f'{name}: saved state holds {sorted(saved)}, the '
                       f'optimizer {sorted(targets)}')
    for key, tensor in targets.items():
        tensor.copy_(saved[key])


class ParamGroup:
    """One optimizer chain over a list of parameters, with its own state.

    Args:
        names: parameter names, which key the state in ``state_dict()``.
        params: parameters, updated in place.
        output_axes: output axis of each parameter for gradient
            centralisation, None for parameters it leaves alone.
        schedule: ``step -> learning rate``.
        weight_decay: decoupled weight decay.
        kind: 'ADAM' (AMSGrad), 'RADAM', or 'RANGER' (gradient
            centralisation + Lookahead around RAdam).
    """

    def __init__(self, names, params, output_axes, schedule, weight_decay,
                 kind='RANGER'):
        if kind not in KINDS:
            raise ValueError(f'unsupported optimizer {kind!r} ({KINDS})')
        self.names = list(names)
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

    def state_dict(self) -> dict:
        """``count`` and each state tensor by name: ``mu``, ``nu``, and
        ``nu_max`` (ADAM) or ``slow`` (RANGER).  The tensors are the live
        ones, not copies."""
        state = {'count': self.count}
        for key in ('mu', 'nu', 'nu_max', 'slow'):
            tensors = getattr(self, key)
            if tensors is not None:
                state[key] = dict(zip(self.names, tensors))
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        keys = {k for k in ('mu', 'nu', 'nu_max', 'slow')
                if getattr(self, k) is not None}
        if set(state) != keys | {'count'}:
            raise KeyError(f'saved group state holds {sorted(state)}, a '
                           f'{self.kind} group {sorted(keys | {"count"})}')
        for key in keys:
            _copy_into(key, dict(zip(self.names, getattr(self, key))),
                       state[key])
        self.count = int(state['count'])

    def _centralize(self, g, axis):
        if not self.ranger or axis is None:
            return g
        dims = [d for d in range(g.dim()) if d != axis]
        return g - g.mean(dim=dims, keepdim=True)

    def scalars(self, count: int) -> list:
        """``SCALARS`` of the update that follows ``count`` updates: the
        learning rate at ``count``, the bias corrections and RAdam's ``r``
        after the update (0 and not rectified below the threshold), and
        whether Lookahead syncs after it."""
        bc1, bc2, r = _radam_scalars(count + 1)
        sync = self.ranger and (count + 1) % SYNC_PERIOD == 0
        return [self.schedule(count), bc1, bc2, 0.0 if r is None else r,
                float(r is not None), float(sync)]

    @torch.no_grad()
    def apply(self, grads, scalars):
        """One update of the parameters and the state in place, with this
        update's ``SCALARS`` as a float32 tensor ``[6]`` on the
        parameters' device.  Reads nothing on the host, so a CUDA graph
        can capture it; ``count`` is the caller's to advance."""
        lr, bc1, bc2, r, rectified, sync = scalars.unbind()
        rectified, sync = rectified > 0, sync > 0
        for i, (p, g) in enumerate(zip(self.params, grads)):
            g = self._centralize(g, self.output_axes[i])
            mu, nu = self.mu[i], self.nu[i]
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            mu_hat = mu / bc1
            if self.nu_max is not None:              # AMSGrad
                torch.maximum(self.nu_max[i], nu / bc2, out=self.nu_max[i])
                u = mu_hat / (self.nu_max[i].sqrt() + EPS)
            else:
                u = torch.where(rectified,
                                r * mu_hat / ((nu / bc2).sqrt_() + EPS),
                                mu_hat)
            u = u + self.weight_decay * p
            p.sub_(u * lr)
            if self.ranger:
                slow = self.slow[i]
                moved = slow.add(p - slow, alpha=SLOW_STEP)
                slow.copy_(torch.where(sync, moved, slow))
                p.copy_(torch.where(sync, moved, p))


def _upload(rows, device) -> torch.Tensor:
    """Rows of scalars as a float32 tensor on ``device``: from pinned
    memory without blocking the host where the device is a card."""
    table = torch.tensor(rows, dtype=torch.float32)
    if device.type != 'cuda':
        return table
    return table.pin_memory().to(device, non_blocking=True)


class Optimizer:
    """Named parameter groups updated together, one step per call, after
    an optional clip of all gradients by their global norm (0 = off), and
    followed by an optional parameter EMA (``ema_decay``, 0 = off)."""

    def __init__(self, groups, clip_norm=0.0, ema_decay=0.0):
        self.groups = groups          # {group name: ParamGroup}
        self.clip_norm = float(clip_norm)
        self.ema_decay = float(ema_decay)
        self.ema = None               # {parameter name: EMA tensor}
        if self.ema_decay > 0.0:
            if not self.ema_decay < 1.0:
                raise ValueError(f'the parameter EMA needs 0 < ema_decay < '
                                 f'1, got {self.ema_decay}')
            # a copy: the EMA must not alias the live parameters
            self.ema = {n: p.detach().clone() for group in groups.values()
                        for n, p in zip(group.names, group.params)}

    @torch.no_grad()
    def clip(self, grads):
        """optax ``clip_by_global_norm``, with no host sync."""
        norm = torch.stack([g.square().sum() for g in grads.values()]) \
            .sum().sqrt()
        keep = norm < self.clip_norm
        return {name: torch.where(keep, g, g / norm * self.clip_norm)
                for name, g in grads.items()}

    def scalar_table(self, updates: int, device) -> torch.Tensor:
        """The ``SCALARS`` of the next ``updates`` updates of every group
        from the host's counts, float32 ``[updates, groups, 6]`` on
        ``device`` (one copy)."""
        return _upload([[group.scalars(group.count + j)
                         for group in self.groups.values()]
                        for j in range(updates)], device)

    def advance(self, updates: int):
        """Count ``updates`` updates that ``apply`` made on every group."""
        for group in self.groups.values():
            group.count += updates

    def apply(self, grads, scalars):
        """One update from ``grads`` (parameter names to gradients) with
        the groups' scalars ``[groups, 6]`` on the device: the clip, every
        group, the EMA.  Touches no host state."""
        if self.clip_norm > 0.0:
            grads = self.clip(grads)
        for row, group in zip(scalars, self.groups.values()):
            group.apply([grads[name] for name in group.names], row)
        if self.ema is not None:
            self._update_ema()

    def step(self, grads):
        """Apply one update; ``grads`` maps parameter names to gradients.
        The scalars of the next count go up as one row of ``scalar_table``."""
        device = next(iter(self.groups.values())).params[0].device
        self.apply(grads, self.scalar_table(1, device)[0])
        self.advance(1)

    def tensors(self) -> list:
        """Every tensor of the state that ``apply`` writes besides the
        parameters: the moments, the slow weights and the EMA."""
        out = [t for group in self.groups.values()
               for key in ('mu', 'nu', 'nu_max', 'slow')
               for t in (getattr(group, key) or ())]
        return out + list((self.ema or {}).values())

    @torch.no_grad()
    def _update_ema(self):
        # multi-tensor kernels: three launches a step, not three a parameter
        params = [p for group in self.groups.values() for p in group.params]
        ema = list(self.ema.values())
        torch._foreach_mul_(ema, self.ema_decay)
        torch._foreach_add_(ema, torch._foreach_mul(params,
                                                    1.0 - self.ema_decay))

    def state_dict(self) -> dict:
        """``{'groups': {group: ParamGroup.state_dict()}}``, plus
        ``'ema_params'`` (by parameter name) when the EMA is on.  The
        tensors are the live ones, not copies."""
        state = {'groups': {key: group.state_dict()
                            for key, group in self.groups.items()}}
        if self.ema is not None:
            state['ema_params'] = dict(self.ema)
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Restore ``state_dict()`` output exactly, in place."""
        if set(state['groups']) != set(self.groups):
            raise KeyError(f'saved groups {sorted(state["groups"])}, the '
                           f'optimizer\'s {sorted(self.groups)}')
        if ('ema_params' in state) != (self.ema is not None):
            raise KeyError('the saved state and the optimizer disagree on '
                           'the parameter EMA (--ema-decay)')
        for key, group in self.groups.items():
            group.load_state_dict(state['groups'][key])
        if self.ema is not None:
            _copy_into('ema_params', self.ema, state['ema_params'])


def construct_optimizer(args, model) -> Optimizer:
    """ADAM, RADAM or RANGER over the model's two groups, or over one
    (``predictor``) when it has no ``quantization_layer``.

    ``args`` carries ``optimizer``, ``lr``, ``wdw`` (weight decay),
    ``half_life``, ``num_warmup_steps``, ``training_steps`` and ``rs``;
    the representation group's schedule is delayed by
    ``training_steps * rs`` steps and, with
    ``representation_warmup_steps``, ramped up after.  ``grad_clip_norm``
    (0 or absent = off) clips by global norm; ``ema_decay`` (0 or absent =
    off) keeps the parameter EMA.
    """
    name = args.optimizer.upper()
    if name not in KINDS:
        raise ValueError(f'unsupported optimizer {args.optimizer!r} '
                         f'({", ".join(KINDS)} are ported)')
    schedules = _schedules(args)
    axes = output_axes(model)
    named = dict(model.named_parameters())
    names = {'representation': [], 'predictor': []}
    for pname in named:
        key = ('representation' if pname.startswith('quantization_layer.')
               else 'predictor')
        names[key].append(pname)
    groups = {key: ParamGroup(names[key], [named[n] for n in names[key]],
                              [axes[n] for n in names[key]],
                              schedules[key], args.wdw, kind=name)
              for key in names if names[key]}
    return Optimizer(groups,
                     float(getattr(args, 'grad_clip_norm', 0.0) or 0.0),
                     float(getattr(args, 'ema_decay', 0.0) or 0.0))


def _schedules(args):
    """The two groups' schedules: the representation group's delayed by
    ``training_steps * rs`` steps."""
    warmup = getattr(args, 'num_warmup_steps', 0)
    delay = int(getattr(args, 'training_steps', 0) * getattr(args, 'rs', 0))
    return {
        'representation': make_lr_schedule(
            args.lr, warmup, args.half_life, delay_steps=delay,
            rewarmup_steps=getattr(args, 'representation_warmup_steps', 0)),
        'predictor': make_lr_schedule(args.lr, warmup, args.half_life),
    }


def current_learning_rates(args, step: int,
                           groups=('representation', 'predictor')):
    """The learning rates of ``groups`` (an optimizer's ``groups``) at
    ``step`` for logging (``General/learning rate/{i}``), in that order:
    the representation group first where there is one."""
    schedules = _schedules(args)
    return [schedules[key](step) for key in groups]
