"""The plain reference: a configuration's network (``configs/<name>.py``),
the multi-scale loss and RANGER, in plain PyTorch.  It imports nothing of
the port, and takes from the benchmark only what both sides are given:
the collated batches and the initial weights."""
import numpy as np
import torch

from .layers import init_specs, output_axes
from .loss import multiscale_loss
from .precision import ROUNDINGS
from .ranger import Ranger


def recipe(flags):
    """The optimizer's settings from a configuration's flags."""
    return {'lr': flags['-lr'], 'weight_decay': flags['-wdw'],
            'half_life': flags['--half_life'],
            'warmup': flags.get('--num-warmup-steps', 0),
            'training_steps': flags['-ne'],
            'representation_start': flags.get('--representation-start', 0.5),
            'grad_clip_norm': flags.get('--grad-clip-norm', 0.0)}


def device_batch(collated, device):
    """A host-collated batch as the reference's tensors: the real events
    only, and ``first``, each sample's first timestamp slot."""
    ev = collated['events']
    sample_idx = np.asarray(collated['sample_idx'])
    size = int(collated['size'])

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    return {
        'events': {'x': t(ev['x'], torch.long), 'y': t(ev['y'], torch.long),
                   'timestamp': t(ev['timestamp'], torch.float32),
                   'polarity': t(ev['polarity'], torch.float32),
                   'element_index': t(ev['element_index'], torch.long),
                   'sample_index': t(ev['sample_index'], torch.long)},
        'timestamps': t(collated['timestamps'], torch.float32),
        'sample_idx': t(sample_idx, torch.long),
        'images': t(collated['images'], torch.float32),
        'first': t(np.searchsorted(sample_idx, np.arange(size)), torch.long),
        'size': size}


def loss_of(model, batch):
    flows, flow_ts, flow_sample_idx = model(batch)
    return multiscale_loss(flows, flow_ts, flow_sample_idx, batch)


def train(module, config, weights, batches, device, rounding='float32',
          fault=None, state=None):
    """Train the reference from ``weights`` over ``batches``, one update
    a batch.  Returns ``{'loss': [per step], 'params': {name: tensor},
    'mu': {name: first moment}}`` on the CPU.

    ``rounding`` is ``precision.ROUNDINGS``' key of the compute type;
    ``fault`` plants one of ``FAULTS`` in place of the program; ``state``,
    where given, is the optimizer's to start from (``Ranger``)."""
    model = module.build(config, ROUNDINGS[rounding]).to(device)
    model.load_state_dict(weights, strict=True)
    named = dict(model.named_parameters())
    opt = Ranger(named, output_axes(model), recipe(config['flags']), state)
    losses = []
    for collated in batches:
        batch = device_batch(collated, device)
        if fault == 'half_batch':
            batch = first_half(batch)
        loss, _ = loss_of(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        if fault != 'state_unchanged':
            opt.step(grads)
        losses.append(loss.detach())
    losses = [float(v) for v in torch.stack(losses).cpu()]
    if fault == 'loss_shifted':         # each step reports the one before
        losses = losses[:1] + losses[:-1]
    return {'loss': losses,
            'params': {k: p.detach().cpu() for k, p in named.items()},
            'mu': {k: m.cpu() for k, m in opt.mu.items()}}


def first_half(batch):
    """The batch's first half of samples: the loss is the mean over them."""
    keep = batch['size'] // 2
    ev = batch['events']
    sel = ev['sample_index'] < keep
    slots = batch['sample_idx'] < keep
    return dict(batch, events={k: v[sel] for k, v in ev.items()},
                timestamps=batch['timestamps'][slots],
                sample_idx=batch['sample_idx'][slots],
                images=batch['images'][slots], first=batch['first'][:keep],
                size=keep)


# faults that a training cell can have, planted in the reference in the
# program's place: an update that leaves the state unchanged; half of the
# batch left out, the mean taken over the rest; a step's loss altered
# where it is produced (each step reports the loss of the step before)
FAULTS = ('state_unchanged', 'half_batch', 'loss_shifted')

__all__ = ['FAULTS', 'device_batch', 'init_specs', 'loss_of',
           'output_axes', 'recipe', 'train']
