"""Port parity: the parameter-EMA rider (``--ema-decay``).

Mirrors the JAX package's tests/training/test_ema.py:26-107:

- the port's EMA against the JAX package's ``with_param_ema`` over twelve
  RANGER steps of EVFlowNet's two groups on the same gradients, which
  cross two Lookahead syncs (steps 6 and 12), where the EMA averages the
  parameters after the jump to the slow weights; the tolerance of
  tests/test_torch_optim.py (rtol 1e-5, atol 1e-7);
- the EMA starts as a copy of the parameters, not an alias;
- ``Serializer.finalize(use_ema=True)`` exports the EMA, which loads into
  the model;
- ``finalize(use_ema=True)`` of a checkpoint without an EMA raises.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.training.optimizers import \
    construct_optimizer as jax_construct_optimizer
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.training.optimizers import \
    construct_optimizer
from dvs_of_training_framework_tpu_torch.training.serializer import (
    Serializer, read_params_file)
from dvs_of_training_framework_tpu_torch.utils.convert import (
    load_flax_params, torch_to_flax)
from tests.test_torch_optim import flax_params

ARGS = SimpleNamespace(optimizer='RANGER', lr=1e-2, wdw=1e-2, half_life=20,
                       num_warmup_steps=0, training_steps=10, rs=0.3,
                       grad_clip_norm=5.0, ema_decay=0.7)


def small_model():
    return evflownet.Model(event_representation_depth=4, base_channels=8)


def test_param_ema_matches_jax():
    params = flax_params()
    tx = jax_construct_optimizer(ARGS, params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)

    model = small_model()
    load_flax_params(model, params)
    opt = construct_optimizer(ARGS, model)
    named = dict(model.named_parameters())

    rng = np.random.default_rng(1)
    jax_params = params
    for step in range(12):
        grads = {name: torch.from_numpy(rng.normal(size=p.shape)
                                        .astype(np.float32))
                 for name, p in named.items()}
        updates, opt_state = update(torch_to_flax(grads), opt_state,
                                    jax_params)
        jax_params = jax.tree_util.tree_map(lambda p, u: p + u,
                                            jax_params, updates)
        opt.step(grads)
        got = dict(jax.tree_util.tree_leaves_with_path(
            torch_to_flax(opt.state_dict()['ema_params'])))
        for path, want in jax.tree_util.tree_leaves_with_path(
                opt_state.ema_params):
            np.testing.assert_allclose(
                got[path], np.asarray(want), rtol=1e-5, atol=1e-7,
                err_msg=f'step {step}: {jax.tree_util.keystr(path)}')


def test_ema_does_not_alias_params():
    model = small_model()
    opt = construct_optimizer(ARGS, model)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    for name, ema in opt.state_dict()['ema_params'].items():
        assert ema.data_ptr() != named[name].data_ptr()
        assert torch.equal(ema, before[name])
    opt.step({n: torch.ones_like(p) for n, p in named.items()})
    decay = ARGS.ema_decay
    moved = 0
    for name, ema in opt.state_dict()['ema_params'].items():
        # the init-time copy kept the old values: e = d * p0 + (1 - d) * p1
        want = before[name] * decay + named[name].detach() * (1 - decay)
        torch.testing.assert_close(ema, want, rtol=1e-6, atol=1e-7)
        moved += not torch.equal(ema, before[name])
    assert moved > 30


def test_construct_optimizer_ema_checkpoints_and_finalize(tmp_path):
    model = small_model()
    opt = construct_optimizer(ARGS, model)
    named = dict(model.named_parameters())
    opt.step({n: torch.full_like(p, 0.1) for n, p in named.items()})
    serializer = Serializer(tmp_path, 2, 10)
    serializer.checkpoint_model(model.state_dict(), opt.state_dict(),
                                global_step=1, samples_passed=8)

    out = tmp_path / 'ema.ckpt'
    serializer.finalize(1, out, use_ema=True)
    exported = read_params_file(out)
    ema = opt.state_dict()['ema_params']
    assert exported.keys() == ema.keys()
    assert all(torch.equal(exported[n], ema[n]) for n in ema)
    fresh = small_model()
    fresh.load_state_dict(exported, strict=True)

    # resume restores the EMA exactly
    restored = construct_optimizer(ARGS, small_model())
    serializer.load_checkpoint(1, optimizer=restored)
    assert all(torch.equal(restored.ema[n], ema[n]) for n in ema)


def test_finalize_without_ema_raises(tmp_path):
    model = small_model()
    args = SimpleNamespace(**{**vars(ARGS), 'ema_decay': 0.0})
    opt = construct_optimizer(args, model)
    serializer = Serializer(tmp_path, 2, 10)
    serializer.checkpoint_model(model.state_dict(), opt.state_dict(),
                                global_step=1, samples_passed=8)
    with pytest.raises(ValueError, match='no parameter EMA'):
        serializer.finalize(1, tmp_path / 'x.ckpt', use_ema=True)
