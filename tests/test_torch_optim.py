"""Port parity: ADAM (AMSGrad), RADAM and RANGER over EVFlowNet's two
parameter groups against the JAX package's optax chains, and the
global-norm clip rider.

Twelve steps on the same gradients (made with numpy) cross two Lookahead
syncs (steps 6 and 12), the RAdam rectification threshold (step 6) and a
representation delay of 3 steps.  The clip runs RANGER with a clip norm
of 1e-2, far below the gradients' global norm, so every step is clipped.  The JAX package pins its own resume
at rtol 1e-6 (tests/training/test_serializer.py:109), one framework
against itself.  Across frameworks parameters take rtol 1e-5 / atol 1e-7:
both sides apply the same float32 formulas, but RAdam divides by sqrt(v),
which magnifies the one-ulp differences of operation order (gradient
centralisation's means, fused multiply-adds).
"""
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.models import load_model_class
from dvs_of_training_framework_tpu.training.optimizers import \
    construct_optimizer as jax_construct_optimizer
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.training.optimizers import (
    construct_optimizer, make_lr_schedule)
from dvs_of_training_framework_tpu_torch.utils.convert import (
    load_flax_params, torch_to_flax)

REPO = Path(__file__).resolve().parents[1]


def flax_params():
    module = load_model_class(REPO / 'EVFlowNet')
    model = module.Model(event_representation_depth=4, base_channels=8)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *_dummy_inputs(),
                           (32, 32))['params'])
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32),
        shapes)


def _dummy_inputs():
    from dvs_of_training_framework_tpu.data.schema import pad_events
    ev = {k: np.zeros(4) for k in ('x', 'y', 'timestamp', 'polarity',
                                   'element_index')}
    ev['sample_index'] = np.array([0, 0, 1, 1])
    return (pad_events(ev, 2, 8), jnp.array([0.0, 0.04, 0.0, 0.04]),
            jnp.array([0, 0, 1, 1], jnp.int32))


def run_against_optax(args):
    """Twelve steps of the JAX optimizer and the port's on the same
    gradients; the parameters must agree after each."""
    params = flax_params()
    tx = jax_construct_optimizer(args, params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)

    model = evflownet.Model(event_representation_depth=4, base_channels=8)
    load_flax_params(model, params)
    opt = construct_optimizer(args, model)
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
            torch_to_flax(model.state_dict())))
        for path, want in jax.tree_util.tree_leaves_with_path(jax_params):
            np.testing.assert_allclose(
                got[path], np.asarray(want), rtol=1e-5, atol=1e-7,
                err_msg=f'step {step}: {jax.tree_util.keystr(path)}')

    return opt


@pytest.mark.parametrize('optimizer', ['RADAM', 'RANGER', 'ADAM'])
def test_optimizer_matches_optax(optimizer):
    args = SimpleNamespace(optimizer=optimizer, lr=1e-2, wdw=1e-2,
                           half_life=20, num_warmup_steps=0,
                           training_steps=10, rs=0.3)
    opt = run_against_optax(args)
    # frozen for 3 steps, then live; moments updated all along
    rep = opt.groups['representation']
    assert rep.count == 12 and rep.schedule(3) == 0.0
    assert rep.schedule(4) > 0.0


def test_clip_by_global_norm_matches_optax():
    args = SimpleNamespace(optimizer='RANGER', lr=1e-2, wdw=1e-2,
                           half_life=20, num_warmup_steps=0,
                           training_steps=10, rs=0.3, grad_clip_norm=1e-2)
    opt = run_against_optax(args)
    assert opt.clip_norm == 1e-2
    grads = {'a': torch.full((3,), 4.0), 'b': torch.zeros(2)}
    clipped = opt.clip(grads)                 # global norm sqrt(48)
    assert torch.allclose(torch.cat([g.reshape(-1) for g in
                                     clipped.values()]).norm(),
                          torch.tensor(1e-2))


def test_ema_rider_is_refused():
    """The EMA rider refuses a decay outside (0, 1), as the JAX package's
    ``with_param_ema`` asserts."""
    model = evflownet.Model(event_representation_depth=4, base_channels=8)
    args = SimpleNamespace(optimizer='RANGER', lr=1e-2, wdw=1e-2,
                           half_life=20, ema_decay=1.5)
    with pytest.raises(ValueError, match='EMA'):
        construct_optimizer(args, model)


def test_schedule_matches_jax():
    from dvs_of_training_framework_tpu.training.optimizers import \
        make_lr_schedule as jax_schedule
    for kwargs in ({}, {'delay_steps': 5},
                   {'delay_steps': 5, 'rewarmup_steps': 3}):
        want = jax_schedule(1e-3, 4, 100.0, **kwargs)
        got = make_lr_schedule(1e-3, 4, 100.0, **kwargs)
        for step in range(12):
            assert got(step) == pytest.approx(float(want(step)),
                                              rel=1e-6, abs=0.0), step
