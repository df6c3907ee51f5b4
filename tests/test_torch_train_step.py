"""Port parity: the whole golden training step against the JAX package's
``make_train_step``, seven steps, with accumulation 1 and 2.

EVFlowNet at depth 4, base 8, 32x32, batch 2, RANGER with a
representation delay of 3 optimizer steps, loss weights (0.5, 1, 1), on
three batches made with numpy and cycled.  The flow heads start with
biases of (0.37, 0.23) px: at the flax init the flows are ~1e-3 px, so
every warp samples next to a pixel centre, where the bilinear gradient
jumps and the rounding of the grid arithmetic picks the side (the JAX
step's own gradient moves by 10% between eager and jitted runs there).
Each step's loss takes rtol 1e-5 (the frameworks sum fp32 convolutions
in another order), and the parameters after the last step the rtol 1e-5
/ atol 1e-7 of tests/test_torch_optim.py.
"""
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvs_of_training_framework_tpu.data.schema import \
    pad_batch as jax_pad_batch
from dvs_of_training_framework_tpu.losses import \
    MultiScaleLoss as JaxMultiScaleLoss
from dvs_of_training_framework_tpu.models import load_model_class
from dvs_of_training_framework_tpu.training import optimizers as jax_opt
from dvs_of_training_framework_tpu.training import state as jax_state
from dvs_of_training_framework_tpu_torch.data.schema import pad_batch
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_train_step)
from dvs_of_training_framework_tpu_torch.utils.convert import (
    load_flax_params, torch_to_flax)

REPO = Path(__file__).resolve().parents[1]
B, H, W, CAPACITY = 2, 32, 32, 256
ARGS = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                       half_life=100000, num_warmup_steps=0,
                       training_steps=10, rs=0.3)
SHAPES = [(H // 2 ** i, W // 2 ** i) for i in range(4)][::-1]


def make_collated(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(150, 240))
    events = {
        'x': rng.integers(0, W, n),
        'y': rng.integers(0, H, n),
        'timestamp': rng.uniform(0, 0.04, n).astype(np.float32),
        'polarity': rng.choice([-1.0, 1.0], n),
        'element_index': np.zeros(n, np.int64),
        'sample_index': np.sort(rng.integers(0, B, n)),
    }
    # smooth frames, the second shifted: a photometric signal to follow
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    phase = rng.uniform(0, 2 * np.pi)
    images = []
    for b in range(B):
        for shift in (0, 1 + b):
            images.append(128 + 100 * np.sin((xx + shift) / 3.0 + phase)
                          * np.cos(yy / 5.0))
    return {'events': events,
            'timestamps': np.tile([0.0, 0.04], B).astype(np.float32),
            'sample_idx': np.repeat(np.arange(B), 2),
            'images': np.stack(images).astype(np.float32),
            'size': B}


@pytest.mark.parametrize('accumulation', [1, 2])
def test_train_step_matches_jax(accumulation):
    collated = [make_collated(s) for s in range(3)]

    module = load_model_class(REPO / 'EVFlowNet')
    model = module.Model(event_representation_depth=4, base_channels=8)
    jax_batches = [jax_pad_batch(c, capacity=CAPACITY) for c in collated]
    first = jax_batches[0]
    params = model.init(jax.random.PRNGKey(0), first.events,
                        first.timestamps, first.sample_idx, (H, W))['params']
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (np.array([0.37, 0.23], np.float32)
                         if 'flow' in jax.tree_util.keystr(path)
                         and p.ndim == 1 else np.asarray(p)), params)
    tx = jax_opt.construct_optimizer(ARGS, params)
    jax_step = jax_state.make_train_step(
        model, JaxMultiScaleLoss(SHAPES), tx, [0.5, 1, 1],
        accumulation_steps=accumulation, is_raw=True)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)

    port = evflownet.Model(event_representation_depth=4, base_channels=8)
    load_flax_params(port, params)
    step_fn = make_train_step(port, MultiScaleLoss(SHAPES),
                              construct_optimizer(ARGS, port), [0.5, 1, 1],
                              accumulation)
    port_state = create_train_state()
    batches = [pad_batch(c, CAPACITY).to('cpu') for c in collated]

    for i in range(7):
        state, (want_loss, _) = jax_step(state, jax_batches[i % 3])
        port_state, (loss, terms) = step_fn(port_state, batches[i % 3])
        assert len(terms) == 3 and len(terms[0]) == 4
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                                   err_msg=f'step {i}')
    assert port_state.step == int(state.step) == 7 // accumulation
    assert port_state.micro_step == int(state.micro_step) == 7

    got = dict(jax.tree_util.tree_leaves_with_path(
        torch_to_flax(port.state_dict())))
    moved = 0
    for path, want in jax.tree_util.tree_leaves_with_path(state.params):
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    for path, start in jax.tree_util.tree_leaves_with_path(params):
        moved += not np.array_equal(got[path], np.asarray(start))
    assert moved > 30     # the step really trained (both groups)
