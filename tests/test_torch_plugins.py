"""Port parity: the model-plugin contract, RecurrentFlowNet, DummyFlowNet
and ``--mish`` against the JAX package's plugins.

JAX weights reach the port through ``utils/convert.flax_to_torch``; the
JAX plugins run on their CPU path (the plain scatter and the XLA
kernel-MLP, as tests/training/test_recurrent.py runs them) but for the
bf16 recipe, whose kernel-MLP runs the Pallas kernel in interpret mode
as tests/test_torch_recipe.py runs it.

- The loader: ``EVFlowNet``, ``RecurrentFlowNet`` and ``DummyFlowNet``
  resolve to the port's own modules wherever the path points, and the
  root plugin directories of those names are never imported; another
  directory loads as a torch plugin.
- RecurrentFlowNet at depth 3, base 4, hidden 4, 32x32, batch 2, L = 2,
  prefix 0 and 1: flows rtol 1e-4 / atol 1e-6, features rtol 1e-4 /
  atol 1e-5, ``flow_ts`` exactly and the parameter gradients rtol 1e-3 /
  atol 1e-4 times the leaf's scale (tests/test_torch_model.py); a golden
  sequence of 7 RANGER steps, each loss at rtol 1e-5 and the parameters
  after it at rtol 1e-5 / atol 1e-7 (tests/test_torch_train_step.py);
  and 3 steps of the bf16 recipe, with both groups training from the
  first, under tests/test_torch_recipe.py's rule: each leaf within twice
  the JAX package's own bf16-vs-fp32 gap (+1e-7).  Over 7 steps the bf16
  roundings that fall the other way compound, as that test notes for
  ``predictor.dec0.bias``: there single leaves measured 2.75 (prefix 0)
  and up to 8.8 (prefix 1) times that gap.
- DummyFlowNet: zero flows at its init; one optimizer group whose steps
  equal the JAX package's (the same tolerances); its optax state carried
  across by ``optax_state_to_torch`` continues the run.
- ``--mish``: EVFlowNet's flows and features at tests/test_torch_model.py's
  tolerances.
- Both new inference wrappers against the JAX plugins' at the rtol 1e-4 /
  atol 1e-6 of tests/test_torch_eval_cli.py::test_inference_matches_jax.
- The converter maps the RecurrentFlowNet tree (46 leaves) and the
  DummyFlowNet tree (a top-level ``flow_bias``) both ways exactly.
- The CLIs on the CPU: the evaluation CLI refuses multi-element
  windows; ``train.main()`` with ``--flownet_path
  RecurrentFlowNet`` on 2-element shards trains 3 steps, a run stopped at
  step 2 resumes to the same step-3 state exactly, and the evaluation
  CLI's ``main()`` scores it.
"""
import contextlib
import functools
import importlib
import pickle
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvs_of_training_framework_tpu.data.schema as jax_schema
from dvs_of_training_framework_tpu.losses import \
    MultiScaleLoss as JaxMultiScaleLoss
from dvs_of_training_framework_tpu.models import \
    load_model_class as jax_load_model_class
from dvs_of_training_framework_tpu.training import optimizers as jax_opt
from dvs_of_training_framework_tpu.training import state as jax_state
from dvs_of_training_framework_tpu_torch import test as eval_cli
from dvs_of_training_framework_tpu_torch import train as train_cli
from dvs_of_training_framework_tpu_torch.data import schema
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import (
    BaseOpticalFlow, dummy_flownet, evflownet, loader, recurrent_flownet)
from dvs_of_training_framework_tpu_torch.tools import prepare_batches
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, current_learning_rates,
    make_train_step)
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from dvs_of_training_framework_tpu_torch.utils.convert import (
    flax_to_torch, load_flax_params, optax_state_to_torch, torch_to_flax)
from tests.helpers import data_path
from tests.test_torch_eval_cli import jax_checkpoint, random_windows
from tests.test_torch_recipe import FACTOR, jax_losses, port_losses
from tests.test_torch_sequences import (jax_init, make_sequence_collated,
                                        offset_flow_biases)
from tests.test_torch_train_step import ARGS

REPO = Path(__file__).resolve().parents[1]
H = W = 32
SHAPES = [(H >> s, W >> s) for s in (3, 2, 1, 0)]
CAPACITY = 256
SMALL = dict(event_representation_depth=3, base_channels=4,
             hidden_channels=4)


# --- the loader ------------------------------------------------------------

@pytest.mark.parametrize('name', ['EVFlowNet', 'RecurrentFlowNet',
                                  'DummyFlowNet'])
def test_loader_resolves_the_port_plugins(name):
    want = importlib.import_module(
        f'dvs_of_training_framework_tpu_torch.models.'
        f'{loader.PORT_PLUGINS[name]}')
    before = {k: v for k, v in sys.modules.items()
              if k.split('.')[0] == name}
    # importing a plugin directory would fail the test
    with mock.patch.object(loader, 'import_module',
                           side_effect=AssertionError('imported')):
        for path in (name, REPO / name, Path('/elsewhere') / name):
            assert loader.load_model_class(path) is want
            assert loader.load_plugin(path) is want
    assert {k: v for k, v in sys.modules.items()
            if k.split('.')[0] == name} == before
    assert issubclass(want.OpticalFlow, BaseOpticalFlow)


def test_loader_imports_a_torch_plugin_directory(tmp_path):
    plugin = tmp_path / 'TinyFlowNet'
    plugin.mkdir()
    (plugin / 'net.py').write_text(
        'from dvs_of_training_framework_tpu_torch.models.dummy_flownet '
        'import Model as _Dummy\n'
        'import torch\n\n\n'
        'class Model(_Dummy):\n'
        '    def __init__(self, max_sequence_length=1, generator=None,\n'
        '                 device=None):\n'
        '        super().__init__(max_sequence_length=max_sequence_length,\n'
        '                         device=device)\n'
        '        self.mix = torch.nn.Linear(2, 2)\n')
    (plugin / '__init__.py').write_text(
        'from dvs_of_training_framework_tpu_torch.models.dummy_flownet '
        'import OpticalFlow  # noqa: F401\n')
    args = train_cli.parse_args(['-m', str(tmp_path / 'run'), '-d', 'cpu',
                                 '--flownet_path', str(plugin)])
    model = loader.init_model(args, torch.device('cpu'))
    assert type(model).__module__ == 'TinyFlowNet.net'
    assert loader.output_axes(model) == {'flow_bias': None,
                                         'mix.weight': 0, 'mix.bias': None}
    assert set(construct_optimizer(args, model).groups) == {'predictor'}
    assert loader.load_plugin(plugin).OpticalFlow is \
        dummy_flownet.OpticalFlow


# --- RecurrentFlowNet -------------------------------------------------------

def jax_recurrent(prefix, dtype='float32', interpret=False):
    module = jax_load_model_class(REPO / 'RecurrentFlowNet')
    model = module.Model(prefix_length=prefix, max_sequence_length=2,
                         dtype=dtype, **SMALL)
    if not interpret:
        return model, None
    # the recipe's kernel-MLP through the Pallas kernel in interpret mode
    # (the plugin builds EVFlowNet's QuantizationLayer with its defaults)
    return model, mock.patch.object(
        module, 'QuantizationLayer', functools.partial(
            module.QuantizationLayer, kernel_mlp='interpret'))


def port_recurrent(params, prefix, dtype='float32'):
    model = recurrent_flownet.Model(prefix_length=prefix,
                                    max_sequence_length=2, dtype=dtype,
                                    **SMALL)
    load_flax_params(model, params)
    return model


@pytest.fixture(scope='module')
def batches():
    collated = [make_sequence_collated(s) for s in range(3)]
    return ([jax.tree_util.tree_map(jnp.asarray, jax_schema.pad_batch(
                c, capacity=CAPACITY)) for c in collated],
            [schema.pad_batch(c, CAPACITY).to('cpu') for c in collated])


def recurrent_params(jax_batch, prefix=0):
    return offset_flow_biases(jax_init(jax_recurrent(prefix)[0], jax_batch,
                                       0, (H, W)))


@pytest.mark.parametrize('prefix', [0, 1])
def test_recurrent_forward_and_gradients_match_jax(batches, prefix):
    jb, batch = batches[0][0], batches[1][0]
    params = recurrent_params(jb, prefix)
    model, _ = jax_recurrent(prefix)
    rng = np.random.default_rng(4)
    cots = [rng.normal(size=(2, 2, h, w)).astype(np.float32)
            for h, w in SHAPES]

    @jax.jit
    def objective(p):
        flows, flow_ts, flow_sidx, features = model.apply(
            {'params': p}, jb.events, jb.timestamps, jb.sample_idx, (H, W),
            intermediate=True)
        value = sum(jnp.sum(f * c) for f, c in zip(flows, cots))
        return value, (flows, flow_ts, flow_sidx, features)

    (value, (flows, flow_ts, flow_sidx, features)), grads = \
        jax.value_and_grad(objective, has_aux=True)(params)

    port = port_recurrent(params, prefix)
    got_flows, got_ts, got_sidx, got_features = port(
        batch.events, batch.timestamps, batch.sample_idx, (H, W),
        intermediate=True)
    for want, got in zip(features, got_features):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-4, atol=1e-5)
    for want, got in zip(flows, got_flows):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(flow_ts))
    np.testing.assert_array_equal(got_ts.numpy(), batch.timestamps.numpy()
                                  .reshape(2, 3)[:, prefix:prefix + 2])
    np.testing.assert_array_equal(got_sidx.numpy(), np.asarray(flow_sidx))

    got_value = sum((f * torch.from_numpy(c)).sum()
                    for f, c in zip(got_flows, cots))
    got_value.backward()
    np.testing.assert_allclose(float(got_value.detach()), float(value),
                               rtol=1e-4)
    want_grads = flax_to_torch(grads)
    assert set(want_grads) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        want = want_grads[name].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)
    # the state after the prefix element feeds the predictor: the second
    # GRU step matters only with prefix 1
    assert np.abs(grads['gru']['update']['kernel']).max() > 0


def run_jax(model, params, jax_batches, precision, steps=7, patch=None,
            args=ARGS):
    tx = jax_opt.construct_optimizer(args, params)
    step = jax_state.make_train_step(model, jax_losses(precision), tx,
                                     [0.5, 1, 1], accumulation_steps=1,
                                     is_raw=True)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)
    losses = []
    with patch or contextlib.nullcontext():
        for i in range(steps):
            state, (loss, _) = step(state, jax_batches[i % 3])
            losses.append(float(loss))
    return state, losses


def run_port(model, port_batches, precision, steps=7, args=ARGS):
    evaluator = (MultiScaleLoss(SHAPES) if precision == 'highest'
                 else port_losses(precision))
    step_fn = make_train_step(model, evaluator,
                              construct_optimizer(args, model), [0.5, 1, 1],
                              1)
    state, losses = create_train_state(), []
    for i in range(steps):
        state, (loss, _) = step_fn(state, port_batches[i % 3])
        losses.append(float(loss))
    return state, losses


def leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize('prefix', [0, 1])
def test_recurrent_golden_steps_match_jax(batches, prefix):
    jax_batches, port_batches = batches
    params = recurrent_params(jax_batches[0], prefix)
    model, _ = jax_recurrent(prefix)
    state, want_losses = run_jax(model, params, jax_batches, 'highest')
    port = port_recurrent(params, prefix)
    port_state, losses = run_port(port, port_batches, 'highest')
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert port_state.step == int(state.step) == 7
    got = leaves(torch_to_flax(port.state_dict()))
    moved = 0
    for path, want in leaves(state.params).items():
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
        moved += not np.array_equal(got[path], leaves(params)[path])
    assert moved > 40     # both groups trained


@pytest.mark.parametrize('prefix', [0, 1])
def test_recurrent_recipe_steps_match_jax(batches, prefix):
    jax_batches, port_batches = batches
    params = recurrent_params(jax_batches[0], prefix)
    args = SimpleNamespace(**dict(vars(ARGS), rs=0.0))
    model, patch = jax_recurrent(prefix, 'bfloat16', interpret=True)
    state, want_losses = run_jax(model, params, jax_batches, 'bf16x2',
                                 steps=3, patch=patch, args=args)
    golden, _ = run_jax(jax_recurrent(prefix)[0], params, jax_batches,
                        'highest', steps=3, args=args)
    port = port_recurrent(params, prefix, 'bfloat16')
    _, losses = run_port(port, port_batches, 'bf16x2', steps=3, args=args)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    got = leaves(torch_to_flax(port.state_dict()))
    gold = leaves(golden.params)
    moved = 0
    for path, want in leaves(state.params).items():
        want = np.asarray(want)
        err = np.abs(got[path] - want).max()
        gap = np.abs(want - np.asarray(gold[path])).max()
        assert err <= FACTOR * gap + 1e-7, (
            f'{jax.tree_util.keystr(path)}: port-vs-jax {err:.3e}, jax '
            f'bf16-vs-fp32 {gap:.3e}')
        moved += not np.array_equal(got[path], leaves(params)[path])
    assert moved > 40     # both groups trained


# --- DummyFlowNet ----------------------------------------------------------

def test_dummy_flows_start_at_zero():
    model = dummy_flownet.Model()
    timestamps = torch.tensor([0.0, 0.04, 0.0, 0.05])
    flows, flow_ts, flow_sidx = model(None, timestamps,
                                      torch.tensor([0, 0, 1, 1]), (H, W))
    assert [tuple(f.shape) for f in flows] == [(2, 2, h, w)
                                               for h, w in SHAPES]
    assert not any(f.any() for f in flows)
    assert torch.equal(flow_ts, timestamps.view(2, 2))
    assert flow_sidx.tolist() == [0, 1]


def test_dummy_one_group_steps_match_jax(batches):
    collated = [make_sequence_collated(s, L=1) for s in range(3)]
    jax_batches = [jax_schema.pad_batch(c, capacity=CAPACITY)
                   for c in collated]
    port_batches = [schema.pad_batch(c, CAPACITY).to('cpu')
                    for c in collated]
    module = jax_load_model_class(REPO / 'DummyFlowNet')
    model = module.Model()
    params = {'flow_bias': np.array([0.37, 0.23], np.float32)}
    args = SimpleNamespace(**dict(vars(ARGS), grad_clip_norm=1.0,
                                  ema_decay=0.9))
    tx = jax_opt.construct_optimizer(args, params)
    step = jax_state.make_train_step(model, JaxMultiScaleLoss(SHAPES), tx,
                                     [0.5, 1, 1], accumulation_steps=1,
                                     is_raw=True)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)

    port = dummy_flownet.Model()
    load_flax_params(port, params)
    optimizer = construct_optimizer(args, port)
    assert list(optimizer.groups) == ['predictor']
    assert current_learning_rates(args, 3, optimizer.groups) == \
        [current_learning_rates(args, 3)[1]]
    step_fn = make_train_step(port, MultiScaleLoss(SHAPES), optimizer,
                              [0.5, 1, 1], 1)
    port_state = create_train_state()
    for i in range(7):
        if i == 4:      # carry the JAX optimizer state across and go on
            optimizer.load_state_dict(optax_state_to_torch(state.opt_state,
                                                           port))
            port.load_state_dict(flax_to_torch(state.params))
        state, (want, _) = step(state, jax_batches[i % 3])
        port_state, (loss, _) = step_fn(port_state, port_batches[i % 3])
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5,
                                   err_msg=f'step {i}')
    np.testing.assert_allclose(port.flow_bias.detach().numpy(),
                               np.asarray(state.params['flow_bias']),
                               rtol=1e-5, atol=1e-7)
    ema = optimizer.state_dict()['ema_params']['flow_bias']
    want_ema = optax_state_to_torch(state.opt_state, port)
    np.testing.assert_allclose(ema.numpy(),
                               want_ema['ema_params']['flow_bias'].numpy(),
                               rtol=1e-5, atol=1e-7)
    assert not np.allclose(port.flow_bias.detach().numpy(), [0.37, 0.23])


# --- mish ------------------------------------------------------------------

def test_mish_evflownet_matches_jax(batches):
    jb, batch = batches[0][0], batches[1][0]
    module = jax_load_model_class(REPO / 'EVFlowNet')
    model = module.Model(event_representation_depth=3, base_channels=4,
                         max_sequence_length=2, activation='mish')
    params = offset_flow_biases(jax_init(model, jb, 3, (H, W)))
    flows, _, _, features = jax.jit(lambda p, e, t, s: model.apply(
        {'params': p}, e, t, s, (H, W), intermediate=True))(
        params, jb.events, jb.timestamps, jb.sample_idx)
    port = evflownet.Model(event_representation_depth=3, base_channels=4,
                           max_sequence_length=2, activation='mish')
    load_flax_params(port, params)
    with torch.no_grad():
        got_flows, _, _, got_features = port(
            batch.events, batch.timestamps, batch.sample_idx, (H, W),
            intermediate=True)
    relu = evflownet.Model(event_representation_depth=3, base_channels=4,
                           max_sequence_length=2)
    load_flax_params(relu, params)
    with torch.no_grad():
        relu_features = relu(batch.events, batch.timestamps,
                             batch.sample_idx, (H, W), intermediate=True)[3]
    for want, got, other in zip(features, got_features, relu_features):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-4, atol=1e-5)
        assert not torch.allclose(got, other)      # mish really ran
    for want, got in zip(flows, got_flows):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)


# --- the inference wrappers -------------------------------------------------

@pytest.mark.parametrize('name, kwargs', [('RecurrentFlowNet', SMALL),
                                          ('DummyFlowNet', {})])
def test_wrappers_match_jax(tmp_path, name, kwargs):
    port_module = loader.load_plugin(name)
    weights = port_module.Model(generator=torch.Generator().manual_seed(5),
                                **kwargs).state_dict()
    if name == 'DummyFlowNet':
        weights = {'flow_bias': torch.tensor([0.37, -0.23])}
    ckpt = jax_checkpoint(weights, tmp_path / 'jax')
    jax_of = importlib.import_module(name).OpticalFlow(
        (48, 48), model=ckpt, event_capacity=4096, **kwargs)
    port_of = port_module.OpticalFlow((48, 48), model=ckpt,
                                      event_capacity=4096, device='cpu',
                                      **kwargs)
    windows = random_windows(np.random.default_rng(1), 3)
    args = ([w for w, _, _ in windows], [s for _, s, _ in windows],
            [t for _, _, t in windows])
    want = jax_of(*args, return_all=True)
    got = port_of(*args, return_all=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    assert np.abs(got[-1]).max() > 0


# --- the converter -----------------------------------------------------------

@pytest.mark.parametrize('name', ['RecurrentFlowNet', 'DummyFlowNet'])
def test_converter_round_trips(batches, name):
    jb = batches[0][0]
    module = jax_load_model_class(REPO / name)
    kwargs = dict(max_sequence_length=2, **(SMALL if name ==
                                            'RecurrentFlowNet' else {}))
    model = module.Model(**kwargs)
    params = jax_init(model, jb, 2, (H, W))
    port = loader.load_model_class(name).Model(**kwargs)
    load_flax_params(port, params)
    want = leaves(params)
    got = leaves(torch_to_flax(port.state_dict()))
    assert len(got) == len(want) == (46 if name == 'RecurrentFlowNet'
                                     else 1)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_full_width_recurrent_tree():
    """The flax tree at L = 2 and the defaults: 46 leaves, 3,404,085
    parameters, and the port's names and shapes."""
    module = jax_load_model_class(REPO / 'RecurrentFlowNet')
    model = module.Model(max_sequence_length=2)
    ev = jax_schema.pad_events({k: np.zeros(0) for k in (
        'x', 'y', 'timestamp', 'polarity', 'element_index',
        'sample_index')}, 1, 8)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), ev, jnp.arange(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.int32), (32, 32)))['params']
    want = {name: tuple(v.shape) for name, v in flax_to_torch(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes)).items()}
    port = recurrent_flownet.Model(max_sequence_length=2)
    got = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert got == want and len(got) == 46
    assert sum(p.numel() for p in port.parameters()) == 3404085


# --- the CLIs on the CPU ----------------------------------------------------

@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_eval_root(tmp_path):
    """tests/test_torch_eval_cli.py's miniature MVSEC sequence under
    ``raw/`` with its ``info/`` file; returns the root and a test
    config."""
    rng = np.random.default_rng(0)
    t0, n, size = 100.0, 5000, 64
    events = np.stack([rng.integers(0, size, n).astype(np.float64),
                       rng.integers(0, size, n).astype(np.float64),
                       np.sort(rng.uniform(t0, t0 + 2.0, n)),
                       rng.choice([-1.0, 1.0], n)], axis=1)
    image_ts = np.arange(t0, t0 + 2.0, 0.1)
    root = tmp_path / 'eval_root'
    seq_dir = root / 'raw' / 'mini' / 'mini_seq'
    seq_dir.mkdir(parents=True)
    with h5py.File(seq_dir / 'mini_seq1_data.hdf5', 'w') as f:
        left = f.create_group('davis').create_group('left')
        left.create_dataset('events', data=events)
        left.create_dataset('image_raw_ts', data=image_ts)
    gt_dir = root / 'raw' / 'mini' / 'FlowGT' / 'mini_seq'
    gt_dir.mkdir(parents=True)
    gt_ts = np.arange(t0, t0 + 2.2, 0.1)
    np.savez(gt_dir / 'mini_seq1_gt_flow_dist.npz', timestamps=gt_ts,
             x_flow_dist=np.full((gt_ts.size, size, size), 0.5, np.float32),
             y_flow_dist=np.zeros((gt_ts.size, size, size), np.float32))
    (root / 'info').mkdir()
    with h5py.File(root / 'info' / 'mini.hdf5', 'w') as f:
        f.create_dataset('set_name', data=np.array([b'mini_seq1']))
        f.create_dataset('start_time', data=np.array([t0]))
    config = tmp_path / 'testing.json'
    config.write_text('{"mini": {"mini_seq1": {"step": [1], "start": 0.2, '
                      '"stop": 0.8, "test_shape": [48, 48], "crop_type": '
                      '"central", "is_car": false}}}')
    return root, config


@pytest.mark.parametrize('flags', [['--max-sequence-length', '2'],
                                   ['--max-sequence-length', '2',
                                    '--prefix-length', '1']])
def test_eval_cli_refuses_multi_element_windows(tmp_path, flags):
    with pytest.raises(ValueError, match='one element each'):
        eval_cli.parse_args(['-m', str(tmp_path), '-o', str(tmp_path),
                             '--flownet_path', 'RecurrentFlowNet'] + flags)
    assert eval_cli.parse_args(['-m', str(tmp_path), '-o', str(tmp_path),
                                '--flownet_path', 'RecurrentFlowNet',
                                '--dynamic-sample-length']).device == 'cuda'


def test_recurrent_clis_train_resume_and_evaluate(tmp_path, monkeypatch,
                                                  one_torch_thread):
    mvsec = tmp_path / 'mvsec'
    mvsec.mkdir()
    for split in ('outdoor_day1', 'outdoor_day2'):
        (mvsec / split).symlink_to(data_path)
    monkeypatch.setenv('DVS_DATA_PATH', str(mvsec))
    sequence = ['--min-sequence-length', '2', '--max-sequence-length', '2']
    shards = tmp_path / 'shards'
    prepare_batches.main(prepare_batches.parse_args(
        ['-o', str(shards), '-s', '6', '--samples-per-file', '2',
         '--height', '64', '--width', '64', '-mbs', '2', '--num_workers',
         '0'] + sequence))

    def main(run, steps, extra=()):
        train_cli.main(['-m', str(run), '-d', 'cpu', '-bs', '2', '-mbs', '2',
                        '-ne', str(steps), '--height', '64', '--width', '64',
                        '--num_workers', '0', '--event-capacity', '16384',
                        '--flownet_path', 'RecurrentFlowNet',
                        '--preprocessed-dataset-path', str(shards),
                        '--checkpointing_interval', '1',
                        '--permanent_interval', '1', '-vp', '3',
                        '--device-queue-window', '1']
                       + sequence + list(extra))

    main(tmp_path / 'whole', 3)
    main(tmp_path / 'resumed', 2)
    main(tmp_path / 'resumed', 3, ['--allow-arguments-change'])
    whole = Serializer(tmp_path / 'whole').read_state_dict(3)
    resumed = Serializer(tmp_path / 'resumed').read_state_dict(3)
    assert Serializer(tmp_path / 'resumed').list_known_steps() == [0, 1, 2,
                                                                   3]
    assert set(whole['model']) == {n for n, _ in recurrent_flownet.Model()
                                   .named_parameters()}
    assert int(resumed['samples_passed']) == int(whole['samples_passed'])
    for key, value in whole['model'].items():
        assert torch.equal(resumed['model'][key], value), key
    for key, group in whole['optimizer']['groups'].items():
        assert group['count'] == resumed['optimizer']['groups'][key][
            'count'] == 3
    start = Serializer(tmp_path / 'whole').read_state_dict(0)['model']
    assert not torch.equal(start['gru.update.weight'],
                           whole['model']['gru.update.weight'])

    root, config = write_eval_root(tmp_path)
    monkeypatch.setenv('DVS_DATA_ROOT', str(root))
    out = tmp_path / 'eval'
    eval_cli.main(['-m', str(tmp_path / 'whole'), '-o', str(out), '-s', '3',
                   '-d', 'cpu', '--flownet_path', 'RecurrentFlowNet',
                   '--test-config', str(config)])
    (record,) = pickle.loads((out / 'step_3.pkl').read_bytes())
    assert np.isfinite([record.mAEE, record.mpAEE, record.mMedEE]).all()
    assert len(record.windows) == 5
