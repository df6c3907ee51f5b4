"""Port parity: dense mode (``--ev_images``) and representation baking
against the JAX package.

JAX weights reach the port through ``utils/convert``; the JAX models run
on their CPU path (the plain scatter and the XLA kernel-MLP), but in bf16,
where the kernel-MLP runs the Pallas kernel in interpret mode as
tests/test_torch_recipe.py runs it (the XLA form computes the MLP in
bf16, the kernel and the port in fp32).

- ``compute_event_image`` of the three plugins equals the root plugins'
  bit for bit on the rows the dataset hands it from the ``tests/data``
  fixtures, with 1- and 2-element samples, at depth 3 and 9.
- ``quantize`` against ``model.apply(..., method=model.quantize)``:
  EVFlowNet at L = 1 and 2, RecurrentFlowNet, DummyFlowNet in fp32 at
  the rtol/atol 1e-5 of
  tests/test_torch_model.py::test_quantization_layer_matches_flax; in
  bf16 within one bf16 ulp of the grid's largest value (2^-7 * max, the
  grid bound of tests/test_torch_recipe.py).
- ``forward(raw=False)``: flows, ``flow_ts`` and every parameter
  gradient at the tolerances of
  tests/test_torch_model.py::test_model_forward_and_gradients_match_flax;
  the quantization layer's gradients are exactly zero on both sides.
- Three RANGER steps on dense batches built by both ``pad_batch``es, with
  ``--representation-start 0``, so that the zero-gradient quantization
  leaves move by weight decay and Lookahead, against JAX
  ``make_train_step(..., is_raw=False)`` with accumulation 1 and 2: each
  loss at rtol 1e-5 and every leaf after the last step at the rtol 1e-5
  / atol 1e-7 of tests/test_torch_train_step.py.
- The bake tool on the CPU (``-d cpu``) against ``scripts/
  quantize_preprocessed.py``'s ``main`` over shards of the fixtures, from
  one ``--sp`` checkpoint, at the quantize tolerance; the capacity skips
  batches, the first before the resume point: a resume equals one go bit
  for bit, and a changed argument is refused.
- The training CLI with ``--ev_images``: 3 steps on baked shards with
  raw validation, a run stopped at step 2 resumes to the same step-3
  state exactly, a resume with the flag flipped is refused; and a step
  over the raw fixtures through the plugin's ``compute_event_image``.
"""
import contextlib
import functools
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvs_of_training_framework_tpu.data.schema as jax_schema
from dvs_of_training_framework_tpu.data.dataset import \
    DatasetImpl as JaxDatasetImpl
from dvs_of_training_framework_tpu.losses import \
    MultiScaleLoss as JaxMultiScaleLoss
from dvs_of_training_framework_tpu.models import \
    load_model_class as jax_load_model_class
from dvs_of_training_framework_tpu.training import optimizers as jax_opt
from dvs_of_training_framework_tpu.training import state as jax_state
from dvs_of_training_framework_tpu_torch import train as train_cli
from dvs_of_training_framework_tpu_torch.data import schema
from dvs_of_training_framework_tpu_torch.data.dataset import DatasetImpl
from dvs_of_training_framework_tpu_torch.data.preprocessed import \
    PreprocessedDataloader
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import (dummy_flownet,
                                                        evflownet, loader,
                                                        recurrent_flownet)
from dvs_of_training_framework_tpu_torch.tools import quantize_preprocessed
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_train_step)
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from dvs_of_training_framework_tpu_torch.utils.convert import (
    flax_to_torch, load_flax_params, torch_to_flax)
from tests.dataset.test_preprocessed import write_shards
from tests.helpers import data_path
from tests.test_torch_eval_cli import jax_checkpoint
from tests.test_torch_sequences import (jax_init, make_sequence_collated,
                                        offset_flow_biases)
from tests.test_torch_train_step import ARGS

REPO = Path(__file__).resolve().parents[1]
H = W = 32
SHAPES = [(H >> s, W >> s) for s in (3, 2, 1, 0)]
CAPACITY = 256
DEPTH = 3
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_cli.py: the CLI tests
    train the full-width model, and parallel test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- compute_event_image -----------------------------------------------------

@pytest.fixture(scope='module')
def image_calls():
    """The arguments the dataset hands ``event_image_fn`` for the first
    fixtures, as 1- and 2-element samples."""
    calls = []

    def capture(events, start_ts, stop_ts, shape):
        calls.append((np.array(events), np.array(start_ts),
                      np.array(stop_ts), tuple(shape)))
        return np.zeros((len(start_ts), 1, *shape), np.float32)

    for length in (1, 2):
        dataset = DatasetImpl(path=data_path, shape=[64, 64],
                              augmentation=False, collapse_length=1,
                              is_raw=False, min_seq_length=length,
                              max_seq_length=length, event_image_fn=capture)
        for i in range(3):
            dataset[i]
    return calls


@pytest.mark.parametrize('name', ['EVFlowNet', 'RecurrentFlowNet',
                                  'DummyFlowNet'])
def test_event_images_match_root_plugins(image_calls, name):
    want_fn = jax_load_model_class(REPO / name).compute_event_image
    got_fn = loader.load_model_class(name).compute_event_image
    assert {len(start) for _, start, _, _ in image_calls} == {1, 2}
    for args in image_calls:
        for depth in (3, 9):
            got = got_fn(*args, depth=depth)
            want = want_fn(*args, depth=depth)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0


# --- quantize ----------------------------------------------------------------

SMALL = dict(event_representation_depth=DEPTH, base_channels=4)


def jax_plugin(name, L, dtype='float32'):
    """The JAX plugin's model, and the patch that runs its kernel-MLP in
    interpret mode (bf16) or None."""
    module = jax_load_model_class(REPO / name)
    if name == 'DummyFlowNet':
        return module.Model(max_sequence_length=L), None
    kwargs = dict(SMALL, max_sequence_length=L, dtype=dtype)
    if name == 'RecurrentFlowNet':
        kwargs['hidden_channels'] = 4
    if dtype == 'float32':
        return module.Model(**kwargs), None
    if name == 'EVFlowNet':
        return module.Model(kernel_mlp='interpret', **kwargs), None
    return module.Model(**kwargs), mock.patch.object(
        module, 'QuantizationLayer', functools.partial(
            module.QuantizationLayer, kernel_mlp='interpret'))


def port_plugin(name, L, params, dtype='float32'):
    if name == 'DummyFlowNet':
        model = dummy_flownet.Model(max_sequence_length=L)
    elif name == 'RecurrentFlowNet':
        model = recurrent_flownet.Model(max_sequence_length=L, dtype=dtype,
                                        hidden_channels=4, **SMALL)
    else:
        model = evflownet.Model(max_sequence_length=L, dtype=dtype, **SMALL)
    load_flax_params(model, params)
    return model


def raw_pair(seed, L):
    collated = make_sequence_collated(seed, L=L, H=H, W=W)
    return (collated, jax.tree_util.tree_map(jnp.asarray, jax_schema.pad_batch(
                collated, capacity=CAPACITY)),
            schema.pad_batch(collated, CAPACITY).to('cpu'))


@pytest.mark.parametrize('name, L, dtype', [
    ('EVFlowNet', 1, 'float32'), ('EVFlowNet', 2, 'float32'),
    ('RecurrentFlowNet', 2, 'float32'), ('DummyFlowNet', 1, 'float32'),
    ('EVFlowNet', 2, 'bfloat16'), ('RecurrentFlowNet', 2, 'bfloat16')])
def test_quantize_matches_jax(name, L, dtype):
    _, jb, batch = raw_pair(0, L)
    model, patch = jax_plugin(name, L, dtype)
    params = jax_init(model, jb, 1, (H, W)) if name != 'DummyFlowNet' \
        else {'flow_bias': np.array([0.37, 0.23], np.float32)}
    with patch or contextlib.nullcontext():
        want = np.asarray(model.apply(
            {'params': params}, jb.events, jb.timestamps, jb.sample_idx,
            (H, W), method=model.quantize))
    port = port_plugin(name, L, params, dtype)
    with torch.inference_mode():
        got = port.quantize(batch.events, batch.timestamps,
                            batch.sample_idx, (H, W))
    channels = L if name == 'DummyFlowNet' else L * DEPTH
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tuple(got.shape) == want.shape == (2, channels, H, W)
    got = got.numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= BF16_ULP * scale
    if name != 'DummyFlowNet':
        assert np.abs(want).max() > 0


# --- the dense forward and its gradients --------------------------------------

@pytest.mark.parametrize('name, L', [('EVFlowNet', 1), ('EVFlowNet', 2),
                                     ('RecurrentFlowNet', 2)])
def test_dense_forward_and_gradients_match_jax(name, L):
    _, jb, batch = raw_pair(2, L)
    model, _ = jax_plugin(name, L)
    # the quantization layer is created by a raw call
    params = offset_flow_biases(jax_init(model, jb, 3, (H, W)))
    rng = np.random.default_rng(4)
    data = rng.normal(size=(2, L * DEPTH, H, W)).astype(np.float32)
    cots = [rng.normal(size=(2, 2, h, w)).astype(np.float32)
            for h, w in SHAPES]

    @jax.jit
    def objective(p):
        flows, flow_ts, flow_sidx = model.apply(
            {'params': p}, jnp.asarray(data), jb.timestamps, jb.sample_idx,
            (H, W), raw=False)
        value = sum(jnp.sum(f * c) for f, c in zip(flows, cots))
        return value, (flows, flow_ts, flow_sidx)

    (value, (flows, flow_ts, flow_sidx)), grads = \
        jax.value_and_grad(objective, has_aux=True)(params)

    port = port_plugin(name, L, params)
    got_flows, got_ts, got_sidx = port(torch.from_numpy(data),
                                       batch.timestamps, batch.sample_idx,
                                       (H, W), raw=False)
    for want, got in zip(flows, got_flows):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(flow_ts))
    np.testing.assert_array_equal(got_sidx.numpy(), np.asarray(flow_sidx))
    got_value = sum((f * torch.from_numpy(c)).sum()
                    for f, c in zip(got_flows, cots))
    np.testing.assert_allclose(float(got_value.detach()), float(value),
                               rtol=1e-4)
    named = dict(port.named_parameters())
    got_grads = dict(zip(named, torch.autograd.grad(
        got_value, list(named.values()), materialize_grads=True)))
    want_grads = flax_to_torch(grads)
    assert set(want_grads) == set(got_grads)
    quantization = [k for k in named if k.startswith('quantization_layer.')]
    assert len(quantization) == 6
    for key in quantization:
        assert not want_grads[key].any() and not got_grads[key].any(), key
    for key, got in got_grads.items():
        want = want_grads[key].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=key)


# --- dense training steps -------------------------------------------------------

def dense_collated(model, params, seed):
    """A raw batch of the port's sequence maker, baked by the JAX model:
    the dense batch dict a quantized shard decodes to."""
    collated, jb, _ = raw_pair(seed, 1)
    data = np.asarray(model.apply({'params': params}, jb.events,
                                  jb.timestamps, jb.sample_idx, (H, W),
                                  method=model.quantize))
    dense = {k: v for k, v in collated.items() if k != 'events'}
    dense['data'] = data
    return dense


@pytest.mark.parametrize('accumulation', [1, 2])
def test_dense_train_steps_match_jax(accumulation):
    model, _ = jax_plugin('EVFlowNet', 1)
    jb = raw_pair(0, 1)[1]
    params = offset_flow_biases(jax_init(model, jb, 5, (H, W)))
    collated = [dense_collated(model, params, s) for s in range(3)]
    jax_batches = [jax_schema.pad_batch(c) for c in collated]
    port_batches = [schema.pad_batch(c).to('cpu') for c in collated]
    assert all(b.events is None and b.data is not None
               for b in jax_batches + port_batches)

    args = type(ARGS)(**dict(vars(ARGS), rs=0.0))
    tx = jax_opt.construct_optimizer(args, params)
    jax_step = jax_state.make_train_step(
        model, JaxMultiScaleLoss(SHAPES), tx, [0.5, 1, 1],
        accumulation_steps=accumulation, is_raw=False)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)
    port = port_plugin('EVFlowNet', 1, params)
    step_fn = make_train_step(port, MultiScaleLoss(SHAPES),
                              construct_optimizer(args, port), [0.5, 1, 1],
                              accumulation, is_raw=False)
    port_state = create_train_state()
    for i in range(3 * accumulation):
        state, (want_loss, _) = jax_step(state, jax_batches[i % 3])
        port_state, (loss, _) = step_fn(port_state, port_batches[i % 3])
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                                   err_msg=f'step {i}')
    assert port_state.step == int(state.step) == 3

    got = dict(jax.tree_util.tree_leaves_with_path(
        torch_to_flax(port.state_dict())))
    start = dict(jax.tree_util.tree_leaves_with_path(params))
    moved = []
    for path, want in jax.tree_util.tree_leaves_with_path(state.params):
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
        if not np.array_equal(got[path], np.asarray(start[path])):
            moved.append(jax.tree_util.keystr(path))
    # the zero-gradient representation leaves moved too (weight decay;
    # their biases start at zero, which decay keeps)
    assert {p for p in moved if 'quantization_layer' in p} == {
        f"['quantization_layer']['{layer}']['kernel']"
        for layer in ('kernel_hidden1', 'kernel_hidden2', 'kernel_out')}


# --- the bake tool ---------------------------------------------------------------

def read_set(path):
    """Every sample of a quantized shard set, in stream order: the dense
    data, timestamps and images of each batch of 2."""
    reader = PreprocessedDataloader(path, batch_size=2, is_raw=False,
                                    show_progress=False)
    batches = [next(reader) for _ in range(len(reader) // 2)]
    return {key: np.concatenate([b[key] for b in batches])
            for key in ('data', 'timestamps', 'sample_idx', 'images')}


@pytest.fixture(scope='module')
def bake_inputs(tmp_path_factory):
    """Raw HDF5 shards of 9 fixture samples, a JAX checkpoint of seeded
    port weights, and the bake's arguments.  At -mbs 2 the batches from
    sample 0 hold 40, 24, 38, 30, 42 (wrapping), 29, 24, 40 events:
    capacity 39 skips the first, the fifth and the eighth."""
    tmp = tmp_path_factory.mktemp('bake')
    shards, _ = write_shards(tmp, samples_per_file=3, num_files=3)
    weights = evflownet.Model(event_representation_depth=DEPTH,
                              generator=torch.Generator().manual_seed(7)) \
        .state_dict()
    ckpt = jax_checkpoint(weights, tmp / 'jax_run')
    argv = ['-s', '8', '--samples-per-file', '2', '-mbs', '2', '--height',
            '64', '--width', '64', '--num_workers', '0',
            '--event-representation-depth', str(DEPTH),
            '--preprocessed-dataset-path', str(shards),
            '--event-capacity', '39', '-sp', str(ckpt)]
    return tmp, argv


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    monkeypatch.setenv('DVS_DATA_PATH', str(tmp_path))


def bake(out, argv):
    return quantize_preprocessed.main(quantize_preprocessed.parse_args(
        ['-o', str(out), '-d', 'cpu'] + argv))


def test_bake_matches_jax_script(bake_inputs, data_root, capsys):
    from scripts import quantize_preprocessed as jax_script
    tmp, argv = bake_inputs
    stats = bake(tmp / 'port', argv)
    assert (stats.samples, stats.batches, stats.skipped) == (8, 4, 2)
    assert 'Skipping batch with 40 events > capacity 39' in \
        capsys.readouterr().out
    jax_script.main(jax_script.parse_args(
        ['-o', str(tmp / 'jax'), '-d', 'cpu'] + argv))
    got, want = read_set(tmp / 'port'), read_set(tmp / 'jax')
    assert got['data'].shape == (8, DEPTH, 64, 64)
    np.testing.assert_allclose(got['data'], want['data'], rtol=1e-5,
                               atol=1e-5)
    for key in ('timestamps', 'sample_idx', 'images'):
        np.testing.assert_array_equal(got[key], want[key])
    # the stream from sample 2 on: the batch of samples 0-1 was skipped
    dataset = JaxDatasetImpl(path=data_path, shape=[64, 64],
                             augmentation=False, collapse_length=1,
                             is_raw=True, max_seq_length=1)
    np.testing.assert_array_equal(got['images'][:2, 0], dataset[2][2])
    assert np.abs(got['data']).max() > 0


def test_bake_resumes_exactly_and_guards_arguments(bake_inputs, data_root):
    tmp, argv = bake_inputs
    whole = tmp / 'whole'
    bake(whole, argv)
    cut = tmp / 'cut'
    first = bake(cut, argv + ['-s', '4'])
    assert (first.samples, first.skipped) == (4, 1)
    resumed = bake(cut, argv + ['--allow-arguments-change'])
    # from sample 6 on, past the batch skipped before the cut; the batch
    # of samples 4-5 is not baked twice
    assert (resumed.samples, resumed.skipped) == (4, 1)
    got, want = read_set(cut), read_set(whole)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(AssertionError, match='argument'):
        quantize_preprocessed.parse_args(['-o', str(whole), '-d', 'cpu']
                                         + argv + ['--event-capacity', '64'])


def test_stream_position_counts_skipped_batches():
    per_sample = np.array([24, 16, 13, 11, 13, 25, 15, 15, 18])
    position = functools.partial(quantize_preprocessed.stream_position,
                                 per_sample, 2, 39)
    assert [position(n) for n in (0, 2, 4, 6, 8, 10)] == [0, 4, 6, 8, 12,
                                                          14]
    with pytest.raises(ValueError, match='no batch'):
        quantize_preprocessed.stream_position(per_sample, 2, 10, 2)


# --- the training CLI -------------------------------------------------------------

@pytest.fixture
def mvsec_layout(tmp_path, monkeypatch):
    root = tmp_path / 'mvsec'
    root.mkdir()
    (root / 'outdoor_day2').symlink_to(data_path)
    (root / 'outdoor_day1').symlink_to(data_path)
    monkeypatch.setenv('DVS_DATA_PATH', str(root))
    return root


CLI = ['-d', 'cpu', '-bs', '2', '-mbs', '2', '--num_workers', '0',
       '--height', '64', '--width', '64', '-cl', '1', '--optimizer',
       'RANGER', '--event-capacity', '4096', '--checkpointing_interval',
       '1', '--permanent_interval', '1', '-vp', '2', '--ev_images',
       '--event-representation-depth', str(DEPTH)]


def test_train_cli_dense_on_baked_shards(tmp_path, mvsec_layout):
    shards, _ = write_shards(tmp_path, samples_per_file=3, num_files=2)
    sp = tmp_path / 'start.ckpt'
    weights = evflownet.Model(event_representation_depth=DEPTH,
                              generator=torch.Generator().manual_seed(3))
    torch.save({'model': weights.state_dict()}, sp)
    baked = tmp_path / 'baked'
    bake(baked, ['-s', '6', '--samples-per-file', '2', '-mbs', '2',
                 '--height', '64', '--width', '64', '--num_workers', '0',
                 '--event-representation-depth', str(DEPTH),
                 '--preprocessed-dataset-path', str(shards),
                 '--event-capacity', '4096', '-sp', str(sp)])
    argv = CLI + ['--preprocessed-dataset-path', str(baked), '-sp', str(sp),
                  '--representation-start', '1.0']
    validations = []
    run = train_cli.run

    def counted_run(args, train_factory, val_factory, logger, timers=None):
        def val():
            validations.append(1)
            return val_factory()
        return run(args, train_factory, val, logger, timers)

    with mock.patch.object(train_cli, 'run', counted_run):
        train_cli.main(['-m', str(tmp_path / 'whole'), '-ne', '3'] + argv)
    whole = Serializer(tmp_path / 'whole')
    assert whole.list_known_steps() == [0, 1, 2, 3]
    assert len(validations) == 3                   # steps 0, 2 and the end
    # a run stopped at step 2 resumes to the uninterrupted step-3 state
    part = tmp_path / 'part'
    train_cli.main(['-m', str(part), '-ne', '2'] + argv)
    train_cli.main(['-m', str(part), '-ne', '3', '--allow-arguments-change']
                   + argv)
    got = Serializer(part).read_state_dict(3)
    want = whole.read_state_dict(3)
    assert int(got['samples_passed']) == int(want['samples_passed']) == 6
    for key, value in want['model'].items():
        assert torch.equal(got['model'][key], value), key
    start = torch.load(sp)['model']
    # a frozen representation (--representation-start 1.0) stays the
    # baked one; the predictor trained
    moved = {key for key, value in want['model'].items()
             if not torch.equal(value, start[key])}
    assert moved and not any(k.startswith('quantization_layer.')
                             for k in moved)
    # the provenance records --ev_images: a resume without it is refused
    with pytest.raises(AssertionError, match='argument'):
        train_cli.main(['-m', str(part), '-ne', '3']
                       + [a for a in argv if a != '--ev_images'])


def test_train_cli_dense_over_raw_data(tmp_path, mvsec_layout):
    calls = []
    image = evflownet.compute_event_image

    def counted(*args, **kwargs):
        calls.append(kwargs['depth'])
        return image(*args, **kwargs)

    with mock.patch.object(evflownet, 'compute_event_image', counted):
        train_cli.main(['-m', str(tmp_path / 'run'), '-ne', '1',
                        '--skip-validation'] + CLI)
    assert Serializer(tmp_path / 'run').list_known_steps() == [0, 1]
    assert len(calls) >= 2 and set(calls) == {DEPTH}
