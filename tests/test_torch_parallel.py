"""Port parity: ``parallel/`` against the JAX package's ``parallel/``.

- ``split_batch_for_mesh`` equals the JAX package's array for array: raw
  batches over 2 data shards, 2 and 4 event shards, the slot layout of
  ``--dynamic-sample-length``, dense batches and the ``OverflowError``.
- A mesh spec's rank coordinates are ``make_mesh``'s device layout.
- The sharded training step on gloo ranks (2 or 4 processes on the CPU,
  ``tests/torch_mesh_worker.py``) against the JAX package's
  ``make_sharded_train_step`` on the same mesh shape over the virtual CPU
  devices: ``data:2``, ``data:1,event:2``, ``data:2,event:2``, ``data:2``
  with accumulation 2 and ``data:2`` on dense batches (``--ev_images``);
  one RANGER step from the same weights, the loss at rtol 1e-5 and the
  parameters at rtol 1e-5 / atol 1e-7, as tests/test_torch_train_step.py.
  The same runs against the port's single-process step on the whole
  batch, at tests/training/test_parallel.py's tolerances (loss rtol 1e-4,
  parameters rtol 2e-3 / atol 2e-5), and the ranks' parameters equal bit
  for bit.
- The sharded validation pass against the JAX package's
  ``make_sharded_eval_step`` through ``validate`` (a remainder batch
  dropped), the loss at rel 1e-5 and every scalar at rel 1e-4 / abs 1e-7
  (test_parallel.py).
- ``ShardedBatchSkipper`` and ``distributed_spec`` take the JAX
  package's decisions on tests/training/test_distributed.py's cases.

EVFlowNet at depth 3, base 4, 32x32, batch 4; the flow heads start at
(0.37, 0.23) px, as in tests/test_torch_train_step.py.
"""
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu import parallel as jax_parallel
from dvs_of_training_framework_tpu.losses import \
    MultiScaleLoss as JaxMultiScaleLoss
from dvs_of_training_framework_tpu.models import load_model_class
from dvs_of_training_framework_tpu.parallel import \
    distributed as jax_distributed
from dvs_of_training_framework_tpu.training import optimizers as jax_opt
from dvs_of_training_framework_tpu.training import state as jax_state
from dvs_of_training_framework_tpu.training import train as jax_train
from dvs_of_training_framework_tpu_torch import parallel
from dvs_of_training_framework_tpu_torch.data.schema import pad_batch
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.parallel import distributed
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_train_step)
from dvs_of_training_framework_tpu_torch.utils.convert import torch_to_flax
from tests import torch_procs
from tests.training.test_distributed import (FakeLoader,
                                             brute_force_overflow)

REPO = Path(__file__).resolve().parents[1]
B, H, W, DEPTH = 4, 32, 32, 3
CAPACITY = 512                 # events a shard holds
SHAPES = [(H // 2 ** i, W // 2 ** i) for i in range(4)][::-1]
TAGS = [f'{h}x{w}' for h, w in SHAPES]
WEIGHTS = [0.5, 1, 1]
ARGS = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                       half_life=100000, num_warmup_steps=0,
                       training_steps=10, rs=0.0)
MODEL = dict(event_representation_depth=DEPTH, base_channels=4)
# name: (mesh, is_raw, accumulation, batches)
TRAIN_CASES = {
    'data2': ('data:2', True, 1, (0,)),
    'event2': ('data:1,event:2', True, 1, (0,)),
    'data2_event2': ('data:2,event:2', True, 1, (0,)),
    'data2_accumulate2': ('data:2', True, 2, (0, 1)),
    'data2_dense': ('data:2', False, 1, (0,)),
}


def make_collated(seed, size=B, dense=False, sequence=None):
    """A host batch of ``size`` samples made with numpy; ``sequence``
    gives each sample's element count (``--dynamic-sample-length``)."""
    rng = np.random.default_rng(seed)
    counts = [1] * size if sequence is None else list(sequence)
    n = int(rng.integers(75, 120)) * size
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    phase = rng.uniform(0, 2 * np.pi)
    images, timestamps, sample_idx = [], [], []
    for b, elements in enumerate(counts):
        for k in range(elements + 1):
            images.append(128 + 100 * np.sin((xx + k * (1 + b)) / 3.0
                                             + phase) * np.cos(yy / 5.0))
            timestamps.append(0.04 * k)
            sample_idx.append(b)
    sample = np.sort(rng.integers(0, size, n))
    out = {'timestamps': np.asarray(timestamps, np.float32),
           'sample_idx': np.asarray(sample_idx),
           'images': np.stack(images).astype(np.float32), 'size': size}
    if dense:
        out['data'] = rng.normal(0, 0.5, (size, DEPTH, H, W)) \
            .astype(np.float32)
        return out
    out['events'] = {
        'x': rng.integers(0, W, n), 'y': rng.integers(0, H, n),
        'timestamp': rng.uniform(0, 0.04, n).astype(np.float32),
        'polarity': rng.choice([-1.0, 1.0], n),
        'element_index': rng.integers(0, np.asarray(counts)[sample]),
        'sample_index': sample}
    return out


def batches(case):
    _, is_raw, _, seeds = TRAIN_CASES[case]
    return [make_collated(s, dense=not is_raw) for s in seeds]


@pytest.fixture(scope='module')
def weights():
    """The port's weights (flow heads at (0.37, 0.23) px) and their flax
    tree."""
    model = evflownet.Model(**MODEL)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'flow' in name and p.dim() == 1:
                p.copy_(torch.tensor([0.37, 0.23]))
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    return state_dict, torch_to_flax(state_dict)


@pytest.fixture(scope='module')
def port_runs(weights, tmp_path_factory):
    """The port's ranks for every case, started in the background: a
    group of 2 and a group of 4 gloo processes; ``.result()`` gives
    ``{case: [rank results]}``."""
    work = tmp_path_factory.mktemp('mesh')
    cases = [{'name': name, 'mesh': mesh, 'is_raw': is_raw,
              'accumulation': acc, 'kind': 'train', 'batches': batches(name),
              'world': parallel.parse_mesh(mesh).size}
             for name, (mesh, is_raw, acc, _) in TRAIN_CASES.items()]
    cases.append({'name': 'eval', 'mesh': 'data:2', 'kind': 'eval',
                  'world': 2, 'batches': eval_batches()})
    torch.save({'cases': cases, 'state_dict': weights[0],
                'model_kwargs': MODEL, 'shapes': SHAPES, 'tags': TAGS,
                'weights': WEIGHTS, 'optimizer': ARGS,
                'capacity': CAPACITY}, work / 'job.pt')
    commands = []
    for world in (2, 4):
        port = distributed.free_port()
        commands += [torch_procs.python(REPO / 'tests' / 'torch_mesh_worker.py',
                                        work, rank, world, port)
                     for rank in range(world)]

    def run():
        torch_procs.run_group(commands, work / 'logs', timeout=240)
        return {case['name']: [torch.load(work / f'{case["name"]}.{r}.pt',
                                          weights_only=False)
                               for r in range(case['world'])]
                for case in cases}

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


def eval_batches():
    # a one-sample remainder batch, which the 2-way split refuses
    return [make_collated(20, size=1), make_collated(21)]


def jax_model():
    return load_model_class(REPO / 'EVFlowNet').Model(**MODEL)


def port_model(state_dict):
    model = evflownet.Model(**MODEL)
    model.load_state_dict(state_dict)
    return model


def assert_split_equal(got, want):
    for name in ('timestamps', 'sample_idx', 'images'):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
        assert getattr(got, name).dtype == np.asarray(
            getattr(want, name)).dtype, name
    assert got.size == want.size
    assert (got.data is None) == (want.data is None)
    if got.data is not None:
        np.testing.assert_array_equal(got.data, np.asarray(want.data))
    assert (got.events is None) == (want.events is None)
    if got.events is not None:
        for name in ('x', 'y', 'timestamp', 'polarity', 'element_index',
                     'sample_index', 'num_events'):
            np.testing.assert_array_equal(
                np.asarray(getattr(got.events, name)),
                np.asarray(getattr(want.events, name)), err_msg=name)


@pytest.mark.parametrize('shards, event_shards, sequence, dense', [
    (2, 1, None, False),
    (2, 2, None, False),
    (1, 4, None, False),
    (2, 1, (1, 2, 2, 1), False),
    (2, 1, None, True),
], ids=['data2', 'event2', 'event4', 'dynamic_slots', 'dense'])
def test_split_batch_matches_jax(shards, event_shards, sequence, dense):
    collated = make_collated(3, dense=dense, sequence=sequence)
    kwargs = dict(event_shards=event_shards,
                  sequence_length=None if sequence is None else 2)
    got = parallel.split_batch_for_mesh(collated, shards, CAPACITY, **kwargs)
    want = jax_parallel.split_batch_for_mesh(collated, shards, CAPACITY,
                                             **kwargs)
    assert_split_equal(got, want)
    lead = (shards,) if event_shards == 1 else (shards, event_shards)
    if not dense:
        assert got.events.x.shape == lead + (CAPACITY,)
        # every rank's piece is its slice, with a count of its own
        index = (shards - 1,) if event_shards == 1 \
            else (shards - 1, event_shards - 1)
        piece = parallel.shard_of(got, *index)
        assert piece.events.num_events == int(got.events.num_events[index])
        assert piece.events.x.shape == (CAPACITY,)
        assert piece.size == B // shards


def test_split_batch_overflow_matches_jax():
    collated = make_collated(4)
    events = collated['events']['x'].size
    for split in (parallel.split_batch_for_mesh,
                  jax_parallel.split_batch_for_mesh):
        with pytest.raises(OverflowError):
            split(collated, 2, events // 4)


@pytest.mark.parametrize('spec', ['data:4', 'data:2,event:2',
                                  'event:2,data:3'])
def test_mesh_coordinates_follow_make_mesh(spec):
    mesh = jax_parallel.make_mesh(spec)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    port = parallel.parse_mesh(spec)
    first = min(d.id for d in jax.devices())
    for rank in range(port.size):
        d, e = port.coordinates(rank)
        place = {'data': d, 'event': e}
        assert ids[tuple(place[n] for n in mesh.axis_names)] - first == rank
        assert port.rank_of(d, e) == rank


def jax_run(case, flax_params):
    """The JAX package's sharded steps on the case's batches: losses and
    the final parameters."""
    spec, is_raw, accumulation, _ = TRAIN_CASES[case]
    model = jax_model()
    mesh = jax_parallel.make_mesh(spec)
    event_axis = 'event' if 'event' in mesh.shape else None
    tx = jax_opt.construct_optimizer(ARGS, flax_params)
    step, n_shards = jax_parallel.make_sharded_train_step(
        model, JaxMultiScaleLoss(SHAPES), tx, WEIGHTS, accumulation, mesh,
        is_raw=is_raw, event_axis=event_axis)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, flax_params), tx)
    losses = []
    for collated in batches(case):
        device_batch = jax_parallel.shard_host_batch(
            jax_parallel.split_batch_for_mesh(
                collated, n_shards, CAPACITY,
                event_shards=mesh.shape.get('event', 1)),
            mesh, event_axis=event_axis)
        state, (loss, _) = step(state, device_batch)
        losses.append(float(loss))
    return losses, state.params


@pytest.mark.parametrize('case', list(TRAIN_CASES))
def test_sharded_step_matches_jax(case, weights, port_runs):
    want_losses, want_params = jax_run(case, weights[1])
    ranks = port_runs.result()[case]
    np.testing.assert_allclose(ranks[0]['losses'], want_losses, rtol=1e-5)
    assert ranks[0]['step'] == 1
    got = dict(jax.tree_util.tree_leaves_with_path(
        torch_to_flax(ranks[0]['state_dict'])))
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('case', list(TRAIN_CASES))
def test_sharded_step_matches_single_process(case, weights, port_runs):
    _, is_raw, accumulation, _ = TRAIN_CASES[case]
    model = port_model(weights[0])
    step = make_train_step(model, MultiScaleLoss(SHAPES),
                           construct_optimizer(ARGS, model), WEIGHTS,
                           accumulation, is_raw=is_raw)
    state, losses = create_train_state(), []
    for collated in batches(case):
        state, (loss, _) = step(state, pad_batch(
            collated, 4 * CAPACITY if is_raw else None).to('cpu'))
        losses.append(float(loss))
    ranks = port_runs.result()[case]
    np.testing.assert_allclose(ranks[0]['losses'], losses, rtol=1e-4)
    moved = 0
    for name, want in model.state_dict().items():
        got = ranks[0]['state_dict'][name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=name)
        moved += not torch.equal(got, weights[0][name])
        for other in ranks[1:]:      # the replicas hold the same bits
            assert torch.equal(other['state_dict'][name].view(torch.int32),
                               got.view(torch.int32)), name
    assert all(r['losses'] == ranks[0]['losses'] for r in ranks)
    assert moved > 20


def test_sharded_eval_matches_jax(weights, port_runs):
    model = jax_model()
    mesh = jax_parallel.make_mesh('data:2')
    eval_step = jax_parallel.make_sharded_eval_step(
        model, JaxMultiScaleLoss(SHAPES), WEIGHTS, mesh)

    def prepare(collated, capacity):
        if int(collated['size']) % 2:
            raise ValueError('indivisible')
        return jax_parallel.make_global_batch(
            jax_parallel.split_batch_for_mesh(collated, 2, capacity // 2),
            mesh)

    scalars = {}

    class Log:
        def add_scalar(self, tag, value, step):
            scalars[tag] = value

    want = jax_train.validate(
        eval_step, jax.tree_util.tree_map(jnp.array, weights[1]),
        iter(eval_batches()), 0, Log(), TAGS, event_capacity=2 * CAPACITY,
        prepare_batch=prepare)
    ranks = port_runs.result()['eval']
    assert ranks[0]['loss'] == pytest.approx(want, rel=1e-5)
    got = {tag: v for tag, v, _ in ranks[0]['scalars']}
    assert set(got) == set(scalars)
    for tag, value in scalars.items():
        assert got[tag] == pytest.approx(value, rel=1e-4, abs=1e-7), tag
    assert ranks[1]['scalars'] == ranks[0]['scalars']


def skipper_decisions(module, counts, gb, n_shards, cap, n, start=0):
    loader = FakeLoader(gb)
    loader.pos = (start // gb) * gb
    it = iter(module.ShardedBatchSkipper(
        loader, counts, global_batch=gb, n_shards=n_shards,
        capacity_per_shard=cap, start_sample=start))
    return [next(it) for _ in range(n)], loader.skipped


@pytest.mark.parametrize('seed, size, poison, gb, n_shards, cap, start', [
    (0, 24, (5, 1000), 8, 4, 150, 0),      # test_skip_rule_matches_brute
    (1, 32, (10, 500), 8, 2, 300, 0),      # ..._across_processes
    (1, 32, (10, 500), 8, 2, 300, 16),     # ... and its resume
    (2, 7, (3, 900), 4, 2, 200, 5),        # a batch wrapping the epoch
], ids=['brute_force', 'processes', 'resume', 'wrapping'])
def test_sharded_batch_skipper_matches_jax(seed, size, poison, gb, n_shards,
                                           cap, start):
    counts = np.random.default_rng(seed).integers(1, 100, size)
    counts[poison[0]] = poison[1]
    got = skipper_decisions(distributed, counts, gb, n_shards, cap, 9,
                            start)
    want = skipper_decisions(jax_distributed, counts, gb, n_shards, cap, 9,
                             start)
    assert got == want
    assert got[1], 'the poisoned sample was never skipped'
    assert not any(brute_force_overflow(counts, p % size, gb, n_shards, cap)
                   for p in got[0])


def test_sharded_batch_skipper_raises_on_a_stream_it_cannot_serve():
    # the JAX package's skipper would skip forever here
    counts = np.full(12, 500)
    it = iter(distributed.ShardedBatchSkipper(
        FakeLoader(8), counts, global_batch=8, n_shards=2,
        capacity_per_shard=1000))
    with pytest.raises(RuntimeError, match='every global batch'):
        next(it)


@pytest.mark.parametrize('flags, environ', [
    ({}, {}),
    ({'num_processes': 2, 'process_id': 1,
      'coordinator_address': 'h:1'}, {}),
    ({}, {'JAX_NUM_PROCESSES': '4', 'JAX_PROCESS_ID': '3',
          'JAX_COORDINATOR_ADDRESS': 'h:2'}),
    ({'num_processes': 2}, {'JAX_PROCESS_ID': '0'}),
], ids=['none', 'flags', 'environment', 'mixed'])
def test_distributed_spec_matches_jax(flags, environ, monkeypatch):
    for name in ('JAX_NUM_PROCESSES', 'JAX_PROCESS_ID',
                 'JAX_COORDINATOR_ADDRESS'):
        monkeypatch.delenv(name, raising=False)
    for name, value in environ.items():
        monkeypatch.setenv(name, value)
    args = SimpleNamespace(**flags)
    assert distributed.distributed_spec(args) == \
        jax_distributed.distributed_spec(args)
    assert distributed.distributed_spec(None) == \
        jax_distributed.distributed_spec(None)
