"""Port parity: the device-queue window on a mesh.

Mirrors the JAX package's tests/training/test_mesh_window.py with the
port's ranks as gloo processes on the CPU (``tests/torch_mesh_worker.py``
under ``tests/torch_procs.run_group``), on tests/test_torch_parallel.py's
setup (EVFlowNet at depth 3, base 4, 32x32, global batch 4, RANGER):

- ``make_sharded_fused_window_step`` over staged windows on ``data:2``
  (accumulation 1 and 2), ``data:1,event:2`` and ``data:2,event:2``,
  against the JAX package's ``make_sharded_fused_window_step`` on the same
  mesh over its virtual CPU devices, at tests/test_torch_parallel.py's
  tolerances (losses rtol 1e-5, parameters rtol 1e-5 / atol 1e-7); and
  bit for bit against the port's window step slot by slot and its
  per-step sharded step (``window=0``), with the replicas equal bit for
  bit.
- ``train()`` on a mesh with windows (raw with a window a hook cuts and a
  tail window, accumulation 2, dense batches, and the event axis) against
  the JAX package's ``train(window=K, train_step_fused=...,
  place_window=...)`` at tests/training/test_device_queue.py's
  tolerances (parameters rtol 1e-4 / atol 1e-5, scalars rtol 1e-4 / atol
  1e-7), and bit for bit against the port's loop one batch at a time;
  ranks that stage different windows raise instead of drifting apart.
- ``train.main(['--mesh', 'data:2', '--device-queue-window', '4', ...])``
  over preprocessed shards: a run cut at step 4 and resumed equals the
  uninterrupted run to step 8 bit for bit; the backend's window rule and
  the per-batch validation are printed once each.
- On a card (``cuda``, skipped here): a one-rank NCCL group's graph
  replays equal its eager sharded steps bit for bit, with the event axis
  too.
"""
import copy
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from dvs_of_training_framework_tpu import parallel as jax_parallel
    from dvs_of_training_framework_tpu.data import device_queue as jax_queue
    from dvs_of_training_framework_tpu.losses import \
        MultiScaleLoss as JaxMultiScaleLoss
    from dvs_of_training_framework_tpu.training import \
        optimizers as jax_opt
    from dvs_of_training_framework_tpu.training import state as jax_state
    from dvs_of_training_framework_tpu.training import train as jax_train
    from tests.test_torch_parallel import (ARGS, CAPACITY, MODEL, SHAPES,
                                           TAGS, WEIGHTS, jax_model,
                                           make_collated)
except ModuleNotFoundError:     # a card's machine: the cuda test only
    jax = None
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch import parallel
from dvs_of_training_framework_tpu_torch.parallel import distributed
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from dvs_of_training_framework_tpu_torch.utils.convert import torch_to_flax
from tests import torch_procs

REPO = Path(__file__).resolve().parents[1]
# name: (mesh, is_raw, accumulation, window, batch seeds)
WINDOW_CASES = {
    'data2': ('data:2', True, 1, 2, (0, 1, 2, 3)),
    'data2_accumulate2': ('data:2', True, 2, 4, (0, 1, 2, 3)),
    'event2': ('data:1,event:2', True, 1, 2, (0, 1, 2, 3)),
    'data2_event2': ('data:2,event:2', True, 1, 2, (0, 1)),
}
# name: (mesh, is_raw, accumulation, window, batches, steps, hook period,
#        held against JAX)
LOOP_CASES = {
    # windows of 2: fused, cut by the hook at step 3, fused, a tail of 1
    'raw': ('data:2', True, 1, 2, 7, 7, 3, True),
    'accumulation': ('data:2', True, 2, 4, 8, 4, 2, True),
    'dense': ('data:2', False, 1, 2, 4, 4, 2, True),
    'event2': ('data:1,event:2', True, 1, 2, 4, 4, 2, False),
}
MAIN = ('import json, sys\n'
        'from dvs_of_training_framework_tpu_torch import train\n'
        'print("RESULT", json.dumps(train.main(sys.argv[1:])))\n')
CLI_ARGV = ['-d', 'cpu', '-bs', '4', '-mbs', '4', '--num_workers', '0',
            '--height', '64', '--width', '64', '-cl', '1', '--flownet_path',
            'DummyFlowNet', '--optimizer', 'ADAM', '--checkpointing_interval',
            '4', '--permanent_interval', '4', '--event-capacity', '16384',
            '-vp', '4', '--validation-window', '2', '--mesh', 'data:2',
            '--device-queue-window', '4']


def window_batches(case):
    return [make_collated(s, dense=not WINDOW_CASES[case][1])
            for s in WINDOW_CASES[case][4]]


def loop_batches(case):
    _, is_raw, _, _, n, *_ = LOOP_CASES[case]
    return [make_collated(10 + s, dense=not is_raw) for s in range(n)]


@pytest.fixture(scope='module')
def weights():
    """The port's weights (flow heads at (0.37, 0.23) px) and their flax
    tree, as tests/test_torch_parallel.py makes them."""
    model = evflownet.Model(**MODEL)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'flow' in name and p.dim() == 1:
                p.copy_(torch.tensor([0.37, 0.23]))
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    return state_dict, torch_to_flax(state_dict)


@pytest.fixture(scope='module')
def port_runs(weights, cli_runs, tmp_path_factory):
    """Every case's ranks, started in the background (after the CLI's
    runs): a group of 2 and a group of 4 gloo processes; ``.result()``
    gives ``{case: [rank results]}``."""
    work = tmp_path_factory.mktemp('mesh_window')
    cases = [{'name': f'window_{name}', 'mesh': mesh, 'is_raw': is_raw,
              'accumulation': acc, 'window': window, 'kind': 'window',
              'batches': window_batches(name)}
             for name, (mesh, is_raw, acc, window, _) in WINDOW_CASES.items()]
    cases += [{'name': f'loop_{name}', 'mesh': mesh, 'is_raw': is_raw,
               'accumulation': acc, 'window': window, 'kind': 'loop',
               'batches': loop_batches(name), 'steps': steps,
               'every': every}
              for name, (mesh, is_raw, acc, window, _, steps, every, _)
              in LOOP_CASES.items()]
    oversized = make_collated(30)
    oversized['events'] = {k: np.concatenate([v] * 8)
                           for k, v in oversized['events'].items()}
    oversized['events']['sample_index'].sort()
    cases.append({'name': 'disagree', 'mesh': 'data:2', 'is_raw': True,
                  'accumulation': 1, 'window': 2, 'kind': 'disagree',
                  'batches': [make_collated(s) for s in (40, 41, 42, 43)],
                  'oversized': oversized, 'steps': 4, 'every': 2})
    for case in cases:
        case['world'] = parallel.parse_mesh(case['mesh']).size
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
        torch_procs.run_group(commands, work / 'logs', timeout=300)
        return {case['name']: [torch.load(work / f'{case["name"]}.{r}.pt',
                                          weights_only=False)
                               for r in range(case['world'])]
                for case in cases}

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)



@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """``train.main`` with ``--mesh data:2 --device-queue-window 4`` over
    preprocessed shards, started in the background: 8 steps in one go,
    then 4 steps, resumed to 8; ``.result()`` gives the runs' directory
    and outputs."""
    from dvs_of_training_framework_tpu_torch.tools import prepare_batches
    from tests.helpers import data_path
    root = tmp_path_factory.mktemp('mesh_window_cli')
    mvsec = root / 'mvsec'
    mvsec.mkdir()
    for split in ('outdoor_day1', 'outdoor_day2'):
        (mvsec / split).symlink_to(data_path)
    environ = torch_procs.env(DVS_DATA_PATH=str(mvsec))
    shards = root / 'shards'
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv('DVS_DATA_PATH', str(mvsec))
        prepare_batches.main(prepare_batches.parse_args(
            ['-o', str(shards), '-s', '16', '--samples-per-file', '4',
             '--height', '64', '--width', '64', '-mbs', '4',
             '--num_workers', '0']))

    def command(name, steps, *extra):
        return torch_procs.python(
            '-c', MAIN, '-m', root / name, *CLI_ARGV, '-ne', steps,
            '--preprocessed-dataset-path', shards, *extra)

    def run():
        # one run at a time: each spawning launcher picks its store's port
        # when it starts, and two starting together can pick the same one
        runs = {'whole': command('whole', 8), 'cut': command('cut', 4),
                'resumed': command('cut', 8, '--allow-arguments-change')}
        outputs = {name: torch_procs.run_group(
            [cmd], root / f'logs_{name}', timeout=180, environ=environ)[0]
            for name, cmd in runs.items()}
        return SimpleNamespace(root=root, outputs=outputs)

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


def jax_setup(flax_params, spec, accumulation, window, is_raw=True):
    """The JAX package's mesh, fused window step, window step and state."""
    model = jax_model()
    mesh = jax_parallel.make_mesh(spec)
    event_axis = 'event' if 'event' in mesh.shape else None
    tx = jax_opt.construct_optimizer(ARGS, flax_params)
    kwargs = dict(event_axis=event_axis, is_raw=is_raw)
    step, n_shards = jax_parallel.make_sharded_train_step(
        model, JaxMultiScaleLoss(SHAPES), tx, WEIGHTS, accumulation, mesh,
        window=window, **kwargs)
    fused = jax_parallel.make_sharded_fused_window_step(
        model, JaxMultiScaleLoss(SHAPES), tx, WEIGHTS, accumulation, mesh,
        window, **kwargs)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, flax_params), tx)

    def split(collated):
        return jax_parallel.split_batch_for_mesh(
            collated, n_shards, CAPACITY,
            event_shards=mesh.shape.get('event', 1))

    def place(stacked):
        return jax_parallel.shard_host_batch(stacked, mesh,
                                             event_axis=event_axis,
                                             window=True)

    return SimpleNamespace(step=step, fused=fused, state=state, split=split,
                           place=place)


def assert_params_close(state_dict, want_params, rtol, atol):
    got = dict(jax.tree_util.tree_leaves_with_path(torch_to_flax(state_dict)))
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=rtol,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def assert_bits(got, want):
    """Two nested state dicts equal bit for bit."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_bits(got[k], want[k])
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize('case', list(WINDOW_CASES))
def test_sharded_fused_window_matches_jax(case, weights, port_runs):
    spec, _, accumulation, window, _ = WINDOW_CASES[case]
    jx = jax_setup(weights[1], spec, accumulation, window)
    batches = window_batches(case)
    state, losses = jx.state, []
    for i in range(0, len(batches), window):
        staged = jx.place(jax_queue.stack_batches(
            [jx.split(c) for c in batches[i:i + window]]))
        state, (loss, _) = jx.fused(state, staged)
        losses += np.asarray(loss).tolist()
    got = port_runs.result()[f'window_{case}'][0]['fused']
    np.testing.assert_allclose(got['losses'], losses, rtol=1e-5)
    assert got['step'] == int(state.step) == len(batches) // accumulation
    assert_params_close(got['state_dict'], state.params, 1e-5, 1e-7)


@pytest.mark.parametrize('case', list(WINDOW_CASES))
def test_sharded_fused_window_equals_the_sharded_steps(case, weights,
                                                       port_runs):
    """Bit for bit: the fused windows, the window step slot by slot and
    the per-step sharded step; and every rank against rank 0."""
    ranks = port_runs.result()[f'window_{case}']
    want = ranks[0]['steps']
    for rank in ranks:
        for way in ('fused', 'slots', 'steps'):
            got = rank[way]
            assert got['losses'] == want['losses'], way
            assert got['step'] == want['step'], way
            assert_bits(got['state_dict'], want['state_dict'])
            assert_bits(got['optimizer'], want['optimizer'])
    moved = sum(not torch.equal(v, weights[0][k])
                for k, v in want['state_dict'].items())
    assert moved > 20


def run_jax_loop(case, flax_params):
    """The JAX package's ``train`` on a mesh with windows, the fused
    window step and ``place_window``: final parameters, samples, the
    logged scalars and the hook calls."""
    spec, is_raw, accumulation, window, _, steps, every, _ = \
        LOOP_CASES[case]
    jx = jax_setup(flax_params, spec, accumulation, window, is_raw)
    log, calls = ListLog(), []
    hook = jax_train.make_hook_periodic(lambda s, n: calls.append((s, n)),
                                        every)
    state, samples = jax_train.train(
        jx.step, jx.state, loop_batches(case), steps, log, TAGS,
        accumulation_steps=accumulation, event_capacity=2 * CAPACITY,
        hooks={'record': hook}, metric_flush_steps=3, window=window,
        prepare_batch=lambda c, capacity: jx.split(c),
        place_window=jx.place, train_step_fused=jx.fused, is_raw=is_raw)
    return state.params, samples, log.scalars, calls


class ListLog:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


@pytest.mark.parametrize('case', [c for c in LOOP_CASES if LOOP_CASES[c][7]])
def test_mesh_train_with_windows_matches_jax(case, weights, port_runs):
    want_params, samples, scalars, calls = run_jax_loop(case, weights[1])
    got = port_runs.result()[f'loop_{case}'][0][LOOP_CASES[case][3]]
    assert (got['samples'], got['calls']) == (samples, calls)
    assert got['step'] == LOOP_CASES[case][5]
    assert [(t, s) for t, _, s in got['scalars']] == \
        [(t, s) for t, _, s in scalars]
    np.testing.assert_allclose([v for _, v, _ in got['scalars']],
                               [v for _, v, _ in scalars],
                               rtol=1e-4, atol=1e-7)
    assert_params_close(got['state_dict'], want_params, 1e-4, 1e-5)


@pytest.mark.parametrize('case', list(LOOP_CASES))
def test_mesh_train_with_windows_equals_one_batch_at_a_time(case,
                                                            port_runs):
    ranks = port_runs.result()[f'loop_{case}']
    window = LOOP_CASES[case][3]
    want = ranks[0][0]
    for rank in ranks:
        for got in (rank[window], rank[0]):
            assert (got['step'], got['samples'], got['calls']) == \
                (want['step'], want['samples'], want['calls'])
            assert_bits(got['state_dict'], want['state_dict'])
            assert_bits(got['optimizer'], want['optimizer'])
    # rank 0's log; another rank logs the same values
    assert ranks[0][window]['scalars'] == want['scalars']


def test_ranks_staging_different_windows_raise(port_runs):
    """Rank 1 skips an oversized batch that rank 0 never sees: both raise
    at the window, before a collective pairs different steps."""
    for rank in port_runs.result()['disagree']:
        assert 'the ranks staged different windows' in rank['error']


def cli_records(output):
    return [r for line in output.splitlines() if line.startswith('RESULT ')
            for r in json.loads(line[len('RESULT '):])]


def test_mesh_main_with_windows_resumes_to_the_uninterrupted_run(cli_runs):
    runs = cli_runs.result()
    for name, steps in (('whole', 8), ('resumed', 8)):
        out = runs.outputs[name]
        assert [(r['rank'], r['step'], r['samples_passed'])
                for r in cli_records(out)] == [(0, steps, 4 * steps),
                                               (1, steps, 4 * steps)]
        assert out.count('device-queue windows: a window runs its steps '
                         'eagerly in one call on the CPU') == 1
        assert out.count('--validation-window 2: validation on a mesh runs '
                         'per batch') == 1
        assert out.count('--device-queue-window 4 on a mesh') == 1
    assert 'Flushed logs for step 8 (32 passed)' in runs.outputs['resumed']
    whole = Serializer(runs.root / 'whole').read_state_dict(8)
    resumed = Serializer(runs.root / 'cut').read_state_dict(8)
    assert_bits(resumed['model'], whole['model'])
    assert_bits(resumed['optimizer'], whole['optimizer'])
    start = Serializer(runs.root / 'whole').read_state_dict(0)['model']
    assert any(not torch.equal(v, start[k])
               for k, v in whole['model'].items())


def card_windows(device, groups):
    """Two windows of 4 small raw batches staged on the card: this rank's
    pieces of batches of 2 samples a data shard."""
    from dvs_of_training_framework_tpu_torch.data.device_queue import \
        stack_batches
    from tests.test_torch_device_queue import card_batch
    mesh = groups.mesh
    hosts = [parallel.shard_of(parallel.split_batch_for_mesh(
        card_batch(s, B=2 * mesh.data), mesh.data, 1024,
        event_shards=mesh.event), groups.data_index,
        groups.event_index if mesh.event > 1 else None) for s in range(8)]
    return [stack_batches(hosts[i:i + 4], pin=True).to(device)
            for i in (0, 4)]


def eager_and_replayed(groups, device):
    """The recipe at accumulation 2, RANGER with the clip and the EMA,
    over ``card_windows``: 8 eager sharded steps, and 2 windows of 4 as
    graph replays; each way's losses, parameters, optimizer state and
    step."""
    from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, create_train_state)
    torch.backends.cudnn.deterministic = True
    args = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                           half_life=100000, num_warmup_steps=0,
                           training_steps=10, rs=0.3, grad_clip_norm=1.0,
                           ema_decay=0.9)
    shapes = [(32 >> s, 32 >> s) for s in (3, 2, 1, 0)]
    loss_weights = [0.5, 1, 1]
    staged = card_windows(device, groups)
    event_axis = 'event' in groups.mesh.names
    assert groups.window_graph
    results = {}
    for mode in ('eager', 'graph'):
        model = evflownet.Model(event_representation_depth=4,
                                base_channels=8, dtype='bfloat16',
                                device=device)
        evaluator = MultiScaleLoss(shapes, bf16x2=True)
        optimizer = construct_optimizer(args, model)
        state = create_train_state()
        if mode == 'eager':
            step = parallel.make_sharded_train_step(
                model, evaluator, optimizer, loss_weights, 2, groups,
                event_axis=event_axis, window=4)
            losses = torch.stack([step(state, w)[1][0]
                                  for w in staged for _ in range(4)])
        else:
            fused = parallel.make_sharded_fused_window_step(
                model, evaluator, optimizer, loss_weights, 2, groups, 4,
                event_axis=event_axis)
            losses = torch.cat([fused(state, w)[1][0] for w in staged])
            graph, = fused.graphs.values()
            assert graph.replays == 2
        torch.cuda.synchronize()
        results[mode] = (losses.cpu(), to_cpu(model.state_dict()),
                         to_cpu(optimizer.state_dict()), state.step)
    return results


def assert_replay_equals_eager(results):
    eager, graph = results['eager'], results['graph']
    assert torch.equal(eager[0], graph[0])
    assert_bits(graph[1], eager[1])
    assert_bits(graph[2], eager[2])
    assert graph[3] == eager[3] == 4


@pytest.mark.cuda
@pytest.mark.parametrize('spec', ['data:1', 'data:1,event:1'],
                         ids=['data', 'event'])
def test_one_rank_nccl_window_replay_equals_eager_steps_on_the_card(spec):
    """A one-rank NCCL group: two windows of 4 as graph replays, whose
    capture holds the data group's all-reduce (and on the event axis the
    grid sum and the quantization gradients' sum), against 8 eager
    sharded steps."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import torch.distributed as dist
    device = torch.device('cuda')
    dist.init_process_group('nccl', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        results = eager_and_replayed(
            parallel.MeshGroups(parallel.parse_mesh(spec), device), device)
    finally:
        dist.destroy_process_group()
    assert_replay_equals_eager(results)


def nccl_ranks_worker(rank, world, spec, port, out):
    """One NCCL rank of ``spec`` on a card of its own: its eager and
    replayed windows, saved to ``out``."""
    import torch.distributed as dist
    device = distributed.initialize(f'127.0.0.1:{port}', world, rank,
                                    'cuda')
    groups = parallel.MeshGroups(parallel.parse_mesh(spec), device)
    torch.save(eager_and_replayed(groups, device), Path(out) / f'{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_ranks_window_replay_equals_eager_steps_on_the_cards(tmp_path):
    """Ranks on cards of their own (NCCL): ``data:N`` over the cards, and
    ``data:2,event:2`` on four, each rank's replayed windows equal to its
    eager sharded steps bit for bit, and the replicas to rank 0's."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two or more CUDA cards')
    world = min(torch.cuda.device_count(), 4)
    specs = [f'data:{world}'] + (['data:2,event:2'] if world == 4 else [])
    for spec in specs:
        out = tmp_path / spec.replace(':', '').replace(',', '_')
        out.mkdir()
        torch.multiprocessing.start_processes(
            nccl_ranks_worker, args=(world, spec, distributed.free_port(),
                                     str(out)),
            nprocs=world, start_method='spawn')
        ranks = [torch.load(out / f'{r}.pt', weights_only=False)
                 for r in range(world)]
        for results in ranks:
            assert_replay_equals_eager(results)
            assert_bits(results['graph'][1], ranks[0]['graph'][1])
            assert torch.equal(results['graph'][0], ranks[0]['graph'][0])


def to_cpu(tree):
    """A nested state dict copied to the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) \
        else copy.deepcopy(tree)
