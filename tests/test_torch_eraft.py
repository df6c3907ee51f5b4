"""E-RAFT (``models/eraft.py``) against the plain reference
``tests/eraft_reference.py``, and the benchmark's copy of the reference
(``portbench/configs/eraft.py``) against it, on the CPU at 64x64, batch 2,
3 update iterations, the published widths kept.

Tolerances, each from float32 rounding:

- flows and loss terms rtol 1e-4 / atol 1e-6: the two sides add in other
  orders (``F.batch_norm`` against the written-out statistics, the
  lookup's grid as one ``addcmul`` against RAFT's division), gaps of a
  few float32 ulps that three iterations of the update carry to
  ~1e-5 of the flow;
- the parameters' gradients, and the change of one RANGER step after
  them, leaf by leaf in L2 over the larger of the leaf's norm and the
  median leaf's: the median leaf within 1e-4, the worst within 1e-2 (the
  change 5e-2: gradient centralisation leaves each leaf's gradient less
  its mean, a residue up to ~15 times smaller, so the same gap reads up
  to ~15 times larger; the empty volume's fnet leaves read 1.9e-2).
  Most leaves agree to ~2e-6; one read 4e-3 on the dense grid, where a
  float32 gap of an ulp moves a ReLU's input across 0 at one pixel (the
  stem's weight gradient, one output channel).  At a quarter of the
  events (0.12 a pixel) batch norm's division by the tiny spread of the
  sparse grid's channels put a dozen leaves near 1e-2: the batches here
  hold ~0.5 events a pixel, the traffic's density;
- the fused window against its single steps exactly: on the CPU the
  window runs the same ops in the same order;
- the two references agree to 1e-5 (flows, loss), their gradients as
  above: they differ in the lookup's arithmetic alone.

The file imports no JAX, so its ``cuda`` test runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_eraft.py -k card``.
"""
import inspect
import json
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu_torch import train as train_cli
from dvs_of_training_framework_tpu_torch.data import schema
from dvs_of_training_framework_tpu_torch.data.device_queue import \
    stack_batches
from dvs_of_training_framework_tpu_torch.losses import (MultiScaleLoss,
                                                        combined_loss)
from dvs_of_training_framework_tpu_torch.models import eraft
from dvs_of_training_framework_tpu_torch.parallel import mesh
from dvs_of_training_framework_tpu_torch.tools import prepare_batches
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_eval_step,
    make_fused_window_step, make_train_step)
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from tests import eraft_reference as ref

REPO = Path(__file__).resolve().parents[1]
# tests/data/seq (tests/helpers.py's data_path): that module imports JAX
# and h5py, which the card's machine lacks
DATA = REPO / 'tests' / 'data' / 'seq'
sys.path[:0] = [str(REPO / 'portbench')]
from harness import flops  # noqa: E402
from harness import reference as bench_reference  # noqa: E402
from harness.reference.ranger import Ranger  # noqa: E402

H = W = 64
B, DEPTH, ITERATIONS = 2, 15, 3
SHAPES = [(H >> s, W >> s) for s in (3, 2, 1, 0)]
CAPACITY = 16384
ARGS = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                       half_life=20000, num_warmup_steps=0,
                       training_steps=40000, rs=0.0, grad_clip_norm=1.0)
RECIPE = {'lr': 1e-3, 'weight_decay': 1e-4, 'half_life': 20000,
          'warmup': 0, 'training_steps': 40000, 'representation_start': 0.0,
          'grad_clip_norm': 1.0}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_cli.py keeps: the suite's
    parallel workers share the cores, and a file that takes them all
    slows the others' subprocesses many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_collated(seed):
    """A collated batch of two-element samples: events in each element's
    window, and smooth frames shifted a pixel more each slot."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8000, 10000))
    sample = np.sort(rng.integers(0, B, n))
    element = rng.integers(0, 2, n)
    order = np.lexsort((element, sample))
    sample, element = sample[order], element[order]
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    phase = rng.uniform(0, 2 * np.pi)
    images = [128 + 100 * np.sin((xx + s * (1 + b)) / 3.0 + phase)
              * np.cos(yy / 5.0) for b in range(B) for s in range(3)]
    return {'events': {
                'x': rng.integers(0, W, n), 'y': rng.integers(0, H, n),
                'timestamp': (element * 0.04 + rng.uniform(0, 0.04, n))
                .astype(np.float32),
                'polarity': rng.choice([-1.0, 1.0], n),
                'element_index': element, 'sample_index': sample},
            'timestamps': np.tile(np.arange(3) * 0.04, B).astype(np.float32),
            'sample_idx': np.repeat(np.arange(B), 3),
            'images': np.stack(images)[:, None].astype(np.float32),
            'size': B}


def seeded_port(seed=0):
    """The port's E-RAFT at its seeded init, every leaf drawn 0 (biases,
    norm scales and shifts) offset by a small draw so that it matters."""
    model = eraft.Model(iterations=ITERATIONS, plain_ops=True,
                        generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def reference_for(model):
    out = ref.ERAFT(DEPTH, iterations=ITERATIONS)
    out.load_state_dict(model.state_dict(), strict=True)
    return out


def port_loss(model, batch, raw=True, grid=None):
    flows, flow_ts, flow_sidx = model(
        batch.events if raw else grid, batch.timestamps, batch.sample_idx,
        (H, W), raw=raw)
    loss, terms = combined_loss(MultiScaleLoss(SHAPES), flows, flow_ts,
                                flow_sidx, batch.images, batch.timestamps,
                                batch.sample_idx)
    return flows, loss, terms


def reference_loss(model, batch, grid=None):
    flows, flow_ts, flow_sidx = model(batch)
    if grid is not None:
        flows = model.dense(grid)
    loss, terms = ref.multiscale_loss(flows, flow_ts, flow_sidx, batch)
    return flows, loss, terms


def assert_leaves_close(got, want, worst=1e-2, median=1e-4):
    """Each leaf's gap ``|got - want|`` over the larger of ``|want|`` and
    the median leaf's ``|want|`` (L2 norms; a leaf whose gradient is 0 but
    for rounding, a bias in front of a norm, is held to the median's):
    the worst leaf's at most ``worst``, the median leaf's at most
    ``median``."""
    norms = {k: float(w.norm()) for k, w in want.items()}
    floor = statistics.median(norms.values())
    gaps = sorted((float((got[k] - w).norm()) / max(norms[k], floor), k)
                  for k, w in want.items())
    assert gaps[-1][0] <= worst, gaps[-3:]
    assert statistics.median(g for g, _ in gaps) <= median, gaps[-3:]


def without_events(collated, sample, element):
    """``collated`` with no events in one element: an empty volume."""
    ev = collated['events']
    keep = (ev['sample_index'] != sample) | (ev['element_index'] != element)
    return dict(collated, events={k: v[keep] for k, v in ev.items()})


@pytest.mark.parametrize('case', ['raw', 'raw, an empty volume', 'dense'])
def test_eraft_matches_the_reference(case):
    """The forward, the loss, every gradient and a RANGER step; an empty
    volume's instance norms normalise a constant map to exactly 0 on both
    sides (without the shift of ``eraft.InstanceNorm`` its stem's bias
    gradient read 11 times its scale apart)."""
    raw = case != 'dense'
    collated = make_collated(3)
    if case == 'raw, an empty volume':
        collated = without_events(collated, 0, 0)
    batch = schema.pad_batch(collated, CAPACITY).to('cpu')
    want_batch = bench_reference.device_batch(collated, torch.device('cpu'))
    grid = None if raw else torch.randn(
        B, 2 * DEPTH, H, W, generator=torch.Generator().manual_seed(5))
    port = seeded_port()
    plain = reference_for(port)
    flows, loss, terms = port_loss(port, batch, raw, grid)
    want_flows, want_loss, want_terms = reference_loss(plain, want_batch,
                                                       grid)
    assert [tuple(f.shape) for f in flows] == [(B, 2, h, w)
                                               for h, w in SHAPES]
    for got, want in zip(flows, want_flows):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    assert float(want_flows[0].abs().max()) > 0.05
    for got, want in zip(terms, want_terms):
        torch.testing.assert_close(torch.stack(list(got)),
                                   torch.stack(list(want)), rtol=1e-4,
                                   atol=1e-6)
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-6)

    named = dict(port.named_parameters())
    want_named = dict(plain.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                materialize_grads=True)))
    want_grads = dict(zip(want_named, torch.autograd.grad(
        want_loss, list(want_named.values()), materialize_grads=True)))
    representation = {k for k in named if k.startswith('quantization_')}
    if raw:
        assert all(grads[k].abs().max() > 0 for k in representation)
    assert_leaves_close(grads, want_grads)

    start = {k: p.detach().clone() for k, p in named.items()}
    construct_optimizer(ARGS, port).step(grads)
    axes = {k: (1 if k.endswith('.kernel') else 0) if p.dim() >= 2 else None
            for k, p in want_named.items()}
    with torch.no_grad():
        Ranger(want_named, axes, RECIPE).step(want_grads)
    assert_leaves_close({k: p.detach() - start[k] for k, p in named.items()},
                        {k: p.detach() - start[k]
                         for k, p in want_named.items()}, worst=5e-2)


def test_fused_window_equals_its_single_steps():
    """Two steps as one eagerly run window and as two single steps: the
    parameters, the batch norm's running statistics and the losses
    exactly."""
    batches = [schema.pad_batch(make_collated(s), CAPACITY) for s in (1, 2)]
    staged = stack_batches(batches)
    runs = []
    for fused in (True, False):
        model = seeded_port(1)
        optimizer = construct_optimizer(ARGS, model)
        evaluator = MultiScaleLoss(SHAPES)
        state = create_train_state(0)
        if fused:
            step = make_fused_window_step(model, evaluator, optimizer,
                                          (0.5, 1, 1), 1, 2)
            state, (losses, _) = step(state, staged)
        else:
            step = make_train_step(model, evaluator, optimizer, (0.5, 1, 1),
                                   1, window=2)
            losses = []
            for _ in range(2):
                state, (loss, _) = step(state, staged)
                losses.append(loss)
            losses = torch.stack(losses)
        runs.append((losses, dict(model.named_parameters()),
                     dict(model.named_buffers()), state.step))
    (loss_a, params_a, buf_a, step_a), (loss_b, params_b, buf_b, step_b) \
        = runs
    assert step_a == step_b == 2
    assert torch.equal(loss_a, loss_b)
    for name in params_a:
        assert torch.equal(params_a[name], params_b[name]), name
    for name in buf_a:
        assert torch.equal(buf_a[name], buf_b[name]), name
    assert not torch.equal(buf_a['cnet.norm1.running_mean'],
                           torch.zeros(64))


def test_validation_leaves_the_running_statistics_alone():
    model = seeded_port()
    batch = schema.pad_batch(make_collated(4), CAPACITY).to('cpu')
    saved = {k: b.clone() for k, b in model.named_buffers()}
    loss, _ = make_eval_step(model, MultiScaleLoss(SHAPES), (0.5, 1, 1))(
        batch)
    assert torch.isfinite(loss) and model.training
    for name, value in model.named_buffers():
        assert torch.equal(value, saved[name]), name
    model.eval()
    flows_eval = model(batch.events, batch.timestamps, batch.sample_idx,
                       (H, W))[0]
    model.train()
    flows_train = model(batch.events, batch.timestamps, batch.sample_idx,
                        (H, W))[0]
    assert not torch.equal(flows_eval[0], flows_train[0])


def bench_config(iterations=ITERATIONS):
    config = json.loads((REPO / 'portbench' / 'configs' / 'eraft.json')
                        .read_text())
    config['flags'].update({'--height': H, '--width': W, '-mbs': B,
                            '-bs': B})
    config['model']['iterations'] = iterations
    return config


def bench_module():
    from harness import spec
    cell = spec.Cell(spec.load_benchmark(REPO), 'eraft.pair_b8')
    return cell.reference()


def test_the_benchmark_reference_matches_this_one():
    collated = make_collated(6)
    batch = bench_reference.device_batch(collated, torch.device('cpu'))
    plain = reference_for(seeded_port(2))
    bench = bench_module().build(bench_config(), lambda x: x)
    bench.load_state_dict(plain.state_dict(), strict=True)
    want_flows, want_loss, _ = reference_loss(plain, batch)
    loss, _ = bench_reference.loss_of(bench, batch)
    flows = bench(batch)[0]
    for got, want in zip(flows, want_flows):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-7)
    named, want_named = (dict(m.named_parameters()) for m in (bench, plain))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want_grads = dict(zip(want_named, torch.autograd.grad(
        want_loss, list(want_named.values()))))
    assert_leaves_close(grads, want_grads)


def test_conv_flops_of_the_benchmark_reference_by_hand():
    """Every convolution of every iteration, forward, batch 1 at 64x64:
    the encoders at 32x32 (stem), 32, 16 and 8; the update at 8x8."""
    model = bench_module().build(bench_config(), lambda x: x)

    def conv(cin, cout, kh, kw, hw):
        return 2 * cin * kh * kw * cout * hw * hw

    def encoder(out):
        return (conv(DEPTH, 64, 7, 7, 32) + 4 * conv(64, 64, 3, 3, 32)
                + conv(64, 96, 3, 3, 16) + conv(64, 96, 1, 1, 16)
                + 3 * conv(96, 96, 3, 3, 16) + conv(96, 128, 3, 3, 8)
                + conv(96, 128, 1, 1, 8) + 3 * conv(128, 128, 3, 3, 8)
                + conv(128, out, 1, 1, 8))

    update = (conv(324, 256, 1, 1, 8) + conv(256, 192, 3, 3, 8)
              + conv(2, 128, 7, 7, 8) + conv(128, 64, 3, 3, 8)
              + conv(256, 126, 3, 3, 8) + 3 * conv(384, 128, 1, 5, 8)
              + 3 * conv(384, 128, 5, 1, 8) + conv(128, 256, 3, 3, 8)
              + conv(256, 2, 3, 3, 8))
    mask = conv(128, 256, 3, 3, 8) + conv(256, 576, 1, 1, 8)
    want = 2 * encoder(256) + encoder(256) + ITERATIONS * update + mask
    assert flops.conv_flops(model, 1, 2 * DEPTH, (H, W)) == want


def test_the_configuration_holds_the_ports_sizes():
    """``configs/eraft.json``'s ``model`` block, which the benchmark's
    reference and the lookup's byte count read, is the port's own sizes
    and the plain reference's defaults: one edit cannot move one of them
    alone."""
    config = json.loads((REPO / 'portbench' / 'configs' / 'eraft.json')
                        .read_text())
    defaults = inspect.signature(eraft.Model).parameters
    layer = inspect.signature(eraft.QuantizationLayer).parameters
    port = {'kernel_mlp_hidden': layer['hidden'].default,
            'iterations': defaults['iterations'].default,
            'corr_levels': eraft.CORR_LEVELS,
            'corr_radius': eraft.CORR_RADIUS, 'hidden': eraft.HIDDEN,
            'context': eraft.CONTEXT, 'feature': eraft.FEATURES}
    assert config['model'] == port
    assert config['flags']['--event-representation-depth'] == \
        defaults['event_representation_depth'].default
    plain = inspect.signature(ref.ERAFT).parameters
    assert (plain['hidden'].default, plain['iterations'].default,
            plain['levels'].default, plain['radius'].default) == \
        (port['kernel_mlp_hidden'], port['iterations'],
         port['corr_levels'], port['corr_radius'])


def test_the_lookup_bytes_by_hand():
    """``harness/eraft_work.py``'s count at 64x64 (8x8 at 1/8): along an
    axis, pixel i's window on level k spans cells i // 2^k - 4 to
    i // 2^k + 5, cut to the level's 8, 4, 2, 1 cells."""
    from harness import eraft_work
    cells = {0: [6, 7, 8, 8, 8, 7, 6, 5], 1: [4] * 8, 2: [2] * 8,
             3: [1] * 8}
    for k, want in cells.items():
        assert eraft_work.window_cells(8, k, 4) == sum(want)
    touched = sum(sum(c) ** 2 for c in cells.values())
    pixels = B * 64
    out, coords = 4 * pixels * 324, 4 * pixels * 2
    dense = (64 + 16 + 4 + 1) * pixels * 4
    work = eraft_work.lookup_work(B, H, W, 4, 4, ITERATIONS)
    assert work['fwd']['nbytes'] == ITERATIONS * (4 * B * touched + coords
                                                  + out)
    assert work['bwd']['nbytes'] == ITERATIONS * (out + coords + dense)


@pytest.mark.parametrize('step', ['train', 'fused window', 'eval'])
def test_the_mesh_refuses_batch_statistics(step):
    """The mesh reduces the parameters' gradients alone: a model with
    buffers (batch norm's running statistics) is refused before any
    group is used."""
    model = eraft.Model(iterations=1, plain_ops=True)
    make = {'train': lambda: mesh.make_sharded_train_step(
                model, MultiScaleLoss(SHAPES), None, (0.5, 1, 1), 1, None),
            'fused window': lambda: mesh.make_sharded_fused_window_step(
                model, MultiScaleLoss(SHAPES), None, (0.5, 1, 1), 1, None,
                2),
            'eval': lambda: mesh.make_sharded_eval_step(
                model, MultiScaleLoss(SHAPES), (0.5, 1, 1), None)}[step]
    with pytest.raises(ValueError, match='buffers'):
        make()


def test_eraft_trains_through_main_and_resumes(tmp_path, monkeypatch):
    """``train.main()`` with ``--flownet_path ERAFT`` through the device
    queue's windows: 3 steps, and a run stopped at step 2 resumes to the
    same step-3 parameters and running statistics exactly."""
    mvsec = tmp_path / 'mvsec'
    mvsec.mkdir()
    for split in ('outdoor_day1', 'outdoor_day2'):
        (mvsec / split).symlink_to(DATA)
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
                        '--flownet_path', 'ERAFT', '--prefix-length', '1',
                        '--event-representation-depth', '15',
                        '--grad-clip-norm', '1.0', '--skip-validation',
                        '--preprocessed-dataset-path', str(shards),
                        '--checkpointing_interval', '1',
                        '--permanent_interval', '1',
                        '--device-queue-window', '1']
                       + sequence + list(extra))

    main(tmp_path / 'whole', 3)
    main(tmp_path / 'resumed', 2)
    main(tmp_path / 'resumed', 3, ['--allow-arguments-change'])
    whole = Serializer(tmp_path / 'whole').read_state_dict(3)
    resumed = Serializer(tmp_path / 'resumed').read_state_dict(3)
    names = dict(eraft.Model().named_buffers())
    assert set(whole['model']) == {n for n, _ in eraft.Model()
                                   .named_parameters()}
    assert set(whole['buffers']) == set(names) and len(names) == 30
    for key in ('model', 'buffers'):
        for name, value in whole[key].items():
            assert torch.equal(resumed[key][name], value), name
    start = Serializer(tmp_path / 'whole').read_state_dict(0)
    for key, name in (('model', 'update_block.gru.convz1.weight'),
                      ('buffers', 'cnet.norm1.running_var')):
        assert not torch.equal(start[key][name], whole[key][name])


@pytest.mark.cuda
def test_graph_replay_follows_eager_steps_on_the_card():
    """A window of 2 steps as one ``WindowGraph`` replay and as two eager
    steps, float32, from the same state: the same losses, parameters and
    running statistics up to the order of ``grid_sampler_2d``'s atomic
    scatter in the backward, which makes neither bit for bit: the loss
    rtol 1e-5, the statistics as ``assert_leaves_close``, each leaf's
    change as the RANGER step of ``test_eraft_matches_the_reference``
    (the fnet leaves read up to 1.5e-2 on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    device = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batches = [schema.pad_batch(make_collated(s), CAPACITY) for s in (1, 2)]
    staged = stack_batches(batches).to(device)
    runs = []
    for fused in (True, False):
        model = seeded_port(1).to(device)
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        optimizer = construct_optimizer(ARGS, model)
        evaluator = MultiScaleLoss(SHAPES)
        state = create_train_state(0)
        if fused:
            step = make_fused_window_step(model, evaluator, optimizer,
                                          (0.5, 1, 1), 1, 2)
            state, (losses, _) = step(state, staged)
            assert len(step.graphs) == 1
        else:
            step = make_train_step(model, evaluator, optimizer, (0.5, 1, 1),
                                   1, window=2)
            losses = []
            for _ in range(2):
                state, (loss, _) = step(state, staged)
                losses.append(loss)
            losses = torch.stack(losses)
        runs.append((losses.cpu(),
                     {k: (p.detach() - start[k]).cpu()
                      for k, p in model.named_parameters()},
                     {k: b.cpu() for k, b in model.named_buffers()}))
    (loss_a, change_a, buf_a), (loss_b, change_b, buf_b) = runs
    torch.testing.assert_close(loss_a, loss_b, rtol=1e-5, atol=0)
    assert_leaves_close(change_a, change_b, worst=5e-2)
    assert_leaves_close(buf_a, buf_b)
