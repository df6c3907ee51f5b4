"""Port parity: the device queue and the window steps.

The setup of tests/test_torch_train_loop.py: EVFlowNet at depth 4, base 8,
32x32, batch 2, flow-head biases (0.37, 0.23), RANGER.

- ``stack_batches`` and ``prefetch_windows`` against the JAX package's on
  the same host batches: the stacked arrays, ``n_valid``, the
  repeat-padded tail and ``skipped`` with an oversized batch inside a
  window, exactly.
- The windowed loop, with ``make_fused_window_step``, against the JAX
  package's ``train(window=K, train_step_fused=...)``: a partial tail, a
  window larger than the stream, a hook inside every window (the per-slot
  path), accumulation over a fused window, and a fused window inside
  which the delayed representation group starts and ramps up.
  Parameters, per-step losses and logged values take
  tests/training/test_device_queue.py's tolerances (rtol 1e-4, atol 1e-5
  for parameters, 1e-7 for scalars); samples, skips and hook calls are
  equal exactly.
- The port's windowed runs against its own ``window=0`` run, bit for bit
  on the CPU: raw, dense (``--ev_images`` batches) and dynamic sample
  lengths, fused and slot by slot, with accumulation.
- The alignment check refuses a state resumed mid-window; an aligned
  resume equals the uninterrupted windowed run bit for bit.
- ``validate_windowed`` against the JAX package's (rtol 1e-4, atol 1e-7)
  and against the port's ``validate`` (exactly), with an oversized batch
  and a smaller remainder batch (two runs of equal size).
- On a card (``cuda``, skipped here): one graph replay of a window equals
  the eager per-batch steps bit for bit, golden and recipe, the
  validation window too.

The optimizer's device-scalar form is held against optax by
tests/test_torch_optim.py, at the tolerances it had before.
"""
import copy

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from dvs_of_training_framework_tpu.data import device_queue as jax_queue
    from dvs_of_training_framework_tpu.data.schema import expand_batch
    from dvs_of_training_framework_tpu.data.schema import \
        pad_batch as jax_pad_batch
    from dvs_of_training_framework_tpu.losses import \
        MultiScaleLoss as JaxMultiScaleLoss
    from dvs_of_training_framework_tpu.training import \
        optimizers as jax_opt
    from dvs_of_training_framework_tpu.training import state as jax_state
    from dvs_of_training_framework_tpu.training import train as jax_train
    from tests.test_torch_train_loop import (ARGS, CAPACITY, SHAPES, TAGS,
                                             ListLogger, jax_setup,
                                             make_collated, oversized,
                                             port_model)
except ModuleNotFoundError:     # a card's machine: the cuda test only
    jax = None
from dvs_of_training_framework_tpu_torch.data.device_queue import (
    prefetch_windows, stack_batches)
from dvs_of_training_framework_tpu_torch.data.schema import (
    pad_batch, slice_window_batch)
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, current_learning_rates,
    make_eval_step, make_fused_eval_step, make_fused_window_step,
    make_train_step)
from dvs_of_training_framework_tpu_torch.training import train as port_train

CPU = torch.device('cpu')
WEIGHTS = [0.5, 1, 1]


def single(seed):
    """A one-sample batch: sample 0 of ``make_collated(seed)``."""
    batch = make_collated(seed)
    keep = batch['events']['sample_index'] == 0
    return {'events': {k: v[keep] for k, v in batch['events'].items()},
            'timestamps': batch['timestamps'][:2],
            'sample_idx': batch['sample_idx'][:2],
            'images': batch['images'][:2], 'size': 1}


def jax_fields(batch):
    """``{name: array}`` of a JAX Batch, named as the port's Window."""
    out = {f'events.{k}': np.asarray(getattr(batch.events, k))
           for k in ('x', 'y', 'timestamp', 'polarity', 'element_index',
                     'sample_index')}
    out.update({k: np.asarray(getattr(batch, k))
                for k in ('timestamps', 'sample_idx', 'images')})
    return out


def assert_window_equals_jax(window, jax_window):
    want = jax_fields(jax_window)
    batch = window.batch
    got = {f'events.{k}': getattr(batch.events, k).numpy()
           for k in ('x', 'y', 'timestamp', 'polarity', 'element_index',
                     'sample_index')}
    got.update({k: getattr(batch, k).numpy()
                for k in ('timestamps', 'sample_idx', 'images')})
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        batch.events.num_events, np.asarray(jax_window.events.num_events))
    assert window.size == jax_window.size


def test_stack_batches_matches_jax():
    collated = [make_collated(s) for s in range(3)]
    window = stack_batches([pad_batch(c, CAPACITY) for c in collated])
    assert_window_equals_jax(window, jax_queue.stack_batches(
        [jax_pad_batch(c, capacity=CAPACITY) for c in collated]))
    for k, c in enumerate(collated):
        got = slice_window_batch(window.batch, k)
        want = pad_batch(c, CAPACITY)
        assert got.events.num_events == want.events.num_events
        np.testing.assert_array_equal(got.images.numpy(), want.images)
        np.testing.assert_array_equal(got.events.x.numpy(), want.events.x)
    with pytest.raises(AssertionError, match='static batch size'):
        stack_batches([pad_batch(c, CAPACITY)
                       for c in (make_collated(0), single(1))])


@pytest.mark.parametrize('depth', [0, 2])
def test_prefetch_windows_matches_jax(depth):
    """Five batches with an oversized one inside the second window, in
    windows of 2: two full windows, a repeat-padded tail.  Depth 0 is
    clamped to 1."""
    stream = [make_collated(0), make_collated(1), make_collated(2),
              oversized(5), make_collated(3), make_collated(4)]

    def prepare(host):
        if host['events']['x'].size > CAPACITY:
            raise OverflowError('oversized')
        return host

    got = list(prefetch_windows(iter(stream),
                                lambda h: pad_batch(prepare(h), CAPACITY),
                                2, depth=depth))
    want = list(jax_queue.prefetch_windows(
        iter(stream), lambda h: jax_pad_batch(prepare(h), capacity=CAPACITY),
        2, depth=depth))
    assert [(n, len(s)) for _, _, n, s in got] == \
        [(n, len(s)) for _, _, n, s in want] == [(2, 0), (2, 1), (1, 0)]
    for (hosts, window, _, skipped), (j_hosts, j_window, _, j_skipped) in \
            zip(got, want):
        assert [id(h) for h in hosts] == [id(h) for h in j_hosts]
        assert [id(h) for h in skipped] == [id(h) for h in j_skipped]
        # the JAX window travels in its packed wire form: expanded per slot
        assert_window_equals_jax(window, jax.vmap(expand_batch)(j_window))
    tail = got[-1][1].batch
    np.testing.assert_array_equal(tail.images[0].numpy(),
                                  tail.images[1].numpy())


def run_jax(loader, window, num_steps, accumulation, every, fused,
            args=None):
    args = args or ARGS
    model, params, tx = jax_setup(args)
    evaluator = JaxMultiScaleLoss(SHAPES)
    step = jax_state.make_train_step(model, evaluator, tx, WEIGHTS,
                                     accumulation, window=window)
    step_fused = jax_state.make_fused_window_step(
        model, evaluator, tx, WEIGHTS, accumulation, window) if fused \
        else None
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, params), tx)
    logger, calls = ListLogger(), []
    hook = jax_train.make_hook_periodic(lambda s, n: calls.append((s, n)),
                                        every)
    state, samples = jax_train.train(
        step, state, loader, num_steps, logger, TAGS,
        lr_fn=lambda s: jax_opt.current_learning_rates(args, s),
        accumulation_steps=accumulation, event_capacity=CAPACITY,
        hooks={'record': hook}, metric_flush_steps=3, window=window,
        train_step_fused=step_fused)
    return (jax.device_get(state.params), int(state.step), samples,
            logger.scalars, calls)


def run_port(loader, window, num_steps, accumulation, every, fused,
             params=None, args=None, model=None, is_raw=True,
             sequence_length=None, evaluator=None, capacity=None):
    """The port's loop; returns the model's state, the optimizer's, the
    step, samples passed, the logged scalars and the hook calls."""
    args = args or ARGS
    if model is None:
        model = port_model(params if params is not None
                           else jax_setup(ARGS)[1])
    evaluator = evaluator or MultiScaleLoss(SHAPES)
    optimizer = construct_optimizer(args, model)
    step = make_train_step(model, evaluator, optimizer, WEIGHTS,
                           accumulation, is_raw=is_raw, window=window)
    step_fused = make_fused_window_step(
        model, evaluator, optimizer, WEIGHTS, accumulation, window,
        is_raw=is_raw) if fused else None
    logger, calls = ListLogger(), []
    hook = port_train.make_hook_periodic(lambda s, n: calls.append((s, n)),
                                         every)
    state, samples = port_train.train(
        step, create_train_state(), loader, num_steps, logger, TAGS, CPU,
        lr_fn=lambda s: current_learning_rates(args, s),
        accumulation_steps=accumulation,
        event_capacity=capacity or CAPACITY,
        hooks={'record': hook}, metric_flush_steps=3, window=window,
        train_step_fused=step_fused, is_raw=is_raw,
        sequence_length=sequence_length)
    return (copy.deepcopy(model.state_dict()),
            copy.deepcopy(optimizer.state_dict()), state.step, samples,
            logger.scalars, calls)


def stream(n, bad_at=None):
    batches = [make_collated(s) for s in range(n)]
    if bad_at is not None:
        batches.insert(bad_at, oversized(9))
    return batches


# (batches, oversized batch at, window, steps, accumulation, hook period)
JAX_CASES = {
    # an oversized batch inside a fused window, then a partial tail
    'partial tail': (5, 3, 2, 5, 1, 2),
    'window larger than the stream': (2, None, 8, 2, 1, 1),
    # a hook every step: no window is fused
    'hook inside': (4, None, 2, 4, 1, 1),
    'accumulation': (8, 5, 4, 4, 2, 2),
}


@pytest.mark.parametrize('case', list(JAX_CASES))
def test_windowed_train_matches_jax(case):
    n, bad_at, window, steps, accumulation, every = JAX_CASES[case]
    loader, fused = stream(n, bad_at), True
    want = run_jax(loader, window, steps, accumulation, every, fused)
    got = run_port(loader, window, steps, accumulation, every, fused)
    assert_port_matches_jax(got, want)


def test_a_window_across_the_representation_start_matches_jax():
    """The delayed representation group starts (``delay_steps`` 2 of 8)
    and ramps up over its rewarmup inside the first fused window of 4:
    against the JAX package's ``train()`` and bit for bit the port's
    one-batch-at-a-time run."""
    from types import SimpleNamespace
    args = SimpleNamespace(**dict(vars(ARGS), training_steps=8, rs=0.25,
                                  representation_warmup_steps=2))
    loader = stream(8)
    want = run_jax(loader, 4, 8, 1, 4, True, args=args)
    got = run_port(loader, 4, 8, 1, 4, True, args=args)
    assert_port_matches_jax(got, want)
    rates = [v for t, v, _ in got[4] if t == 'General/learning rate/0']
    assert rates[:2] == [0.0, 0.0] and 0 < rates[2] < rates[3]
    eager = run_port(loader, 0, 8, 1, 4, False, args=args)
    assert_bits(got[0], eager[0])
    assert_bits(got[1], eager[1])
    assert got[2:] == eager[2:]


def assert_port_matches_jax(got, want):
    assert got[2:4] == want[1:3]
    assert got[5] == want[4]
    assert [(t, s) for t, _, s in got[4]] == [(t, s) for t, _, s in want[3]]
    np.testing.assert_allclose([v for _, v, _ in got[4]],
                               [v for _, v, _ in want[3]],
                               rtol=1e-4, atol=1e-7)
    assert [v for t, v, _ in got[4] if t == 'General/skipped batches'] == \
        [v for t, v, _ in want[3] if t == 'General/skipped batches']
    from dvs_of_training_framework_tpu_torch.utils.convert import \
        torch_to_flax
    params = dict(jax.tree_util.tree_leaves_with_path(
        torch_to_flax(got[0])))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want[0]):
        np.testing.assert_allclose(params[path], np.asarray(leaf),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def assert_bits(got, want):
    """Two nested state dicts equal bit for bit."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_bits(got[k], want[k])
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    else:
        assert got == want


def dense_batch(seed, channels=4):
    batch = make_collated(seed)
    rng = np.random.default_rng(seed)
    batch = {k: v for k, v in batch.items() if k != 'events'}
    batch['data'] = rng.normal(size=(2, channels, 32, 32)) \
        .astype(np.float32)
    return batch


def dynamic_stream():
    from tests.test_torch_sequences import fixture_collated
    return [fixture_collated(n) for n in ([1, 3], [2, 1], [3, 3], [1, 2])]


@pytest.mark.parametrize('case', ['raw', 'raw accumulation', 'dense',
                                  'dynamic'])
def test_windowed_train_equals_per_batch_bit_for_bit(case):
    """Windows of 2 fused, and of 3 slot by slot, against one batch at a
    time; the logs too, as no batch is skipped."""
    params = jax_setup(ARGS)[1]
    accumulation = 2 if case == 'raw accumulation' else 1
    kwargs = {}
    if case == 'dense':
        loader = [dense_batch(s) for s in range(4)]
        kwargs = dict(is_raw=False)
    elif case == 'dynamic':
        from tests.test_torch_sequences import SHAPES as SEQ_SHAPES
        loader = dynamic_stream()
        kwargs = dict(sequence_length=3, capacity=8192,
                      evaluator=MultiScaleLoss(SEQ_SHAPES))
    else:
        loader = stream(8)
    steps = len(loader) // accumulation

    def run(window, fused):
        if case == 'dynamic':
            model = evflownet.Model(max_sequence_length=3,
                                    dynamic_sample_length=True,
                                    event_representation_depth=3,
                                    base_channels=4)
            return run_port(loader, window, steps, accumulation, 2, fused,
                            model=model, **kwargs)
        return run_port(loader, window, steps, accumulation, 2, fused,
                        params=params, **kwargs)

    want = run(0, False)
    for window, fused in ((2, True), (3, False)):
        got = run(window, fused)
        assert_bits(got[0], want[0])
        assert_bits(got[1], want[1])
        assert got[2:] == want[2:]


def test_misaligned_resume_is_refused():
    model = port_model(jax_setup(ARGS)[1])
    step = make_train_step(model, MultiScaleLoss(SHAPES),
                           construct_optimizer(ARGS, model), WEIGHTS, 1,
                           window=2)
    state = create_train_state()
    state.micro_step = 1
    with pytest.raises(ValueError, match='aligned'):
        port_train.train(step, state, stream(2), 2, ListLogger(), TAGS, CPU,
                         event_capacity=CAPACITY, window=2)


def test_aligned_resume_equals_the_uninterrupted_run():
    """Two fused windows of 2, against one window, the model's and the
    optimizer's state through ``state_dict`` as a checkpoint carries
    them, and a second loop from step 2."""
    params = jax_setup(ARGS)[1]
    loader = stream(4)
    want = run_port(loader, 2, 4, 1, 2, True, params=params)

    model = port_model(params)
    evaluator = MultiScaleLoss(SHAPES)
    first = run_port(loader[:2], 2, 2, 1, 2, True, model=model)
    resumed = port_model(params)
    resumed.load_state_dict(first[0])
    optimizer = construct_optimizer(ARGS, resumed)
    optimizer.load_state_dict(first[1])
    step = make_train_step(resumed, evaluator, optimizer, WEIGHTS, 1,
                           window=2)
    fused = make_fused_window_step(resumed, evaluator, optimizer, WEIGHTS,
                                   1, 2)
    state, samples = port_train.train(
        step, create_train_state(2), loader[2:], 4, ListLogger(), TAGS, CPU,
        event_capacity=CAPACITY, init_step=2, init_samples_passed=first[3],
        window=2, train_step_fused=fused)
    assert (state.step, samples) == (4, want[3])
    assert_bits(resumed.state_dict(), want[0])
    assert_bits(optimizer.state_dict(), want[1])


def test_validate_windowed_matches_jax_and_validate():
    loader = [make_collated(6), oversized(7), make_collated(8),
              make_collated(9), single(10), single(11)]
    model, params, _ = jax_setup(ARGS)
    jax_log = ListLogger()
    want = jax_train.validate_windowed(
        jax_state.make_fused_eval_step(model, JaxMultiScaleLoss(SHAPES),
                                       WEIGHTS, 2),
        jax.tree_util.tree_map(jnp.array, params), loader, 10, jax_log,
        TAGS, 2, event_capacity=CAPACITY)
    port = port_model(params)
    logs = {'windowed': ListLogger(), 'per batch': ListLogger()}
    got = port_train.validate_windowed(
        make_fused_eval_step(port, MultiScaleLoss(SHAPES), WEIGHTS, 2),
        loader, 10, logs['windowed'], TAGS, 2, CPU, event_capacity=CAPACITY)
    plain = port_train.validate(
        make_eval_step(port, MultiScaleLoss(SHAPES), WEIGHTS), loader, 10,
        logs['per batch'], TAGS, CPU, event_capacity=CAPACITY)
    assert got == plain
    assert logs['windowed'].scalars == logs['per batch'].scalars
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert [(t, s) for t, _, s in logs['windowed'].scalars] == \
        [(t, s) for t, _, s in jax_log.scalars]
    np.testing.assert_allclose([v for _, v, _ in logs['windowed'].scalars],
                               [v for _, v, _ in jax_log.scalars],
                               rtol=1e-4, atol=1e-7)


def card_batch(seed, B=2, H=32, W=32):
    """A small raw batch of random events and smooth frames."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(300, 500))
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    images = [128 + 100 * np.sin((xx + shift) / 3.0 + seed)
              * np.cos(yy / 5.0) for b in range(B) for shift in (0, 1 + b)]
    return {'events': {'x': rng.integers(0, W, n),
                       'y': rng.integers(0, H, n),
                       'timestamp': rng.uniform(0, 0.04, n).astype(
                           np.float32),
                       'polarity': rng.choice([-1.0, 1.0], n),
                       'element_index': np.zeros(n, np.int64),
                       'sample_index': np.sort(rng.integers(0, B, n))},
            'timestamps': np.tile([0.0, 0.04], B).astype(np.float32),
            'sample_idx': np.repeat(np.arange(B), 2),
            'images': np.stack(images).astype(np.float32), 'size': B}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype, bf16x2', [('float32', False),
                                           ('bfloat16', True)])
def test_graph_replay_equals_eager_steps_on_the_card(dtype, bf16x2):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    device = torch.device('cuda')
    torch.backends.cudnn.deterministic = True
    from types import SimpleNamespace
    args = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                           half_life=100000, num_warmup_steps=0,
                           training_steps=10, rs=0.3, grad_clip_norm=1.0,
                           ema_decay=0.9)
    shapes = [(32 >> s, 32 >> s) for s in (3, 2, 1, 0)]
    hosts = [pad_batch(card_batch(s), 1024) for s in range(8)]
    staged = [stack_batches(hosts[i:i + 4], pin=True).to(device)
              for i in (0, 4)]
    results = {}
    for mode in ('eager', 'graph'):
        model = evflownet.Model(event_representation_depth=4,
                                base_channels=8, dtype=dtype,
                                device=device)
        evaluator = MultiScaleLoss(shapes, bf16x2=bf16x2)
        optimizer = construct_optimizer(args, model)
        state = create_train_state()
        rows = []
        if mode == 'eager':
            step = make_train_step(model, evaluator, optimizer, WEIGHTS, 2,
                                   window=4)
            for window in staged:
                for _ in range(4):
                    state, (loss, _) = step(state, window)
                    rows.append(loss)
            losses = torch.stack(rows)
            evals = torch.stack([make_eval_step(model, evaluator, WEIGHTS)(
                slice_window_batch(staged[0].batch, k))[0]
                for k in range(4)])
        else:
            fused = make_fused_window_step(model, evaluator, optimizer,
                                           WEIGHTS, 2, 4)
            losses = torch.cat([fused(state, w)[1][0] for w in staged])
            evals = make_fused_eval_step(model, evaluator, WEIGHTS, 4)(
                staged[0])[0]
            graph, = fused.graphs.values()
            assert graph.replays == 2
        torch.cuda.synchronize()
        results[mode] = (losses.cpu(), evals.cpu(),
                         copy.deepcopy(model.state_dict()),
                         copy.deepcopy(optimizer.state_dict()), state.step)
    eager, graph = results['eager'], results['graph']
    assert torch.equal(eager[0], graph[0])
    assert torch.equal(eager[1], graph[1])
    assert_bits(to_cpu(graph[2]), to_cpu(eager[2]))
    assert_bits(to_cpu(graph[3]), to_cpu(eager[3]))
    assert graph[4] == eager[4] == 4


def to_cpu(tree):
    """A nested state dict with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree
