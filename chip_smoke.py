#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

Drives the port's golden EVFlowNet training step (fp32, TF32 off) at the
full width that ``bench.py`` times: base 64, depth 9, 256x256, batch 8,
event capacity 2^17, RANGER at lr 1e-3.  Phases:

1. device: the card's name and power limit, then the nvcc build of the
   kernels in ``dvs_of_training_framework_tpu_torch/csrc/``;
2. K1 (voxelize) against its plain twin on a bench batch, forward and
   backward, with the device time of both;
3. K2 (kernel-MLP) against its plain twin on delta [9, 2^17], forward and
   the seven gradients, with the device time of both;
4. one golden step through the kernels against one through the twins:
   the loss and the raw gradient of every parameter, before the
   optimizer;
5. 3 warm-up and 10 timed training steps on fresh bench batches copied
   to the card each step, with the kernels' launch counters reset just
   before and checked just after;
6. two more steps under ``torch.profiler``: device busy time a step and
   the busiest device ops.

Prints the kernels as one JSON line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Any failure
raises, so the exit code is not 0 and that line is not printed.

Usage (from the root of a checkout):  python3 chip_smoke.py
"""
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WARMUP, STEPS = 3, 10
TIMING_ITERS = 20
LOSS_WEIGHTS = (0.5, 1, 1)


def card_line():
    """``name, power.limit`` of card 0, as nvidia-smi prints them."""
    return subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def profile():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def device_ops(events):
    """The profiler's device-side events (kernels, copies, memsets)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, iters=TIMING_ITERS):
    """Mean device time of ``fn()`` in ms after warm-up: the summed
    durations of the kernels it launches, from ``torch.profiler``, so
    host and launch gaps between them do not count.  Where the profiler
    records no device time, CUDA events around the loop stand in."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile() as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.device_time_total for e in device_ops(prof.events()))
    if busy_us > 0:
        return busy_us / iters / 1e3
    print('  (the profiler recorded no device time: CUDA events instead)')
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(kernel_fn, plain_fn):
    """(kernel ms, plain ms) of device time, in turns: plain, kernel,
    kernel, plain."""
    p1, k1, k2, p2 = (device_ms(f) for f in (plain_fn, kernel_fn, kernel_fn,
                                             plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def trace_steps(step_fn, state, batches, device, step_ms, top=12):
    """Device busy time and the busiest device ops over a few steps.  The
    profiler slows the host, so the idle share is taken against
    ``step_ms``, the step time measured without it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile() as prof:
        for batch in batches:
            step_fn(state, batch.to(device))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    ops = device_ops(prof.key_averages())
    busy_ms = sum(e.device_time_total for e in ops) / 1e3 / len(batches)
    if busy_ms == 0:
        print('[6] the profiler recorded no device time: not measured')
        return
    print(f'[6] traced {len(batches)} steps: device busy {busy_ms:.3f} ms a '
          f'step, {100 * (1 - busy_ms / step_ms):.1f}% idle in the '
          f'{step_ms:.3f} ms step ({wall_ms:.3f} ms a step under the '
          f'profiler)')
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:top]:
        ms = e.device_time_total / 1e3 / len(batches)
        calls = e.count // len(batches)
        print(f'  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}%  x{calls:<4d} '
              f'{e.key[:90]}')


def max_abs(a, b):
    return (a - b).abs().max().item()


def check_close(name, got, want, rtol, atol):
    """Raise unless |got - want| <= atol + rtol * |want| everywhere."""
    err = max_abs(got, want)
    bound = (atol + rtol * want.abs()).sub((got - want).abs()).min().item()
    print(f'  {name}: max abs err {err:.3e} (rtol {rtol:g}, atol {atol:g})')
    if bound < 0 or not torch.isfinite(got).all():
        raise AssertionError(f'{name}: kernel and twin disagree '
                             f'(max abs err {err:.3e})')
    return err


def import_bench():
    """``bench`` for its batch maker.  ``scripts/make_synthetic_mvsec.py``
    imports h5py at its top but never uses it to simulate; where h5py is
    missing a placeholder module stands in for that one import."""
    placeholder = importlib.util.find_spec('h5py') is None
    if placeholder:
        sys.modules['h5py'] = types.ModuleType('h5py')
        print('h5py: not installed; a placeholder module stands in for the '
              'unused import in scripts/make_synthetic_mvsec.py')
    try:
        import bench
        import scripts.make_synthetic_mvsec  # noqa: F401
    finally:
        if placeholder:
            del sys.modules['h5py']
    return bench


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
    from dvs_of_training_framework_tpu_torch.models import Model
    from dvs_of_training_framework_tpu_torch.ops import (
        _build, kernel_mlp_cuda, voxel_cuda)
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, create_train_state, make_loss_fn,
        make_train_step)

    # --- 1. device and build ---------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f'[1] card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}, {torch.cuda.device_count()} device(s)')
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    print(f'[1] kernels built in {build_s:.2f} s: {lib_path.name}')
    for line in log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print('    ' + line.strip())

    bench = import_bench()
    B, (H, W), capacity = bench.BATCH_SIZE, bench.IMSIZE, bench.CAPACITY
    rng = np.random.default_rng(0)
    host = [pad_batch(bench.make_collated(rng, sample_offset=i * B),
                      capacity) for i in range(WARMUP + STEPS)]
    n_events = host[0].events.num_events
    print(f'[1] bench batches: B {B}, {H}x{W}, capacity {capacity}, '
          f'{n_events} events in the first')

    gen = torch.Generator().manual_seed(0)
    model = Model(event_representation_depth=9, base_channels=64,
                  generator=gen, device=device)
    kernels = []

    # --- 2. K1 against its twin ------------------------------------------
    ev = host[0].to(device).events
    valid = ev.sample_index < B
    plane = ev.sample_index.clamp(0, B - 1)       # one element per sample
    C = 9
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(capacity, C)).astype(np.float32)).to(device)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, H, W, C)).astype(np.float32)).to(device)
    vox_args = (ev.x, ev.y, plane)
    results = {}
    for name, fn in (('kernel', voxel_cuda.voxelize),
                     ('plain', voxel_cuda.plain)):
        wr = w.clone().requires_grad_(True)
        grid = fn(*vox_args, wr, valid, B, H, W)
        (dw,) = torch.autograd.grad(grid, wr, g)
        torch.cuda.synchronize()
        results[name] = (grid.detach(), dw)
    print('[2] K1 voxelize against voxelize_scatter')
    err_f = check_close('forward', results['kernel'][0], results['plain'][0],
                        1e-5, 1e-5)
    err_b = check_close('backward', results['kernel'][1],
                        results['plain'][1], 1e-6, 1e-6)
    if results['kernel'][1][~valid].any():
        raise AssertionError('K1 backward: padding rows got a gradient')

    def vox_fwd(fn):
        return lambda: fn(*vox_args, w, valid, B, H, W)

    wg = w.clone().requires_grad_(True)
    graphs = {name: fn(*vox_args, wg, valid, B, H, W)
              for name, fn in (('kernel', voxel_cuda.voxelize),
                               ('plain', voxel_cuda.plain))}

    def vox_bwd(name):
        return lambda: torch.autograd.grad(graphs[name], wg, g,
                                           retain_graph=True)

    for suffix, err, (k_ms, p_ms), line in (
            ('fwd', err_f, time_pair(vox_fwd(voxel_cuda.voxelize),
                                     vox_fwd(voxel_cuda.plain)), 272),
            ('bwd', err_b, time_pair(vox_bwd('kernel'), vox_bwd('plain')),
             324)):
        print(f'  voxelize_{suffix}: kernel {k_ms:.4f} ms, plain '
              f'{p_ms:.4f} ms')
        kernels.append({
            'name': f'voxelize_{suffix}', 'route': 'cuda',
            'source': 'dvs_of_training_framework_tpu_torch/csrc/voxelize.cu',
            'replaces': 'dvs_of_training_framework_tpu/ops/voxel_pallas.py:'
                        f'{line}',
            'max_abs_err': err, 'ms': k_ms, 'plain_ms': p_ms})
    del graphs
    torch.cuda.synchronize()

    # --- 3. K2 against its twin ------------------------------------------
    ql = model.quantization_layer
    mlp_params = [t.detach() for layer in (ql.kernel_hidden1,
                                           ql.kernel_hidden2, ql.kernel_out)
                  for t in layer()]
    delta = torch.from_numpy(np.random.default_rng(3).uniform(
        -1.2, 1.2, size=(C, capacity)).astype(np.float32)).to(device)
    cot = torch.from_numpy(np.random.default_rng(4).normal(
        size=(C, capacity)).astype(np.float32)).to(device)
    results = {}
    for name, fn in (('kernel', kernel_mlp_cuda.kernel_mlp),
                     ('plain', kernel_mlp_cuda.plain)):
        inputs = [t.clone().requires_grad_(True)
                  for t in [delta] + mlp_params]
        out = fn(*inputs)
        grads = torch.autograd.grad(out, inputs, cot)
        torch.cuda.synchronize()
        results[name] = (out.detach(), grads)
    print('[3] K2 kernel_mlp against its plain twin')
    err_f = check_close('forward', results['kernel'][0], results['plain'][0],
                        2e-6, 2e-6)
    err_b = 0.0
    for gname, got, want in zip(['delta', 'w1', 'b1', 'w2', 'b2', 'w3', 'b3'],
                                results['kernel'][1], results['plain'][1]):
        scale = max(1.0, want.abs().max().item())
        err_b = max(err_b, check_close(f'd{gname}', got, want, 1e-5,
                                       1e-5 * scale))

    def mlp_fwd(fn):
        return lambda: fn(delta, *mlp_params)

    params_g = [t.clone().requires_grad_(True) for t in mlp_params]
    graphs = {name: fn(delta, *params_g)
              for name, fn in (('kernel', kernel_mlp_cuda.kernel_mlp),
                               ('plain', kernel_mlp_cuda.plain))}

    def mlp_bwd(name):
        return lambda: torch.autograd.grad(graphs[name], params_g, cot,
                                           retain_graph=True)

    for suffix, err, (k_ms, p_ms), line in (
            ('fwd', err_f, time_pair(mlp_fwd(kernel_mlp_cuda.kernel_mlp),
                                     mlp_fwd(kernel_mlp_cuda.plain)), 221),
            ('bwd', err_b, time_pair(mlp_bwd('kernel'), mlp_bwd('plain')),
             252)):
        print(f'  kernel_mlp_{suffix}: kernel {k_ms:.4f} ms, plain '
              f'{p_ms:.4f} ms')
        kernels.append({
            'name': f'kernel_mlp_{suffix}', 'route': 'cuda',
            'source': 'dvs_of_training_framework_tpu_torch/csrc/'
                      'kernel_mlp.cu',
            'replaces': 'dvs_of_training_framework_tpu/ops/'
                        f'kernel_mlp_pallas.py:{line}',
            'max_abs_err': err, 'ms': k_ms, 'plain_ms': p_ms})
    del graphs
    torch.cuda.synchronize()

    # --- 4. one golden step: kernel path against twin path ---------------
    shapes = [(H // 2 ** i, W // 2 ** i) for i in range(4)][::-1]
    evaluator = MultiScaleLoss(shapes)
    twin = Model(event_representation_depth=9, base_channels=64,
                 plain_ops=True, generator=torch.Generator().manual_seed(1),
                 device=device)
    twin.load_state_dict(model.state_dict())
    batch = host[0].to(device)
    step_grads = {}
    for name, m in (('kernel', model), ('plain', twin)):
        loss, _ = make_loss_fn(m, evaluator, LOSS_WEIGHTS)(batch)
        named = dict(m.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        torch.cuda.synchronize()
        step_grads[name] = (loss.item(), dict(zip(named, grads)))
    loss_k, grads_k = step_grads['kernel']
    loss_p, grads_p = step_grads['plain']
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f'[4] golden step, kernels against twins: loss {loss_k:.7f} vs '
          f'{loss_p:.7f} (rel {rel:.2e})')
    if not rel <= 1e-5:
        raise AssertionError('golden step: loss differs from the twin path')
    worst = (0.0, '')
    for pname, want in grads_p.items():
        got = grads_k[pname]
        scale = want.abs().max().item()
        err = max_abs(got, want)
        ratio = err / max(scale, 1e-12)
        worst = max(worst, (ratio, pname))
        if not (torch.isfinite(got).all() and err <= 1e-4 * scale + 1e-9):
            raise AssertionError(f'golden step: gradient of {pname} '
                                 f'differs (max abs err {err:.3e}, leaf '
                                 f'max {scale:.3e})')
    print(f'  {len(grads_p)} parameter gradients agree; worst max-abs-err / '
          f'leaf-max {worst[0]:.2e} ({worst[1]})')
    qgrads = [pn for pn in grads_k if pn.startswith('quantization_layer.')]
    print('  quantization_layer gradients: ' + ', '.join(
        f'{pn.split(".", 1)[1]} {grads_k[pn].abs().max().item():.3e}'
        for pn in qgrads))
    del twin, step_grads, grads_k, grads_p, batch
    torch.cuda.synchronize()

    # --- 5. train: the main path ------------------------------------------
    args = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                           half_life=100000, num_warmup_steps=0,
                           training_steps=1000000, rs=0.5)
    step_fn = make_train_step(model, evaluator,
                              construct_optimizer(args, model),
                              LOSS_WEIGHTS, 1)
    state = create_train_state()
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in (voxel_cuda.launches, kernel_mlp_cuda.launches):
        for key in counter:
            counter[key] = 0
    for i, host_batch in enumerate(host):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, (loss, _) = step_fn(state, host_batch.to(device))
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    counts = {'voxelize_fwd': voxel_cuda.launches['fwd'],
              'voxelize_bwd': voxel_cuda.launches['bwd'],
              'kernel_mlp_fwd': kernel_mlp_cuda.launches['fwd'],
              'kernel_mlp_bwd': kernel_mlp_cuda.launches['bwd']}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).cpu()
    print(f'[5] {WARMUP}+{STEPS} golden steps: losses '
          + ' '.join(f'{v:.5f}' for v in losses.tolist()))
    if not torch.isfinite(losses).all():
        raise AssertionError('training produced a non-finite loss')
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError('training produced non-finite parameters')
    if state.step != WARMUP + STEPS:
        raise AssertionError(f'{state.step} optimizer steps taken')
    for name, n in counts.items():
        if n != WARMUP + STEPS:
            raise AssertionError(f'{name} launched {n} times in '
                                 f'{WARMUP + STEPS} steps')
    print(f'  launches: {counts}')
    print(f'  step {step_ms:.3f} ms ({1e3 / step_ms:.3f} batches/s), peak '
          f'memory {peak_gib:.3f} GiB, host-to-device copy included; '
          f'card: {card}')

    for entry in kernels:
        entry['launches'] = counts[entry['name']]
    trace_steps(step_fn, state, host[:2], device, step_ms)

    jax_side = sorted(m for m in sys.modules if m.split('.')[0] in (
        'jax', 'flax', 'optax', 'dvs_of_training_framework_tpu'))
    if jax_side:
        raise AssertionError(f'the port loaded JAX-side modules: {jax_side}')

    print(json.dumps({'kernels': kernels}))
    print(f'card: {card}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
