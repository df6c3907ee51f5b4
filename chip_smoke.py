#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

Drives the port's two EVFlowNet training configurations at the full width
that ``bench.py`` times: base 64, depth 9, 256x256, batch 8, event
capacity 2^17, RANGER at lr 1e-3, loss weights (0.5, 1, 1).  "Golden" is
fp32 with TF32 off and the ``F.grid_sample`` warp; "recipe" is the bf16
model with the ``bf16x2`` loss, whose warp takes its corners from K3.
Phases:

1. device: the card's name and power limit, then the nvcc build of the
   kernels in ``dvs_of_training_framework_tpu_torch/csrc/``;
2. K1 (voxelize) against its plain twin on a bench batch, forward and
   backward, with the device time of both; then K1 with bf16 weights;
3. K2 (kernel-MLP) against its plain twin on delta [9, 2^17], forward and
   the seven gradients, with the device time of both;
4. K3 (warp corners) against its plain twin on the bench frames at the
   four loss scales, with flows reaching past the border and points at
   +-1e6 px: corners exactly, the warp's grid gradient, device times;
5. one golden step through the kernels against one through the twins:
   the loss and the raw gradient of every parameter, before the
   optimizer;
6. the same for one recipe step;
7. 3 warm-up and 10 timed golden steps on bench batches copied to the
   card each step, with the kernels' launch counters reset just before
   and checked just after (K3 is not on this path);
8. two more golden steps under ``torch.profiler``: device busy time a
   step and the busiest device ops;
9. and 10. phases 7 and 8 for the recipe (K3 four times a step).

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
CONFIGS = {'golden': ('float32', 'highest'), 'recipe': ('bfloat16', 'bf16x2')}
KERNEL_SOURCE = 'dvs_of_training_framework_tpu_torch/csrc/'


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


def trace_steps(label, step_fn, state, batches, device, step_ms, top=12):
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
        print(f'{label} the profiler recorded no device time: not measured')
        return
    print(f'{label} traced {len(batches)} steps: device busy {busy_ms:.3f} '
          f'ms a step, {100 * (1 - busy_ms / step_ms):.1f}% idle in the '
          f'{step_ms:.3f} ms step ({wall_ms:.3f} ms a step under the '
          f'profiler)')
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:top]:
        ms = e.device_time_total / 1e3 / len(batches)
        calls = e.count // len(batches)
        print(f'  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}%  x{calls:<4d} '
              f'{e.key[:90]}')


def max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_close(name, got, want, rtol, atol):
    """Raise unless |got - want| <= atol + rtol * |want| everywhere."""
    got, want = got.float(), want.float()
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


def kernel_entry(name, source, replaces, err, k_ms, p_ms):
    return {'name': name, 'route': 'cuda', 'source': KERNEL_SOURCE + source,
            'replaces': 'dvs_of_training_framework_tpu/ops/' + replaces,
            'max_abs_err': err, 'ms': k_ms, 'plain_ms': p_ms}


def compare_step(label, models, evaluators, batch, loss_rtol, grad_tol):
    """One step's loss and raw gradients through the kernels against the
    twins; raises unless the loss agrees to ``loss_rtol`` and every
    gradient to ``grad_tol`` of its leaf's largest value."""
    from dvs_of_training_framework_tpu_torch.training import make_loss_fn
    step_grads = {}
    for name in ('kernel', 'plain'):
        m = models[name]
        loss, _ = make_loss_fn(m, evaluators[name], LOSS_WEIGHTS)(batch)
        named = dict(m.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        torch.cuda.synchronize()
        step_grads[name] = (loss.item(), dict(zip(named, grads)))
    loss_k, grads_k = step_grads['kernel']
    loss_p, grads_p = step_grads['plain']
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f'{label} kernels against twins: loss {loss_k:.7f} vs '
          f'{loss_p:.7f} (rel {rel:.2e}, tol {loss_rtol:g})')
    if not rel <= loss_rtol:
        raise AssertionError(f'{label}: loss differs from the twin path')
    worst = (0.0, '')
    for pname, want in grads_p.items():
        got = grads_k[pname]
        scale = want.abs().max().item()
        err = max_abs(got, want)
        worst = max(worst, (err / max(scale, 1e-12), pname))
        if not (torch.isfinite(got).all()
                and err <= grad_tol * scale + 1e-9):
            raise AssertionError(f'{label}: gradient of {pname} differs '
                                 f'(max abs err {err:.3e}, leaf max '
                                 f'{scale:.3e})')
    print(f'  {len(grads_p)} parameter gradients agree; worst max-abs-err / '
          f'leaf-max {worst[0]:.2e} ({worst[1]}, tol {grad_tol:g})')
    qgrads = [pn for pn in grads_k if pn.startswith('quantization_layer.')]
    print('  quantization_layer gradients: ' + ', '.join(
        f'{pn.split(".", 1)[1]} {grads_k[pn].abs().max().item():.3e}'
        for pn in qgrads))


def train(label, model, evaluator, host, device, card, counters):
    """WARMUP + STEPS training steps, each on a host batch copied to the
    card; the launch counters are reset just before and read just after.
    Returns the step function and state, the step time in ms, the
    launch counts and the peak memory in GiB."""
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, create_train_state, make_train_step)
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
    for counter, key in counters.values():
        counter[key] = 0
    for i, host_batch in enumerate(host):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, (loss, _) = step_fn(state, host_batch.to(device))
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    counts = {name: counter[key] for name, (counter, key) in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).cpu()
    print(f'{label} {WARMUP}+{STEPS} steps: losses '
          + ' '.join(f'{v:.5f}' for v in losses.tolist()))
    if not torch.isfinite(losses).all():
        raise AssertionError(f'{label}: a non-finite loss')
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError(f'{label}: non-finite parameters')
    if state.step != WARMUP + STEPS:
        raise AssertionError(f'{label}: {state.step} optimizer steps taken')
    print(f'  launches: {counts}')
    print(f'  step {step_ms:.3f} ms ({1e3 / step_ms:.3f} batches/s), peak '
          f'memory {peak_gib:.3f} GiB, host-to-device copy included; '
          f'card: {card}')
    return step_fn, state, step_ms, counts


def check_counts(label, counts, expected):
    for name, n in counts.items():
        if n != expected[name]:
            raise AssertionError(f'{label}: {name} launched {n} times in '
                                 f'{WARMUP + STEPS} steps, expected '
                                 f'{expected[name]}')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.losses import (
        LOSS_PRECISIONS, MultiScaleLoss)
    from dvs_of_training_framework_tpu_torch.models import Model
    from dvs_of_training_framework_tpu_torch.ops import (
        _build, kernel_mlp_cuda, voxel_cuda, warp, warp_cuda)
    from dvs_of_training_framework_tpu_torch.ops.resize import \
        resize_bilinear

    counters = {'voxelize_fwd': (voxel_cuda.launches, 'fwd'),
                'voxelize_bwd': (voxel_cuda.launches, 'bwd'),
                'kernel_mlp_fwd': (kernel_mlp_cuda.launches, 'fwd'),
                'kernel_mlp_bwd': (kernel_mlp_cuda.launches, 'bwd'),
                'corner_values': (warp_cuda.launches, 'fwd')}

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

    def make_model(config, plain_ops=False, seed=0):
        return Model(event_representation_depth=9, base_channels=64,
                     plain_ops=plain_ops, dtype=CONFIGS[config][0],
                     generator=torch.Generator().manual_seed(seed),
                     device=device)

    model = make_model('golden')
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

    def vox_results(weights):
        results = {}
        for name, fn in (('kernel', voxel_cuda.voxelize),
                         ('plain', voxel_cuda.plain)):
            wr = weights.clone().requires_grad_(True)
            grid = fn(*vox_args, wr, valid, B, H, W)
            (dw,) = torch.autograd.grad(grid, wr, g)
            torch.cuda.synchronize()
            results[name] = (grid.detach(), dw)
        if results['kernel'][1][~valid].any():
            raise AssertionError('K1 backward: padding rows got a gradient')
        return results

    results = vox_results(w)
    print('[2] K1 voxelize against voxelize_scatter')
    err_f = check_close('forward', results['kernel'][0], results['plain'][0],
                        1e-5, 1e-5)
    err_b = check_close('backward', results['kernel'][1],
                        results['plain'][1], 1e-6, 1e-6)

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
        kernels.append(kernel_entry(f'voxelize_{suffix}', 'voxelize.cu',
                                    f'voxel_pallas.py:{line}', err, k_ms,
                                    p_ms))
    del graphs

    # the recipe's bf16 weights: the grid stays fp32, dw comes back in bf16
    results = vox_results(w.bfloat16())
    print('[2] K1 voxelize with bf16 weights against voxelize_scatter')
    check_close('forward', results['kernel'][0], results['plain'][0],
                1e-5, 1e-5)
    if results['kernel'][1].dtype != torch.bfloat16:
        raise AssertionError('K1 backward: bf16 weights got a '
                             f'{results["kernel"][1].dtype} gradient')
    check_close('backward (bf16)', results['kernel'][1], results['plain'][1],
                1e-6, 1e-6)
    del results
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
        kernels.append(kernel_entry(f'kernel_mlp_{suffix}', 'kernel_mlp.cu',
                                    f'kernel_mlp_pallas.py:{line}', err,
                                    k_ms, p_ms))
    del graphs, model
    torch.cuda.synchronize()

    # --- 4. K3 against its twin ------------------------------------------
    print('[4] K3 corner_values against its plain twin, bench frames')
    frames = host[0].to(device).images[1::2]        # the warped frames
    flow_rng = np.random.default_rng(5)
    k_total = p_total = err_corners = 0.0
    for S in (H // 8, H // 4, H // 2, H):
        frames = resize_bilinear(frames, (S, S))     # chained, as the loss
        base = torch.stack(torch.meshgrid(
            torch.arange(S, dtype=torch.float32),
            torch.arange(S, dtype=torch.float32), indexing='xy'))
        # flows of S/8 px carry points past the border; 4 points a frame
        # at +-1e6 px
        flow = torch.from_numpy(flow_rng.normal(
            0.0, S / 8, (B, 2, S, S)).astype(np.float32))
        flow[:, 0, 0, :4] = torch.tensor([1e6, -1e6, 0.0, 0.0])
        flow[:, 1, 0, :4] = torch.tensor([0.0, 0.0, 1e6, -1e6])
        grid = (base[None] + flow) / ((S - 1) / 2.0) - 1.0
        grid = grid.permute(0, 2, 3, 1).contiguous().to(device)
        iy, ix = (t.contiguous() for t in
                  warp._unnormalize(grid.reshape(B, S * S, 2), S, S))
        got = warp_cuda.corner_values(frames, iy, ix)
        want = warp.corner_values(frames, iy, ix)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f'K3 at {S}x{S}: corners differ (max abs '
                                 f'err {max_abs(got, want):.3e})')
        err_corners = max(err_corners, max_abs(got, want))
        outside = (got == 0).float().mean().item()
        cot = torch.randn(B, 1, S, S, device=device,
                          generator=torch.Generator(device).manual_seed(S))
        warped = {}
        for plain_ops in (False, True):
            gr = grid.clone().requires_grad_(True)
            out = warp.grid_sample_onehot(frames, gr, True, plain_ops)
            (dgrid,) = torch.autograd.grad(out, gr, cot)
            torch.cuda.synchronize()
            warped[plain_ops] = (out.detach(), dgrid)
        if not torch.equal(warped[False][0], warped[True][0]):
            raise AssertionError(f'K3 at {S}x{S}: warped frames differ')
        print(f'  {S}x{S}: corners equal ({100 * outside:.2f}% zero)')
        check_close(f'{S}x{S} grid gradient', warped[False][1],
                    warped[True][1], 1e-4, 1e-4)
        k_ms, p_ms = time_pair(
            lambda: warp_cuda.corner_values(frames, iy, ix),
            lambda: warp.corner_values(frames, iy, ix))
        print(f'  {S}x{S}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms')
        k_total += k_ms
        p_total += p_ms
    print(f'  corner_values, the four scales of a step: kernel '
          f'{k_total:.4f} ms, plain {p_total:.4f} ms')
    kernels.append(kernel_entry('corner_values', 'warp_corners.cu',
                                'warp_pallas.py:126', err_corners, k_total,
                                p_total))
    del frames, grid, iy, ix, got, want, warped
    torch.cuda.synchronize()

    # --- 5. and 6. one step of each config: kernel path against twins ----
    shapes = [(H // 2 ** i, W // 2 ** i) for i in range(4)][::-1]
    batch = host[0].to(device)
    # Golden: fp32 everywhere, so the two paths differ only in the kernels'
    # summation order.  Recipe: K1's fp32 atomics add in another order and
    # K2 differs from its twin by ~1e-8, so a few bf16 roundings of the
    # grid and the MLP output fall the other way, and the bf16 network
    # carries those flips to every gradient: loss 1e-3, gradients 5e-2 of
    # the leaf's largest value.
    for phase, config, loss_rtol, grad_tol in (('[5]', 'golden', 1e-5, 1e-4),
                                               ('[6]', 'recipe', 1e-3, 5e-2)):
        bf16x2 = LOSS_PRECISIONS[CONFIGS[config][1]]
        kernel_model = make_model(config)
        twin = make_model(config, plain_ops=True, seed=1)
        twin.load_state_dict(kernel_model.state_dict())
        compare_step(f'{phase} {config} step',
                     {'kernel': kernel_model, 'plain': twin},
                     {'kernel': MultiScaleLoss(shapes, bf16x2=bf16x2),
                      'plain': MultiScaleLoss(shapes, bf16x2=bf16x2,
                                              plain_ops=True)},
                     batch, loss_rtol, grad_tol)
        del twin, kernel_model
    del batch
    torch.cuda.synchronize()

    # --- 7. to 10. train each config: the main paths -----------------------
    launches = {}
    n = WARMUP + STEPS
    for phases, config in ((('[7]', '[8]'), 'golden'),
                           (('[9]', '[10]'), 'recipe')):
        m = make_model(config)
        evaluator = MultiScaleLoss(
            shapes, bf16x2=LOSS_PRECISIONS[CONFIGS[config][1]])
        step_fn, state, step_ms, counts = train(
            f'{phases[0]} {config}', m, evaluator, host, device, card,
            counters)
        check_counts(config, counts, {
            'voxelize_fwd': n, 'voxelize_bwd': n, 'kernel_mlp_fwd': n,
            'kernel_mlp_bwd': n,
            'corner_values': 4 * n if config == 'recipe' else 0})
        launches[config] = counts
        trace_steps(phases[1], step_fn, state, host[:2], device, step_ms)
        del step_fn, state, m, evaluator
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    for entry in kernels:
        entry['launches'] = launches['recipe'][entry['name']]
        entry['golden_launches'] = launches['golden'][entry['name']]

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
