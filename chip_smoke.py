#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

Drives the port's two EVFlowNet training configurations at the full width
that ``bench.py`` times: base 64, depth 9, 256x256, batch 8, event
capacity 2^17, RANGER at lr 1e-3, loss weights (0.5, 1, 1).  "Golden" is
fp32 with TF32 off and the ``F.grid_sample`` warp; "recipe" is the bf16
model with the ``bf16x2`` loss, whose warp takes its corners from K3.
Phases:

1. device: the card's name and power limit, then the nvcc build of the
   kernels in ``dvs_of_training_framework_tpu_torch/csrc/``, with each
   kernel's registers, shared memory and spills, and the K2 kernels'
   SASS instructions, tensor-core (HMMA) and special-function (MUFU)
   ones apart, where the toolkit has ``cuobjdump`` (HMMA must not be 0);
2. K1 (voxelize) against its plain twin on a bench batch, forward and
   backward; its device time beside the twin's, one PyTorch call's
   (``index_put_(accumulate=True)`` forward, a gather backward) and the
   bound; then, with fp32 and with bf16 weights, on the batch and on the
   batch with 3000 events moved onto 3 hot pixels, 200 repeats of the
   forward must equal the first grid bit for bit, and that grid the
   twin's on the CPU (one thread: a serial add in event order); on each
   of the two batches the forward's device time and device ops, beside
   a stable argsort of the cell ids; then K1 with bf16 weights against
   its twin;
3. K2 (kernel-MLP) against its plain twin on delta [9, 2^17], forward and
   the seven gradients; both against a float64 evaluation, where the
   kernel may err on each tensor by at most twice what the fp32 twin errs
   (or 4 fp32 ulps of the tensor's scale); device times beside the
   bounds, which count the products at the tensor cores' 3xTF32 rate and
   each tanh as one special-function operation;
4. K3 (warp corners) against its plain twin on the bench frames at the
   four loss scales, with flows reaching past the border and points at
   +-1e6 px: corners exactly, the warp's grid gradient, device times;
5. one golden step through the kernels against one through the twins:
   the loss and the raw gradient of every parameter, before the
   optimizer; then the same golden step twice from the same state under
   ``cudnn.deterministic``, which must repeat bit for bit;
6. the same for one recipe step;
7. 3 warm-up and 10 timed golden steps on bench batches copied to the
   card each step, with the kernels' launch counters reset just before
   and checked just after (K3 is not on this path), four times: with
   cuDNN's default algorithms, with only its deterministic ones (as the
   CLI's ``run()`` sets), deterministic again and default again;
8. two more golden steps under ``torch.profiler`` with each setting:
   device busy time a step and the busiest device ops;
9. and 10. phases 7 and 8 for the recipe (K3 four times a step);
11. the training loop through the CLI's ``run()`` with the production
    recipe (bf16, ``bf16x2``, bs 8, lr 1e-3, half-life 20000, 200 warm-up
    steps, clip 1.0, EMA 0.999): 12 steps over an in-memory stream of
    bench batches with one oversized batch to skip, checkpoints and
    validation (2 other bench batches) every 4 steps, with the launch
    counters reset just before and checked just after; prints the loop's
    step time, the checkpoint write time and size and the validation time;
12. resume: a fresh model and optimizer load checkpoint 8, bit for bit,
    and train to step 12 through the loop as phase 11 does, under the
    profiler for the batch uploads; every parameter is held against the
    uninterrupted run within twice the card's own run-to-run spread, the
    largest difference of any parameter between two runs of steps 9-12
    from the same state, and exactly where those two runs agree;
13. the EMA export: ``finalize(use_ema=True)`` of checkpoint 12 equals
    the EMA of the optimizer state and loads into a fresh model.

Prints the kernels as one JSON line (each with its time, the twin's,
one PyTorch call's where one computes the same function, its bound at
the published H100 SXM peaks and its launches on the main path), the
card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``.  Any failure raises, so the exit code is not 0 and
that line is not printed.

Usage (from the root of a checkout):  python3 chip_smoke.py
"""
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WARMUP, STEPS = 3, 10
TIMING_ITERS = 20
REPEATS = 200       # K1 launches on one batch that must repeat exactly
HOT_EVENTS, HOT_CELLS = 3000, 3   # events moved onto a few hot pixels
# published H100 SXM peaks (dense): fp32 outside the tensor cores, TF32 on
# them, device memory; special-function (MUFU) results come 16 a clock an
# SM against the 128 fp32 FMAs (256 flop) of the fp32 peak
FP32_FLOPS, TF32_FLOPS, MEMORY_BYTES_S = 67e12, 495e12, 3.35e12
SFU_OPS = FP32_FLOPS / 16
LOSS_WEIGHTS = (0.5, 1, 1)
CONFIGS = {'golden': ('float32', 'highest'), 'recipe': ('bfloat16', 'bf16x2')}
KERNEL_SOURCE = 'dvs_of_training_framework_tpu_torch/csrc/'
LOOP_STEPS, LOOP_EVERY, SKIP_AT = 12, 4, 2


MLP_GRADS = ['delta', 'w1', 'b1', 'w2', 'b2', 'w3', 'b3']
# 4 fp32 ulps of a tensor's largest magnitude: where the twin lands within
# an ulp (db3, a plain sum over all points), twice its error would ask the
# kernel for less than the one rounding its own result needs
F64_FLOOR = 4 * 2.0 ** -23


def kernel_mlp_f64(delta, w1, b1, w2, b2, w3, b3):
    """K2's function as ``kernel_mlp_cuda.plain`` computes it, in the
    inputs' own type (float64 here: the reference of both)."""
    h = torch.tanh(delta.reshape(-1, 1) @ w1 + b1)
    h = torch.tanh(h @ w2 + b2)
    return (h @ w3 + b3).reshape(delta.shape)


def check_against_float64(results):
    """Raise unless, for the output and each of the seven gradients, the
    kernel's largest error against float64 is at most twice the fp32
    twin's, or at most F64_FLOOR; each error is taken relative to the
    tensor's largest magnitude."""
    print('  against float64, max abs err / max magnitude (kernel, twin, '
          'ratio):')
    failed = []
    for i, oname in enumerate(['out'] + MLP_GRADS):
        exact = results['float64'][i]
        scale = exact.abs().max().item() or 1.0
        errs = {k: max_abs(results[k][i].double(), exact) / scale
                for k in ('kernel', 'plain')}
        print(f'    {oname}: {errs["kernel"]:.3e}, {errs["plain"]:.3e}, '
              f'{errs["kernel"] / max(errs["plain"], 1e-30):.2f}')
        if errs['kernel'] > max(2 * errs['plain'], F64_FLOOR):
            failed.append(oname)
    if failed:
        raise AssertionError(f'K2 errs by more than twice its fp32 twin on '
                             f'{failed}')


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
    host and launch gaps between them do not count.  The profiler now and
    then records no device time; after three such tries CUDA events
    around the loop stand in."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
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


def time_pair(kernel_fn, plain_fn, library_fn=None):
    """(kernel ms, plain ms, library ms or None) of device time, in
    turns: plain, kernel, library, library, kernel, plain."""
    fns = [plain_fn, kernel_fn] + ([library_fn] if library_fn else [])
    times = [device_ms(f) for f in fns + fns[::-1]]
    means = [(a + b) / 2 for a, b in zip(times, times[::-1])]
    return means[1], means[0], (means[2] if library_fn else None)


def bound(nbytes=0.0, flops=0.0, mma_flops=0.0, sfu_ops=0.0):
    """(ms, 'bytes' or 'operations', limiting unit): the least time the
    card could take to move ``nbytes`` of device memory and to do
    ``flops`` fp32 operations on the CUDA cores, ``mma_flops`` fp32
    product operations on the tensor cores as 3xTF32 (three TF32 products
    each) and ``sfu_ops`` special-function operations, at the published
    peaks.  The units run side by side, so the slowest sets the bound."""
    times = {'bytes': nbytes / MEMORY_BYTES_S, 'fp32': flops / FP32_FLOPS,
             '3xTF32': 3 * mma_flops / TF32_FLOPS, 'MUFU': sfu_ops / SFU_OPS}
    unit = max(times, key=times.get)
    return (times[unit] * 1e3, 'bytes' if unit == 'bytes' else 'operations',
            unit)


def kernel_mlp_work(points, hd):
    """``{'fwd': {...}, 'bwd': {...}}``: ``bound``'s keyword arguments
    for K2 at ``points`` points and hidden size ``hd``.  Products: h1 W2
    (2 hd^2 a point); the backward recomputes it and adds dh1 = dz2 W2^T
    and dW2 += h1^T dz2.  Vector work: w1 d + b1 (2 hd), + b2 (hd),
    w3 . h2 + b3 (2 hd + 1); backward also dz2 (3 hd), dw3 (2 hd), db2
    (hd), dz1 (2 hd), d(delta) (2 hd), dw1 (2 hd), db1 (hd) and db3 (1).
    Each tanh is one special-function operation (the least the card needs
    for one), 2 hd a point both ways.  Bytes: delta and the output
    (forward); delta, its cotangent and d(delta) (backward)."""
    fwd = dict(flops=points * (5 * hd + 1), mma_flops=points * 2 * hd * hd,
               sfu_ops=points * 2 * hd, nbytes=8 * points)
    bwd = dict(flops=points * (18 * hd + 2), mma_flops=3 * fwd['mma_flops'],
               sfu_ops=fwd['sfu_ops'], nbytes=12 * points)
    return {'fwd': fwd, 'bwd': bwd}


def sass_counts(lib_path):
    """``{kernel: {'all': n, 'HMMA': n, 'MUFU': n}}``: the SASS
    instructions of each kernel of the built library (tensor-core MMAs
    and special-function operations apart), from cuobjdump, or None where
    the toolkit has no cuobjdump."""
    tool = shutil.which('cuobjdump')
    if tool is None and Path('/usr/local/cuda/bin/cuobjdump').exists():
        tool = '/usr/local/cuda/bin/cuobjdump'
    if tool is None:
        return None
    sass = subprocess.run([tool, '-sass', str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            function = line.split(':', 1)[1].strip()
            counts[function] = {'all': 0, 'HMMA': 0, 'MUFU': 0}
        elif function is not None and line.lstrip().startswith('/*') \
                and '*/' in line and ';' in line:
            counts[function]['all'] += 1
            for op in ('HMMA', 'MUFU'):
                counts[function][op] += op in line
    return counts


def device_parts(fn, iters=TIMING_ITERS):
    """``[(us a call, device op)]`` of ``fn()``, busiest first."""
    fn()
    torch.cuda.synchronize()
    with profile() as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.device_time_total / iters, e.key)
                   for e in device_ops(prof.key_averages())), reverse=True)


def one_thread_twin(fn, *args):
    """``fn(*args)`` on the CPU copies of the tensors in ``args`` with
    one intra-op thread, so that a CPU scatter adds in index order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args))
    finally:
        torch.set_num_threads(threads)


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


def kernel_entry(name, source, replaces, err, times, bound_ms):
    (k_ms, p_ms, lib_ms), (b_ms, b_kind, unit) = times, bound_ms
    print(f'  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library '
          + ('none' if lib_ms is None else f'{lib_ms:.4f} ms')
          + f'; bound {b_ms:.4f} ms ({b_kind}: {unit}), kernel at '
          f'{100 * b_ms / k_ms:.1f}% of it')
    return {'name': name, 'route': 'cuda', 'source': KERNEL_SOURCE + source,
            'replaces': 'dvs_of_training_framework_tpu/ops/' + replaces,
            'max_abs_err': err, 'ms': k_ms, 'plain_ms': p_ms,
            'bound_ms': b_ms, 'bound_by': b_kind, 'library_ms': lib_ms}


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
    worst, bad = (0.0, ''), []
    for pname, want in grads_p.items():
        got = grads_k[pname]
        scale = want.abs().max().item()
        err = max_abs(got, want)
        worst = max(worst, (err / max(scale, 1e-12), pname))
        if not (torch.isfinite(got).all()
                and err <= grad_tol * scale + 1e-9):
            bad.append(f'{pname} (max abs err {err:.3e}, leaf max '
                       f'{scale:.3e})')
    if bad:
        raise AssertionError(f'{label}: gradients differ: ' + '; '.join(bad))
    print(f'  {len(grads_p)} parameter gradients agree; worst max-abs-err / '
          f'leaf-max {worst[0]:.2e} ({worst[1]}, tol {grad_tol:g})')
    qgrads = [pn for pn in grads_k if pn.startswith('quantization_layer.')]
    print('  quantization_layer gradients: ' + ', '.join(
        f'{pn.split(".", 1)[1]} {grads_k[pn].abs().max().item():.3e}'
        for pn in qgrads))


def repeat_step(model, evaluator, batch):
    """The same step twice from the same weights and batch, with only
    cuDNN's deterministic algorithms: raises unless the loss and every raw
    gradient repeat bit for bit."""
    from dvs_of_training_framework_tpu_torch.training import make_loss_fn
    torch.backends.cudnn.deterministic = True
    runs = []
    for _ in range(2):
        loss, _ = make_loss_fn(model, evaluator, LOSS_WEIGHTS)(batch)
        runs.append([loss.detach()] + list(torch.autograd.grad(
            loss, list(model.parameters()))))
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    same = sum(bits_equal(a, b) for a, b in zip(*runs))
    print(f'  the step repeated from the same state under cudnn.'
          f'deterministic: the loss and {same - 1} of {len(runs[0]) - 1} '
          'raw gradients equal bit for bit')
    if same != len(runs[0]):
        raise AssertionError('the golden step does not repeat bit for bit')


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


class LoopClock:
    """The JAX package's timer interface for ``train``: the host clock at
    each train step's start and the time inside each hook call."""
    HOOKS = ('serialization', 'validation')

    def __init__(self):
        self.step_starts = []
        self.hook_spans = []        # (steps started so far, name, seconds)
        self.started = {}

    def __call__(self, name):
        clock = self

        class Span:
            def start(self):
                clock.started[name] = time.perf_counter()
                if name == 'train_step':
                    clock.step_starts.append(clock.started[name])

            def stop(self):
                if name in clock.HOOKS:
                    clock.hook_spans.append(
                        (len(clock.step_starts), name,
                         time.perf_counter() - clock.started[name]))
        return Span()

    def log(self, *args, **kwargs):
        pass

    def step_ms(self, first):
        """Host time of steps ``first`` .. ``last - 1`` (1-based), each from
        its start to the next step's start, less its hooks' time."""
        hooks = {}
        for j, _, seconds in self.hook_spans:
            hooks[j] = hooks.get(j, 0.0) + seconds
        starts = self.step_starts
        return [(starts[j] - starts[j - 1] - hooks.get(j, 0.0)) * 1e3
                for j in range(first, len(starts))]

    def hook_seconds(self, name, every):
        return [s for j, n, s in self.hook_spans
                if n == name and j % every == 0]


def flat_state(tree, prefix=''):
    """``{dotted name: leaf}`` of a nested state dict."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat_state(value, f'{prefix}{key}.'))
        else:
            out[prefix + key] = value
    return out


def clone_tree(tree):
    """A copy of a nested state with every tensor cloned in place."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def bits_equal(a, b):
    if isinstance(a, torch.Tensor):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.is_floating_point():
            view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
            a = a.view(view[a.element_size()])
            b = b.view(view[b.element_size()])
        return torch.equal(a, b)
    return a == b


def loop_phases(out, collated, capacity, device, card, counters, bare_ms):
    """Phases 11-13 in ``out``; returns phase 11's launch counts."""
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.losses import (LOSS_PRECISIONS,
                                                            MultiScaleLoss)
    from dvs_of_training_framework_tpu_torch.models import Model
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, create_train_state, make_eval_step,
        make_train_step)
    from dvs_of_training_framework_tpu_torch.training.serializer import (
        Serializer, read_params_file)
    from dvs_of_training_framework_tpu_torch.training.train import train
    from dvs_of_training_framework_tpu_torch.utils.tb import (
        NullSummaryWriter, SummaryWriter, read_events)

    B = collated[0]['size']
    good = collated[:LOOP_STEPS]
    val = collated[LOOP_STEPS:LOOP_STEPS + 2]
    big = dict(collated[0], augmentation_params=None,
               events={k: np.concatenate([v, v])
                       for k, v in collated[0]['events'].items()})

    def stream(samples_passed):
        """The bench batches from sample ``samples_passed`` on, cycled,
        with the oversized batch once before the third."""
        i = samples_passed // B
        while True:
            if i == SKIP_AT:
                yield big
            yield good[i % LOOP_STEPS]
            i += 1

    args = cli.parse_args([
        '-m', str(out), '-d', 'cuda', '--height', '256', '--width', '256',
        '--precision', 'bfloat16', '--loss-precision', 'bf16x2',
        '-bs', str(B), '-mbs', str(B), '-lr', '1e-3', '--half_life', '20000',
        '--num-warmup-steps', '200', '--grad-clip-norm', '1.0',
        '--ema-decay', '0.999', '-ne', str(LOOP_STEPS),
        '--checkpointing_interval', str(LOOP_EVERY), '-vp', str(LOOP_EVERY),
        '--permanent_interval', str(2 * LOOP_EVERY), '--num_checkpoints', '2',
        '--event-capacity', str(capacity)])

    # --- 11. the loop ------------------------------------------------------
    for counter, key in counters.values():
        counter[key] = 0
    clock = LoopClock()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.run(args, stream, lambda: val, SummaryWriter(out / 'log'),
            timers=clock)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = {name: counter[key] for name, (counter, key) in counters.items()}

    scalars = {}
    for path in (out / 'log').glob('events.out.tfevents.*'):
        for event in read_events(path):
            for tag, value in event['scalars'].items():
                scalars.setdefault(tag, []).append(value)
    losses = scalars.get('General/Train loss', [])
    val_losses = scalars.get('General/Validation loss', [])
    print(f'[11] loop, {LOOP_STEPS} recipe steps through the CLI\'s run(): '
          'losses ' + ' '.join(f'{v:.5f}' for v in losses))
    print('  validation losses ' + ' '.join(f'{v:.5f}' for v in val_losses))
    tags = cli.shapes2tags(cli.flow_shapes(args.shape))
    want_tags = {f'{kind}/{tag}' for tag in tags
                 for kind in ('Train/photometric loss',
                              'Train/smoothness loss',
                              'Train/out regularization')}
    want_tags |= {'General/learning rate/0', 'General/learning rate/1'}
    if (len(losses) != LOOP_STEPS or len(val_losses) != 5
            or not np.isfinite(losses + val_losses).all()):
        raise AssertionError('loop: missing or non-finite losses')
    if not want_tags <= set(scalars):
        raise AssertionError(f'loop: missing tags {want_tags - set(scalars)}')
    if scalars.get('General/skipped batches') != [1.0]:
        raise AssertionError('loop: the oversized batch was not skipped once')
    lrs = scalars['General/learning rate/1']
    print(f'  learning rates (predictor) {lrs[0]:.3e} .. {lrs[-1]:.3e}; '
          'skipped batches 1')

    ser = Serializer(out, args.num_checkpoints, args.permanent_interval)
    steps = ser.list_known_steps()
    on_disk = sorted(p.name for p in out.glob('step_*'))
    print(f'  checkpoints {steps}, files {on_disk}')
    want_steps = [0, 4, 8, 12]
    if steps != want_steps or on_disk != sorted(
            f'step_{s}.ckpt' for s in want_steps):
        raise AssertionError(f'loop: checkpoints {steps} ({on_disk})')

    # 12 steps and 5 validation passes of 2 batches: before, at 4, 8 and
    # 12, and after
    forwards = LOOP_STEPS + 5 * len(val)
    expected = {'voxelize_fwd': forwards, 'voxelize_bwd': LOOP_STEPS,
                'kernel_mlp_fwd': forwards, 'kernel_mlp_bwd': LOOP_STEPS,
                'corner_values': 4 * forwards}
    print(f'  launches: {counts}')
    if counts != expected:
        raise AssertionError(f'loop: launches {counts}, expected {expected}')

    loop_ms = clock.step_ms(WARMUP + 1)
    ckpt_s = clock.hook_seconds('serialization', LOOP_EVERY)
    val_s = clock.hook_seconds('validation', LOOP_EVERY)
    size_mb = (out / f'step_{LOOP_EVERY}.ckpt').stat().st_size / 1e6
    print(f'  loop step {statistics.median(loop_ms):.3f} ms (median of steps '
          f'{WARMUP + 1}-{LOOP_STEPS - 1}, hooks excluded: '
          + ' '.join(f'{v:.1f}' for v in loop_ms)
          + f'); the bare step of phase 9 with deterministic cuDNN: '
          f'{bare_ms:.3f} ms')
    print('  checkpoint write ' + ' '.join(f'{v:.3f}' for v in ckpt_s)
          + f' s, {size_mb:.1f} MB a checkpoint; validation (2 batches) '
          + ' '.join(f'{v:.3f}' for v in val_s) + ' s; run() '
          f'{run_s:.2f} s in all; card: {card}')

    # --- 12. resume from checkpoint 8 -------------------------------------
    evaluator = MultiScaleLoss(cli.flow_shapes(args.shape),
                               bf16x2=LOSS_PRECISIONS[args.loss_precision])

    def fresh(seed):
        model = Model(event_representation_depth=9, dtype=args.precision,
                      generator=torch.Generator().manual_seed(seed),
                      device=device)
        optimizer = construct_optimizer(args, model)
        step_fn = make_train_step(model, evaluator, optimizer,
                                  args.loss_weights, 1)
        return model, optimizer, step_fn

    resume_at = 2 * LOOP_EVERY
    saved = ser.read_state_dict(resume_at)
    model, optimizer, step_fn = fresh(1)
    step, _, _, extra = ser.load_checkpoint(resume_at, model=model,
                                            optimizer=optimizer)
    restored = flat_state({'model': model.state_dict(),
                           'optimizer': optimizer.state_dict()})
    want = flat_state({'model': saved['model'],
                       'optimizer': saved['optimizer']})
    bad = [k for k in want if k not in restored
           or not bits_equal(restored[k], want[k])]
    samples = int(extra['samples_passed'])
    if bad or restored.keys() != want.keys() or step != resume_at \
            or samples != resume_at * B:
        raise AssertionError(f'resume: restored state differs: {bad[:5]}, '
                             f'step {step}, samples {samples}')
    n_tensors = sum(isinstance(v, torch.Tensor) for v in want.values())
    print(f'[12] resume from checkpoint {resume_at}: {n_tensors} tensors '
          '(parameters, moments, slow weights, EMA) and the counts, step '
          f'{step} and samples passed {samples} restored bit for bit')
    snapshot = clone_tree((model.state_dict(), optimizer.state_dict()))

    # the resumed steps take the loop's path, as in phase 11, under the
    # profiler for the batch uploads
    with profile() as prof:
        state, samples = train(step_fn, create_train_state(step),
                               stream(samples), LOOP_STEPS,
                               NullSummaryWriter(), tags, device,
                               event_capacity=capacity, init_step=step,
                               init_samples_passed=samples)
        torch.cuda.synchronize()
    copies = {}
    for e in device_ops(prof.key_averages()):
        if e.key.startswith('Memcpy HtoD'):
            copies[e.key] = (e.count, e.device_time_total / 1e3)
    print('  batch uploads a step in the resumed loop: ' + '; '.join(
        f'{k} x{n / (LOOP_STEPS - step):g} {ms / (LOOP_STEPS - step):.3f} ms'
        for k, (n, ms) in copies.items()))
    if (state.step, samples) != (LOOP_STEPS, LOOP_STEPS * B):
        raise AssertionError(f'resume: ended at {state.step}, {samples}')
    resumed = {k: v.clone() for k, v in model.state_dict().items()}

    batches = [pad_batch(good[i % LOOP_STEPS], capacity)
               for i in range(resume_at, LOOP_STEPS)]
    noise_runs = []
    for _ in range(2):       # from the same state, with no serializer
        model.load_state_dict(snapshot[0])
        optimizer.load_state_dict(snapshot[1])
        run_state = create_train_state(resume_at)
        for batch in batches:
            run_state, _ = step_fn(run_state, batch.to(device))
        noise_runs.append(clone_tree(model.state_dict()))
    uninterrupted = {k: v.to(device) for k, v in
                     ser.read_state_dict(LOOP_STEPS)['model'].items()}
    # (resumed vs uninterrupted, run vs run) max abs difference a parameter
    diffs = {name: (max_abs(resumed[name], want),
                    max_abs(noise_runs[0][name], noise_runs[1][name]))
             for name, want in uninterrupted.items()}
    # the card's spread is the largest run-to-run difference of any
    # parameter, as one pair of runs is too few to estimate it per
    # parameter.  With cuDNN deterministic, as run() sets it, and kernels
    # that add in a fixed order, it is expected to be 0
    spread = max(d_ab for _, d_ab in diffs.values())
    worst_ru = max(d_ru for d_ru, _ in diffs.values())
    for name, (d_ru, d_ab) in diffs.items():
        if d_ru > 2 * spread or (d_ab == 0 and not bits_equal(
                resumed[name], uninterrupted[name])):
            raise AssertionError(f'resume: {name} differs from the '
                                 f'uninterrupted run by {d_ru:.3e}, the '
                                 f'card\'s own spread is {spread:.3e} '
                                 f'({d_ab:.3e} for this parameter)')
    ratio, ratio_name = max(((d_ru / d_ab, name)
                             for name, (d_ru, d_ab) in diffs.items() if d_ab),
                            default=(0.0, 'none'))
    print(f'  steps {resume_at + 1}-{LOOP_STEPS} after the resume against the '
          f'uninterrupted run: worst max abs diff {worst_ru:.3e} ('
          f'{sum(d == 0 for d, _ in diffs.values())}/{len(diffs)} parameters '
          f'equal bit for bit); two runs from the same state: {spread:.3e} ('
          f'{sum(d == 0 for _, d in diffs.values())}/{len(diffs)} equal); '
          f'bound 2x; largest ratio of one parameter\'s two differences '
          f'{ratio:.2f} ({ratio_name})')

    # --- 13. the EMA export -----------------------------------------------
    final = ser.read_state_dict(LOOP_STEPS)
    ema_path = out / 'ema.ckpt'
    ser.finalize(LOOP_STEPS, ema_path, use_ema=True)
    exported = read_params_file(ema_path)
    ema = final['optimizer']['ema_params']
    if exported.keys() != ema.keys() or not all(
            bits_equal(exported[k], ema[k]) for k in ema):
        raise AssertionError('EMA export differs from the optimizer\'s EMA')
    ema_model, _, _ = fresh(2)
    ema_model.load_state_dict(exported, strict=True)
    loss, _ = make_eval_step(ema_model, evaluator, args.loss_weights)(
        pad_batch(val[0], capacity).to(device))
    loss = loss.item()
    live_gap = max(max_abs(ema[k], final['model'][k]) for k in ema)
    if not np.isfinite(loss) or live_gap == 0:
        raise AssertionError(f'EMA export: loss {loss}, gap {live_gap}')
    print(f'[13] finalize(use_ema=True) at step {LOOP_STEPS}: {len(ema)} '
          'tensors equal the optimizer\'s EMA bit for bit and load into a '
          f'fresh model (validation loss {loss:.5f}); largest EMA - live '
          f'weight gap {live_gap:.3e}')
    return counts


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
    sass = sass_counts(lib_path)
    if sass is None:
        print('[1] cuobjdump not found: the HMMA count is not measured')
    else:
        mlp = {k: n for k, n in sass.items() if 'kernel_mlp_' in k
               and ('_fwd_' in k or '_bwd_' in k)}
        for k, n in mlp.items():
            print(f'[1] {k}: {n["all"]} SASS instructions, {n["HMMA"]} '
                  f'tensor-core (HMMA), {n["MUFU"]} special-function (MUFU)')
        if len(mlp) != 2 or not all(n['HMMA'] for n in mlp.values()):
            raise AssertionError('K2 does not run on the tensor cores')

    bench = import_bench()
    B, (H, W), capacity = bench.BATCH_SIZE, bench.IMSIZE, bench.CAPACITY
    rng = np.random.default_rng(0)
    # the first WARMUP + STEPS batches feed phases 5-10 and the loop, the
    # last two the loop's validation
    collated = [bench.make_collated(rng, sample_offset=i * B)
                for i in range(WARMUP + STEPS + 2)]
    host = [pad_batch(c, capacity) for c in collated[:WARMUP + STEPS]]
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

    # the yardsticks, one PyTorch call each, which the port never calls:
    # index_put_ of the valid rows into the flat grid (the indices and
    # values are prepared outside the timing); a gather of the twin's
    # flat indices (an invalid row reads bin 0)
    pix = (plane.long() * H + ev.y.long()) * W + ev.x.long()
    flat = torch.where(valid[:, None],
                       pix[:, None] * C + torch.arange(C, device=device), 0)
    flat = flat.reshape(-1)
    put_at = flat.view(capacity, C)[valid].reshape(-1)
    put_values = w[valid].reshape(-1)

    def index_put():
        return torch.zeros(B * H * W * C, device=device).index_put_(
            (put_at,), put_values, accumulate=True)

    def vox_fwd(fn):
        return lambda: fn(*vox_args, w, valid, B, H, W)

    wg = w.clone().requires_grad_(True)
    graphs = {name: fn(*vox_args, wg, valid, B, H, W)
              for name, fn in (('kernel', voxel_cuda.voxelize),
                               ('plain', voxel_cuda.plain))}

    def vox_bwd(name):
        return lambda: torch.autograd.grad(graphs[name], wg, g,
                                           retain_graph=True)

    # bytes this batch needs: x, y, plane and valid of every row, the
    # weights of the valid rows and every cell of the grid (forward);
    # the same indices, the gradient at the cells the valid rows touch and
    # every row of dw (backward)
    n_valid = int(valid.sum())
    n_cells = int(torch.unique(pix[valid]).numel())
    index_bytes = 13 * capacity
    grid_bytes = 4 * B * H * W * C
    for suffix, err, times, nbytes, line in (
            ('fwd', err_f, time_pair(vox_fwd(voxel_cuda.voxelize),
                                     vox_fwd(voxel_cuda.plain), index_put),
             index_bytes + 4 * n_valid * C + grid_bytes, 272),
            ('bwd', err_b, time_pair(vox_bwd('kernel'), vox_bwd('plain'),
                                     lambda: g.view(-1)[flat]),
             index_bytes + 4 * n_cells * C + 4 * capacity * C, 324)):
        kernels.append(kernel_entry(f'voxelize_{suffix}', 'voxelize.cu',
                                    f'voxel_pallas.py:{line}', err, times,
                                    bound(nbytes=nbytes)))
    del graphs, flat, put_at, put_values

    # K1's forward adds each cell in ascending event order: every launch
    # on one batch gives the same grid, and that grid equals the twin's
    # serial index_add on the CPU bit for bit.  Then the same with a few
    # hot pixels, which take the kernel's path for crowded cells
    hot_x, hot_y = ev.x.clone(), ev.y.clone()
    spots = torch.arange(HOT_EVENTS, device=device) % HOT_CELLS
    hot_x[:HOT_EVENTS], hot_y[:HOT_EVENTS] = spots, spots
    for label, xy in (('the batch', (ev.x, ev.y)),
                      (f'{HOT_EVENTS} events on {HOT_CELLS} hot pixels',
                       (hot_x, hot_y))):
        args = (*xy, plane)
        crowd = torch.bincount(((plane.long() * H + xy[1].long()) * W
                                + xy[0].long())[valid])
        for weights in (w, w.bfloat16()):
            first = voxel_cuda.voxelize(*args, weights, valid, B, H, W)
            same = sum(
                torch.equal(voxel_cuda.voxelize(*args, weights, valid, B, H,
                                                 W).view(torch.int32),
                            first.view(torch.int32))
                for _ in range(REPEATS))
            twin = one_thread_twin(voxel_cuda.plain, *args, weights, valid,
                                   B, H, W)
            exact = bits_equal(first, twin)
            print(f'  voxelize_fwd on {label} (up to {crowd.max().item()} '
                  f'events a cell), {weights.dtype} weights: {same} of '
                  f'{REPEATS} repeats equal the first grid bit for bit; the '
                  f'grid equals the CPU twin\'s bit for bit: {exact}')
            if same != REPEATS or not exact:
                raise AssertionError('K1 forward is not reproducible or '
                                     'differs from its twin\'s order')
        # K1's forward on this batch beside its twin and beside a stable
        # argsort of the cell ids (invalid rows last), which would put each
        # cell's events in ascending order in place of the placement pass,
        # the per-cell sort and the hot-cell kernel
        keys = torch.where(valid, (plane * H + xy[1]) * W + xy[0], B * H * W)
        k_ms, p_ms, sort_ms = time_pair(
            lambda: voxel_cuda.voxelize(*args, w, valid, B, H, W),
            lambda: voxel_cuda.plain(*args, w, valid, B, H, W),
            lambda: torch.sort(keys, stable=True))
        parts = device_parts(
            lambda: voxel_cuda.voxelize(*args, w, valid, B, H, W))
        replaced = sum(us for us, key in parts
                       if 'place_kernel' in key or 'hot_kernel' in key)
        print(f'  voxelize_fwd on {label}: kernel {k_ms:.4f} ms, plain '
              f'{p_ms:.4f} ms; stable argsort of the cell ids {sort_ms:.4f} '
              f'ms against {replaced / 1e3:.4f} ms of placement and hot-cell '
              f'kernels; by device op, us a call: ' + '; '.join(
                  f'{us:.2f} {key[:48]}' for us, key in parts))
    del first, twin, keys

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
    for name, fn, dtype in (('kernel', kernel_mlp_cuda.kernel_mlp,
                             torch.float32),
                            ('plain', kernel_mlp_cuda.plain, torch.float32),
                            ('float64', kernel_mlp_f64, torch.float64)):
        inputs = [t.to(dtype).clone().requires_grad_(True)
                  for t in [delta] + mlp_params]
        out = fn(*inputs)
        grads = torch.autograd.grad(out, inputs, cot.to(dtype))
        torch.cuda.synchronize()
        results[name] = [out.detach()] + list(grads)
    print('[3] K2 kernel_mlp against its plain twin')
    err_f = check_close('forward', results['kernel'][0], results['plain'][0],
                        2e-6, 2e-6)
    err_b = 0.0
    for gname, got, want in zip(MLP_GRADS, results['kernel'][1:],
                                results['plain'][1:]):
        scale = max(1.0, want.abs().max().item())
        err_b = max(err_b, check_close(f'd{gname}', got, want, 1e-5,
                                       1e-5 * scale))
    # against float64: the tensor cores' 3xTF32 products keep fp32 accuracy
    # when each tensor errs by at most twice the fp32 twin's error
    check_against_float64(results)
    del results

    def mlp_fwd(fn):
        return lambda: fn(delta, *mlp_params)

    params_g = [t.clone().requires_grad_(True) for t in mlp_params]
    graphs = {name: fn(delta, *params_g)
              for name, fn in (('kernel', kernel_mlp_cuda.kernel_mlp),
                               ('plain', kernel_mlp_cuda.plain))}

    def mlp_bwd(name):
        return lambda: torch.autograd.grad(graphs[name], params_g, cot,
                                           retain_graph=True)

    work = kernel_mlp_work(delta.numel(), mlp_params[2].shape[0])
    for suffix, err, times, line in (
            ('fwd', err_f, time_pair(mlp_fwd(kernel_mlp_cuda.kernel_mlp),
                                     mlp_fwd(kernel_mlp_cuda.plain)), 221),
            ('bwd', err_b, time_pair(mlp_bwd('kernel'), mlp_bwd('plain')),
             252)):
        kernels.append(kernel_entry(f'kernel_mlp_{suffix}', 'kernel_mlp.cu',
                                    f'kernel_mlp_pallas.py:{line}', err,
                                    times, bound(**work[suffix])))
    del graphs, model
    torch.cuda.synchronize()

    # --- 4. K3 against its twin ------------------------------------------
    print('[4] K3 corner_values against its plain twin, bench frames')
    frames = host[0].to(device).images[1::2]        # the warped frames
    flow_rng = np.random.default_rng(5)
    k_total = p_total = err_corners = corner_bytes = 0.0
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
        k_ms, p_ms, _ = time_pair(
            lambda: warp_cuda.corner_values(frames, iy, ix),
            lambda: warp.corner_values(frames, iy, ix))
        print(f'  {S}x{S}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms')
        k_total += k_ms
        p_total += p_ms
        # the frames, the coordinates and the four corners of each point
        corner_bytes += 4 * (frames.numel() + 2 * iy.numel() + got.numel())
    print('  corner_values, the four scales of a step:')
    kernels.append(kernel_entry('corner_values', 'warp_corners.cu',
                                'warp_pallas.py:126', err_corners,
                                (k_total, p_total, None),
                                bound(nbytes=corner_bytes)))
    del frames, grid, iy, ix, got, want, warped
    torch.cuda.synchronize()

    # --- 5. and 6. one step of each config: kernel path against twins ----
    shapes = [(H // 2 ** i, W // 2 ** i) for i in range(4)][::-1]
    batch = host[0].to(device)
    # Golden: fp32 everywhere, so the two paths differ only in the kernels'
    # summation order.  Recipe: K2 differs from its twin by ~1e-8, so a few
    # bf16 roundings of the MLP output fall the other way, and the bf16
    # network carries those flips to every gradient: loss 1e-3, gradients
    # 5e-2 of the leaf's largest value.
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
        if config == 'golden':
            repeat_step(kernel_model, MultiScaleLoss(shapes), batch)
        del twin, kernel_model
    del batch
    torch.cuda.synchronize()

    # --- 7. to 10. train each config: the main paths -----------------------
    # each config with cuDNN's default algorithms and with only its
    # deterministic ones (as the CLI's run() sets), in turns off, on, on,
    # off; the first run's launch counts stand for the path
    launches, bare_ms = {}, {}
    n = WARMUP + STEPS
    for phases, config in ((('[7]', '[8]'), 'golden'),
                           (('[9]', '[10]'), 'recipe')):
        m = make_model(config)
        evaluator = MultiScaleLoss(
            shapes, bf16x2=LOSS_PRECISIONS[CONFIGS[config][1]])
        times = {False: [], True: []}
        for deterministic in (False, True, True, False):
            torch.backends.cudnn.deterministic = deterministic
            label = f'{phases[0]} {config}, cudnn.deterministic={deterministic}'
            step_fn, state, step_ms, counts = train(
                label, m, evaluator, host, device, card, counters)
            check_counts(config, counts, {
                'voxelize_fwd': n, 'voxelize_bwd': n, 'kernel_mlp_fwd': n,
                'kernel_mlp_bwd': n,
                'corner_values': 4 * n if config == 'recipe' else 0})
            launches.setdefault(config, counts)
            times[deterministic].append(step_ms)
        bare_ms[config] = {k: statistics.mean(v) for k, v in times.items()}
        print(f'{phases[0]} {config} step: {bare_ms[config][False]:.3f} ms '
              f'with cuDNN\'s default algorithms, {bare_ms[config][True]:.3f} '
              'ms with only its deterministic ones (means of two 10-step '
              f'windows each); card: {card}')
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            trace_steps(f'{phases[1]} cudnn.deterministic={deterministic}',
                        step_fn, state, host[:2], device,
                        bare_ms[config][deterministic])
        torch.backends.cudnn.deterministic = False
        del step_fn, state, m, evaluator
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # --- 11. to 13. the loop, resume and the EMA export ------------------
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as out:
        launches['loop'] = loop_phases(Path(out), collated, capacity, device,
                                       card, counters,
                                       bare_ms['recipe'][True])

    for entry in kernels:
        name = entry['name']
        entry['launches'] = launches['recipe'][name] + launches['loop'][name]
        entry['recipe_launches'] = launches['recipe'][name]
        entry['loop_launches'] = launches['loop'][name]
        entry['golden_launches'] = launches['golden'][name]

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
