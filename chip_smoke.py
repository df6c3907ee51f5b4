#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

Drives the port's two EVFlowNet training configurations at the full width
of the repo's benchmark, then RecurrentFlowNet at its full width, multi-
element samples, DummyFlowNet, the representation bake and dense
training (``--ev_images``): base 64, depth 9, 256x256, batch 8, event
capacity 2^17, RANGER at lr 1e-3, loss weights (0.5, 1, 1), on batches
from the port's copy of the benchmark's batch maker
(``dvs_of_training_framework_tpu_torch/data/synthetic.py``).  "Golden" is
fp32 with TF32 off and the ``F.grid_sample`` warp; "recipe" is the bf16
model with the ``bf16x2`` loss, whose warp runs as K3's fused kernels.
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
   of the two batches the forward's device time and its device ops,
   each with its time and launches; then K1 with bf16 weights against
   its twin;
3. K2 (kernel-MLP) against its plain twin on delta [9, 2^17], forward and
   the seven gradients; both against a float64 evaluation, where the
   kernel may err on each tensor by at most twice what the fp32 twin errs
   (or 4 fp32 ulps of the tensor's scale); device times beside the
   bounds, which count the products at the tensor cores' 3xTF32 rate and
   each tanh as one special-function operation;
4. K3 on the bench frames at the four loss scales, with smooth flows
   reaching past the border and points at +-1e6 px, the grid a permuted
   [N, 2, H, W] view as the loss makes it: the corner gather
   (``warp_corners``) exactly against its twin; the fused warp
   (``warp_fwd``, ``warp_bwd``) against the corner twin's warp, values
   to 1e-5 and the grid gradient to 1e-4; per scale and summed, the
   fused kernels' device time beside the twin's, ``F.grid_sample``'s
   and the bound; and the device ops of one warp forward and backward
   through K3's corner gather and plain ops (the route before the
   fusion) and through the fused kernels;
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
   device busy time and device ops a step, and the busiest ops;
9. and 10. phases 7 and 8 for the recipe (the fused warp's forward and
   backward four times a step each, the lone corner gather never);
11. the training loop through the CLI's ``run()`` with the production
    recipe (bf16, ``bf16x2``, bs 8, lr 1e-3, half-life 20000, 200 warm-up
    steps, clip 1.0, EMA 0.999): 12 steps over an in-memory stream of
    bench batches with one oversized batch to skip (the default window of
    16 is more than 12 steps: slot by slot), checkpoints and validation
    (2 other bench batches, one window of 2 replayed) every 4 steps, with
    the launch counters reset just before and checked just after; prints
    the loop's step time, the checkpoint write time and size and the
    validation time;
12. resume: a fresh model and optimizer load checkpoint 8, bit for bit,
    and train to step 12 through the loop as phase 11 does, under the
    profiler for the batch uploads; every parameter is held against the
    uninterrupted run within twice the card's own run-to-run spread, the
    largest difference of any parameter between two runs of steps 9-12
    from the same state, and exactly where those two runs agree;
13. the EMA export: ``finalize(use_ema=True)`` of checkpoint 12 equals
    the EMA of the optimizer state and loads into a fresh model;
14. the data path on the card: the port's tools build the synthetic
    ``varied`` benchmark (``scripts/prep_accuracy_varied.sh``'s chain,
    cut in its durations and its sample count only; each tool timed), and
    the training CLI's ``main()`` trains 12 production-recipe steps on its
    shards one batch at a time (``--device-queue-window 0``; bs 8,
    256x256, phase 11's event capacity 2^17, checkpoints and validation on
    the raw val split every 6 steps), with the launch counters reset just
    before and read just after; its step time beside phase 11's ``run()``
    loop step, at the same capacity, is the reader's cost;
15. the evaluation CLI's ``main()`` on that run's last checkpoint, live
    and ``--use-ema``, over ``config/synth_testing.json`` (mean AEE, %AEE,
    mean median EE), with the counters reset just before; then
    ``evaluate`` timed alone at 8 windows a block (windows/s, the time of
    the forward and of the host's GT propagation, the device-busy share
    of one block under the profiler), and the card's flows at every scale
    on two windows held to the same weights' flows on the CPU (rtol 1e-4,
    TF32 off against CPU convolutions);
16. K1 at depth 64 (two channel groups) on the bench batch: with fp32 and
    bf16 weights, 20 launches equal the one-thread CPU twin bit for bit,
    forward and backward; its time beside the twin's, ``index_put_`` and
    the bound; and one recipe training step at depth 64;
17. RecurrentFlowNet (base 32, hidden 32, depth 9, the ConvGRU over the
    elements) on 2-element samples of phase 14's raw set, read through the
    port's loader with ``--min/max-sequence-length 2`` (bs 8, 256x256, K1
    over 16 planes): one recipe step through the kernels against one
    through the twins (phase 6's tolerances), then 3 + 10 recipe steps
    (clip 1.0) under deterministic cuDNN, timed and traced as phases 9-10,
    with the launch counters reset just before and checked just after;
18. 2-element shards built by ``tools.prepare_batches``, ``train.main()``
    with ``--flownet_path RecurrentFlowNet`` for 12 recipe steps at the
    capacity ``--event-capacity auto`` resolves, checkpoints and
    validation every 4 steps, in windows of 4 replayed as CUDA graphs;
    two copies of the run cut back to checkpoint 8 resume through
    ``main()`` and are held to phase 12's rule; then the evaluation CLI's ``main()`` scores step 12 (one GRU
    step a window), and the card's flows are held to the CPU's as in
    phase 15;
19. EVFlowNet on 1-2 element samples (``--dynamic-sample-length``, padding
    slots in every batch): one recipe step through the kernels against
    the twins, then 4 steps of ``run()``; and DummyFlowNet for 4 steps of
    ``run()``, with one optimizer group;
20. the bake: ``tools.quantize_preprocessed`` (-mbs 8, phase 11's event
    capacity 2^17, bf16) bakes phase 14's raw shards with phase 14's
    step-12 checkpoint on the card, in one go and again cut at half and
    resumed, which must give the same files byte for byte; K1 and K2
    forward launch once a batch and nothing else; the first baked batch
    equals, bit for bit, the CPU twins' ``quantize`` of the same padded
    batch with the card's K2 output standing in for the K2 twin's, which
    it must match within phase 3's bound; prints samples/s, the split
    between reading, the device and writing, the skips and the set's size;
21. dense training: ``train.main()`` with ``--ev_images`` on the baked
    shards, the recipe flags, ``-sp`` that checkpoint and
    ``--representation-start 1.0``, 12 steps in windows of 4 replayed as
    CUDA graphs with checkpoints and raw validation every 4: the train
    steps launch the fused warp 4 times each way (and a step's worth
    before the capture) and no K1 or K2, which launch in the validation
    passes only; two
    resumes from checkpoint 8 held to phase 12's rule; its step and the
    reader's time a batch beside phase 14's; then one dense step through
    the kernels against the twins (the recipe at phase 6's tolerances, and
    fp32 through the fused warp at phase 5's), and 3 + 10 dense recipe
    steps timed and traced as phases 9-10;
22. ``--ev_images`` over the raw set: 4 steps of ``run()``, one batch at a
    time, with EVFlowNet's ``compute_event_image`` on the host (its ms a
    sample), then DummyFlowNet's;
23. the bare sharded step (``parallel.make_sharded_train_step``) on the
    first bench batch, golden and recipe: a one-rank NCCL group
    (``data:1``) equals the unsharded step bit for bit (loss, the
    gradients it applies, the parameters after it); then two ranks
    sharing the card (gloo, spawned), ``data:2`` and ``data:1,event:2``,
    each against the single-process step on the whole batch: golden
    within tests/training/test_parallel.py's tolerances (loss 1e-4, the
    parameters after the step rtol 2e-3, atol 2e-5), the recipe by phase
    6's rule (loss 1e-3, each gradient 5e-2 of its leaf or within 4x the
    bf16-vs-fp32 gap); the two ranks' parameters equal bit for bit;
    each rank's ms a step, the all-reduce's wall time on the stream
    (CUDA events around it: gloo reduces through the host) and the bytes
    reduced a step on each axis;
24. ``train.main(['--mesh', 'data:2', ...])`` over phase 14's shards: 8
    production-recipe steps on two spawned ranks sharing the card,
    checkpoints and sharded validation every 4, one step at a time
    (``--device-queue-window 0``: phase 30 runs it in windows); rank 0
    alone writes,
    ``samples_passed`` counts global samples, two copies cut back to
    checkpoint 4 resume through ``main()`` held to phase 12's rule, and
    beside them (every rank a process of its own) ``--mesh
    data:1,event:2`` 4 steps over the raw split in one window (event rank
    0 reads and sends each batch, each rank voxelizes half its events);
25. two processes started with the multi-host flags (``--coordinator-
    address``, ``--num-processes 2``, ``--process-id``) over phase 14's
    shards (strided reads, the sharded skip rule), 8 recipe steps with
    ``--timers --profiling JAX``: rank 0 alone prints the timer lines
    (their medians printed), its trace names the kernels, and its
    TensorBoard log holds the device monitor's scalars;
26. the visualize CLI's ``main()`` with ``--precision bfloat16``,
    EVFlowNet at full width with phase 14's step-12 checkpoint over its
    validation split (a panel a batch of one sample, the CLI's default
    writer count): K1 and K2 forward launch once a panel and nothing
    else; seconds a panel and its split between the reader, the device,
    rendering and the writers; every PNG read back with the port's
    reader, the first two equal bit for bit to their rendering on the
    host from the card's flows; a second ``main()`` skips every panel
    and launches nothing; two batches through ``visualize_batch`` in
    fp32 on the card and on the CPU, every flow and loss term within
    rtol 1e-4 (phase 15's rule); the device time of one forward and loss
    at batch 1 in fp32 and bf16; then RecurrentFlowNet on 2-element
    samples at prefix 1 with phase 18's checkpoint, 2 panels;
27. the host tools on the card's machine: the zero-flow and
    constant-flow-oracle baselines over phase 14's test split, the AEE
    table of phase 15's live and EMA pickles (an EMA row of its own),
    ``fix_events`` over phase 18's resumed run (its two event files
    merged: steps strictly increasing per tag afterwards, the resume's
    values kept), ``profile_dataset`` over phase 14's shards (µs an
    iteration) and ``make_info`` over phase 14's raw sequences (equal,
    through ``read_info``, to the simulator's info file);
28. the accuracy protocol's three scripts
    (``dvs_of_training_framework_tpu_torch/scripts/``) as subprocesses,
    each ``python -m`` child with a ``sitecustomize`` first on its path
    that records, when it exits, its arguments, the kernels' launches and
    any module of the JAX package or from outside the port that it
    loaded (none may be): ``prep_accuracy_varied.sh`` at phase 14's cut
    over phase 14's layout (its existence checks skip the simulator and
    the slicing; ``prepare_batches`` writes 96 samples), then
    ``run_accuracy_varied.sh`` with the production recipe at full width
    in windows of 4 for 4 steps, and again on the same directory to 8
    with validation every 4 steps: each training child launches K1 and K2
    backward once a step and the fused warp's backward 4 times, and a
    step's worth before its graph's capture (the second run 4 steps: it
    resumed at step 4), and the checkpoints kept are steps 0, 4 and 8;
    then ``eval_accuracy_varied.sh``: one pickle a kept checkpoint for
    each matrix, finite, a row of ``aee_table`` for each, and K1 and K2
    forward alone in the evaluation children;
29. the device queue (``data/device_queue.py``) at the bench shape: two
    windows of 16 bench batches staged in one upload each, golden and
    recipe (RANGER with the clip, the EMA and the representation group
    starting inside the second window, deterministic cuDNN), as 32 eager
    steps and as 2 replays of one CUDA graph captured over the 16-step
    window: losses, parameters and the optimizer state equal bit for
    bit; the launches of each way (a replay counts what its capture
    recorded, and the profiler's kernels inside one replay must agree);
    then each way's ms a step (in turns: eager one window, graph two,
    twice each), device busy and ops, idle share, host launches a step,
    peak memory, the capture's time;
    ``validate_windowed`` against ``validate`` bit for bit and timed; a
    ``run()`` of 32 steps in windows of 16 resumed from checkpoint 16
    equals the uninterrupted run bit for bit; then ``train.main()`` with
    the default windows (16 and 8) over phase 14's shards, 64 steps with
    checkpoints and validation every 16: every window one replay, ms a
    loop step against phase 14's one batch at a time;
30. the device-queue window on a mesh: (a) a one-rank NCCL group
    (``data:1``) in this process, two windows of 8 bench batches as 16
    eager sharded steps and as 2 replays of one graph whose capture
    holds the data group's all-reduce, golden and recipe (phase 29's
    optimizer), then the recipe on ``data:1,event:1`` (the grid sum and
    the quantization gradients' sum captured too): losses, parameters
    and the optimizer state bit for bit, each way's ms a step (in turns),
    device busy, idle share, host launches, NCCL's kernels' share of the
    busy time, peak memory and capture time, and the MB all-reduced a
    step; (b) two spawned ranks sharing the card (gloo), ``data:2`` and
    ``data:1,event:2``, the recipe over 8 bench batches as windows of 4
    (eager in one call each, gloo's rule) and as per-step sharded steps,
    bit for bit, both ranks, timed in turns; (c) ``train.main()`` with
    ``--mesh data:2 --device-queue-window 4`` as phase 24, 8 steps
    over phase 14's shards, against phase 24's seconds, and two copies cut
    back to checkpoint 4 resumed at once and held to phase 12's rule;
31. oversized batches skipped unread on one rank: RecurrentFlowNet's
    recipe through ``train.main()`` over phase 18's 2-element shards (96
    samples, 12 batch positions of 8) at the median of the positions'
    recorded event counts, so that some fit and some overflow, 12 steps in
    windows of 4, twice: over the reader ``read_train`` builds, which
    skips a batch from the shards' recorded counts without reading it,
    and over the bare reader, which decodes every batch and the loop
    drops those over the capacity; the losses, the ``General/skipped
    batches`` scalars, the parameters and the optimizer state equal bit
    for bit, the launches equal; each way's ms a skipped batch, ms
    reading a trained batch, ms a trained step and seconds;
32. the evaluation CLI's ``DevicePool`` over phase 14's checkpoints
    (steps 0, 6 and 12) on ``cuda:0``: in turn (``-s``, one checkpoint a
    call), then through the pool at ``--tests_per_device`` 1 and 2, twice
    each in turns, then once each under the profiler: every pickle of
    every run equal bit for bit to the in-turn run's, and step 12's to
    phase 15's; K1 and K2 forward once a block of windows and nothing
    else in each run; each run's seconds, and the card's busy share
    (the union of its device ops' intervals over the run's wall time)
    of the traced ones; where the machine has two cards or more, ``-d
    cuda`` spreads the checkpoints over every card and its pickles equal
    one card's;
33. the file cache for slow storage (``--cache-dir``):
    ``tools.prepare_batches`` writes 100 samples of phase 14's raw split
    in 7 files (the last of 4), then ``train.main()`` takes 48 recipe
    steps (3 windows of 16, checkpoints and validation every 16) with no
    cache, the warm path (``--cache-size 8``), the strict iterator
    (``--cache-size 3 --process-only-once``) and the non-blocking one
    (``--cache-size 3``, each copy held back CACHE_DELAY seconds, so
    that it serves cached files again): the warm and strict runs equal
    the uncached run bit for bit (losses, validation losses, the last
    checkpoint's parameters and optimizer state); then the non-blocking
    cache on ``--mesh data:2``, two gloo ranks sharing the card, 48
    steps.  In every run each slice the reader reads must lie inside its
    served file, and the non-blocking runs must serve a file again on
    one rank and on each rank of the mesh.  Per run: seconds, loop step,
    ms reading a batch, MB copied, files served and served again.
    ``python3 chip_smoke.py --phase 33`` builds the kernels and phase
    14's set and runs this phase alone.

Every phase from 17 on prints its own seconds.  A window (phases 11, 18,
21, 28, 29, 30) runs as one CUDA graph replay where it covers whole
optimizer steps and no hook is due inside it; the capture's warm-up
step counts its launches, the capture none, and each replay what the
capture recorded (``ops.count_launches``).  A phase that starts
processes puts a time limit on them, and a rank that fails stops the
others and fails the phase.  Prints the kernels as
one JSON line (each with its time, the twin's, one PyTorch call's where
one computes the same function, its bound at the published H100 SXM
peaks, its launches on the main paths in all and on each path), the
card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``.  Any failure raises, so the exit code is not 0 and
that line is not printed.

Usage (from the root of a checkout):  python3 chip_smoke.py
"""
import contextlib
import filecmp
import json
import math
import os
import pickle
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

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
# a bf16 gradient leaf's largest kernel-vs-twin difference, against the
# twin's own bf16-vs-fp32 difference: tests/test_torch_recipe.py's factor
# for a leaf whose gradient sums few bf16 cotangents (there dec0.bias at
# 1/8 scale; here RecurrentFlowNet's 16x16 bottleneck, enc3 and res0-1,
# measured up to 2.02)
GAP_FACTOR = 4.0
CONFIGS = {'golden': ('float32', 'highest'), 'recipe': ('bfloat16', 'bf16x2')}
KERNEL_SOURCE = 'dvs_of_training_framework_tpu_torch/csrc/'
LOOP_STEPS, LOOP_EVERY, SKIP_AT = 12, 4, 2
LOOP_VAL = 2                   # phase 11's validation batches and window
# phase 14: the synthetic benchmark's durations in seconds and its sample
# count, cut from scripts/prep_accuracy_varied.sh's 60, 12, 12 and 16384
SYNTH_CUTS = (('--train-secs', 2.0, 60.0), ('--eval-secs', 1.0, 12.0),
              ('--val-secs', 1.0, 12.0))
SHARD_SAMPLES, SHARD_SAMPLES_FULL = 96, 16384
MAIN_STEPS, MAIN_EVERY = 12, 6
# phase 20: the bake's capacity, phase 11's 2^17, and its shard size
BAKE_CAPACITY, BAKE_FILE_SAMPLES = 2 ** 17, 16
EVAL_BLOCK = 8                 # windows a forward in evaluate
DEEP = 64                      # phase 16's event-representation depth
RECIPE_FLAGS = ['--precision', 'bfloat16', '--loss-precision', 'bf16x2',
                '--grad-clip-norm', '1.0', '--ema-decay', '0.999', '-lr',
                '1e-3', '--half_life', '20000', '--num-warmup-steps', '200']
# the bare steps' optimizer: RANGER at lr 1e-3, wd 1e-4, no warm-up, the
# representation group frozen for the first half of a long run
BARE_ARGS = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                            half_life=100000, num_warmup_steps=0,
                            training_steps=1000000, rs=0.5)
# phases 23-25: the meshes of two ranks sharing the card, and the steps
# of the spawned mesh's main() and of the multi-host flags' main()
MESHES = ('data:2', 'data:1,event:2')
MESH_STEPS, HOSTS_STEPS = 8, 8
# phase 28: the accuracy scripts' first run and its resume, in steps,
# and the resumed run's validation period
ACCURACY_STEPS, ACCURACY_EVERY = (4, 8), 4
ACCURACY_LIMIT = 240           # seconds a script may take
# the kernels that phase 25's trace of a training step must name
TRACE_KERNELS = ('voxelize_tile_kernel', 'voxelize_bwd_kernel',
                 'kernel_mlp_fwd_kernel', 'kernel_mlp_bwd_kernel',
                 'warp_fwd_kernel', 'warp_bwd_kernel')
# each launch counter's kernel in a trace (K1's forward: its tile kernel)
TRACE_KERNEL_OF = dict(zip(('voxelize_fwd', 'voxelize_bwd', 'kernel_mlp_fwd',
                            'kernel_mlp_bwd', 'warp_fwd', 'warp_bwd'),
                           TRACE_KERNELS))
# phase 29: the device queue's default windows (utils/options.py), the
# bare steps' optimizer with the production riders and the representation
# group starting inside the second window, and main()'s steps
WINDOW, VAL_WINDOW = 16, 8
WINDOW_ARGS = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                              half_life=100000, num_warmup_steps=0,
                              training_steps=40, rs=0.5, grad_clip_norm=1.0,
                              ema_decay=0.999)
WINDOW_MAIN_STEPS = 4 * WINDOW
# phase 30: the one-rank NCCL group's windows, and the windows of two
# ranks sharing the card and of the spawned mesh's main() (phase 24's
# checkpoint cadence)
MESH_GRAPH_WINDOW, MESH_WINDOW = 8, 4
# phase 33: the file cache's set (prepare_batches over phase 14's raw
# split: 6 files of 16 samples and a last of 4), the steps of each run
# (3 windows of 16: the second interval between windows is the first
# without the graph's capture), and the seconds each copy into the cache
# is held back, as from storage that copies one 15-30 MB file in that
# time
CACHE_SAMPLES, CACHE_FILE_SAMPLES = 100, 16
CACHE_STEPS = 3 * WINDOW
CACHE_DELAY = 0.5
CACHE_PROBE_ENV = 'CHIP_SMOKE_CACHE_PROBE'


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
    """``[(us a call, launches a call, device op)]`` of ``fn()``, busiest
    first; three tries, as the profiler now and then records no device
    op."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        parts = sorted(((e.device_time_total / iters, e.count / iters, e.key)
                        for e in device_ops(prof.key_averages())),
                       reverse=True)
        if parts:
            return parts
    raise AssertionError('the profiler recorded no device op in 3 tries')


def voxelize_times(vox_args, valid, w, g, P, H, W):
    """K1's forward and backward on ``P`` planes: ``((kernel ms, plain ms,
    library ms), bound)`` each.  The yardsticks are one PyTorch call each,
    which the port never calls: ``index_put_`` of the valid rows into the
    flat grid (the indices and values are prepared outside the timing);
    a gather of the twin's flat indices (an invalid row reads bin 0)."""
    from dvs_of_training_framework_tpu_torch.ops import voxel_cuda
    x, y, plane = vox_args
    capacity, C = w.shape
    pix = (plane.long() * H + y.long()) * W + x.long()
    flat = torch.where(valid[:, None],
                       pix[:, None] * C + torch.arange(C, device=w.device), 0)
    flat = flat.reshape(-1)
    put_at = flat.view(capacity, C)[valid].reshape(-1)
    put_values = w[valid].reshape(-1)

    def index_put():
        return torch.zeros(P * H * W * C, device=w.device).index_put_(
            (put_at,), put_values, accumulate=True)

    def vox_fwd(fn):
        return lambda: fn(*vox_args, w, valid, P, H, W)

    wg = w.clone().requires_grad_(True)
    graphs = {name: fn(*vox_args, wg, valid, P, H, W)
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
    return ((time_pair(vox_fwd(voxel_cuda.voxelize),
                       vox_fwd(voxel_cuda.plain), index_put),
             bound(nbytes=index_bytes + 4 * n_valid * C + 4 * P * H * W * C)),
            (time_pair(vox_bwd('kernel'), vox_bwd('plain'),
                       lambda: g.view(-1)[flat]),
             bound(nbytes=index_bytes + 4 * n_cells * C + 4 * capacity * C)))


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
    n_ops = sum(e.count for e in ops) / len(batches)
    print(f'{label} traced {len(batches)} steps: device busy {busy_ms:.3f} '
          f'ms and {n_ops:g} device ops a step, '
          f'{100 * (1 - busy_ms / step_ms):.1f}% idle in the '
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


def compare_step(label, models, evaluators, batch, loss_rtol, grad_tol,
                 is_raw=True):
    """One step's loss and raw gradients through the kernels against the
    twins; raises unless the loss agrees to ``loss_rtol`` and every
    gradient to ``grad_tol`` of its leaf's largest value (a dense batch,
    ``is_raw=False``, gives the quantization layer zero gradients).  Where
    ``models`` and ``evaluators`` also hold a ``'golden'`` path (the twins
    in fp32 on the same weights), a bf16 leaf beyond ``grad_tol`` passes
    when the kernels move it at most GAP_FACTOR times as far as bf16
    itself does: max |kernel - twin| <= GAP_FACTOR max |twin - golden|."""
    from dvs_of_training_framework_tpu_torch.training import make_loss_fn
    step_grads = {}
    for name in models:
        m = models[name]
        loss, _ = make_loss_fn(m, evaluators[name], LOSS_WEIGHTS,
                               is_raw)(batch)
        named = dict(m.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()),
                                    materialize_grads=True)
        torch.cuda.synchronize()
        step_grads[name] = (loss.item(), dict(zip(named, grads)))
    loss_k, grads_k = step_grads['kernel']
    loss_p, grads_p = step_grads['plain']
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f'{label} kernels against twins: loss {loss_k:.7f} vs '
          f'{loss_p:.7f} (rel {rel:.2e}, tol {loss_rtol:g})')
    if not rel <= loss_rtol:
        raise AssertionError(f'{label}: loss differs from the twin path')
    check_grads(label, grads_k, grads_p,
                step_grads.get('golden', (None, None))[1], grad_tol)
    qgrads = [pn for pn in grads_k if pn.startswith('quantization_layer.')]
    print('  quantization_layer gradients: ' + ', '.join(
        f'{pn.split(".", 1)[1]} {grads_k[pn].abs().max().item():.3e}'
        for pn in qgrads))


def check_grads(label, grads_k, grads_p, golden, grad_tol):
    """Raise unless every gradient of ``grads_k`` is within ``grad_tol`` of
    its leaf's largest value of ``grads_p``'s, or, where ``golden`` (the
    fp32 twin's gradients on the same weights) is given, a bf16 leaf
    beyond it moves at most GAP_FACTOR times as far as bf16 itself does:
    max |kernel - twin| <= GAP_FACTOR max |twin - golden|."""
    worst, bad, by_gap = (0.0, ''), [], []
    for pname, want in grads_p.items():
        got = grads_k[pname]
        scale = want.abs().max().item()
        err = max_abs(got, want)
        worst = max(worst, (err / max(scale, 1e-12), pname))
        if not torch.isfinite(got).all():
            bad.append(f'{pname} (not finite)')
        elif err > grad_tol * scale + 1e-9:
            gap = None if golden is None else max_abs(want, golden[pname])
            line = (f'{pname} (max abs err {err:.3e}, leaf max {scale:.3e}'
                    + ('' if gap is None else
                       f', bf16-vs-fp32 gap {gap:.3e}') + ')')
            (by_gap if gap is not None and err <= GAP_FACTOR * gap
             else bad).append(line)
    if bad:
        raise AssertionError(f'{label}: gradients differ: ' + '; '.join(bad))
    print(f'  {len(grads_p)} parameter gradients agree; worst max-abs-err / '
          f'leaf-max {worst[0]:.2e} ({worst[1]}, tol {grad_tol:g})')
    if by_gap:
        print(f'  {len(by_gap)} of them beyond {grad_tol:g} of the leaf, '
              f'within {GAP_FACTOR:g}x the twin\'s own bf16-vs-fp32 gap: '
              + '; '.join(by_gap))


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


def read_scalars(log_dir):
    """``{tag: [values]}`` of the TensorBoard files in ``log_dir``."""
    from dvs_of_training_framework_tpu_torch.utils.tb import read_events
    scalars = {}
    for path in log_dir.glob('events.out.tfevents.*'):
        for event in read_events(path):
            for tag, value in event['scalars'].items():
                scalars.setdefault(tag, []).append(value)
    return scalars


def skipped_after(log_dir, batch_size):
    """Steps taken when each skipped batch was read: the loop logs
    'General/skipped batches' at the samples passed so far."""
    from dvs_of_training_framework_tpu_torch.utils.tb import read_events
    return {event['step'] // batch_size
            for path in log_dir.glob('events.out.tfevents.*')
            for event in read_events(path)
            if 'General/skipped batches' in event['scalars']}


def reset(counters):
    for counter, key in counters.values():
        counter[key] = 0


def read_counts(counters):
    return {name: counter[key] for name, (counter, key) in counters.items()}


def train(label, model, evaluator, host, device, card, counters,
          grad_clip_norm=0.0, is_raw=True):
    """WARMUP + STEPS training steps, each on a host batch copied to the
    card; the launch counters are reset just before and read just after.
    Returns the step function and state, the step time in ms and the
    launch counts."""
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, create_train_state, make_train_step)
    args = SimpleNamespace(**vars(BARE_ARGS),
                           grad_clip_norm=grad_clip_norm)
    step_fn = make_train_step(model, evaluator,
                              construct_optimizer(args, model),
                              LOSS_WEIGHTS, 1, is_raw=is_raw)
    state = create_train_state()
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    for i, host_batch in enumerate(host):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, (loss, _) = step_fn(state, host_batch.to(device))
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    counts = read_counts(counters)
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
            raise AssertionError(f'{label}: {name} launched {n} times, '
                                 f'expected {expected[name]}')


class LoopClock:
    """The JAX package's timer interface for ``train``: the host clock at
    each train step's start, the time inside each hook call and each
    batch's reading (``batch_construction``: the loader, padding, pinning
    and the upload's issue), and, given the launch ``counters``, the
    launches inside the train steps alone."""
    HOOKS = ('serialization', 'validation')

    def __init__(self, counters=None):
        self.step_starts = []
        self.hook_spans = []        # (steps started so far, name, seconds)
        self.reads = []             # seconds reading each batch
        self.started = {}
        self.counters = counters
        self.step_launches = None if counters is None else {
            k: 0 for k in counters}
        self.snapshot = None

    def __call__(self, name):
        clock = self

        class Span:
            def start(self):
                clock.started[name] = time.perf_counter()
                if name == 'train_step':
                    clock.step_starts.append(clock.started[name])
                    if clock.counters is not None:
                        clock.snapshot = read_counts(clock.counters)

            def stop(self):
                seconds = time.perf_counter() - clock.started[name]
                if name in clock.HOOKS:
                    clock.hook_spans.append(
                        (len(clock.step_starts), name, seconds))
                elif name == 'batch_construction':
                    clock.reads.append(seconds)
                elif name == 'train_step' and clock.counters is not None:
                    for k, n in read_counts(clock.counters).items():
                        clock.step_launches[k] += n - clock.snapshot[k]
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

    def window_ms(self, window):
        """Host ms a step of fused windows of ``window`` steps (one
        train_step span each): each window's interval to the next one's
        start, less its hooks, over its steps, from the second interval
        on (the first window holds the graph's capture)."""
        return [v / window for v in self.step_ms(2)]

    def window_read_ms(self, window):
        """Host ms reading a batch of a window (``batch_construction`` of
        each window after the first read, which stages two)."""
        return [1e3 * v / window for v in self.reads[1:]]

    def hook_seconds(self, name, every):
        return [s for j, n, s in self.hook_spans
                if n == name and j % every == 0]


def tree_bytes(path):
    """Bytes of a file, or of every file under a directory (a shard of
    the npy store)."""
    path = Path(path)
    if path.is_dir():
        return sum(f.stat().st_size for f in path.rglob('*') if f.is_file())
    return path.stat().st_size


class CacheProbe:
    """Phase 33's view of the file cache (``--cache-dir``), installed on
    the port's classes for one run and removed after it: each copy into
    the cache held back ``delay`` seconds and counted with its bytes; each
    file the non-blocking cache serves counted, and each copy it serves
    again (a re-serve); each slice the reader reads checked to lie inside
    its served file (else it raises).  In a spawned rank (``report``) it
    also hands ``run()`` a ``LoopClock`` and writes its counts and the
    clock's times to ``report`` as JSON."""

    def __init__(self, delay=0.0, report=None):
        self.delay, self.report = delay, report
        self.copies = self.bytes = self.visits = self.reserves = 0
        self.slices = self.samples = self.rank = 0
        self.served, self.saved, self.clock = set(), [], None

    def install(self):
        from dvs_of_training_framework_tpu_torch import train as cli
        from dvs_of_training_framework_tpu_torch.data import \
            file_iterators as fi
        from dvs_of_training_framework_tpu_torch.data.preprocessed import \
            PreprocessedDataloader as Reader
        probe = self
        copy, serve = fi.FileLoader.__call__, fi.NonBlockingFileIterator.next
        read, run = Reader._read_slice, cli.run

        def slow_copy(loader, filename):
            time.sleep(probe.delay)
            cached = copy(loader, filename)
            probe.copies += 1
            probe.bytes += tree_bytes(cached)
            return cached

        def counted_serve(iterator, block=True):
            served = serve(iterator, block)
            if served is not None:
                probe.visits += 1
                probe.reserves += served.name in probe.served
                probe.served.add(served.name)
            return served

        def checked_read(reader, shard, begin, end):
            size = len(shard['elements_per_sample'])
            if not 0 <= begin < end <= size:
                raise AssertionError(
                    f'[33] slice [{begin}, {end}) of '
                    f'{reader.current_file.name}, a file of {size} samples')
            probe.slices += 1
            probe.samples += end - begin
            probe.rank = reader.process_index
            return read(reader, shard, begin, end)

        def clocked_run(*args, **kwargs):
            probe.clock = LoopClock()
            try:
                return run(*args, timers=probe.clock, **kwargs)
            finally:
                Path(probe.report).write_text(json.dumps(probe.numbers()))

        patches = [(fi.FileLoader, '__call__', slow_copy),
                   (fi.NonBlockingFileIterator, 'next', counted_serve),
                   (Reader, '_read_slice', checked_read)]
        if self.report is not None:
            patches.append((cli, 'run', clocked_run))
        for owner, name, fn in patches:
            self.saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, fn)
        return self

    def remove(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved = []

    def numbers(self):
        out = {'rank': self.rank, 'copies': self.copies,
               'mb_copied': self.bytes / 1e6, 'visits': self.visits,
               'reserves': self.reserves, 'slices': self.slices,
               'samples': self.samples}
        if self.clock is not None:
            out['step_ms'] = self.clock.window_ms(WINDOW)
            out['read_ms'] = self.clock.window_read_ms(WINDOW)
        return out


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
    """Phases 11-13 in ``out``; returns phase 11's launch counts and its
    loop step in ms."""
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
        NullSummaryWriter, SummaryWriter)

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
        '--validation-window', str(LOOP_VAL), '--event-capacity',
        str(capacity)])

    # --- 11. the loop ------------------------------------------------------
    reset(counters)
    clock = LoopClock()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.run(args, stream, lambda: val, SummaryWriter(out / 'log'),
            timers=clock)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts(counters)
    scalars = read_scalars(out / 'log')
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

    # 12 steps (the default window of 16 is more than they are: one slot
    # at a time) and 5 validation passes of one window of 2 batches:
    # before, at 4, 8 and 12, and after, one forward before the capture
    forwards = LOOP_STEPS + 5 * len(val) + 1
    expected = {'voxelize_fwd': forwards, 'voxelize_bwd': LOOP_STEPS,
                'kernel_mlp_fwd': forwards, 'kernel_mlp_bwd': LOOP_STEPS,
                'corner_values': 0, 'warp_fwd': 4 * forwards,
                'warp_bwd': 4 * LOOP_STEPS}
    print(f'  launches: {counts}')
    if counts != expected:
        raise AssertionError(f'loop: launches {counts}, expected {expected}')

    loop_ms = clock.step_ms(WARMUP + 1)
    ckpt_s = clock.hook_seconds('serialization', LOOP_EVERY)
    val_s = clock.hook_seconds('validation', LOOP_EVERY)
    size_mb = (out / f'step_{LOOP_EVERY}.ckpt').stat().st_size / 1e6
    loop_step_ms = statistics.median(loop_ms)
    print(f'  loop step {loop_step_ms:.3f} ms (median of steps '
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
    return counts, loop_step_ms


def build_synthetic(root, shards):
    """Phase 14's set: the port's three tools in turn, each timed; returns
    ``{tool: seconds}``."""
    from dvs_of_training_framework_tpu_torch.tools import (
        make_synthetic_mvsec, prepare_batches, sequence2samples)
    configs = REPO / 'dvs_of_training_framework_tpu_torch' / 'config'
    seconds = {}
    t0 = time.perf_counter()
    make_synthetic_mvsec.main(
        [str(root), '--motion', 'varied', '--speed', '0.35']
        + [v for flag, secs, _ in SYNTH_CUTS for v in (flag, str(secs))])
    seconds['make_synthetic_mvsec'] = time.perf_counter() - t0
    os.environ['DVS_DATA_ROOT'] = str(root)
    t0 = time.perf_counter()
    sequence2samples.main([str(configs / 'synth_train_datasets.json')])
    seconds['sequence2samples'] = time.perf_counter() - t0
    # the loaders' split (train = outdoor_day2, val = outdoor_day1), as
    # scripts/prep_accuracy_varied.sh links it
    split = root / 'training' / 'synth'
    (split / 'outdoor_day2').symlink_to(split / 'outdoor_synth2')
    (split / 'outdoor_day1').symlink_to(split / 'outdoor_synth3')
    os.environ['DVS_DATA_PATH'] = str(split)
    t0 = time.perf_counter()
    prepare_batches.main(prepare_batches.parse_args(
        ['-o', str(shards), '-s', str(SHARD_SAMPLES), '--samples-per-file',
         '32']))
    seconds['prepare_batches'] = time.perf_counter() - t0
    return seconds


def data_phases(out, capacity, device, card, counters, loop_step_ms):
    """Phases 14 and 15 in ``out``; main() pads its batches to phase 11's
    ``capacity``.  Returns the launch counts of main() and of the
    evaluation CLI."""
    from dvs_of_training_framework_tpu_torch import test as eval_cli
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.evaluation import (
        estimate_corresponding_gt_flow, evaluate)
    from dvs_of_training_framework_tpu_torch.models import OpticalFlow
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer

    # --- 14. the set, then main() ------------------------------------------
    root, shards, run = out / 'synth', out / 'shards', out / 'run'
    print('[14] the synthetic varied benchmark built on the card with the '
          'port\'s tools; cut in duration and size only: ' + ', '.join(
              f'{flag} {secs:g} (full {full:g})'
              for flag, secs, full in SYNTH_CUTS)
          + f', prepare_batches -s {SHARD_SAMPLES} (full '
          f'{SHARD_SAMPLES_FULL})')
    seconds = build_synthetic(root, shards)
    n_elements = {p.name: len(list(p.glob('*.hdf5'))) for p in sorted(
        (root / 'training' / 'synth').glob('outdoor_synth*'))}
    print('  ' + ', '.join(f'{tool} {s:.2f} s' for tool, s in seconds.items())
          + f'; elements {n_elements}; shards '
          f'{sorted(p.name for p in shards.glob("*.hdf5"))}')

    argv = ['-m', str(run), '-d', device.type, '-bs', '8', '-mbs', '8',
            '-ne', str(MAIN_STEPS), '--preprocessed-dataset-path',
            str(shards), '--checkpointing_interval', str(MAIN_EVERY),
            '--permanent_interval', str(MAIN_EVERY), '-vp', str(MAIN_EVERY),
            '--event-capacity', str(capacity), '--device-queue-window',
            '0'] + RECIPE_FLAGS
    clock = LoopClock()
    run_fn = cli.run
    # the host clock of phase 11, handed to the run() that main() calls
    cli.run = lambda *a, **k: run_fn(*a, timers=clock, **k)
    reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        cli.main(argv)
    finally:
        cli.run = run_fn
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_counts = read_counts(counters)
    scalars = read_scalars(run / 'log')
    losses = scalars.get('General/Train loss', [])
    val_losses = scalars.get('General/Validation loss', [])
    steps = Serializer(run).list_known_steps()
    print(f'[14] train.main(), {MAIN_STEPS} production-recipe steps on the '
          f'shards: losses ' + ' '.join(f'{v:.5f}' for v in losses)
          + '; validation ' + ' '.join(f'{v:.5f}' for v in val_losses)
          + f'; checkpoints {steps}; skipped batches '
          f'{scalars.get("General/skipped batches", [0.0])[-1]:g}')
    print(f'  launches: {main_counts}')
    if (len(losses) != MAIN_STEPS or not val_losses
            or not np.isfinite(losses + val_losses).all()
            or steps != list(range(0, MAIN_STEPS + 1, MAIN_EVERY))):
        raise AssertionError('main(): missing or non-finite losses, or '
                             f'checkpoints {steps}')
    fwd = main_counts['voxelize_fwd']
    if (main_counts['voxelize_bwd'] != MAIN_STEPS
            or main_counts['kernel_mlp_bwd'] != MAIN_STEPS
            or main_counts['warp_bwd'] != 4 * MAIN_STEPS
            or main_counts['kernel_mlp_fwd'] != fwd
            or main_counts['warp_fwd'] != 4 * fwd
            or main_counts['corner_values'] != 0 or fwd <= MAIN_STEPS):
        raise AssertionError(f'main(): launches {main_counts}')
    main_ms = clock.step_ms(WARMUP + 1)
    read_ms = statistics.median(clock.reads[WARMUP:MAIN_STEPS]) * 1e3
    # a step whose interval also read a skipped (oversized) batch
    skips = skipped_after(run / 'log', 8)
    clean = [v for j, v in enumerate(main_ms, WARMUP + 1) if j not in skips]
    print(f'  main() step {statistics.median(main_ms):.3f} ms (median of '
          f'steps {WARMUP + 1}-{MAIN_STEPS - 1}, hooks excluded: '
          + ' '.join(f'{v:.1f}' for v in main_ms) + '); '
          + (f'{statistics.median(clean):.3f} ms over the {len(clean)} of '
             'them that read no skipped batch' if clean else
             'every one of them read a skipped batch')
          + f' (skips after steps {sorted(skips)}); phase 11\'s run() '
          f'loop step over batches in memory: {loop_step_ms:.3f} ms; both at '
          f'event capacity {capacity}; reading a batch {read_ms:.3f} ms '
          f'(median of steps {WARMUP + 1}-{MAIN_STEPS}); main() {main_s:.2f} '
          f's in all; card: {card}')

    # --- 15. the evaluation CLI on the last checkpoint -----------------------
    configs = REPO / 'dvs_of_training_framework_tpu_torch' / 'config'
    eval_argv = ['-m', str(run), '-o', str(out / 'eval'), '-s',
                 str(MAIN_STEPS), '-d', device.type, '--test-config',
                 str(configs / 'synth_testing.json')]
    reset(counters)
    results = {}
    for label, extra in (('live', []), ('EMA', ['--use-ema'])):
        t0 = time.perf_counter()
        eval_cli.main(eval_argv + extra)
        seconds = time.perf_counter() - t0
        suffix = '_ema' if extra else ''
        records = pickle.loads(
            (out / 'eval' / f'step_{MAIN_STEPS}{suffix}.pkl').read_bytes())
        results[label] = records
        n_windows = sum(len(r.windows) for r in records)
        print(f'[15] evaluation CLI, {label} weights of step {MAIN_STEPS}, '
              f'{n_windows} windows in {seconds:.2f} s (model build and data '
              'load included): ' + '; '.join(
                  f'step {r.step}: mAEE {r.mAEE:.4f}, %AEE '
                  f'{100 * r.mpAEE:.2f}, mMedEE {r.mMedEE:.4f} '
                  f'({len(r.windows)} windows)' for r in records))
        numbers = [v for r in records for v in (r.mAEE, r.mpAEE, r.mMedEE)]
        if (len(records) != 3 or not np.isfinite(numbers).all()
                or not all(r.windows for r in records)):
            raise AssertionError(f'evaluation ({label}): {numbers}')
    eval_counts = read_counts(counters)
    blocks = 2 * sum(math.ceil(len(r.windows) / EVAL_BLOCK)
                     for r in results['live'])
    print(f'  launches (both runs): {eval_counts}')
    if (eval_counts['voxelize_fwd'] != blocks
            or eval_counts['kernel_mlp_fwd'] != blocks
            or any(eval_counts[k] for k in eval_counts
                   if k not in ('voxelize_fwd', 'kernel_mlp_fwd'))):
        raise AssertionError(f'evaluation: launches {eval_counts}, '
                             f'expected {blocks} forwards')
    if all(a.mAEE == b.mAEE for a, b in zip(results['live'],
                                             results['EMA'])):
        raise AssertionError('evaluation: the EMA scores as the live weights')

    # the card's flows against the same weights' on the CPU; then
    # evaluate alone: windows/s, the forward's and the GT's time, and the
    # device-busy share of one block
    ctx = card_vs_cpu('[15]', eval_cli, eval_argv, OpticalFlow, EVAL_BLOCK)
    of, block, dataset, cfg, frames = (ctx.of, ctx.block, ctx.dataset,
                                       ctx.cfg, ctx.frames)
    spans = {'forward': [], 'gt': []}

    def timed_of(*a, **k):
        t = time.perf_counter()
        flows = of(*a, **k)     # numpy: the device work is done
        spans['forward'].append(time.perf_counter() - t)
        return flows

    def gt_flow_fn(start, stop):
        t = time.perf_counter()
        gt = estimate_corresponding_gt_flow(
            dataset.gt['x_flow_dist'], dataset.gt['y_flow_dist'],
            dataset.gt['timestamps'], start, stop)
        spans['gt'].append(time.perf_counter() - t)
        return gt

    def run_evaluate():
        return evaluate(timed_of, dataset.events, frames, dataset.gt,
                        event_preproc_fun=ctx.event_crop,
                        gt_proc_fun=ctx.gt_crop,
                        is_car=cfg.is_car, gt_flow_fn=gt_flow_fn,
                        batch_windows=EVAL_BLOCK)
    run_evaluate()                                  # warm-up
    walls = []
    for _ in range(2):
        spans = {'forward': [], 'gt': []}
        t0 = time.perf_counter()
        maee, mpaee = run_evaluate()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f'[15] evaluate, step {cfg.step}, {len(frames)} windows of '
          f'{cfg.test_shape[0]}x{cfg.test_shape[1]} in blocks of '
          f'{EVAL_BLOCK}: {len(frames) / wall:.2f} windows/s ({wall:.3f} s; '
          f'runs {" ".join(f"{w:.3f}" for w in walls)}); forward '
          f'{sum(spans["forward"]):.3f} s in {len(spans["forward"])} blocks, '
          f'GT propagation {sum(spans["gt"]):.3f} s on its thread; mAEE '
          f'{maee:.4f}, %AEE {100 * mpaee:.2f}')
    of(*block)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile() as prof:
        of(*block)
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    ops = device_ops(prof.key_averages())
    busy_ms = sum(e.device_time_total for e in ops) / 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        of(*block)
    block_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f'  one block of {EVAL_BLOCK} windows: {block_ms:.3f} ms without '
          f'the profiler, device busy {busy_ms:.3f} ms in '
          f'{sum(e.count for e in ops)} device ops: '
          f'{100 * busy_ms / block_ms:.1f}% busy ({prof_wall * 1e3:.3f} ms '
          'under the profiler); busiest: ' + '; '.join(
              f'{e.device_time_total / 1e3:.3f} ms {e.key[:40]}'
              for e in sorted(ops, key=lambda e: -e.device_time_total)[:4]))
    ctx.staged.model.unlink()
    return main_counts, eval_counts, (statistics.median(main_ms), read_ms)


def deep_phase(vox_args, valid, capacity, bhw, host_batch, device, counters,
               shapes):
    """Phase 16: K1 at depth DEEP on the bench batch, and one recipe step
    at that depth; returns the numbers for the kernels line."""
    from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
    from dvs_of_training_framework_tpu_torch.models import Model
    from dvs_of_training_framework_tpu_torch.ops import voxel_cuda
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, create_train_state, make_train_step)
    B, H, W = bhw
    w = torch.from_numpy(np.random.default_rng(6).normal(
        size=(capacity, DEEP)).astype(np.float32)).to(device)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(B, H, W, DEEP)).astype(np.float32)).to(device)
    print(f'[16] K1 at depth {DEEP} on the bench batch')
    for weights in (w, w.bfloat16()):
        grids, grads = [], []
        for _ in range(20):
            wr = weights.clone().requires_grad_(True)
            grid = voxel_cuda.voxelize(*vox_args, wr, valid, B, H, W)
            grads.append(torch.autograd.grad(grid, wr, g)[0])
            grids.append(grid.detach())
        wt = weights.cpu().requires_grad_(True)
        twin = one_thread_twin(voxel_cuda.plain, *vox_args, wt, valid, B, H,
                               W)
        (twin_dw,) = torch.autograd.grad(twin, wt, g.cpu())
        same = sum(bits_equal(x, twin) for x in grids)
        same_dw = sum(bits_equal(x, twin_dw) for x in grads)
        print(f'  {weights.dtype} weights: {same} of 20 forwards and '
              f'{same_dw} of 20 backwards equal the one-thread CPU twin bit '
              'for bit')
        if same != 20 or same_dw != 20:
            raise AssertionError(f'K1 at depth {DEEP} differs from its twin')
    del grids, grads, twin, twin_dw
    n_valid = int(valid.sum())
    put_at = ((vox_args[2].long() * H + vox_args[1].long()) * W
              + vox_args[0].long())[valid][:, None] * DEEP \
        + torch.arange(DEEP, device=device)
    put_at, put_values = put_at.reshape(-1), w[valid].reshape(-1)
    k_ms, p_ms, lib_ms = time_pair(
        lambda: voxel_cuda.voxelize(*vox_args, w, valid, B, H, W),
        lambda: voxel_cuda.plain(*vox_args, w, valid, B, H, W),
        lambda: torch.zeros(B * H * W * DEEP, device=device).index_put_(
            (put_at,), put_values, accumulate=True))
    b_ms, b_kind, _ = bound(nbytes=13 * capacity + 4 * n_valid * DEEP
                            + 4 * B * H * W * DEEP)
    print(f'  voxelize_fwd at depth {DEEP}: kernel {k_ms:.4f} ms, plain '
          f'{p_ms:.4f} ms, index_put_ {lib_ms:.4f} ms; bound {b_ms:.4f} ms '
          f'({b_kind}), kernel at {100 * b_ms / k_ms:.1f}% of it')
    del put_at, put_values, w, g

    # one production-recipe training step at this depth
    model = Model(event_representation_depth=DEEP, dtype='bfloat16',
                  generator=torch.Generator().manual_seed(0), device=device)
    args = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                           half_life=20000, num_warmup_steps=0,
                           training_steps=1000, rs=0.5)
    step_fn = make_train_step(model, MultiScaleLoss(shapes, bf16x2=True),
                              construct_optimizer(args, model), LOSS_WEIGHTS,
                              1)
    reset(counters)
    state, (loss, _) = step_fn(create_train_state(), host_batch.to(device))
    torch.cuda.synchronize()
    counts = read_counts(counters)
    print(f'  one recipe step at depth {DEEP}: loss {loss.item():.5f}; '
          f'launches {counts}')
    if not torch.isfinite(loss) or counts['voxelize_fwd'] != 1 \
            or counts['voxelize_bwd'] != 1:
        raise AssertionError(f'the recipe step at depth {DEEP} failed')
    return {'depth': DEEP, 'ms': k_ms, 'plain_ms': p_ms,
            'library_ms': lib_ms, 'bound_ms': b_ms, 'bound_by': b_kind}


def raw_batches(out, n, flags):
    """The first ``n`` training batches (bs 8, 256x256) of the loader over
    phase 14's raw set (``DVS_DATA_PATH``) under ``flags``, one worker
    thread (its draws in order)."""
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.data.dataloader import (
        choose_data_path, get_dataloader, get_trainset_params)
    args = choose_data_path(cli.parse_args(
        ['-m', str(out / 'unused'), '-bs', '8', '-mbs', '8',
         '--num_workers', '0'] + flags))
    # the loader draws its augmentation from the global generators: seeded,
    # every run reads the same batches
    random.seed(0)
    np.random.seed(0)
    batches = iter(get_dataloader(get_trainset_params(args)))
    try:
        return [next(batches) for _ in range(n)]
    finally:
        batches.close()


def fitting_capacity(collated, floor=2 ** 18):
    """``floor``, or the largest batch's events rounded up to 1024."""
    most = max(int(c['events']['x'].size) for c in collated)
    return max(floor, -(-most // 1024) * 1024)


def together(*fns):
    """Call ``fns`` at once, each on a thread of its own, and return their
    results in order; the first error is raised once all have ended.  For
    ``train.main()`` calls that spawn ranks of their own: each rank is a
    process, so nothing of one run touches another's."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(fns)) as pool:
        futures = [pool.submit(fn) for fn in fns]
        return [f.result() for f in futures]


def resume_against(label, out, run, argv, steps, every, alongside=None):
    """Phase 12's rule for ``train.main()``: two copies of ``run`` cut back
    to checkpoint ``steps - every`` resume to ``steps``; each parameter of
    the first must lie within twice the two copies' largest difference of
    the uninterrupted run's, and equal it bit for bit where they agree.
    With ``alongside`` (a mesh's runs, whose ranks are processes of their
    own) the two resumes and ``alongside()`` run at once, and its result
    is returned."""
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer

    def resume(i):
        copy = out / f'{run.name}_resume{i}'
        shutil.copytree(run, copy)
        (copy / f'step_{steps}.ckpt').unlink()
        cli.main(['-m', str(copy)] + argv + ['--allow-arguments-change'])
        return Serializer(copy).read_state_dict(steps)['model']

    if alongside is None:
        copies, extra = [resume(0), resume(1)], None
    else:
        *copies, extra = together(lambda: resume(0), lambda: resume(1),
                                  alongside)
    whole = Serializer(run).read_state_dict(steps)['model']
    diffs = {name: (max_abs(copies[0][name], want),
                    max_abs(copies[0][name], copies[1][name]))
             for name, want in whole.items()}
    spread = max(d_ab for _, d_ab in diffs.values())
    for name, (d_ru, d_ab) in diffs.items():
        if d_ru > 2 * spread or (d_ab == 0 and not bits_equal(
                copies[0][name], whole[name])):
            raise AssertionError(f'{label} resume: {name} differs from the '
                                 f'uninterrupted run by {d_ru:.3e}, the '
                                 f'card\'s spread is {spread:.3e}')
    print(f'{label} resumed from checkpoint {steps - every} to {steps} '
          'through main(), twice: against the uninterrupted run, worst max '
          f'abs diff {max(d for d, _ in diffs.values()):.3e} ('
          f'{sum(d == 0 for d, _ in diffs.values())}/{len(diffs)} parameters '
          f'equal bit for bit); the two resumes: {spread:.3e}; bound 2x')
    return extra


def card_vs_cpu(label, eval_cli, argv, plugin_cls, n=2):
    """The evaluation CLI's wrapper on the card and ``plugin_cls`` on the
    CPU, the same staged weights, on the first ``n`` windows of the first
    test configuration: every scale's flow within rtol 1e-4, atol 1e-4 of
    the flow's largest value.  Returns the wrapper, the windows (a block
    for the wrapper), the staged args, the test record, its configuration,
    frames and crops."""
    from dvs_of_training_framework_tpu_torch.data.augmentation import \
        frame_generator
    args = eval_cli.parse_args(argv)
    staged = eval_cli.export_weights_only(args)
    dataset, shared_cfg = eval_cli.build_test_matrix(args)[0]
    cfg = eval_cli.resolve_time_range(SimpleNamespace(**vars(shared_cfg)),
                                      dataset)
    event_crop, gt_crop = eval_cli.build_crops(dataset.imshape,
                                               cfg.test_shape, cfg.crop_type)
    frames = eval_cli.generate_frames(cfg, dataset.image_ts)
    wins = [(event_crop(np.array(w).T).T, start, stop) for w, start, stop in
            list(frame_generator(dataset.events, frames))[:n]]
    block = ([w for w, _, _ in wins], [s for _, s, _ in wins],
             [t for _, _, t in wins])
    of = eval_cli.init_model(staged, cfg.test_shape)
    on_cpu = plugin_cls(cfg.test_shape, model=staged.model, device='cpu')
    pair = tuple(part[:2] for part in block)
    got, want = of(*pair, return_all=True), on_cpu(*pair, return_all=True)
    print(f'{label} the card\'s flows against the CPU\'s, the same weights, '
          'two windows:')
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        check_close(f'{g.shape[1]}x{g.shape[2]} flow, card vs CPU',
                    torch.from_numpy(g), torch.from_numpy(w), 1e-4,
                    1e-4 * scale)
    return SimpleNamespace(of=of, block=block, staged=staged,
                           dataset=dataset, cfg=cfg, frames=frames,
                           event_crop=event_crop, gt_crop=gt_crop)


def sequence_phases(out, device, card, counters, bench_collated):
    """Phases 17-19 over phase 14's raw set in ``out``; returns the launch
    counts of each path and K1's numbers at 16 planes."""
    from dvs_of_training_framework_tpu_torch import test as eval_cli
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
    from dvs_of_training_framework_tpu_torch.models import (
        evflownet, recurrent_flownet)
    from dvs_of_training_framework_tpu_torch.tools import prepare_batches
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer
    from dvs_of_training_framework_tpu_torch.utils.tb import SummaryWriter
    launches = {}
    shapes = cli.flow_shapes((256, 256))
    pairs = ['--min-sequence-length', '2', '--max-sequence-length', '2']

    def recipe_loss(plain_ops=False):
        return MultiScaleLoss(shapes, bf16x2=True, plain_ops=plain_ops)

    # --- 17. one RecurrentFlowNet recipe step, kernels against twins -------
    t_phase = time.perf_counter()
    collated = raw_batches(out, 4, pairs)
    capacity = fitting_capacity(collated)
    events = [int(c['events']['x'].size) for c in collated]
    print(f'[17] RecurrentFlowNet (base 32, hidden 32, depth 9) on 2-element '
          f'samples of phase 14\'s raw set, bs 8, 256x256: {events} events '
          f'in 4 batches read in {time.perf_counter() - t_phase:.2f} s, '
          f'capacity {capacity}')

    def recurrent(plain_ops=False, seed=0):
        return recurrent_flownet.Model(
            max_sequence_length=2, dtype='bfloat16', plain_ops=plain_ops,
            generator=torch.Generator().manual_seed(seed), device=device)

    host = [pad_batch(c, capacity) for c in collated]

    # K1 on this path's 16 planes (8 samples x 2 elements), first batch
    from dvs_of_training_framework_tpu_torch.ops import voxel_cuda
    ev = host[0].to(device).events
    valid = ev.sample_index < 8
    vox_args = (ev.x, ev.y, ev.sample_index.clamp(0, 7) * 2
                + ev.element_index.clamp(0, 1))
    w = torch.from_numpy(np.random.default_rng(8).normal(
        size=(capacity, 9)).astype(np.float32)).to(device)
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(16, 256, 256, 9)).astype(np.float32)).to(device)
    results = []
    for fn in (voxel_cuda.voxelize, voxel_cuda.plain):
        wr = w.clone().requires_grad_(True)
        grid = fn(*vox_args, wr, valid, 16, 256, 256)
        results.append((grid.detach(), torch.autograd.grad(grid, wr, g)[0]))
    print(f'[17] K1 on 16 planes against its twin ({int(valid.sum())} '
          'events):')
    check_close('forward', results[0][0], results[1][0], 1e-5, 1e-5)
    check_close('backward', results[0][1], results[1][1], 1e-6, 1e-6)
    planes_16 = {}
    for suffix, ((k_ms, p_ms, lib_ms), (b_ms, b_kind, _)) in zip(
            ('fwd', 'bwd'), voxelize_times(vox_args, valid, w, g, 16, 256,
                                           256)):
        planes_16[suffix] = {'planes': 16, 'ms': k_ms, 'plain_ms': p_ms,
                             'library_ms': lib_ms, 'bound_ms': b_ms,
                             'bound_by': b_kind}
        print(f'  voxelize_{suffix} at 16 planes: kernel {k_ms:.4f} ms, '
              f'plain {p_ms:.4f} ms, library {lib_ms:.4f} ms; bound '
              f'{b_ms:.4f} ms ({b_kind}), kernel at {100 * b_ms / k_ms:.1f}% '
              'of it')
    del results, w, g, ev, valid, vox_args

    # only cuDNN's deterministic algorithms, as run() sets them, here and
    # for the timing: the two paths then differ by the kernels alone (with
    # the default algorithms, bf16 weight gradients of this model's small
    # leaves varied by up to 7% of the leaf between two calls)
    torch.backends.cudnn.deterministic = True
    batch = host[0].to(device)
    # in fp32 through the same three kernels (the bf16x2 loss's fused warp
    # computes in fp32): phase 5's golden tolerances
    fp32 = {name: recurrent_flownet.Model(
        max_sequence_length=2, plain_ops=name == 'plain', device=device,
        generator=torch.Generator().manual_seed(0)) for name in ('kernel',
                                                                 'plain')}
    compare_step('[17] recurrent fp32 step, fused warp', fp32,
                 {'kernel': recipe_loss(), 'plain': recipe_loss(True)},
                 batch, 1e-5, 1e-4)
    kernel_model, twin = recurrent(), recurrent(plain_ops=True, seed=1)
    twin.load_state_dict(kernel_model.state_dict())
    fp32['plain'].load_state_dict(kernel_model.state_dict())
    # the recipe: the two paths sum the flows' cotangent in another order
    # (the warp is one autograd node or several), and bf16 carries those
    # last-bit differences to the 16x16 bottleneck's small weight
    # gradients, 5.2-7.5% of the leaf in the first runs against phase 6's
    # 5%: such a leaf is held to the twin's own bf16-vs-fp32 gap
    compare_step('[17] recurrent recipe step', {
        'kernel': kernel_model, 'plain': twin, 'golden': fp32['plain']},
        {'kernel': recipe_loss(), 'plain': recipe_loss(True),
         'golden': MultiScaleLoss(shapes, plain_ops=True)},
        batch, 1e-3, 5e-2)
    del twin, fp32, batch
    n = WARMUP + STEPS
    step_fn, state, step_ms, counts = train(
        '[17] recurrent recipe, cudnn.deterministic=True', kernel_model,
        recipe_loss(), [host[i % len(host)] for i in range(n)], device,
        card, counters, grad_clip_norm=1.0)
    check_counts('recurrent', counts, {
        'voxelize_fwd': n, 'voxelize_bwd': n, 'kernel_mlp_fwd': n,
        'kernel_mlp_bwd': n, 'corner_values': 0, 'warp_fwd': 4 * n,
        'warp_bwd': 4 * n})
    launches['recurrent_step'] = counts
    trace_steps('[17] cudnn.deterministic=True', step_fn, state, host[:2],
                device, step_ms)
    torch.backends.cudnn.deterministic = False
    del step_fn, state, kernel_model, host
    torch.cuda.empty_cache()
    print(f'[17] {time.perf_counter() - t_phase:.2f} s')

    # --- 18. RecurrentFlowNet through main() and the evaluation CLI --------
    t_phase = time.perf_counter()
    shards, run = out / 'shards_pairs', out / 'run_recurrent'
    t0 = time.perf_counter()
    prepare_batches.main(prepare_batches.parse_args(
        ['-o', str(shards), '-s', str(SHARD_SAMPLES), '--samples-per-file',
         '32'] + pairs))
    shard_s = time.perf_counter() - t0
    every = 4
    argv = ['-d', device.type, '-bs', '8', '-mbs', '8', '-ne',
            str(MAIN_STEPS), '--preprocessed-dataset-path', str(shards),
            '--checkpointing_interval', str(every), '--permanent_interval',
            str(every), '-vp', str(every), '--event-capacity', 'auto',
            '--device-queue-window', str(every),
            '--flownet_path', 'RecurrentFlowNet'] + pairs + RECIPE_FLAGS
    clock = LoopClock()
    run_fn = cli.run
    cli.run = lambda *a, **k: run_fn(*a, timers=clock, **k)
    reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        cli.main(['-m', str(run)] + argv)
    finally:
        cli.run = run_fn
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = read_counts(counters)
    launches['recurrent_main'] = counts
    scalars = read_scalars(run / 'log')
    losses = scalars.get('General/Train loss', [])
    val_losses = scalars.get('General/Validation loss', [])
    steps = Serializer(run).list_known_steps()
    skipped = scalars.get('General/skipped batches', [0.0])[-1]
    capacity = json.loads((run / 'parameters').read_text())[
        'arguments']['event_capacity']
    print(f'[18] 2-element shards ({SHARD_SAMPLES} samples) built in '
          f'{shard_s:.2f} s; train.main() --flownet_path RecurrentFlowNet, '
          f'{MAIN_STEPS} production-recipe steps at the resolved capacity '
          f'{capacity}: losses ' + ' '.join(f'{v:.5f}' for v in losses)
          + '; validation ' + ' '.join(f'{v:.5f}' for v in val_losses)
          + f'; checkpoints {steps}; skipped batches {skipped:g}')
    print(f'  launches: {counts}')
    # windows of 4 replayed, and one step before the graph's capture
    fwd, trained = counts['voxelize_fwd'], MAIN_STEPS + 1
    if (len(losses) != MAIN_STEPS or not val_losses
            or not np.isfinite(losses + val_losses).all()
            or steps != list(range(0, MAIN_STEPS + 1, every))
            or len(clock.step_starts) != MAIN_STEPS // every
            or counts['voxelize_bwd'] != trained
            or counts['warp_bwd'] != 4 * trained
            or counts['kernel_mlp_fwd'] != fwd
            or counts['warp_fwd'] != 4 * fwd or fwd <= trained):
        raise AssertionError(f'[18] main(): losses {losses}, checkpoints '
                             f'{steps}, launches {counts}')
    main_ms = clock.window_ms(every)
    print(f'  main() step {statistics.median(main_ms):.3f} ms (windows of '
          f'{every} as graph replays: the intervals after the first window, '
          'hooks excluded, over their steps: '
          + ' '.join(f'{v:.1f}' for v in main_ms) + f'); main() '
          f'{main_s:.2f} s in all; card: {card}')
    resume_against('[18]', out, run, argv, MAIN_STEPS, every)

    configs = REPO / 'dvs_of_training_framework_tpu_torch' / 'config'
    eval_argv = ['-m', str(run), '-o', str(out / 'eval_recurrent'), '-s',
                 str(MAIN_STEPS), '-d', device.type, '--test-config',
                 str(configs / 'synth_testing.json'), '--flownet_path',
                 'RecurrentFlowNet']
    reset(counters)
    t0 = time.perf_counter()
    eval_cli.main(eval_argv)
    seconds = time.perf_counter() - t0
    counts = read_counts(counters)
    launches['recurrent_eval'] = counts
    records = pickle.loads((out / 'eval_recurrent' /
                            f'step_{MAIN_STEPS}.pkl').read_bytes())
    print(f'[18] evaluation CLI, RecurrentFlowNet step {MAIN_STEPS}, '
          f'{sum(len(r.windows) for r in records)} windows in {seconds:.2f} '
          's: ' + '; '.join(f'step {r.step}: mAEE {r.mAEE:.4f}, %AEE '
                            f'{100 * r.mpAEE:.2f}, mMedEE {r.mMedEE:.4f}'
                            for r in records))
    print(f'  launches: {counts}')
    blocks = sum(math.ceil(len(r.windows) / EVAL_BLOCK) for r in records)
    numbers = [v for r in records for v in (r.mAEE, r.mpAEE, r.mMedEE)]
    if (len(records) != 3 or not np.isfinite(numbers).all()
            or counts['voxelize_fwd'] != blocks
            or counts['kernel_mlp_fwd'] != blocks
            or any(counts[k] for k in counts
                   if k not in ('voxelize_fwd', 'kernel_mlp_fwd'))):
        raise AssertionError(f'[18] evaluation: {numbers}, launches {counts}')
    card_vs_cpu('[18]', eval_cli, eval_argv,
                recurrent_flownet.OpticalFlow).staged.model.unlink()
    torch.cuda.empty_cache()
    print(f'[18] {time.perf_counter() - t_phase:.2f} s')

    # --- 19. dynamic sample lengths and DummyFlowNet through run() ---------
    t_phase = time.perf_counter()
    dynamic = ['--min-sequence-length', '1', '--max-sequence-length', '2',
               '--dynamic-sample-length']
    collated = [c for c in raw_batches(out, 5, dynamic)
                if np.bincount(c['sample_idx']).min() < 3]
    if len(collated) < 2:
        raise AssertionError('[19] too few batches with a 1-element sample')
    capacity = fitting_capacity(collated)
    models = {name: evflownet.Model(
        max_sequence_length=2, dynamic_sample_length=True, dtype='bfloat16',
        plain_ops=name == 'plain', device=device,
        generator=torch.Generator().manual_seed(0)) for name in ('kernel',
                                                                 'plain')}
    batch = pad_batch(collated[0], capacity, sequence_length=2)
    pad_slots = int((batch.sample_idx == 8).sum())
    print(f'[19] EVFlowNet on 1-2 element samples (--dynamic-sample-length), '
          f'{len(collated)} batches with padding slots ({pad_slots} in the '
          f'first), capacity {capacity}')
    torch.backends.cudnn.deterministic = True       # as in phase 17
    compare_step('[19] dynamic-length recipe step', models,
                 {'kernel': recipe_loss(), 'plain': recipe_loss(True)},
                 batch.to(device), 1e-3, 5e-2)
    del models

    def run_cli(name, flags, stream, val, capacity):
        path = out / name
        path.mkdir()
        args = cli.parse_args(
            ['-m', str(path), '-d', device.type, '-bs', '8', '-mbs', '8',
             '-ne', '4', '--checkpointing_interval', '4',
             '--permanent_interval', '4', '-vp', '4', '--event-capacity',
             str(capacity)] + flags + RECIPE_FLAGS)
        reset(counters)
        model, optimizer, state, _ = cli.run(
            args, lambda samples: (stream[(samples // 8 + i) % len(stream)]
                                   for i in range(10 ** 6)),
            lambda: val, SummaryWriter(path / 'log'))
        torch.cuda.synchronize()
        counts = read_counts(counters)
        scalars = read_scalars(path / 'log')
        losses = scalars.get('General/Train loss', [])
        if state.step != 4 or len(losses) != 4 \
                or not np.isfinite(losses).all():
            raise AssertionError(f'[19] {name}: step {state.step}, losses '
                                 f'{losses}')
        print(f'[19] run() {name}, 4 recipe steps: losses '
              + ' '.join(f'{v:.5f}' for v in losses) + f'; groups '
              f'{list(optimizer.groups)}; launches {counts}')
        return optimizer, scalars, counts

    _, _, launches['sequences'] = run_cli('dynamic', dynamic, collated,
                                          collated[:1], capacity)
    optimizer, scalars, launches['dummy'] = run_cli(
        'dummy', ['--flownet_path', 'DummyFlowNet'], bench_collated[:4],
        bench_collated[4:5], fitting_capacity(bench_collated, 2 ** 17))
    if list(optimizer.groups) != ['predictor'] or \
            'General/learning rate/1' in scalars:
        raise AssertionError('[19] DummyFlowNet: not one optimizer group')
    if any(launches['dummy'][k] for k in ('voxelize_fwd', 'kernel_mlp_fwd')):
        raise AssertionError('[19] DummyFlowNet ran the event kernels')
    print(f'[19] {time.perf_counter() - t_phase:.2f} s')
    return launches, planes_16


def shard_files(path):
    """``{relative path: file}`` of every array file of a shard set's
    stores (the npy store: a directory a shard, a ``.npy`` an array)."""
    return {str(f.relative_to(path)): f for shard in path.glob('*.hdf5')
            for f in sorted(shard.rglob('*')) if f.is_file()}


def bake_phase(out, device, card, counters, checkpoint):
    """Phase 20: the bake tool over phase 14's raw shards with phase 14's
    checkpoint, in one go and cut at half then resumed; the first baked
    batch against the CPU twins.  Returns the launch counts of the one-go
    bake, its numbers for the report and the baked set's path."""
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.data.preprocessed import \
        PreprocessedDataloader
    from dvs_of_training_framework_tpu_torch.models import init_model
    from dvs_of_training_framework_tpu_torch.ops import kernel_mlp_cuda
    from dvs_of_training_framework_tpu_torch.tools import \
        quantize_preprocessed as bake_tool
    t_phase = time.perf_counter()
    shards = out / 'shards'
    raw = PreprocessedDataloader(shards, 8, is_raw=True, show_progress=False)
    H, W = next(raw)['images'].shape[-2:]
    argv = ['-d', device.type, '-mbs', '8', '--event-capacity',
            str(BAKE_CAPACITY), '--precision', 'bfloat16',
            '--preprocessed-dataset-path', str(shards), '-sp',
            str(checkpoint), '--samples-per-file', str(BAKE_FILE_SAMPLES),
            '--height', str(H), '--width', str(W)]

    def bake(path, size, extra=()):
        return bake_tool.main(bake_tool.parse_args(
            ['-o', str(path), '-s', str(size)] + argv + list(extra)))

    baked, cut = out / 'baked', out / 'baked_cut'
    reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = bake(baked, SHARD_SAMPLES)
    bake_s = time.perf_counter() - t0
    counts = read_counts(counters)
    set_mb = sum(f.stat().st_size for f in shard_files(baked).values()) / 1e6
    loop_s = stats.read_s + stats.device_s + stats.write_s
    print(f'[20] bake, tools.quantize_preprocessed -mbs 8 --event-capacity '
          f'{BAKE_CAPACITY} --precision bfloat16 over phase 14\'s raw shards '
          f'with its step-{MAIN_STEPS} checkpoint: {stats.samples} samples '
          f'in {stats.batches} batches, {stats.skipped} skipped; '
          f'{bake_s:.3f} s in all ({stats.samples / bake_s:.2f} samples/s), '
          f'the loop {loop_s:.3f} s ({stats.samples / loop_s:.2f} '
          f'samples/s): read {stats.read_s:.3f} s, device '
          f'{stats.device_s:.3f} s, write {stats.write_s:.3f} s '
          f'({1e3 * stats.read_s / stats.batches:.2f}, '
          f'{1e3 * stats.device_s / stats.batches:.2f}, '
          f'{1e3 * stats.write_s / stats.batches:.2f} ms a batch); '
          f'{set_mb:.1f} MB on disk; card: {card}')
    print(f'  launches: {counts}')
    if (stats.samples != SHARD_SAMPLES or counts['voxelize_fwd'] !=
            stats.batches or counts['kernel_mlp_fwd'] != stats.batches
            or any(n for k, n in counts.items()
                   if k not in ('voxelize_fwd', 'kernel_mlp_fwd'))):
        raise AssertionError(f'[20] bake: {stats}, launches {counts}')

    # half, then resumed to the whole: the same files, bit for bit
    first = bake(cut, SHARD_SAMPLES // 2)
    second = bake(cut, SHARD_SAMPLES, ['--allow-arguments-change'])
    whole, parts = shard_files(baked), shard_files(cut)
    same = [k for k in whole if k in parts
            and filecmp.cmp(whole[k], parts[k], shallow=False)]
    print(f'[20] bake cut at {SHARD_SAMPLES // 2} samples ({first.batches} '
          f'batches, {first.skipped} skipped), then resumed to '
          f'{SHARD_SAMPLES} ({second.batches} batches, {second.skipped} '
          f'skipped): {len(same)} of {len(whole)} files equal the one-go '
          'bake\'s byte for byte')
    if len(same) != len(whole) or parts.keys() != whole.keys():
        raise AssertionError('[20] the resumed bake differs from one go')
    shutil.rmtree(cut)

    # the first baked batch against the CPU twins' quantize of the same
    # padded batch: K2 on the card within phase 3's bound of its twin, and
    # the rest of the layer on the CPU with the card's K2 output, K1 the
    # one-thread twin, equal to the card's batch bit for bit
    raw.set_index(0)
    skipped = 0
    while True:
        collated = next(raw)
        if collated['events']['x'].size <= BAKE_CAPACITY:
            break
        skipped += 1
    dense = next(PreprocessedDataloader(baked, 8, is_raw=False,
                                        show_progress=False))
    for key in ('timestamps', 'images'):
        if not np.array_equal(dense[key], collated[key]):
            raise AssertionError(f'[20] the baked batch\'s {key} differ')
    host = pad_batch(collated, BAKE_CAPACITY)
    args = bake_tool.parse_args(['-o', str(baked), '-s',
                                 str(SHARD_SAMPLES)] + argv, is_write=False)
    cpu = torch.device('cpu')
    model = init_model(args, cpu)
    # the layer's K2 twin, which the check below stands the card's K2 in for
    model.quantization_layer.plain_ops = True
    plain = kernel_mlp_cuda.plain
    k2_errs = []

    def card_k2(delta, *params):
        got = kernel_mlp_cuda.kernel_mlp(
            delta.to(device), *(p.to(device) for p in params)).cpu()
        k2_errs.append(check_close(
            'K2 forward on the batch, card against the CPU twin', got,
            plain(delta, *params), 2e-6, 2e-6))
        return got

    def cpu_quantize():
        batch = host.to(cpu)
        with torch.inference_mode():
            return one_thread_twin(model.quantize, batch.events,
                                   batch.timestamps, batch.sample_idx,
                                   (H, W))

    kernel_mlp_cuda.plain = card_k2
    try:
        with_card_k2 = cpu_quantize()
    finally:
        kernel_mlp_cuda.plain = plain
    twins = cpu_quantize()
    baked_batch = torch.from_numpy(dense['data'])
    exact = bits_equal(with_card_k2, baked_batch)
    diff = (twins - baked_batch).abs()
    print(f'[20] the first baked batch (after {skipped} skipped) against '
          f'the CPU twins: with the card\'s K2 output, K1\'s sums and the '
          f'layer equal it bit for bit: {exact}; the twins\' own K2: max abs '
          f'diff {diff.max().item():.3e} in {int((diff > 0).sum())} of '
          f'{diff.numel()} values (bf16 roundings of K2\'s last bits), '
          f'largest value {baked_batch.abs().max().item():.3e}')
    if not exact or len(k2_errs) != 1 or not baked_batch.any():
        raise AssertionError('[20] the baked batch differs from the CPU '
                             'twins with the card\'s K2, or is empty')
    print(f'[20] {time.perf_counter() - t_phase:.2f} s')
    return counts, {'samples': stats.samples, 'seconds': bake_s,
                    'samples_per_s': stats.samples / bake_s,
                    'read_s': stats.read_s, 'device_s': stats.device_s,
                    'write_s': stats.write_s, 'skipped': stats.skipped,
                    'mb_on_disk': set_mb}, baked


def dense_phases(out, device, card, counters, raw_main):
    """Phases 20-22 over phase 14's set in ``out``: the bake, dense
    training through ``main()`` on the baked shards, and ``--ev_images``
    over the raw set with host images.  ``raw_main`` is phase 14's
    ``main()`` step and reader ms.  Returns the launch counts of each
    path and the bake's numbers."""
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.data.dataloader import (
        choose_data_path, get_dataloader, get_trainset_params)
    from dvs_of_training_framework_tpu_torch.data.preprocessed import \
        PreprocessedDataloader
    from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
    from dvs_of_training_framework_tpu_torch.models import evflownet
    from dvs_of_training_framework_tpu_torch.training.serializer import (
        Serializer, read_params_file)
    from dvs_of_training_framework_tpu_torch.utils.tb import SummaryWriter
    launches = {}
    checkpoint = out / 'run' / f'step_{MAIN_STEPS}.ckpt'
    launches['bake'], bake, baked = bake_phase(out, device, card, counters,
                                               checkpoint)
    loader = PreprocessedDataloader(baked, 8, is_raw=False,
                                    show_progress=False)
    host = [pad_batch(next(loader)) for _ in range(SHARD_SAMPLES // 8)]
    H, W = host[0].images.shape[-2:]
    shapes = cli.flow_shapes((H, W))

    def recipe_loss(plain_ops=False):
        return MultiScaleLoss(shapes, bf16x2=True, plain_ops=plain_ops)

    # --- 21. dense training through main() on the baked shards --------------
    t_phase = time.perf_counter()
    run, every = out / 'run_dense', 4
    argv = ['-d', device.type, '-bs', '8', '-mbs', '8', '-ne',
            str(MAIN_STEPS), '--ev_images', '--preprocessed-dataset-path',
            str(baked), '-sp', str(checkpoint), '--representation-start',
            '1.0', '--height', str(H), '--width', str(W),
            '--checkpointing_interval', str(every),
            '--permanent_interval', str(2 * every), '--num_checkpoints', '2',
            '-vp', str(every), '--event-capacity',
            str(BAKE_CAPACITY), '--device-queue-window',
            str(every)] + RECIPE_FLAGS
    clock = LoopClock(counters)
    run_fn = cli.run
    cli.run = lambda *a, **k: run_fn(*a, timers=clock, **k)
    reset(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        cli.main(['-m', str(run)] + argv)
    finally:
        cli.run = run_fn
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = read_counts(counters)
    launches['dense_main'] = counts
    in_steps = clock.step_launches
    scalars = read_scalars(run / 'log')
    losses = scalars.get('General/Train loss', [])
    val_losses = scalars.get('General/Validation loss', [])
    steps = Serializer(run).list_known_steps()
    print(f'[21] train.main() --ev_images on the baked shards, '
          f'{MAIN_STEPS} production-recipe steps, --representation-start '
          '1.0, raw validation every 4: losses ' + ' '.join(
              f'{v:.5f}' for v in losses) + '; validation ' + ' '.join(
              f'{v:.5f}' for v in val_losses) + f'; checkpoints {steps}')
    print(f'  launches: {counts}; inside the train steps: {in_steps}')
    # windows of 4 replayed, and one step before the graph's capture
    forwards, trained = counts['voxelize_fwd'], MAIN_STEPS + 1
    want_steps = {k: 0 for k in counts}
    want_steps.update(warp_fwd=4 * trained, warp_bwd=4 * trained)
    if (len(losses) != MAIN_STEPS or len(val_losses) != 5
            or not np.isfinite(losses + val_losses).all()
            or steps != [0, 4, 8, 12] or in_steps != want_steps
            or len(clock.step_starts) != MAIN_STEPS // every
            or forwards == 0 or counts['kernel_mlp_fwd'] != forwards
            or counts['voxelize_bwd'] or counts['kernel_mlp_bwd']
            or counts['corner_values']
            or counts['warp_fwd'] != 4 * (trained + forwards)
            or counts['warp_bwd'] != 4 * trained):
        raise AssertionError(f'[21] main(): losses {losses}, checkpoints '
                             f'{steps}, launches {counts}, in steps '
                             f'{in_steps}')
    main_ms = clock.window_ms(every)
    read_ms = statistics.median(clock.window_read_ms(every))
    print(f'  dense main() step {statistics.median(main_ms):.3f} ms (windows '
          f'of {every} as graph replays: the intervals after the first '
          'window, hooks excluded, over their steps: '
          + ' '.join(f'{v:.1f}' for v in main_ms) + f'); reading a dense '
          f'batch {read_ms:.3f} ms (median); phase 14\'s raw main() step '
          f'{raw_main[0]:.3f} ms, reading a raw batch {raw_main[1]:.3f} ms; '
          f'K1 and K2 forward {forwards} times, in the validation passes '
          f'only; peak memory {peak_gib:.3f} GiB; main() {main_s:.2f} s in '
          f'all; card: {card}')
    resume_against('[21]', out, run, argv, MAIN_STEPS, every)
    for i in range(2):
        shutil.rmtree(out / f'{run.name}_resume{i}')

    # one dense recipe step through the kernels against the twins, and
    # in fp32 through the same fused warp; then the bare step, timed
    weights = read_params_file(checkpoint)
    shutil.rmtree(baked)

    def model(dtype, plain_ops=False):
        m = evflownet.Model(dtype=dtype, plain_ops=plain_ops, device=device)
        m.load_state_dict(weights)
        return m

    torch.backends.cudnn.deterministic = True       # as run() sets it
    batch = host[0].to(device)
    compare_step('[21] dense golden step (fp32, fused warp)',
                 {'kernel': model('float32'),
                  'plain': model('float32', True)},
                 {'kernel': recipe_loss(), 'plain': recipe_loss(True)},
                 batch, 1e-5, 1e-4, is_raw=False)
    compare_step('[21] dense recipe step',
                 {'kernel': model('bfloat16'),
                  'plain': model('bfloat16', True)},
                 {'kernel': recipe_loss(), 'plain': recipe_loss(True)},
                 batch, 1e-3, 5e-2, is_raw=False)
    del batch
    n = WARMUP + STEPS
    step_model = model('bfloat16')
    step_fn, state, step_ms, counts = train(
        '[21] dense recipe, cudnn.deterministic=True', step_model,
        recipe_loss(), [host[i % len(host)] for i in range(n)], device,
        card, counters, grad_clip_norm=1.0, is_raw=False)
    want = {k: 0 for k in counts}
    want.update(warp_fwd=4 * n, warp_bwd=4 * n)
    check_counts('dense step', counts, want)
    launches['dense_step'] = counts
    trace_steps('[21] cudnn.deterministic=True', step_fn, state, host[:2],
                device, step_ms)
    torch.backends.cudnn.deterministic = False
    del step_fn, state, step_model, host
    shutil.rmtree(run)
    torch.cuda.empty_cache()
    print(f'[21] {time.perf_counter() - t_phase:.2f} s')

    # --- 22. --ev_images over the raw set: images made on the host --------
    t_phase = time.perf_counter()
    for name, flags in (('host_images', []),
                        ('dummy_dense', ['--flownet_path', 'DummyFlowNet'])):
        path = out / name
        # one batch at a time: the host makes each image, so a window of
        # 16 staged two ahead would make 32 batches' for 4 steps
        args = choose_data_path(cli.parse_args(
            ['-m', str(path), '-d', device.type, '-bs', '8', '-mbs', '8',
             '-ne', '4', '--ev_images', '--skip-validation', '--height',
             str(H), '--width', str(W), '--num_workers', '0',
             '--checkpointing_interval', '4',
             '--permanent_interval', '4', '--event-capacity',
             str(BAKE_CAPACITY), '--device-queue-window', '0']
            + flags + RECIPE_FLAGS))
        image_fn = cli.make_event_image_fn(args)
        image_s = []

        def timed_image_fn(*a):
            t = time.perf_counter()
            image = image_fn(*a)
            image_s.append(time.perf_counter() - t)
            return image

        trainset = get_trainset_params(args)
        random.seed(0)
        np.random.seed(0)
        reset(counters)
        t0 = time.perf_counter()
        _, optimizer, state, _ = cli.run(
            args, lambda samples: get_dataloader(
                trainset, sample_idx=samples, event_image_fn=timed_image_fn),
            lambda: [], SummaryWriter(path / 'log'))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts(counters)
        launches[name] = counts
        losses = read_scalars(path / 'log').get('General/Train loss', [])
        want = {k: 0 for k in counts}
        want.update(warp_fwd=16, warp_bwd=16)
        print(f'[22] run() --ev_images {" ".join(flags) or "(EVFlowNet)"} '
              'over the raw set, 4 recipe steps: losses ' + ' '.join(
                  f'{v:.5f}' for v in losses) + f'; compute_event_image '
              f'{1e3 * statistics.median(image_s):.3f} ms a sample (median '
              f'of {len(image_s)}; {1e3 * sum(image_s):.1f} ms in all); '
              f'groups {list(optimizer.groups)}; run() {run_s:.2f} s; '
              f'launches {counts}; card: {card}')
        if (state.step != 4 or len(losses) != 4
                or not np.isfinite(losses).all() or counts != want
                or len(image_s) < 32):
            raise AssertionError(f'[22] {name}: step {state.step}, losses '
                                 f'{losses}, launches {counts}')
        shutil.rmtree(path)
    print(f'[22] {time.perf_counter() - t_phase:.2f} s')
    return launches, bake


class RecordingOptimizer:
    """The optimizer, keeping a copy of the first gradients it is given
    (a sharded step hands it the data group's mean)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.grads = None

    def step(self, grads):
        if self.grads is None:
            self.grads = {k: g.detach().clone() for k, g in grads.items()}
        self.optimizer.step(grads)


def bench_model(config, device, plain_ops=False, seed=0):
    from dvs_of_training_framework_tpu_torch.models import Model
    return Model(event_representation_depth=9, base_channels=64,
                 plain_ops=plain_ops, dtype=CONFIGS[config][0],
                 generator=torch.Generator().manual_seed(seed),
                 device=device)


def bench_step(config, device, groups=None, timers=None):
    """A fresh bench model of ``config`` and its training step (RANGER,
    accumulation 1): the single-device step, or the sharded one of
    ``groups``; returns (model, recording optimizer, step)."""
    from dvs_of_training_framework_tpu_torch.losses import (
        LOSS_PRECISIONS, MultiScaleLoss)
    from dvs_of_training_framework_tpu_torch.parallel import \
        make_sharded_train_step
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, make_train_step)
    from dvs_of_training_framework_tpu_torch.data import synthetic
    H, W = synthetic.IMSIZE
    model = bench_model(config, device)
    optimizer = RecordingOptimizer(construct_optimizer(BARE_ARGS, model))
    evaluator = MultiScaleLoss(
        [(H // 2 ** i, W // 2 ** i) for i in range(4)][::-1],
        bf16x2=LOSS_PRECISIONS[CONFIGS[config][1]])
    if groups is None:
        step = make_train_step(model, evaluator, optimizer, LOSS_WEIGHTS, 1)
    else:
        step = make_sharded_train_step(
            model, evaluator, optimizer, LOSS_WEIGHTS, 1, groups,
            event_axis=groups.mesh.event > 1, timers=timers)
    return model, optimizer, step


def rank_batches(groups, collated, capacity):
    """This rank's host piece of each bench batch, split as
    ``train.run`` splits it, each piece padded to ``capacity``."""
    from dvs_of_training_framework_tpu_torch.parallel import (
        shard_of, split_batch_for_mesh)
    mesh = groups.mesh
    return [shard_of(split_batch_for_mesh(
        c, mesh.data, capacity, event_shards=mesh.event), groups.data_index,
        groups.event_index if mesh.event > 1 else None) for c in collated]


def sharded_step_worker(rank, out, port):
    """Phase 23's rank ``rank`` of 2, sharing the card with the other
    (gloo): for each configuration and mesh, one step from the bench
    weights on the first bench batch (its loss, the gradients it applied
    and the parameters after it, saved to ``out``), then WARMUP + STEPS
    timed steps, the all-reduce timed on its own; the kernels' launches
    over the worker's life."""
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist
    from dvs_of_training_framework_tpu_torch.ops import launch_counts
    from dvs_of_training_framework_tpu_torch.parallel import (
        MeshGroups, initialize, parse_mesh)
    from dvs_of_training_framework_tpu_torch.training import \
        create_train_state
    from dvs_of_training_framework_tpu_torch.utils.timer import Timers
    out = Path(out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = initialize(f'127.0.0.1:{port}', 2, rank, 'cuda')
    collated, capacity = torch.load(out / 'batches.pt', weights_only=False)
    timing = {}
    for config in CONFIGS:
        for spec in MESHES:
            groups = MeshGroups(parse_mesh(spec), device)
            timers = Timers(device)
            model, optimizer, step = bench_step(config, device, groups,
                                                timers)
            pieces = rank_batches(groups, collated, capacity)
            state, (loss, _) = step(create_train_state(),
                                    pieces[0].to(device))
            torch.save({'loss': loss.item(), 'grads': {
                k: g.cpu() for k, g in optimizer.grads.items()},
                'params': {k: v.cpu() for k, v in
                           model.state_dict().items()}},
                out / f'{config}_{spec}_{rank}.pt')
            for i in range(WARMUP):
                step(state, pieces[(i + 1) % len(pieces)].to(device))
            torch.cuda.synchronize(device)
            timers.resolve()
            timers.device_spans.clear()
            t0 = time.perf_counter()
            for i in range(STEPS):
                step(state, pieces[i % len(pieces)].to(device))
            torch.cuda.synchronize(device)
            timers.resolve()
            n_params = sum(p.numel() for p in model.parameters())
            n_quant = sum(p.numel() for n, p in model.named_parameters()
                          if n.startswith('quantization_layer.'))
            grid = pieces[0].size * 9 * pieces[0].images.shape[-1] ** 2
            timing[f'{config} {spec}'] = {
                'step_ms': (time.perf_counter() - t0) / STEPS * 1e3,
                'all_reduce_ms': sum(s.ms for s in timers.device_spans
                                     if s.name == 'all_reduce') / STEPS,
                # one flat fp32 buffer on the data axis (gradients, loss,
                # 12 terms); the partial grid and the quantization
                # gradients on the event axis
                'data_bytes': 4 * (n_params + 13),
                'event_bytes': (4 * (grid + n_quant)
                                if groups.mesh.event > 1 else 0)}
            del model, optimizer, step, state
    torch.save({'timing': timing, 'launches': launch_counts(),
                'device': str(device)}, out / f'worker_{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()


def join_spawned(context, seconds, label):
    """Wait for a ``torch.multiprocessing`` context; a worker that fails
    stops the others (``join`` raises), and so does the time limit."""
    deadline = time.monotonic() + seconds
    while not context.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in context.processes:
                proc.kill()
            raise AssertionError(f'{label}: the workers outlived their '
                                 f'{seconds} s')


def run_ranks(commands, seconds, label, env=None):
    """Run ``commands`` together, each in a session of its own; returns
    their outputs.  One that fails, or the time limit, kills them all and
    raises with the outputs."""
    import signal
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO,
                              env=env, start_new_session=True)
             for cmd in commands]
    outputs = [None] * len(procs)
    failure = None
    deadline = time.monotonic() + seconds
    try:
        for i, proc in enumerate(procs):
            outputs[i] = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0]
            if proc.returncode != 0:
                failure = f'rank {i} exited {proc.returncode}'
                break
    except subprocess.TimeoutExpired:
        failure = f'outlived its {seconds} s'
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if failure:
        raise AssertionError(f'{label}: {failure}:\n' + '\n'.join(
            f'--- rank {i}:\n{(o or "")[-4000:]}'
            for i, o in enumerate(outputs)))
    return outputs


def check_run_dir(label, run, ranks, steps, batch):
    """test_multihost.py's checks of a run of 2 ranks: each took
    ``steps`` steps over ``steps * batch`` global samples, the final
    checkpoint holds them, and every TensorBoard file is rank 0's."""
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer
    if [(r['rank'], r['step'], r['samples_passed']) for r in ranks] != \
            [(0, steps, steps * batch), (1, steps, steps * batch)]:
        raise AssertionError(f'{label}: ranks {ranks}')
    saved = Serializer(run).read_state_dict(steps)
    files = [p.name for p in (run / 'log').glob('events.out.tfevents.*')]
    writers = {re.search(r'\.(\d+)\.0(\.monitor)?$', name).group(1)
               for name in files}
    if (int(saved['samples_passed']) != steps * batch
            or not (run / 'parameters').is_file()
            or writers != {str(ranks[0]['pid'])}):
        raise AssertionError(f'{label}: samples {saved["samples_passed"]}, '
                             f'TensorBoard files {files}, rank 0 pid '
                             f'{ranks[0]["pid"]}')
    return saved


def check_rank_launches(label, ranks, steps):
    """Each rank's train steps ran K1 and K2 forward and backward and the
    fused warp 4 times each way (validation adds forwards); ``steps``
    counts a step run before a graph's capture too."""
    for r in ranks:
        n = r['launches']
        if (n['voxelize_bwd'] != steps or n['kernel_mlp_bwd'] != steps
                or n['warp_bwd'] != 4 * steps
                or n['kernel_mlp_fwd'] != n['voxelize_fwd']
                or n['warp_fwd'] != 4 * n['voxelize_fwd']
                or n['voxelize_fwd'] < steps or n['corner_values'] != 0):
            raise AssertionError(f'{label}: rank {r["rank"]} launches {n}')
    return {k: sum(r['launches'][k] for r in ranks)
            for k in ranks[0]['launches']}


def mesh_phases(out, collated, capacity, device, card):
    """Phases 23-25 over phase 14's set in ``out``; returns the launch
    counts of each path and the numbers of the mesh JSON line."""
    import torch.distributed as dist
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.ops import launch_counts
    from dvs_of_training_framework_tpu_torch.parallel import (
        MeshGroups, parse_mesh)
    from dvs_of_training_framework_tpu_torch.parallel.distributed import \
        free_port
    from dvs_of_training_framework_tpu_torch.training import \
        create_train_state
    launches, numbers = {}, {}

    # --- 23. the bare sharded step ---------------------------------------
    t_phase = time.perf_counter()
    work = out / 'sharded_step'
    work.mkdir()
    torch.save((collated[:4], capacity), work / 'batches.pt')
    torch.backends.cudnn.deterministic = True
    whole = {}
    for config in CONFIGS:
        model, optimizer, step = bench_step(config, device)
        _, (loss, _) = step(create_train_state(),
                            pad_batch(collated[0], capacity).to(device))
        whole[config] = (loss.item(), optimizer.grads,
                         {k: v.detach().clone()
                          for k, v in model.state_dict().items()})
        del model, optimizer, step
    # a one-rank NCCL group: the sharded step is the unsharded one
    dist.init_process_group('nccl', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        groups = MeshGroups(parse_mesh('data:1'), device)
        for config in CONFIGS:
            model, optimizer, step = bench_step(config, device, groups)
            _, (loss, _) = step(create_train_state(),
                                pad_batch(collated[0], capacity).to(device))
            want_loss, want_grads, want_params = whole[config]
            same = [bits_equal(v, want_params[k])
                    for k, v in model.state_dict().items()]
            same_grads = [bits_equal(g, want_grads[k])
                          for k, g in optimizer.grads.items()]
            print(f'[23] {config}, a one-rank NCCL group (data:1) against '
                  f'the unsharded step: loss {loss.item():.7f} vs '
                  f'{want_loss:.7f}; {sum(same_grads)}/{len(same_grads)} '
                  f'gradients and {sum(same)}/{len(same)} parameters equal '
                  'bit for bit')
            if not (loss.item() == want_loss and all(same)
                    and all(same_grads)):
                differ = [k for k, ok in zip(model.state_dict(), same)
                          if not ok]
                raise AssertionError(
                    f'[23] {config}: the one-rank NCCL step differs from '
                    f'the unsharded one in {differ}; the unsharded '
                    'gradients\' strides: ' + ', '.join(
                        f'{k} {tuple(want_grads[k].stride())}'
                        for k in differ if k in want_grads))
            del model, optimizer, step
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    context = torch.multiprocessing.start_processes(
        sharded_step_worker, args=(str(work), free_port()), nprocs=2,
        join=False, start_method='spawn')
    join_spawned(context, 600, '[23]')
    workers = [torch.load(work / f'worker_{r}.pt', weights_only=False)
               for r in range(2)]
    for config in CONFIGS:
        want_loss, want_grads, want_params = whole[config]
        for spec in MESHES:
            ranks = [torch.load(work / f'{config}_{spec}_{r}.pt',
                                weights_only=False) for r in range(2)]
            label = f'[23] {config} {spec}'
            rel = abs(ranks[0]['loss'] - want_loss) / abs(want_loss)
            loss_rtol = 1e-4 if config == 'golden' else 1e-3
            print(f'{label}, two ranks sharing the card (gloo) against the '
                  f'single-process step on the whole batch: loss '
                  f'{ranks[0]["loss"]:.7f} vs {want_loss:.7f} (rel '
                  f'{rel:.2e}, tol {loss_rtol:g})')
            if not rel <= loss_rtol:
                raise AssertionError(f'{label}: the loss differs')
            bitwise = sum(bits_equal(ranks[0]['params'][k],
                                     ranks[1]['params'][k])
                          for k in want_params)
            print(f'  the two ranks\' parameters after the step: {bitwise}'
                  f'/{len(want_params)} equal bit for bit')
            if bitwise != len(want_params):
                raise AssertionError(f'{label}: the replicas differ')
            got = {k: v.to(device) for k, v in ranks[0]['grads'].items()}
            if config == 'golden':
                # tests/training/test_parallel.py's tolerances
                worst = max(
                    ((ranks[0]['params'][k].to(device) - want).abs()
                     / (2e-5 + 2e-3 * want.abs())).max().item()
                    for k, want in want_params.items())
                diff = max(max_abs(ranks[0]['params'][k].to(device), want)
                           for k, want in want_params.items())
                print(f'  parameters after the step against the single-'
                      f'process step: max abs diff {diff:.3e}, at most '
                      f'{worst:.3f} of rtol 2e-3, atol 2e-5 (must be <= 1)')
                if worst > 1:
                    raise AssertionError(f'{label}: parameters differ')
            else:
                check_grads(label, got, want_grads, whole['golden'][1],
                            5e-2)
    for key, t in workers[0]['timing'].items():
        t1 = workers[1]['timing'][key]
        print(f'[23] {key}: {t["step_ms"]:.3f} and {t1["step_ms"]:.3f} ms '
              f'a step (ranks 0, 1; {STEPS} steps after {WARMUP}), the '
              f'all-reduce {t["all_reduce_ms"]:.3f} and '
              f'{t1["all_reduce_ms"]:.3f} ms a step on the stream (CUDA '
              f'events around it; gloo reduces through the host) ('
              f'{100 * t["all_reduce_ms"] / t["step_ms"]:.1f}%), '
              f'{t["data_bytes"] / 1e6:.2f} MB reduced on the data axis and '
              f'{t["event_bytes"] / 1e6:.2f} MB on the event axis a step; '
              f'card: {card}')
    numbers['sharded_step'] = {k: [w['timing'][k] for w in workers]
                               for k in workers[0]['timing']}
    # each worker: both configurations on both meshes, 1 + WARMUP + STEPS
    # steps each; the fused warp in the recipe's only
    n = 2 * len(MESHES) * (1 + WARMUP + STEPS)
    for w in workers:
        check_counts('[23]', w['launches'], {
            'voxelize_fwd': n, 'voxelize_bwd': n, 'kernel_mlp_fwd': n,
            'kernel_mlp_bwd': n, 'corner_values': 0, 'warp_fwd': 2 * n,
            'warp_bwd': 2 * n})
    launches['sharded_step'] = {k: sum(w['launches'][k] for w in workers)
                                for k in workers[0]['launches']}
    print(f'  launches of the two workers: {launches["sharded_step"]}')
    del whole
    torch.cuda.empty_cache()
    print(f'[23] {time.perf_counter() - t_phase:.2f} s')

    # --- 24. train.main() --mesh: spawned ranks ----------------------------
    t_phase = time.perf_counter()
    shards, run = out / 'shards', out / 'run_mesh'
    every = 4
    # a data shard's device buffer holds capacity / 2: twice phase 11's
    # capacity gives each rank's 4 samples phase 11's 2^17 events
    argv = ['-d', device.type, '-bs', '8', '-mbs', '8', '-ne',
            str(MESH_STEPS), '--preprocessed-dataset-path', str(shards),
            '--checkpointing_interval', str(every), '--permanent_interval',
            str(every), '-vp', str(every), '--event-capacity',
            str(2 * capacity), '--mesh', 'data:2', '--device-queue-window',
            '0'] + RECIPE_FLAGS
    before = launch_counts()
    t0 = time.perf_counter()
    ranks = cli.main(['-m', str(run)] + argv)
    main_s = time.perf_counter() - t0
    if launch_counts() != before:
        raise AssertionError('[24] the launcher ran kernels itself')
    check_run_dir('[24]', run, ranks, MESH_STEPS, 8)
    scalars = read_scalars(run / 'log')
    losses = scalars.get('General/Train loss', [])
    val_losses = scalars.get('General/Validation loss', [])
    # validation at the start, every `every` steps and at the end
    if (len(losses) != MESH_STEPS
            or len(val_losses) != MESH_STEPS // every + 2
            or not np.isfinite(losses + val_losses).all()
            or 'Monitoring/GPU0/memory peak (GB)' not in scalars):
        raise AssertionError(f'[24] losses {losses}, validation '
                             f'{val_losses}, tags {sorted(scalars)}')
    launches['mesh_main'] = check_rank_launches('[24]', ranks, MESH_STEPS)
    print(f'[24] train.main() --mesh data:2 on {[r["device"] for r in ranks]}'
          f', {MESH_STEPS} production-recipe steps over phase 14\'s shards, '
          f'global batch 8, one step at a time (phase 30 (c) runs it in '
          f'windows): losses ' + ' '.join(f'{v:.5f}' for v in losses)
          + '; sharded validation ' + ' '.join(f'{v:.5f}' for v in val_losses)
          + f' (the sharded skip rule prints its skips above); '
          f'{main_s:.2f} s in all ({main_s / MESH_STEPS * 1e3:.1f} ms a step '
          'with the start of two processes, checkpoints and validation); '
          f'rank 0 alone wrote; card: {card}')
    print(f'  launches: {launches["mesh_main"]}')
    numbers['mesh_main_s'] = main_s

    # the event axis over the raw split: event rank 0 reads, both cut; one
    # window of `every` steps, eager in one call under gloo; run beside
    # the two resumes (every rank a process of its own)
    event_run = out / 'run_mesh_event'
    event_argv = ['-m', str(event_run), '-d', device.type, '-bs', '8',
                  '-mbs', '8', '-ne', str(every), '--checkpointing_interval',
                  str(every), '--permanent_interval', str(every), '-vp',
                  str(every), '--event-capacity', str(2 ** 18), '--mesh',
                  'data:1,event:2', '--device-queue-window',
                  str(every)] + RECIPE_FLAGS

    def event_main():
        t0 = time.perf_counter()
        return cli.main(event_argv), time.perf_counter() - t0

    ranks, main_s = resume_against('[24]', out, run, argv, MESH_STEPS,
                                   every, alongside=event_main)
    check_run_dir('[24] event axis', event_run, ranks, every, 8)
    launches['mesh_event_main'] = check_rank_launches('[24] event axis',
                                                      ranks, every)
    losses = read_scalars(event_run / 'log').get('General/Train loss', [])
    if len(losses) != every or not np.isfinite(losses).all():
        raise AssertionError(f'[24] event axis: losses {losses}')
    print(f'[24] train.main() --mesh data:1,event:2 over the raw split, '
          f'{every} steps in one window, each rank voxelizing half of '
          'each batch\'s '
          'events: losses ' + ' '.join(f'{v:.5f}' for v in losses)
          + f'; {main_s:.2f} s in all, beside the two resumes; launches '
          f'{launches["mesh_event_main"]}')
    print(f'[24] {time.perf_counter() - t_phase:.2f} s')

    # --- 25. two processes started with the multi-host flags -------------
    t_phase = time.perf_counter()
    run = out / 'run_hosts'
    address = f'127.0.0.1:{free_port()}'
    script = ('import json, sys\n'
              'from dvs_of_training_framework_tpu_torch import train\n'
              'print("RESULT", json.dumps(train.main(sys.argv[1:])))\n')
    argv = ['-m', str(run), '-d', device.type, '-bs', '8', '-mbs', '8',
            '-ne', str(HOSTS_STEPS), '--preprocessed-dataset-path',
            str(shards), '--checkpointing_interval', str(every),
            '--permanent_interval', str(every), '-vp', str(every),
            '--event-capacity', str(2 * capacity), '--timers', '--profiling',
            'JAX', '--coordinator-address', address, '--num-processes',
            '2'] + RECIPE_FLAGS
    t0 = time.perf_counter()
    outputs = run_ranks([[sys.executable, '-c', script] + argv
                         + ['--process-id', str(i)] for i in range(2)],
                        600, '[25]')
    hosts_s = time.perf_counter() - t0
    ranks = sorted((r for o in outputs for line in o.splitlines()
                    if line.startswith('RESULT ')
                    for r in json.loads(line[len('RESULT '):])),
                   key=lambda r: r['rank'])
    check_run_dir('[25]', run, ranks, HOSTS_STEPS, 8)
    launches['hosts_main'] = check_rank_launches('[25]', ranks, HOSTS_STEPS)
    lines = [line for line in outputs[0].splitlines()
             if line.startswith('rank=0 time (ms)')]
    if len(lines) != HOSTS_STEPS or any('time (ms)' in o
                                        for o in outputs[1:]):
        raise AssertionError(f'[25] timer lines {lines}')
    regions = {}
    for line in lines:
        for name, ms in re.findall(r'\| ([a-z_]+): ([\d.]+)', line):
            regions.setdefault(name, []).append(float(ms))
    traces = list((run / 'profiling').glob('trace.*.json'))
    text = traces[0].read_text() if len(traces) == 1 else ''
    missing = [k for k in TRACE_KERNELS if k not in text]
    scalars = read_scalars(run / 'log')
    monitor = sorted(t for t in scalars if t.startswith('Monitoring/'))
    if (len(traces) != 1 or traces[0].name != f'trace.{ranks[0]["pid"]}.json'
            or missing or 'Monitoring/GPU0/memory used (GB)' not in monitor
            or 'Monitoring/host/cpu percent' not in monitor):
        raise AssertionError(f'[25] traces {traces}, kernels missing from '
                             f'the trace {missing}, monitor tags {monitor}')
    backend = [line for o in outputs for line in o.splitlines()
               if line.startswith('torch.distributed:')]
    print(f'[25] two processes started with --coordinator-address {address}'
          f' --num-processes 2 --process-id 0/1 ({backend}), '
          f'{HOSTS_STEPS} recipe steps over phase 14\'s shards (strided '
          f'reads, ShardedBatchSkipper) with --timers --profiling JAX: '
          f'{hosts_s:.2f} s in all; the timer regions, median ms of steps '
          f'2-{HOSTS_STEPS}: ' + ', '.join(
              f'{name} {statistics.median(v[1:]):.3f}'
              for name, v in regions.items() if len(v) > 1)
          + f'; rank 0\'s trace {traces[0].name} '
          f'({traces[0].stat().st_size / 1e6:.1f} MB) holds '
          f'{", ".join(TRACE_KERNELS)}; monitor tags {monitor}; card: {card}')
    print(f'  launches: {launches["hosts_main"]}')
    numbers['hosts_regions_ms'] = {name: statistics.median(v[1:])
                                   for name, v in regions.items()
                                   if len(v) > 1}
    print(f'[25] {time.perf_counter() - t_phase:.2f} s')
    return launches, numbers



def merged_log(run, out_dir):
    """One event file of ``run``'s logs (the run's own, then the resume's,
    by name: the time each writer opened), as a log that appends across
    restarts holds them; returns its path and the resume's file."""
    from dvs_of_training_framework_tpu_torch.utils.tb import (read_records,
                                                             write_records)
    files = sorted(f for f in (run / 'log').glob('events.out.tfevents.*')
                   if f.suffix != '.monitor')   # the device monitor's own
    if len(files) != 2:
        raise AssertionError(f'[27] {run.name}: event files {files}')
    out_dir.mkdir()
    merged = out_dir / 'events.out.tfevents.0.merged'
    write_records(merged, [r for f in files for r in read_records(f)])
    return merged, files[1]


def border_slack(flows):
    """Per flow scale of one sample, (k, bound): the border term is the
    mean, over the pixels whose warp target ``(x + u) / ((W - 1) / 2) - 1``
    leaves [-1, 1] in x or y, of half their (x, y) Charbonnier pair.  The
    card divides by that scalar as a product with its reciprocal, one ulp
    from the CPU's quotient, so the k pixels within 8 ulps of the frame's
    edge may count on one and not the other, while the c pixels outside
    beyond doubt count on both.  Either mean then lies within k / (c + k)
    of the range of the values over those c + k pixels from the mean over
    the c alone: the two differ by at most that much."""
    from dvs_of_training_framework_tpu_torch.ops.charbonnier import \
        charbonnier_value
    out = []
    for flow in flows:
        flow = torch.from_numpy(flow[0])                  # [2, h, w]
        h, w = flow.shape[1:]
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32),
                                indexing='ij')
        grid = torch.stack([(xs + flow[0]) / ((w - 1) / 2.0) - 1.0,
                            (ys + flow[1]) / ((h - 1) / 2.0) - 1.0])
        near = ((grid.abs() - 1).abs() <= 8 * 2.0 ** -23).any(dim=0)
        sure = ((grid < -1) | (grid > 1)).any(dim=0) & ~near
        value = charbonnier_value(flow, 0.45, 1e-3).sum(dim=0) / 2
        k, c = int(near.sum()), int(sure.sum())
        both = value[near | sure]
        out.append((k, k / (c + k) * float(both.max() - both.min())
                    if k else 0.0))
    return out


def run_tool(label, fn, *args):
    """``fn(*args)`` with its standard output captured; prints and returns
    its lines and its seconds."""
    import contextlib
    import io
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        value = fn(*args)
    seconds = time.perf_counter() - t0
    lines = text.getvalue().splitlines()
    print(f'[27] {label} ({seconds:.2f} s):')
    for line in lines:
        print(f'    {line}')
    return lines, seconds, value


def visualize_phases(out, capacity, device, card, counters):
    """Phases 26 and 27 over the sets, runs and evaluations of phases 14,
    15 and 18 in ``out``; returns the launch counts of the two visualize
    runs and the numbers of the visualize JSON line."""
    from dvs_of_training_framework_tpu_torch import visualize as vis_cli
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.data.dataloader import (
        get_dataloader, get_valset_params)
    from dvs_of_training_framework_tpu_torch.data.dataset import read_info
    from dvs_of_training_framework_tpu_torch.losses import (MultiScaleLoss,
                                                            combined_loss)
    from dvs_of_training_framework_tpu_torch.models import (init_model,
                                                            load_vis_flow)
    from dvs_of_training_framework_tpu_torch.tools import (
        aee_table, fix_events, make_info, oracle_flow_baseline,
        profile_dataset, zero_flow_baseline)
    from dvs_of_training_framework_tpu_torch.train import flow_shapes
    from dvs_of_training_framework_tpu_torch.utils.tb import read_events
    from dvs_of_training_framework_tpu_torch.utils.visualization import \
        read_png
    launches, numbers = {}, {}
    only_forward = ('voxelize_fwd', 'kernel_mlp_fwd')

    def forward_counts(label, counts, n):
        if any(counts[k] != (n if k in only_forward else 0) for k in counts):
            raise AssertionError(f'{label}: launches {counts}, expected '
                                 f'{n} of K1 and K2 forward and no other')

    # --- 26. the visualize CLI: EVFlowNet at full width, then sequences ----
    t_phase = time.perf_counter()
    checkpoint = out / 'run' / f'step_{MAIN_STEPS}.ckpt'
    # the CLI writes under <repo>/visualization/<name of -m>/<stem of -sp>
    name = f'chip_smoke_{os.getpid()}'
    output = REPO / 'visualization' / name / checkpoint.stem
    argv = ['-m', str(out / name), '-sp', str(checkpoint), '-d',
            device.type, '--event-capacity', str(capacity)]
    bf16 = ['--precision', 'bfloat16']
    rendered = []
    render = vis_cli.visualize

    def recording(*a):          # what the CLI renders: batch, loss, parts,
        rendered.append(a[1:4] + (a[5],))        # and the prediction
        return render(*a)

    try:
        vis_cli.visualize = recording
        reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            record = vis_cli.main(argv + bf16)
        finally:
            vis_cli.visualize = render
        wall = time.perf_counter() - t0
        counts = read_counts(counters)
        launches['visualize'] = counts
        n = record['panels']
        print(f'[26] visualize.main() --precision bfloat16, EVFlowNet (base '
              f'64, depth 9, 256x256) with phase 14\'s step-{MAIN_STEPS} '
              f'checkpoint over its validation split: {n} panels in '
              f'{wall:.2f} s ({record["existing"]} done before, '
              f'{record["oversized"]} over capacity {capacity}), '
              f'{os.cpu_count()} writers')
        print(f'  launches: {counts}')
        if n < 8 or record['existing'] or record['oversized']:
            raise AssertionError(f'[26] visualize: {record}')
        forward_counts('[26] visualize', counts, n)
        split = {k: v / n for k, v in record['seconds'].items()}
        print(f'  seconds a panel: {wall / n:.4f} in all; the reader '
              f'{split["read"]:.4f}, the device (upload, forward, loss, '
              f'fetch) {split["device"]:.4f}, rendering '
              f'{split["render"]:.4f}, the writers (handing over, and the '
              f'wait for them at the end) {split["write"]:.4f}; card: {card}')

        # every panel read back with the port's reader; the first two
        # rendered again on the host from the card's flows and loss terms
        vis_args = vis_cli.parse_args(argv + bf16)
        vis_flow = load_vis_flow(vis_args.flownet_path)
        # the banner, the two frames, the finest flow over the coarser ones
        H, W = vis_args.shape
        shape = (vis_cli.BANNER_ROWS + H + H + H // 2, 2 * W, 3)
        for i in range(n):
            png = read_png(output / f'{i:04d}.png')
            stats = json.loads((output / f'{i:04d}.yml').read_text())
            if png.shape != shape or not np.isfinite(
                    [stats['loss']] + stats['photometric']).all():
                raise AssertionError(f'[26] panel {i}: {png.shape}, {stats}')
            if i < 2:
                batch, loss, parts, prediction = rendered[i]
                panel, again = vis_cli.visualize(
                    vis_args, batch, loss, parts, vis_args.loss_weights,
                    prediction, vis_flow)
                if not (np.array_equal(panel[..., ::-1], png)
                        and again == stats):
                    raise AssertionError(f'[26] panel {i} differs from its '
                                         'rendering on the host')
        print(f'[26] the {n} PNGs read back with utils/visualization.'
              f'read_png, {shape} each; the first two equal, bit for '
              'bit, their rendering on the host from the card\'s flows and '
              'loss terms')

        # a second pass: every panel is done, nothing runs
        reset(counters)
        again = vis_cli.main(argv + bf16, num_writers=1)
        counts = read_counts(counters)
        if again['panels'] or again['existing'] != n or any(
                counts.values()):
            raise AssertionError(f'[26] second pass: {again}, {counts}')
        print(f'[26] a second visualize.main() skips all {n} panels, no '
              'kernel launched')
    finally:
        shutil.rmtree(REPO / 'visualization' / name, ignore_errors=True)

    # the card against the CPU on the first two batches, fp32 (TF32 off):
    # every flow as phase 15 holds the evaluation CLI's (rtol 1e-4), and
    # the loss, smoothness and photometric terms, which follow the flows,
    # at the same rtol; then every term recomputed on the CPU from the
    # card's flows, at tests/test_torch_loss.py's loss rtol 1e-5, the
    # border term besides within what its edge values explain
    # (``border_slack``)
    args = vis_cli.parse_args(argv)
    args.mbs = 1
    batches = iter(get_dataloader(get_valset_params(args)))
    try:
        host = [next(batches) for _ in range(2)]
    finally:
        batches.close()
    evaluator = MultiScaleLoss(flow_shapes(args.shape))
    held = []
    for dev in (device, torch.device('cpu')):
        model = init_model(args, dev)
        held.append([vis_cli.visualize_batch(args, model, evaluator, b, dev,
                                             vis_flow) for b in host])
    print('[26] two batches through visualize_batch, fp32, card against '
          'CPU, the same weights:')
    gap = 0.0
    terms = ('smoothness', 'photometric', 'border')
    for j, ((_, s_card, p_card), (_, s_cpu, p_cpu)) in enumerate(
            zip(*held)):
        for key in ('loss',) + terms[:2]:
            check_close(f'batch {j} {key}', torch.tensor(s_card[key]),
                        torch.tensor(s_cpu[key]), 1e-4, 0.0)
        for g, w, bf in zip(p_card['prediction'], p_cpu['prediction'],
                            rendered[j][3]['prediction']):
            scale = float(np.abs(w).max())
            check_close(f'batch {j} {g.shape[2]}x{g.shape[3]} flow',
                        torch.from_numpy(g), torch.from_numpy(w), 1e-4,
                        1e-4 * scale)
            gap = max(gap, float(np.abs(bf - w).max()) / scale)
        cpu_batch = pad_batch(host[j], args.event_capacity).to('cpu')
        loss, again = combined_loss(
            evaluator, [torch.from_numpy(f) for f in p_card['prediction']],
            torch.from_numpy(p_card['flow_ts']),
            torch.from_numpy(p_card['flow_sample_idx']), cpu_batch.images,
            cpu_batch.timestamps, cpu_batch.sample_idx,
            weights=tuple(args.loss_weights))
        check_close(f'batch {j} loss from the card\'s flows on the CPU',
                    torch.tensor(s_card['loss']), loss, 1e-5, 0.0)
        for key, values in zip(terms[:2], again):
            check_close(f'batch {j} {key} from the card\'s flows on the CPU',
                        torch.tensor(s_card[key]), torch.stack(values),
                        1e-5, 0.0)
        slack = border_slack(p_card['prediction'])
        got, want = np.array(s_card['border']), torch.stack(
            again[2]).numpy()
        print(f'  batch {j} border from the card\'s flows on the CPU: '
              f'{got} against {want}; values within 8 ulps of the frame\'s '
              f'edge a scale {[k for k, _ in slack]}, slack '
              f'{[f"{b:.2e}" for _, b in slack]}')
        if (np.abs(got - want) > 1e-5 * np.abs(want)
                + np.array([b for _, b in slack])).any():
            raise AssertionError(f'[26] batch {j}: border terms differ by '
                                 'more than their edge pixels explain')
    print(f'  the bf16 run\'s flows against the fp32 CPU flows: largest '
          f'difference {gap:.3e} of the flow\'s largest value (not bounded)')

    # the device time of one forward and loss at batch 1, each precision,
    # and the host's time of visualize_batch's two parts on a warm card
    batch = pad_batch(host[0], capacity).to(device)
    for label, extra in (('fp32', []), ('bf16', bf16)):
        timed_args = vis_cli.parse_args(argv + extra)
        model = init_model(timed_args, device)
        warm = {'device': 0.0, 'render': 0.0}
        vis_cli.visualize_batch(timed_args, model, evaluator, host[0],
                                device, vis_flow)
        for b in host * 4:
            vis_cli.visualize_batch(timed_args, model, evaluator, b, device,
                                    vis_flow, warm)
        numbers[f'warm_{label}_ms'] = {k: v / 8 * 1e3
                                       for k, v in warm.items()}

        def forward_and_loss():
            with torch.inference_mode():
                flows, flow_ts, flow_idx, _ = model(
                    batch.events, batch.timestamps, batch.sample_idx,
                    tuple(batch.images.shape[-2:]), intermediate=True)
                return combined_loss(evaluator, flows, flow_ts, flow_idx,
                                     batch.images, batch.timestamps,
                                     batch.sample_idx)

        numbers[f'forward_loss_{label}_ms'] = device_ms(forward_and_loss)
    print(f'[26] one forward (intermediate features) and loss at batch 1, '
          f'device time: fp32 {numbers["forward_loss_fp32_ms"]:.3f} ms, '
          f'bf16 {numbers["forward_loss_bf16_ms"]:.3f} ms; visualize_batch '
          'on a warm card, host ms a batch (mean of 8): ' + '; '.join(
              f'{label} device {numbers[f"warm_{label}_ms"]["device"]:.3f},'
              f' rendering {numbers[f"warm_{label}_ms"]["render"]:.3f}'
              for label in ('fp32', 'bf16')) + f'; card: {card}')
    numbers.update(panels=n, seconds_a_panel=wall / n,
                   split_a_panel=split, writers=os.cpu_count())
    del model, batch, held
    torch.cuda.empty_cache()

    # RecurrentFlowNet on 2-element samples at prefix 1: three elements of
    # the validation split give two samples
    pairs = out / 'vis_pairs'
    (pairs / 'outdoor_day1').mkdir(parents=True)
    val = Path(os.environ['DVS_DATA_PATH']) / 'outdoor_day1'
    for f in sorted(val.glob('*.hdf5'), key=lambda p: int(p.stem))[:3]:
        (pairs / 'outdoor_day1' / f.name).symlink_to(f.resolve())
    name = f'chip_smoke_pairs_{os.getpid()}'
    recurrent = out / 'run_recurrent' / f'step_{MAIN_STEPS}.ckpt'
    output = REPO / 'visualization' / name / recurrent.stem
    data_path = os.environ['DVS_DATA_PATH']
    os.environ['DVS_DATA_PATH'] = str(pairs)
    reset(counters)
    try:
        record = vis_cli.main(
            ['-m', str(out / name), '-sp', str(recurrent), '-d', device.type,
             '--flownet_path', 'RecurrentFlowNet', '--min-sequence-length',
             '2', '--max-sequence-length', '2', '--prefix-length', '1',
             '--event-capacity', str(capacity)] + bf16, num_writers=2)
        counts = read_counts(counters)
        launches['recurrent_visualize'] = counts
        shapes = [read_png(output / f'{i:04d}.png').shape for i in range(2)]
    finally:
        os.environ['DVS_DATA_PATH'] = data_path
        shutil.rmtree(REPO / 'visualization' / name, ignore_errors=True)
    print(f'[26] visualize.main() --flownet_path RecurrentFlowNet, 2-element '
          f'samples at prefix 1, phase 18\'s step-{MAIN_STEPS} checkpoint: '
          f'{record["panels"]} panels {shapes}; launches: {counts}')
    if record['panels'] != 2 or shapes != [shape[:1] + (3 * W, 3)] * 2:
        raise AssertionError(f'[26] RecurrentFlowNet: {record}, {shapes}')
    forward_counts('[26] RecurrentFlowNet', counts, 2)
    if REPO.joinpath('visualization').is_dir() and not any(
            REPO.joinpath('visualization').iterdir()):
        REPO.joinpath('visualization').rmdir()
    print(f'[26] {time.perf_counter() - t_phase:.2f} s')

    # --- 27. the tools on the card's machine -----------------------------
    t_phase = time.perf_counter()
    configs = REPO / 'dvs_of_training_framework_tpu_torch' / 'config'
    testing = ['--test-config', str(configs / 'synth_testing.json')]
    for key, label, tool in (
            ('zero_aee', 'zero-flow baseline', zero_flow_baseline),
            ('oracle_aee', 'constant-flow oracle', oracle_flow_baseline)):
        lines, _, _ = run_tool(f'{label}, phase 14\'s test split', tool.main,
                               testing)
        aees = [float(re.search(r'AEE=([-\d.naif]+) px', line)[1])
                for line in lines]
        if len(aees) != 3 or not np.isfinite(aees).all():
            raise AssertionError(f'[27] {label}: {lines}')
        numbers[key] = aees
    lines, _, _ = run_tool('aee_table over phase 15\'s live and EMA pickles',
                           aee_table.main, [str(out / 'eval'), '--median'])
    rows = [line.split(' | ')[0] for line in lines
            if line.startswith('| step ')]
    if rows != [f'| step {MAIN_STEPS}', f'| step {MAIN_STEPS} EMA']:
        raise AssertionError(f'[27] aee_table: rows {rows}')

    # phase 18's first resume: its log holds the run's file and the
    # resume's; merged into one, as a log appended across restarts
    merged, resumed = merged_log(out / 'run_recurrent_resume0',
                                 out / 'merged_log')
    before = len(read_events(merged))
    run_tool('fix_events over phase 18\'s resumed run, its two event '
             'files merged', fix_events.main, [str(merged.parent)])
    after = read_events(merged)
    latest = {(tag, e['step']): v for e in read_events(resumed)
              for tag, v in e['scalars'].items()}
    by_tag = {}
    for e in after:
        for tag, v in e['scalars'].items():
            by_tag.setdefault(tag, []).append(e['step'])
            if (tag, e['step']) in latest and latest[tag, e['step']] != v:
                raise AssertionError(f'[27] fix_events kept a stale {tag} '
                                     f'at step {e["step"]}')
    if (len(after) >= before or not all(
            b > a for steps in by_tag.values()
            for a, b in zip(steps, steps[1:]))):
        raise AssertionError(f'[27] fix_events: {before} -> {len(after)} '
                             'records, steps not strictly increasing')
    print(f'  {before} -> {len(after)} records; {len(by_tag)} tags, each '
          'with strictly increasing steps; the resume\'s values kept')

    _, _, us = run_tool(
        'profile_dataset over phase 14\'s shards, -mbs 8',
        profile_dataset.main, profile_dataset.parse_args(
            ['--preprocessed-dataset-path', str(out / 'shards'), '-mbs',
             '8', '--start', '2', '--num-iters', '8']))
    numbers['profile_dataset_us'] = us
    root = Path(os.environ['DVS_DATA_ROOT'])
    run_tool('make_info over phase 14\'s raw sequences', make_info.main,
             root / 'raw' / 'synth', out / 'info_check' / 'synth.hdf5')
    made = read_info(str(out / 'info_check' / 'synth.hdf5'))
    want = read_info(str(root / 'info' / 'synth.hdf5'))
    if made != want:
        raise AssertionError(f'[27] make_info: {made}, the simulator\'s '
                             f'{want}')
    print(f'  read_info of it equals the simulator\'s info file: {made}')
    print(f'[27] {time.perf_counter() - t_phase:.2f} s')
    return launches, numbers


def accuracy_phase(out):
    """Phase 28: the three accuracy scripts as subprocesses over phase
    14's layout and shards in ``out``; returns the launch counts of their children
    and the numbers of the accuracy JSON line."""
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer
    t_phase = time.perf_counter()
    scripts = REPO / 'dvs_of_training_framework_tpu_torch' / 'scripts'
    layout, shards, run = out / 'synth', out / 'shards', out / 'acc_run'
    site, probes = out / 'acc_site', out / 'acc_probes'
    site.mkdir()
    probes.mkdir()
    # every python child of the scripts writes what it ran, launched and
    # loaded into PROBE_DIR
    shutil.copy(REPO / 'tests' / 'child_probe.py', site / 'sitecustomize.py')
    # the scripts' `python` is this interpreter
    (site / 'python').write_text(f'#!/bin/sh\nexec {sys.executable} "$@"\n')
    (site / 'python').chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if k not in ('DVS_DATA_PATH', 'DVS_DATA_ROOT', 'PYTHONPATH')}
    env.update(PYTHONPATH=str(site), PROBE_DIR=str(probes),
               PROBE_REPO=str(REPO), PATH=f'{site}:{env["PATH"]}',
               LAYOUT=str(layout), SHARDS=str(shards))
    seconds, children = {}, {}

    def script(label, name, args, **extra):
        before = set(probes.iterdir())
        t0 = time.perf_counter()
        output, = run_ranks([['bash', str(scripts / name), *map(str, args)]],
                            ACCURACY_LIMIT, f'[28] {label}',
                            env=dict(env, **extra))
        seconds[label] = time.perf_counter() - t0
        children[label] = [json.loads(p.read_text()) for p in
                           sorted(set(probes.iterdir()) - before)]
        print(f'[28] {label}: {name} {" ".join(map(str, args))} '
              f'({seconds[label]:.2f} s), children: ' + ', '.join(
                  Path(c['argv'][0]).stem for c in children[label]))
        return output

    cut = {flag.lstrip('-').split('-')[0].upper() + '_SECS': f'{secs:g}'
           for flag, secs, _ in SYNTH_CUTS}
    # over phase 14's layout and shards (their --samples-per-file, so the
    # arguments match; the script runs from the checkout, this process
    # maybe not, so the revisions may not): every step of prep finds its
    # output and skips
    shard_times = {p: p.stat().st_mtime_ns for p in shards.glob('*.hdf5')}
    script('prep', 'prep_accuracy_varied.sh', [layout],
           SIZE=str(SHARD_SAMPLES),
           PREP_ARGS='--samples-per-file 32 --allow-obsolete-code', **cut)
    ran = [Path(c['argv'][0]).stem for c in children['prep']]
    now = {p: p.stat().st_mtime_ns for p in shards.glob('*.hdf5')}
    if ran != ['prepare_batches'] or not shard_times or now != shard_times:
        raise AssertionError(f'[28] prep over phase 14\'s layout ran {ran}; '
                             f'shards {shard_times} then {now}')

    # windows of 4, which divide the resume's step: graph replays
    recipe = ['--precision', 'bfloat16', '--loss-precision', 'bf16x2',
              '--grad-clip-norm', '1.0', '--device-queue-window',
              str(ACCURACY_EVERY)]
    first, last = ACCURACY_STEPS
    script(f'run to {first}', 'run_accuracy_varied.sh', [run, *recipe],
           STEPS=str(first))
    script(f'run to {last}', 'run_accuracy_varied.sh',
           [run, *recipe, '-vp', str(ACCURACY_EVERY)], STEPS=str(last),
           SKIP_VALIDATION='0')
    kept = Serializer(run).list_known_steps()
    passed = int(Serializer(run).read_state_dict(last)['samples_passed'])
    if kept != [0, first, last] or passed != last * 8:
        raise AssertionError(f'[28] checkpoints {kept}, samples at step '
                             f'{last}: {passed}')
    train_launches = []
    for label, steps in ((f'run to {first}', first),
                         (f'run to {last}', last - first)):
        child, = children[label]
        # and one step before the graph's capture
        train_launches.append(check_rank_launches(
            f'[28] {label}', [{'rank': 0, 'launches': child['launches']}],
            steps + 1))
    print(f'  checkpoints {kept}; K1, K2 and the fused warp in both '
          f'training children, the second resumed at step {first}: '
          f'{train_launches}')

    output = script('eval', 'eval_accuracy_varied.sh', [run, out / 'acc'])
    rows = {}
    for matrix in ('val', 'eval'):
        pickles = [out / f'acc_{matrix}' / f'step_{s}.pkl' for s in kept]
        if sorted((out / f'acc_{matrix}').glob('*.pkl')) != sorted(pickles):
            raise AssertionError(f'[28] {matrix} pickles {pickles}')
        for p in pickles:
            aees = [r.mAEE for r in pickle.loads(p.read_bytes())]
            if not aees or not np.isfinite(aees).all():
                raise AssertionError(f'[28] {p}: mean AEE {aees}')
        table = output.split(f'### {out}/acc_{matrix}\n')[1].splitlines()
        rows[matrix] = table[:len(kept)]
        if [r.split(' | ')[0] for r in rows[matrix]] != [
                f'| step {s}' for s in kept]:
            raise AssertionError(f'[28] aee_table: {output}')
        print(f'  {matrix}: ' + '; '.join(rows[matrix]))
    evaluated = [c['launches'] for c in children['eval']
                 if c['launches'] is not None]
    if len(evaluated) != 2 or any(
            n['voxelize_fwd'] == 0 or n['kernel_mlp_fwd'] != n['voxelize_fwd']
            or sum(n.values()) != 2 * n['voxelize_fwd'] for n in evaluated):
        raise AssertionError(f'[28] the evaluation children launched '
                             f'{evaluated}')

    records = [c for label in children for c in children[label]]
    foreign = {Path(c['argv'][0]).stem: c['foreign'] for c in records
               if c['foreign']}
    if foreign:
        raise AssertionError(f'[28] children loaded JAX-side modules or '
                             f'modules from outside the port: {foreign}')
    launches = {k: sum(c['launches'][k] for c in records
                       if c['launches'] is not None)
                for k in train_launches[0]}
    print(f'  {len(records)} children, none loaded JAX or a module outside '
          f'the port; launches {launches}')
    print(f'[28] {time.perf_counter() - t_phase:.2f} s')
    return launches, {'seconds': seconds, 'checkpoints': kept,
                      'train_launches': train_launches,
                      'eval_launches': evaluated, 'rows': rows}


class ListLog:
    """A SummaryWriter that keeps its scalars in a list."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass

    def close(self):
        pass


def host_launches(events):
    """CUDA runtime calls that put work on the card (kernel and graph
    launches, copies, memsets) among the profiler's host events."""
    names = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaGraphLaunch',
             'cudaMemcpyAsync', 'cudaMemsetAsync')
    return sum(e.count for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith(names))


def window_runs(step, state, windows, rounds):
    """``rounds`` windows through ``step(state, window) -> list of loss
    tensors``; returns the host seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(rounds):
        step(state, windows[i % len(windows)])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def window_ways(tag, config, evaluator, build, windows, counters, card):
    """The staged ``windows`` (each of K bench batches) as K eager steps a
    window and as one CUDA graph replay a window, from the same bench
    weights of ``config`` and WINDOW_ARGS' optimizer: ``build(mode,
    model, optimizer)`` gives the eager mode's per-slot step or the graph
    mode's fused window step.  Checks the losses, the parameters and the
    optimizer state bit for bit, and the launches (the capture's warm-up
    step, then what the capture recorded at each replay); times both ways
    in turns and traces a window of each (device busy and ops, host
    launches, NCCL's kernels); returns the two runs, the numbers and the
    graph run's launches."""
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, create_train_state)
    device = windows[0].storage.device
    K = windows[0].window
    runs = {}
    for mode in ('eager', 'graph'):
        model = bench_model(config, device)
        optimizer = construct_optimizer(WINDOW_ARGS, model)
        state = create_train_state()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset(counters)
        one = build(mode, model, optimizer)
        if mode == 'eager':
            def step(st, window, one=one):
                return [one(st, window)[1][0] for _ in range(K)]
            losses = [v for w in windows for v in step(state, w)]
            first_s, graph = None, None
        else:
            def step(st, window, fused=one):
                return [fused(st, window)[1][0]]
            t0 = time.perf_counter()
            losses = step(state, windows[0])
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            losses += step(state, windows[1])
            graph, = one.graphs.values()
        torch.cuda.synchronize()
        counts = read_counts(counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[mode] = SimpleNamespace(
            model=model, optimizer=optimizer, state=state, step=step,
            graph=graph, first_s=first_s, peak=peak, counts=counts,
            losses=torch.cat([v.reshape(-1) for v in losses]).cpu(),
            params=clone_tree(model.state_dict()),
            opt=flat_state(clone_tree(optimizer.state_dict())))
    eager, graph = runs['eager'], runs['graph']
    n = len(windows) * K
    bad = [k for k in eager.params
           if not bits_equal(graph.params[k], eager.params[k])]
    bad += [k for k in eager.opt
            if not bits_equal(graph.opt[k], eager.opt[k])]
    n_equal = int((graph.losses.view(torch.int32)
                   == eager.losses.view(torch.int32)).sum())
    print(f'{tag} {config}: {n} steps as {n} eager steps and as '
          f'{len(windows)} replays of one captured graph: {n_equal}/{n} '
          f'losses, '
          f'{len(eager.params) - len([k for k in bad if k in eager.params])}'
          f'/{len(eager.params)} parameters and the optimizer state '
          f'({len(eager.opt)} entries: moments, slow weights, EMA, '
          f'counts) equal bit for bit; losses '
          + ' '.join(f'{v:.5f}' for v in graph.losses.tolist()[:4])
          + ' ..')
    if bad or n_equal != n or graph.state.step != n:
        raise AssertionError(f'{tag} {config}: the graph replay differs '
                             f'from the eager steps: {bad[:5]}, '
                             f'{n_equal} losses equal')
    # the graph run: one warm-up step before the capture, then the
    # windows; a replay counts what the capture recorded
    want = {k: c + c // n for k, c in eager.counts.items()}
    print(f'  launches: eager {eager.counts}; graph {graph.counts} (the '
          'capture\'s warm-up step, then each replay counts what the '
          f'capture recorded: {graph.graph.launches})')
    if graph.counts != want or not all(
            graph.graph.launches[k] == c // len(windows)
            for k, c in eager.counts.items()):
        raise AssertionError(f'{tag} {config}: graph launches '
                             f'{graph.counts}, expected {want}')

    # ms a step each way, in turns, on the windows already staged
    seconds = {'eager': [], 'graph': []}
    for mode in ('eager', 'graph', 'eager', 'graph'):
        r = runs[mode]
        rounds = 1 if mode == 'eager' else 2
        seconds[mode].append(window_runs(r.step, r.state, windows,
                                         rounds) / (rounds * K))
    ms = {m: 1e3 * statistics.mean(v) for m, v in seconds.items()}
    # one window traced each way; the graph's up to three times, until
    # the trace holds every kernel the counters say a replay launches:
    # the profiler can drop a device event of a graph (one of 16 K2
    # forwards in every try of one run)
    traced = {}
    g = graph.graph
    for mode, tries in (('eager', 1), ('graph', 3)):
        r = runs[mode]
        for _ in range(tries):
            with profile() as prof:
                r.step(r.state, windows[0])
                torch.cuda.synchronize()
            events = prof.key_averages()
            ops = device_ops(events)
            kernels = {k: sum(e.count for e in ops if name in e.key)
                       for k, name in TRACE_KERNEL_OF.items()}
            if all(kernels[k] == g.launches[k] for k in kernels):
                break
        nccl = [e for e in ops if 'nccl' in e.key.lower()]
        traced[mode] = SimpleNamespace(
            busy=sum(e.device_time_total for e in ops) / 1e3 / K,
            ops=sum(e.count for e in ops) / K,
            host=host_launches(events) / K, kernels=kernels,
            nccl_ms=sum(e.device_time_total for e in nccl) / 1e3 / K,
            nccl_ops=sum(e.count for e in nccl) / K)
    print(f'{tag} {config} step, eager against one graph replay a window '
          f'of {K} (staged windows, timed in turns, eager 1 + 1 windows, '
          f'graph 2 + 2):')
    for mode in ('eager', 'graph'):
        t = traced[mode]
        idle = 100 * (1 - t.busy / ms[mode]) if t.busy else float('nan')
        print(f'  {mode}: {ms[mode]:.3f} ms a step; device busy '
              f'{t.busy:.3f} ms a step in {t.ops:g} device ops, '
              f'{idle:.1f}% idle; {t.host:g} host launches a step '
              f'(kernel and graph launches, copies, memsets); NCCL\'s '
              f'kernels {t.nccl_ms:.4f} ms a step in {t.nccl_ops:g} ops ('
              f'{100 * t.nccl_ms / t.busy if t.busy else 0:.2f}% of the '
              f'busy time); peak memory {runs[mode].peak:.3f} GiB; card: '
              f'{card}')
    print(f'  graph: warm-up and capture {graph.first_s:.2f} s with the '
          f'first replay (capture alone {g.capture_s:.2f} s), '
          f'{g.replays} replays')
    inside = traced['graph'].kernels
    if sum(inside.values()):
        print('  kernels inside one replay, by the profiler: '
              + ', '.join(f'{k} {c}' for k, c in inside.items())
              + f'; by the launch counters: {g.launches}')
        # every kernel the replay launches shows in its trace, none
        # more often than the counters say
        if any(not 0 < inside[k] <= g.launches[k] if g.launches[k]
               else inside[k] for k in inside):
            raise AssertionError(f'{tag} {config}: the profiler sees '
                                 f'{inside} in a replay, the counters '
                                 f'{g.launches}')
    else:
        print('  the profiler shows no kernel inside a replay: the '
              f'launch counters stand for it, {g.launches}')
    numbers = {
        'ms': ms, 'busy_ms': {m: traced[m].busy for m in traced},
        'device_ops': {m: traced[m].ops for m in traced},
        'host_launches': {m: traced[m].host for m in traced},
        'nccl_ms': {m: traced[m].nccl_ms for m in traced},
        'peak_gib': {m: runs[m].peak for m in runs},
        'capture_s': g.capture_s, 'first_call_s': graph.first_s,
        'replay_kernels': inside}
    return runs, numbers, graph.counts


def window_phase(out, collated, capacity, device, card, counters, shapes):
    """Phase 29: the device queue's windows at the bench shape, each window
    of WINDOW training steps as eager steps and as one CUDA graph replay,
    golden and recipe, then windowed validation and a windowed resume
    through ``run()``; returns the launch counts of the recipe's graph
    run and the phase's numbers."""
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.data.device_queue import \
        stack_batches
    from dvs_of_training_framework_tpu_torch.losses import (LOSS_PRECISIONS,
                                                            MultiScaleLoss)
    from dvs_of_training_framework_tpu_torch.training import (
        make_eval_step, make_fused_eval_step, make_fused_window_step,
        make_train_step)
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer
    from dvs_of_training_framework_tpu_torch.training.train import (
        validate, validate_windowed)
    from dvs_of_training_framework_tpu_torch.utils.tb import SummaryWriter

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    K = WINDOW
    host = [pad_batch(c, capacity) for c in collated]
    windows = [stack_batches([host[(w * K + i) % len(host)]
                              for i in range(K)], pin=True).to(device)
               for w in range(2)]
    print(f'[29] the device queue at the bench shape: windows of {K} bench '
          f'batches ({windows[0].storage.numel() / 2 ** 20:.1f} MiB each, '
          f'one upload), RANGER with the clip and the EMA, the '
          f'representation group from step {WINDOW_ARGS.training_steps // 2}'
          f', cudnn.deterministic; card: {card}')
    numbers, launches = {}, None
    for config in ('golden', 'recipe'):
        evaluator = MultiScaleLoss(
            shapes, bf16x2=LOSS_PRECISIONS[CONFIGS[config][1]])

        def build(mode, model, optimizer):
            if mode == 'eager':
                return make_train_step(model, evaluator, optimizer,
                                       LOSS_WEIGHTS, 1, window=K)
            return make_fused_window_step(model, evaluator, optimizer,
                                          LOSS_WEIGHTS, 1, K)

        runs, numbers[config], counts = window_ways(
            '[29]', config, evaluator, build, windows, counters, card)
        if config == 'recipe':
            launches = counts

        # --- validation: one window of the first 8 batches, then 2 + 6
        # repeats; against one batch at a time, on the trained weights
        if config == 'recipe':
            model = runs['graph'].model
            val = collated[:10]
            logs = {'windowed': ListLog(), 'per batch': ListLog()}
            tags = cli.shapes2tags(shapes)
            fused_eval = make_fused_eval_step(model, evaluator, LOSS_WEIGHTS,
                                              VAL_WINDOW)
            t0 = time.perf_counter()
            got = validate_windowed(fused_eval, val, 0, logs['windowed'],
                                    tags, VAL_WINDOW, device,
                                    event_capacity=capacity)
            first_s = time.perf_counter() - t0
            times = {}
            for mode in ('per batch', 'windowed', 'per batch', 'windowed'):
                t0 = time.perf_counter()
                if mode == 'windowed':
                    validate_windowed(fused_eval, val, 0, ListLog(), tags,
                                      VAL_WINDOW, device,
                                      event_capacity=capacity)
                else:
                    want = validate(make_eval_step(model, evaluator,
                                                   LOSS_WEIGHTS),
                                    val, 0, logs['per batch'], tags, device,
                                    event_capacity=capacity)
                times.setdefault(mode, []).append(time.perf_counter() - t0)
            if got != want or logs['windowed'].scalars != \
                    logs['per batch'].scalars[:len(logs['windowed'].scalars)]:
                raise AssertionError(f'[29] validate_windowed {got!r} against '
                                     f'validate {want!r}')
            print(f'[29] validate_windowed ({len(val)} bench batches, windows '
                  f'of {VAL_WINDOW}) equals validate bit for bit: loss '
                  f'{got:.7f} and {len(logs["windowed"].scalars)} scalars; '
                  f'{statistics.mean(times["windowed"]):.3f} s a pass '
                  f'against {statistics.mean(times["per batch"]):.3f} s (the '
                  f'first windowed pass, with its captures, {first_s:.2f} s); '
                  f'card: {card}')
            numbers['validation_s'] = {m: statistics.mean(v)
                                       for m, v in times.items()}
        for r in runs.values():
            del r.model, r.optimizer, r.state, r.step, r.graph
        del runs
        torch.cuda.empty_cache()

    # --- the windowed resume through run(): 2 windows of 16, checkpoints
    # and validation at each; a copy cut back to the first resumes
    B = collated[0]['size']

    def stream(samples_passed):
        i = samples_passed // B
        while True:
            yield collated[i % len(collated)]
            i += 1

    steps = 2 * K
    run_dir = out / 'window_run'
    run_dir.mkdir()

    def run_args(path):
        return cli.parse_args(
            ['-m', str(path), '-d', 'cuda', '--height', '256', '--width',
             '256', '-bs', str(B), '-mbs', str(B), '-ne', str(steps),
             '--checkpointing_interval', str(K), '-vp', str(K),
             '--permanent_interval', str(K), '--validation-window', '2',
             '--event-capacity', str(capacity)] + RECIPE_FLAGS)

    t0 = time.perf_counter()
    cli.run(run_args(run_dir), stream, lambda: collated[:2],
            SummaryWriter(run_dir / 'log'))
    run_s = time.perf_counter() - t0
    copy_dir = out / 'window_run_resumed'
    shutil.copytree(run_dir, copy_dir)
    (copy_dir / f'step_{steps}.ckpt').unlink()
    cli.run(run_args(copy_dir), stream, lambda: collated[:2],
            SummaryWriter(copy_dir / 'log'))
    whole, resumed = (flat_state({k: Serializer(d).read_state_dict(steps)[k]
                                  for k in ('model', 'optimizer')})
                      for d in (run_dir, copy_dir))
    bad = [k for k in whole if k not in resumed
           or not bits_equal(resumed[k], whole[k])]
    print(f'[29] run() with --device-queue-window {K}: {steps} recipe steps '
          f'({run_s:.2f} s), checkpoints and validation every {K}; a copy '
          f'cut back to step {K} resumes to {steps}: {len(whole) - len(bad)}'
          f'/{len(whole)} entries of the checkpoint (model, optimizer, '
          'counts) equal the uninterrupted run\'s bit for bit')
    if bad or resumed.keys() != whole.keys():
        raise AssertionError(f'[29] windowed resume differs: {bad[:5]}')
    print(f'[29] {time.perf_counter() - t_phase:.2f} s')
    return launches, numbers


def mesh_window_worker(rank, out, port):
    """Phase 30 (b)'s rank ``rank`` of 2, sharing the card with the other
    (gloo): for each mesh, the recipe from the bench weights over this
    rank's pieces of the bench batches, once as per-step sharded steps
    and once as fused windows of MESH_WINDOW (eager under gloo), saved to
    ``out``; then a pass of each way again, in turns, timed; the kernels'
    launches and steps over the worker's life."""
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist
    from dvs_of_training_framework_tpu_torch.data.device_queue import \
        stack_batches
    from dvs_of_training_framework_tpu_torch.losses import (
        LOSS_PRECISIONS, MultiScaleLoss)
    from dvs_of_training_framework_tpu_torch.ops import launch_counts
    from dvs_of_training_framework_tpu_torch.parallel import (
        MeshGroups, initialize, make_sharded_fused_window_step,
        make_sharded_train_step, parse_mesh)
    from dvs_of_training_framework_tpu_torch.training import (
        construct_optimizer, create_train_state)
    out = Path(out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = initialize(f'127.0.0.1:{port}', 2, rank, 'cuda')
    collated, capacity, shapes = torch.load(out / 'batches.pt',
                                            weights_only=False)
    evaluator = MultiScaleLoss(shapes, bf16x2=LOSS_PRECISIONS['bf16x2'])
    K, timing, steps = MESH_WINDOW, {}, 0
    for spec in MESHES:
        groups = MeshGroups(parse_mesh(spec), device)
        if groups.window_graph:
            raise AssertionError(f'[30] {spec}: gloo ranks sharing the card '
                                 'would replay a graph')
        event_axis = groups.mesh.event > 1
        pieces = rank_batches(groups, collated, capacity)
        windows = [stack_batches(pieces[i:i + K], pin=True).to(device)
                   for i in range(0, len(pieces), K)]
        ways = {}
        for way in ('steps', 'windows'):
            model = bench_model('recipe', device)
            optimizer = construct_optimizer(WINDOW_ARGS, model)
            state = create_train_state()
            if way == 'steps':
                one = make_sharded_train_step(
                    model, evaluator, optimizer, LOSS_WEIGHTS, 1, groups,
                    event_axis=event_axis)

                def run(st, one=one):
                    return [one(st, p.to(device))[1][0] for p in pieces]
            else:
                fused = make_sharded_fused_window_step(
                    model, evaluator, optimizer, LOSS_WEIGHTS, 1, groups, K,
                    event_axis=event_axis)

                def run(st, fused=fused):
                    return [fused(st, w)[1][0] for w in windows]
            losses = torch.cat([v.reshape(-1) for v in run(state)]).cpu()
            steps += len(pieces)
            torch.save({'losses': losses,
                        'params': clone_tree(model.state_dict()),
                        'opt': flat_state(clone_tree(
                            optimizer.state_dict()))},
                       out / f'{spec}_{way}_{rank}.pt')
            ways[way] = (run, state)
        seconds = {'steps': [], 'windows': []}
        for way in ('steps', 'windows', 'windows', 'steps'):
            run, state = ways[way]
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            run(state)
            torch.cuda.synchronize(device)
            seconds[way].append((time.perf_counter() - t0) / len(pieces))
            steps += len(pieces)
        timing[spec] = {way: 1e3 * statistics.mean(v)
                        for way, v in seconds.items()}
        del ways
        torch.cuda.empty_cache()
    torch.save({'timing': timing, 'launches': launch_counts(),
                'steps': steps, 'rank': rank},
               out / f'worker_{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()


def mesh_window_phase(out, collated, capacity, device, card, counters,
                      shapes, per_step_main_s):
    """Phase 30: the device-queue window on a mesh.  (a) A one-rank NCCL
    group at the bench shape: 2 windows of MESH_GRAPH_WINDOW as sharded
    eager steps and as replays of one graph whose capture holds the
    all-reduces, golden and recipe, then the recipe on the event axis
    (the grid sum and the quantization gradients' sum captured too); (b)
    two ranks sharing the card (gloo), ``data:2`` and ``data:1,event:2``:
    windows of MESH_WINDOW, eager in one call each, against per-step
    sharded steps, and the replicas; (c) ``train.main()`` with ``--mesh
    data:2 --device-queue-window MESH_WINDOW`` over phase 14's shards
    with a resume from the checkpoint before the last held to phase 12's
    rule.  Returns the launch
    counts of (a)'s recipe graph run and of (c)'s ranks, and the
    phase's numbers."""
    import torch.distributed as dist
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.data import pad_batch
    from dvs_of_training_framework_tpu_torch.data.device_queue import \
        stack_batches
    from dvs_of_training_framework_tpu_torch.losses import (LOSS_PRECISIONS,
                                                            MultiScaleLoss)
    from dvs_of_training_framework_tpu_torch.ops import launch_counts
    from dvs_of_training_framework_tpu_torch.parallel import (
        MeshGroups, make_sharded_fused_window_step, make_sharded_train_step,
        parse_mesh, window_rule)
    from dvs_of_training_framework_tpu_torch.parallel.distributed import \
        free_port

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    K = MESH_GRAPH_WINDOW
    host = [pad_batch(c, capacity) for c in collated]
    windows = [stack_batches([host[(w * K + i) % len(host)]
                              for i in range(K)], pin=True).to(device)
               for w in range(2)]
    launches, numbers = {}, {}

    # --- (a) a one-rank NCCL group: the window as one graph replay -------
    dist.init_process_group('nccl', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        print(f'[30] (a) a one-rank NCCL group, windows of {K} bench '
              f'batches, WINDOW_ARGS as phase 29: {window_rule("nccl", device)}'
              f'; card: {card}')
        for config, spec in (('golden', 'data:1'), ('recipe', 'data:1'),
                             ('recipe', 'data:1,event:1')):
            groups = MeshGroups(parse_mesh(spec), device)
            event_axis = 'event' in spec
            if not groups.window_graph:
                raise AssertionError(f'[30] {spec}: NCCL would not replay')
            evaluator = MultiScaleLoss(
                shapes, bf16x2=LOSS_PRECISIONS[CONFIGS[config][1]])

            def build(mode, model, optimizer, groups=groups,
                      evaluator=evaluator, event_axis=event_axis):
                if mode == 'eager':
                    return make_sharded_train_step(
                        model, evaluator, optimizer, LOSS_WEIGHTS, 1, groups,
                        event_axis=event_axis, window=K)
                return make_sharded_fused_window_step(
                    model, evaluator, optimizer, LOSS_WEIGHTS, 1, groups, K,
                    event_axis=event_axis)

            runs, nums, counts = window_ways(f'[30] {spec}', config,
                                             evaluator, build, windows,
                                             counters, card)
            model = runs['graph'].model
            n_params = sum(p.numel() for p in model.parameters())
            n_quant = sum(p.numel() for n, p in model.named_parameters()
                          if n.startswith('quantization_layer.'))
            grid = host[0].size * 9 * host[0].images.shape[-1] ** 2
            # the data axis: one flat fp32 buffer of the gradients, the
            # loss and its 12 terms; the event axis: the grid and the
            # quantization layer's gradients
            nums['data_mb'] = 4 * (n_params + 13) / 1e6
            nums['event_mb'] = 4 * (grid + n_quant) / 1e6 if event_axis \
                else 0.0
            print(f'  all-reduced a step: {nums["data_mb"]:.2f} MB on the '
                  f'data axis, {nums["event_mb"]:.2f} MB on the event axis')
            numbers[f'{config} {spec}'] = nums
            if (config, spec) == ('recipe', 'data:1'):
                launches['mesh_window'] = counts
            for r in runs.values():
                del r.model, r.optimizer, r.state, r.step, r.graph
            del runs, model
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f'[30] (a) {time.perf_counter() - t_phase:.2f} s')

    # --- (b) two ranks sharing the card: eager windows under gloo ---------
    t0 = time.perf_counter()
    work = out / 'mesh_window'
    work.mkdir()
    torch.save((collated[:2 * MESH_WINDOW], capacity, shapes),
               work / 'batches.pt')
    context = torch.multiprocessing.start_processes(
        mesh_window_worker, args=(str(work), free_port()), nprocs=2,
        join=False, start_method='spawn')
    join_spawned(context, 600, '[30] (b)')
    workers = [torch.load(work / f'worker_{r}.pt', weights_only=False)
               for r in range(2)]
    for spec in MESHES:
        ways = {(way, r): torch.load(work / f'{spec}_{way}_{r}.pt',
                                     weights_only=False)
                for way in ('steps', 'windows') for r in range(2)}
        want = ways['steps', 0]
        bad = [(way, r, k) for (way, r), got in ways.items()
               for part in ('params', 'opt') for k in want[part]
               if not bits_equal(got[part][k], want[part][k])]
        bad += [(way, r, 'losses') for (way, r), got in ways.items()
                if not bits_equal(got['losses'], want['losses'])]
        print(f'[30] (b) {spec}, two ranks sharing the card (gloo), the '
              f'recipe over {2 * MESH_WINDOW} bench batches: windows of '
              f'{MESH_WINDOW} ({window_rule("gloo", device)}) against '
              f'per-step sharded steps, and rank 1 against rank 0: '
              f'{len(bad)} differences in the losses, {len(want["params"])}'
              f' parameters and {len(want["opt"])} optimizer entries; '
              + '; '.join(f'rank {w["rank"]} {w["timing"][spec]["steps"]:.3f}'
                          f' ms a step per step, '
                          f'{w["timing"][spec]["windows"]:.3f} in windows'
                          for w in workers)
              + f' (in turns); card: {card}')
        if bad:
            raise AssertionError(f'[30] (b) {spec}: differ {bad[:5]}')
    launches['mesh_window_ranks'] = check_rank_launches(
        '[30] (b)', workers, workers[0]['steps'])
    numbers['gloo'] = {spec: [w['timing'][spec] for w in workers]
                       for spec in MESHES}
    print(f'[30] (b) {time.perf_counter() - t0:.2f} s')

    # --- (c) train.main() --mesh data:2 with windows, and a resume --------
    t0 = time.perf_counter()
    run = out / 'run_mesh_window'
    every = 4
    argv = ['-d', device.type, '-bs', '8', '-mbs', '8', '-ne',
            str(MESH_STEPS), '--preprocessed-dataset-path',
            str(out / 'shards'), '--checkpointing_interval', str(every),
            '--permanent_interval', str(every), '-vp', str(every),
            '--event-capacity', str(2 * capacity), '--mesh', 'data:2',
            '--device-queue-window', str(MESH_WINDOW)] + RECIPE_FLAGS
    before = launch_counts()
    t_main = time.perf_counter()
    ranks = cli.main(['-m', str(run)] + argv)
    main_s = time.perf_counter() - t_main
    if launch_counts() != before:
        raise AssertionError('[30] (c) the launcher ran kernels itself')
    check_run_dir('[30] (c)', run, ranks, MESH_STEPS, 8)
    losses = read_scalars(run / 'log').get('General/Train loss', [])
    if len(losses) != MESH_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f'[30] (c) losses {losses}')
    launches['mesh_window_main'] = check_rank_launches('[30] (c)', ranks,
                                                       MESH_STEPS)
    print(f'[30] (c) train.main() --mesh data:2 --device-queue-window '
          f'{MESH_WINDOW} over phase 14\'s shards, {MESH_STEPS} recipe '
          f'steps in windows of {MESH_WINDOW} with checkpoints and sharded '
          'validation every 4: losses ' + ' '.join(f'{v:.5f}' for v in losses)
          + f'; {main_s:.2f} s in all against phase 24\'s '
          f'{per_step_main_s:.2f} s one step at a time; launches '
          f'{launches["mesh_window_main"]}; card: {card}')
    numbers['main_s'] = {'windows': main_s, 'per_step': per_step_main_s}
    # the two resumes at once: each rank is a process of its own
    resume_against('[30] (c)', out, run, argv, MESH_STEPS, every,
                   alongside=lambda: None)
    print(f'[30] (c) {time.perf_counter() - t0:.2f} s')
    print(f'[30] {time.perf_counter() - t_phase:.2f} s')
    return launches, numbers


def window_main_phase(out, capacity, device, card, counters, main_ms):
    """Phase 29's end: ``train.main()`` with the default windows over
    phase 14's shards, WINDOW_MAIN_STEPS steps with checkpoints and
    validation every WINDOW steps; ms a loop step against phase 14's
    ``main()``; returns the launch counts and the numbers."""
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer
    t_phase = time.perf_counter()
    run = out / 'run_windows'
    argv = ['-m', str(run), '-d', device.type, '-bs', '8', '-mbs', '8',
            '-ne', str(WINDOW_MAIN_STEPS), '--preprocessed-dataset-path',
            str(out / 'shards'), '--checkpointing_interval', str(WINDOW),
            '--permanent_interval', str(WINDOW), '-vp', str(WINDOW),
            '--event-capacity', str(capacity)] + RECIPE_FLAGS
    clock = LoopClock()
    run_fn = cli.run
    cli.run = lambda *a, **k: run_fn(*a, timers=clock, **k)
    reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        cli.main(argv)
    finally:
        cli.run = run_fn
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = read_counts(counters)
    scalars = read_scalars(run / 'log')
    losses = scalars.get('General/Train loss', [])
    steps = Serializer(run).list_known_steps()
    windows = len(clock.step_starts)
    # a fused window is one train_step span: its interval to the next
    # window's start, less the hooks, over WINDOW steps; the first window
    # holds the capture
    window_ms = [v / WINDOW for v in clock.step_ms(2)]
    skipped = scalars.get('General/skipped batches', [0.0])[-1]
    print(f'[29] train.main() with the default windows (--device-queue-window '
          f'{WINDOW}, --validation-window {VAL_WINDOW}) over phase 14\'s '
          f'shards, {WINDOW_MAIN_STEPS} recipe steps, checkpoints and '
          f'validation every {WINDOW}: {windows} train-step calls, losses '
          f'{losses[0]:.5f} .. {losses[-1]:.5f}, checkpoints {steps}, '
          f'skipped batches {skipped:g}; launches {counts}')
    if (len(losses) != WINDOW_MAIN_STEPS or not np.isfinite(losses).all()
            or steps != list(range(0, WINDOW_MAIN_STEPS + 1, WINDOW))):
        raise AssertionError(f'[29] main(): losses {losses}, checkpoints '
                             f'{steps}')
    # every window fused: one train-step call each, and one warm-up step
    # before the capture
    if (windows != WINDOW_MAIN_STEPS // WINDOW
            or counts['voxelize_bwd'] != WINDOW_MAIN_STEPS + 1):
        raise AssertionError(f'[29] main(): {windows} train-step calls for '
                             f'{WINDOW_MAIN_STEPS // WINDOW} windows, '
                             f'launches {counts}')
    print(f'  main() loop step {statistics.median(window_ms):.3f} ms (median '
          'over the windows after the first, each window\'s interval less '
          'its hooks over its steps: ' + ' '.join(f'{v:.1f}' for v in
                                                   window_ms)
          + f'); phase 14\'s main() step one batch at a time '
          f'{main_ms:.3f} ms; main() {main_s:.2f} s in all; card: {card}')
    print(f'[29] main() {time.perf_counter() - t_phase:.2f} s')
    return counts, {'main_ms': statistics.median(window_ms),
                    'main_window_ms': window_ms, 'phase14_main_ms': main_ms}


class TimedReader:
    """A training stream that times each item it hands out: the seconds
    of each batch the loop trains on and of each it skips (a skip record
    of ``ShardedBatchSkipper``, or a decoded batch over ``capacity``)."""

    def __init__(self, loader, capacity):
        self.loader, self.capacity = loader, capacity
        self.trained, self.skipped = [], []

    def __iter__(self):
        from dvs_of_training_framework_tpu_torch.training.train import \
            batch_num_events
        items = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(items)
            except StopIteration:
                return
            seconds = time.perf_counter() - t0
            skip = batch_num_events(batch) > self.capacity
            (self.skipped if skip else self.trained).append(seconds)
            yield batch

    def close(self):
        close = getattr(self.loader, 'close', None)
        if close is not None:
            close()


def skip_phase(out, device, card, counters):
    """Phase 31: RecurrentFlowNet's recipe through ``train.main()`` over
    phase 18's 2-element shards at a capacity that skips about half the
    batch positions, with the skip from the shards' recorded event counts
    (the reader ``read_train`` builds) and over the bare reader (decode,
    then skip): losses, skip scalars, parameters and optimizer state bit
    for bit.  Returns the metadata arm's launch counts and the numbers."""
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.data.preprocessed import \
        per_sample_event_counts
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer
    t_phase = time.perf_counter()
    shards = out / 'shards_pairs'
    batch, every = 8, 4
    counts = per_sample_event_counts(shards)
    positions = counts.size // batch
    sums = counts[:positions * batch].reshape(positions, batch).sum(1)
    capacity = int(statistics.median(sums.tolist()))
    fits = int((sums <= capacity).sum())
    print(f'[31] phase 18\'s 2-element shards: {counts.size} samples, '
          f'{positions} batch positions of {batch}, recorded events '
          f'{sorted(sums.tolist())}; capacity {capacity} (their median): '
          f'{fits} fit, {positions - fits} overflow')
    if counts.size % batch or not 0 < fits < positions:
        raise AssertionError(f'[31] {counts.size} samples, {fits} of '
                             f'{positions} positions fit {capacity}')
    pairs = ['--min-sequence-length', '2', '--max-sequence-length', '2']
    skipper = cli.ShardedBatchSkipper
    arms = {}
    for name in ('metadata', 'decoded'):
        run = out / f'run_skip_{name}'
        readers = []

        def timed(loader, *args, _name=name, **kwargs):
            if _name == 'metadata':
                loader = skipper(loader, *args, **kwargs)
            readers.append(TimedReader(loader, capacity))
            return readers[-1]

        argv = ['-m', str(run), '-d', device.type, '-bs', str(batch),
                '-mbs', str(batch), '-ne', str(MAIN_STEPS),
                '--preprocessed-dataset-path', str(shards),
                '--checkpointing_interval', str(every),
                '--permanent_interval', str(every), '--skip-validation',
                '--event-capacity', str(capacity), '--device-queue-window',
                str(every), '--flownet_path', 'RecurrentFlowNet'] \
            + pairs + RECIPE_FLAGS
        clock = LoopClock()
        run_fn = cli.run
        cli.run = lambda *a, **k: run_fn(*a, timers=clock, **k)
        cli.ShardedBatchSkipper = timed
        reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            cli.main(argv)
        finally:
            cli.run, cli.ShardedBatchSkipper = run_fn, skipper
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        (reader,) = readers
        scalars = read_scalars(run / 'log')
        arms[name] = SimpleNamespace(
            run=run, seconds=seconds, counts=read_counts(counters),
            reader=reader, step_ms=statistics.median(clock.window_ms(every)),
            losses=scalars.get('General/Train loss', []),
            skips=scalars.get('General/skipped batches', []),
            state=Serializer(run).read_state_dict(MAIN_STEPS))
    meta, decoded = arms['metadata'], arms['decoded']
    for name, arm in arms.items():
        skip_ms = 1e3 * statistics.mean(arm.reader.skipped)
        read_ms = 1e3 * statistics.mean(arm.reader.trained)
        print(f'[31] {name}: {MAIN_STEPS} recipe steps in windows of '
              f'{every}, {len(arm.reader.trained)} batches trained and '
              f'{len(arm.reader.skipped)} skipped; {skip_ms:.4f} ms a '
              f'skipped batch, {read_ms:.3f} ms reading a trained one, '
              f'{arm.step_ms:.3f} ms a trained step (windows after the '
              f'first, hooks excluded); main() {arm.seconds:.2f} s; '
              f'launches {arm.counts}; card: {card}')
        arm.skip_ms, arm.read_ms = skip_ms, read_ms
    trained = MAIN_STEPS + 1          # and a warm-up step before the capture
    if (len(meta.losses) != MAIN_STEPS
            or not np.isfinite(meta.losses).all() or not meta.skips
            or meta.counts != decoded.counts
            or meta.counts['voxelize_bwd'] != trained
            or meta.counts['voxelize_fwd'] != trained
            or meta.counts['kernel_mlp_fwd'] != trained
            or meta.counts['warp_bwd'] != 4 * trained):
        raise AssertionError(f'[31] losses {meta.losses}, skips '
                             f'{meta.skips}, launches {meta.counts} and '
                             f'{decoded.counts}')
    # the same run: every logged value, parameter and optimizer entry
    same = [meta.losses == decoded.losses, meta.skips == decoded.skips]
    params = flat_state(meta.state['model'])
    others = flat_state(decoded.state['model'])
    entries = flat_state(meta.state['optimizer'])
    other_entries = flat_state(decoded.state['optimizer'])
    same.append(params.keys() == others.keys() and all(
        bits_equal(v, others[k]) for k, v in params.items()))
    same.append(entries.keys() == other_entries.keys() and all(
        bits_equal(v, other_entries[k]) for k, v in entries.items()))
    print(f'[31] metadata against decoded: {len(meta.losses)} losses, '
          f'{len(meta.skips)} skip scalars, {len(params)} parameters, '
          f'{len(entries)} optimizer entries; equal bit for bit: {same}')
    if not all(same):
        raise AssertionError('[31] the metadata skip changed the run')
    print(f'[31] {time.perf_counter() - t_phase:.2f} s')
    return meta.counts, {
        'capacity': capacity, 'fit': fits, 'positions': positions,
        **{f'{name}_{key}': getattr(arm, key) for name, arm in arms.items()
           for key in ('skip_ms', 'read_ms', 'step_ms', 'seconds')},
        'skipped': len(meta.reader.skipped),
        'trained_batches': len(meta.reader.trained)}


def busy_union_ms(events):
    """Milliseconds in which the card ran at least one of the profiler's
    device ops: the union of their intervals, so two streams' overlapping
    kernels count once."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_ops(events))
    busy, end = 0.0, float('-inf')
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def eval_pool_phase(out, device, card, counters):
    """Phase 32: the evaluation CLI over every checkpoint of phase 14's
    run, in turn (``-s`` a checkpoint a call) and through ``DevicePool``
    at one and two jobs a card; every pickle bit for bit the in-turn
    one's and phase 15's; seconds and the card's busy share of each run;
    on a machine of two cards or more, the checkpoints spread over every
    card.  Returns the launch counts of the pool at two jobs a card (the
    CLI's default) and the phase's numbers."""
    from dvs_of_training_framework_tpu_torch import test as eval_cli
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer
    t_phase = time.perf_counter()
    run = out / 'run'
    steps = Serializer(run).list_known_steps()
    config = REPO / 'dvs_of_training_framework_tpu_torch' / 'config' / \
        'synth_testing.json'

    def cli(name, card_flag, extra, profiled=False):
        """The CLI's main() into ``out/<name>``: seconds, the card's busy
        share under the profiler (or None), launches and the pickles."""
        target = out / name
        reset(counters)
        torch.cuda.synchronize()
        with (profile() if profiled else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            if extra[:1] == ['-s']:
                for step in steps:
                    eval_cli.main(['-m', str(run), '-o', str(target), '-d',
                                   card_flag, '--test-config', str(config),
                                   '-s', str(step)])
            else:
                eval_cli.main(['-m', str(run), '-o', str(target), '-d',
                               card_flag, '--test-config', str(config)]
                              + extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        busy = busy_union_ms(prof.events()) / 1e3 / seconds if profiled \
            else None
        pickles = {p.name: p.read_bytes()
                   for p in sorted(target.glob('step_*.pkl'))}
        if sorted(pickles) != sorted(f'step_{s}.pkl' for s in steps):
            raise AssertionError(f'[32] {name}: pickles {sorted(pickles)}')
        return SimpleNamespace(seconds=seconds, busy=busy, pickles=pickles,
                               counts=read_counts(counters))

    runs = {'in turn': cli('pool_in_turn', 'cuda:0', ['-s'])}
    for per_card in (1, 2, 1, 2):
        runs.setdefault(f'pool {per_card}', []).append(cli(
            f'pool_{per_card}_{len(runs.get(f"pool {per_card}", []))}',
            'cuda:0', ['--tests_per_device', str(per_card)]))
    for per_card in (1, 2):
        runs[f'pool {per_card} traced'] = cli(
            f'pool_{per_card}_traced', 'cuda:0',
            ['--tests_per_device', str(per_card)], profiled=True)
    want = runs['in turn']
    records = [pickle.loads(b) for b in want.pickles.values()]
    blocks = sum(math.ceil(len(r.windows) / EVAL_BLOCK)
                 for rs in records for r in rs)
    numbers = [v for rs in records for r in rs
               for v in (r.mAEE, r.mpAEE, r.mMedEE)]
    if not np.isfinite(numbers).all():
        raise AssertionError(f'[32] scores {numbers}')
    expected = {k: blocks if k in ('voxelize_fwd', 'kernel_mlp_fwd') else 0
                for k in counters}
    flat = [('in turn', want)] + [
        (name, r) for name, rs in runs.items() if name != 'in turn'
        for r in (rs if isinstance(rs, list) else [rs])]
    for name, r in flat:
        if r.pickles != want.pickles:
            raise AssertionError(f'[32] {name}: a pickle differs from the '
                                 'in-turn evaluation\'s')
        if r.counts != expected:
            raise AssertionError(f'[32] {name}: launches {r.counts}, '
                                 f'expected {expected}')
    phase15 = (out / 'eval' / f'step_{MAIN_STEPS}.pkl').read_bytes()
    if want.pickles[f'step_{MAIN_STEPS}.pkl'] != phase15:
        raise AssertionError('[32] the in-turn pickle of step '
                             f'{MAIN_STEPS} differs from phase 15\'s')
    seconds = {name: ([r.seconds for r in rs] if isinstance(rs, list)
                      else rs.seconds) for name, rs in runs.items()}
    busy = {name: runs[f'{name} traced'].busy for name in ('pool 1',
                                                           'pool 2')}
    print(f'[32] the evaluation CLI over the {len(steps)} checkpoints '
          f'{steps} of phase 14\'s run, {blocks} blocks of up to '
          f'{EVAL_BLOCK} windows in all: in turn (-s a checkpoint a call) '
          f'{seconds["in turn"]:.2f} s; through DevicePool on cuda:0 with '
          '--tests_per_device 1: ' + ' '.join(
              f'{v:.2f}' for v in seconds['pool 1'])
          + ' s, with 2: ' + ' '.join(f'{v:.2f}' for v in seconds['pool 2'])
          + f' s (in turns); under the profiler {seconds["pool 1 traced"]:.2f}'
          f' and {seconds["pool 2 traced"]:.2f} s, the card busy '
          f'{100 * busy["pool 1"]:.1f}% and {100 * busy["pool 2"]:.1f}% of '
          f'them; every pickle of the {len(flat)} runs equals the in-turn '
          f'run\'s bit for bit, and step {MAIN_STEPS}\'s phase 15\'s; '
          f'launches {runs["pool 2"][0].counts} a run; card: {card}')
    multi = None
    if torch.cuda.device_count() >= 2:
        cards = cli('pool_cards', 'cuda', ['--tests_per_device', '2'])
        if cards.pickles != want.pickles:
            raise AssertionError('[32] the checkpoints spread over '
                                 f'{torch.cuda.device_count()} cards differ '
                                 'from one card\'s')
        multi = {'cards': torch.cuda.device_count(),
                 'seconds': cards.seconds}
        print(f'[32] over {torch.cuda.device_count()} cards (-d cuda, 2 a '
              f'card): {cards.seconds:.2f} s, every pickle one card\'s')
    else:
        print('[32] one card: the spread over several cards is not run')
    print(f'[32] {time.perf_counter() - t_phase:.2f} s')
    return runs['pool 2'][0].counts, {
        'checkpoints': steps, 'blocks': blocks, 'seconds': seconds,
        'busy_share': busy, 'cards': multi}


def cache_phase(out, capacity, device, card, counters):
    """Phase 33: ``train.main()`` over a set of 7 shards through each
    ``--cache-dir`` policy: none, the warm path, the strict iterator and
    the non-blocking one (copies held back CACHE_DELAY seconds, so that
    it serves cached files again), then the non-blocking one on ``--mesh
    data:2``.  The warm and strict runs equal the no-cache run bit for
    bit; every slice of every run lies inside its served file.  Returns
    the one-rank runs' launch counts, the mesh's and the numbers."""
    from dvs_of_training_framework_tpu_torch import train as cli
    from dvs_of_training_framework_tpu_torch.data import store
    from dvs_of_training_framework_tpu_torch.tools import prepare_batches
    from dvs_of_training_framework_tpu_torch.training.serializer import \
        Serializer
    t_phase = time.perf_counter()
    shards = out / 'shards_cache'
    # batches of 4 samples: a file closes at CACHE_FILE_SAMPLES, the last
    # holds the rest
    prepare_batches.main(prepare_batches.parse_args(
        ['-o', str(shards), '-s', str(CACHE_SAMPLES), '--samples-per-file',
         str(CACHE_FILE_SAMPLES), '-mbs', '4']))
    files = sorted(shards.glob('*.hdf5'), key=lambda p: int(p.stem))
    sizes = []
    for f in files:
        with store.open_file(f, 'r') as shard:
            sizes.append(len(shard['elements_per_sample']))
    set_mb = sum(tree_bytes(f) for f in files) / 1e6
    print(f'[33] prepare_batches -s {CACHE_SAMPLES} --samples-per-file '
          f'{CACHE_FILE_SAMPLES} -mbs 4 over phase 14\'s raw split in '
          f'{time.perf_counter() - t_phase:.2f} s: files of {sizes} samples,'
          f' {set_mb:.1f} MB; each copy into a cache held back {CACHE_DELAY} '
          's (slow storage)')
    if sizes[-1] >= CACHE_FILE_SAMPLES or sum(sizes) != CACHE_SAMPLES:
        raise AssertionError(f'[33] files of {sizes} samples')
    policies = {'no cache': [],
                'warm': ['--cache-size', '8'],
                'strict': ['--cache-size', '3', '--process-only-once'],
                'non-blocking': ['--cache-size', '3']}
    runs, launches = {}, {}
    for i, (name, flags) in enumerate(policies.items()):
        run = out / f'run_cache_{i}'
        argv = ['-m', str(run), '-d', device.type, '-bs', '8', '-mbs', '8',
                '-ne', str(CACHE_STEPS), '--preprocessed-dataset-path',
                str(shards), '--checkpointing_interval', str(WINDOW),
                '--permanent_interval', str(WINDOW), '-vp', str(WINDOW),
                '--event-capacity', str(capacity)] + RECIPE_FLAGS
        if flags:
            argv += ['--cache-dir', str(out / f'cache_{i}')] + flags
        probe = CacheProbe(CACHE_DELAY if name == 'non-blocking' else 0.0)
        clock = LoopClock()
        run_fn = cli.run
        probe.install()
        cli.run = lambda *a, **k: run_fn(*a, timers=clock, **k)
        reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            cli.main(argv)
        finally:
            cli.run = run_fn
            probe.remove()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(counters)
        scalars = read_scalars(run / 'log')
        state = Serializer(run).read_state_dict(CACHE_STEPS)
        runs[name] = SimpleNamespace(
            seconds=seconds, counts=counts, probe=probe.numbers(),
            step_ms=statistics.median(clock.window_ms(WINDOW)),
            read_ms=statistics.median(clock.window_read_ms(WINDOW)),
            losses=scalars.get('General/Train loss', []),
            val_losses=scalars.get('General/Validation loss', []),
            params=flat_state(state['model']),
            entries=flat_state(state['optimizer']))
        arm = runs[name]
        passes = arm.probe['samples'] / CACHE_SAMPLES
        print(f'[33] {name}{" (" + " ".join(flags) + ")" if flags else ""}:'
              f' {CACHE_STEPS} recipe steps in windows of {WINDOW}, '
              f'{seconds:.2f} s; loop step {arm.step_ms:.3f} ms, reading a '
              f'batch {arm.read_ms:.3f} ms (batch_construction over a '
              f'window, medians of the windows after the first); '
              f'{arm.probe["mb_copied"]:.1f} MB copied in '
              f'{arm.probe["copies"]} copies; {arm.probe["slices"]} slices '
              f'over {passes:.2f} passes, each inside its file; '
              + (f'{arm.probe["visits"]} files served, '
                 f'{arm.probe["reserves"]} of them again '
                 f'({arm.probe["reserves"] / passes:.2f} a pass)'
                 if name == 'non-blocking' else 'served in file order')
              + f'; losses {arm.losses[0]:.5f} .. {arm.losses[-1]:.5f}; '
              f'launches {counts}; card: {card}')
        if (len(arm.losses) != CACHE_STEPS
                or not np.isfinite(arm.losses + arm.val_losses).all()
                or counts['voxelize_bwd'] != CACHE_STEPS + 1
                or not arm.probe['slices']):
            raise AssertionError(f'[33] {name}: losses {arm.losses}, '
                                 f'launches {counts}, {arm.probe}')
        launches[name] = counts
    want = runs['no cache']
    for name in ('warm', 'strict'):
        arm = runs[name]
        same = (arm.losses == want.losses
                and arm.val_losses == want.val_losses
                and arm.params.keys() == want.params.keys()
                and all(bits_equal(v, want.params[k])
                        for k, v in arm.params.items())
                and arm.entries.keys() == want.entries.keys()
                and all(bits_equal(v, want.entries[k])
                        for k, v in arm.entries.items()))
        print(f'[33] {name} against no cache: {len(arm.losses)} losses, '
              f'{len(arm.val_losses)} validation losses, '
              f'{len(arm.params)} parameters and {len(arm.entries)} '
              f'optimizer entries of step {CACHE_STEPS}: equal bit for bit: '
              f'{same}')
        if not same:
            raise AssertionError(f'[33] the {name} cache changed the run')
    if not runs['non-blocking'].probe['reserves']:
        raise AssertionError('[33] the non-blocking cache served no file '
                             'again')

    # --- the non-blocking cache on a mesh: two spawned gloo ranks ------
    t0 = time.perf_counter()
    run, reports = out / 'run_cache_mesh', out / 'cache_probes'
    reports.mkdir()
    argv = ['-m', str(run), '-d', device.type, '-bs', '8', '-mbs', '8',
            '-ne', str(CACHE_STEPS), '--preprocessed-dataset-path',
            str(shards), '--checkpointing_interval', str(CACHE_STEPS),
            '--permanent_interval', str(CACHE_STEPS),
            '--skip-validation', '--event-capacity', str(2 * capacity),
            '--mesh', 'data:2', '--cache-dir', str(out / 'cache_mesh'),
            '--cache-size', '3'] + RECIPE_FLAGS
    # the spawned ranks run this file again as __mp_main__ and install
    # the probe there (the end of this file)
    os.environ[CACHE_PROBE_ENV] = json.dumps(
        {'delay': CACHE_DELAY, 'report': str(reports)})
    try:
        ranks = cli.main(argv)
    finally:
        del os.environ[CACHE_PROBE_ENV]
    seconds = time.perf_counter() - t0
    check_run_dir('[33] mesh', run, ranks, CACHE_STEPS, 8)
    mesh_launches = check_rank_launches('[33] mesh', ranks,
                                        CACHE_STEPS)
    losses = read_scalars(run / 'log').get('General/Train loss', [])
    probes = [json.loads((reports / f'{r["pid"]}.json').read_text())
              for r in ranks]
    print(f'[33] train.main() --mesh data:2 --cache-dir --cache-size 3 '
          f'(non-blocking), two gloo ranks sharing the card, '
          f'{CACHE_STEPS} recipe steps in windows of {WINDOW}: '
          f'{seconds:.2f} s with the two processes\' start; losses '
          f'{losses[0]:.5f} .. {losses[-1]:.5f}; launches {mesh_launches}; '
          f'card: {card}')
    for p in probes:
        passes = p['samples'] * 2 / CACHE_SAMPLES
        print(f'  rank {p["rank"]}: loop step '
              f'{statistics.median(p["step_ms"]):.3f} ms, reading a batch '
              f'{statistics.median(p["read_ms"]):.3f} ms; '
              f'{p["mb_copied"]:.1f} MB copied in {p["copies"]} copies; '
              f'{p["slices"]} slices over {passes:.2f} passes of its '
              f'stream, each inside its file; {p["visits"]} files served, '
              f'{p["reserves"]} of them again ({p["reserves"] / passes:.2f} '
              'a pass)')
    if (len(losses) != CACHE_STEPS or not np.isfinite(losses).all()
            or sorted(p['rank'] for p in probes) != [0, 1]
            or not all(p['reserves'] and p['slices'] for p in probes)):
        raise AssertionError(f'[33] mesh: losses {losses}, ranks {probes}')
    print(f'[33] {time.perf_counter() - t_phase:.2f} s')
    total = {k: sum(c[k] for c in launches.values()) for k in counters}
    numbers = {name: {'seconds': arm.seconds, 'step_ms': arm.step_ms,
                      'read_ms': arm.read_ms, **arm.probe}
               for name, arm in runs.items()}
    numbers['mesh'] = {'seconds': seconds, 'ranks': probes}
    numbers['delay_s'] = CACHE_DELAY
    return total, mesh_launches, numbers


def launch_counters():
    """``{kernel: (its wrapper's counter, key)}``."""
    from dvs_of_training_framework_tpu_torch.ops import (
        kernel_mlp_cuda, voxel_cuda, warp_cuda)
    return {'voxelize_fwd': (voxel_cuda.launches, 'fwd'),
            'voxelize_bwd': (voxel_cuda.launches, 'bwd'),
            'kernel_mlp_fwd': (kernel_mlp_cuda.launches, 'fwd'),
            'kernel_mlp_bwd': (kernel_mlp_cuda.launches, 'bwd'),
            'corner_values': (warp_cuda.launches, 'corners'),
            'warp_fwd': (warp_cuda.launches, 'fwd'),
            'warp_bwd': (warp_cuda.launches, 'bwd')}


def cache_alone():
    """``python3 chip_smoke.py --phase 33``: the kernels' build, phase
    14's set, then phase 33 alone (no kernels line)."""
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dvs_of_training_framework_tpu_torch.data import synthetic
    from dvs_of_training_framework_tpu_torch.ops import _build
    device, card = torch.device('cuda', 0), card_line()
    print(f'[1] card: {card}')
    _build.build()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_data_') as out:
        out = Path(out)
        print('[14] ' + ', '.join(f'{tool} {s:.2f} s' for tool, s in
                                  build_synthetic(out / 'synth',
                                                  out / 'shards').items()))
        paths = cache_phase(out, synthetic.CAPACITY, device, card,
                            launch_counters())
    print(json.dumps({'cache': paths[2], 'launches': paths[:2]}))
    print(f'card: {card}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dvs_of_training_framework_tpu_torch.data import pad_batch, synthetic
    from dvs_of_training_framework_tpu_torch.losses import (
        LOSS_PRECISIONS, MultiScaleLoss)
    from dvs_of_training_framework_tpu_torch.ops import (
        _build, kernel_mlp_cuda, voxel_cuda, warp, warp_cuda)
    from dvs_of_training_framework_tpu_torch.ops.resize import \
        resize_bilinear

    counters = launch_counters()

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

    B, (H, W) = synthetic.BATCH_SIZE, synthetic.IMSIZE
    capacity = synthetic.CAPACITY
    rng = np.random.default_rng(0)
    # the first WARMUP + STEPS batches feed phases 5-10 and the loop, the
    # last two the loop's validation
    collated = [synthetic.make_collated(rng, sample_offset=i * B)
                for i in range(WARMUP + STEPS + 2)]
    host = [pad_batch(c, capacity) for c in collated[:WARMUP + STEPS]]
    n_events = host[0].events.num_events
    print(f'[1] bench batches: B {B}, {H}x{W}, capacity {capacity}, '
          f'{n_events} events in the first')

    def make_model(config, plain_ops=False, seed=0):
        return bench_model(config, device, plain_ops, seed)

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

    for suffix, (times, bound_ms), err, line in zip(
            ('fwd', 'bwd'), voxelize_times(vox_args, valid, w, g, B, H, W),
            (err_f, err_b), (272, 324)):
        kernels.append(kernel_entry(f'voxelize_{suffix}', 'voxelize.cu',
                                    f'voxel_pallas.py:{line}', err, times,
                                    bound_ms))

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
        # K1's forward on this batch beside its twin, and its device ops
        k_ms, p_ms, _ = time_pair(
            lambda: voxel_cuda.voxelize(*args, w, valid, B, H, W),
            lambda: voxel_cuda.plain(*args, w, valid, B, H, W))
        parts = device_parts(
            lambda: voxel_cuda.voxelize(*args, w, valid, B, H, W))
        print(f'  voxelize_fwd on {label}: kernel {k_ms:.4f} ms, plain '
              f'{p_ms:.4f} ms; {sum(n for _, n, _ in parts):g} device ops a '
              'call (us, launches): ' + '; '.join(
                  f'{us:.2f} x{n:g} {key[:48]}' for us, n, key in parts))
    del first, twin

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
    print('[4] K3 on the bench frames: the corner gather, then the fused '
          'warp against the corner twin\'s warp')
    frames = host[0].to(device).images[1::2]        # the warped frames
    flow_rng = np.random.default_rng(5)
    err_corners = err_fwd = err_bwd = 0.0
    sums = {k: [0.0, 0.0, 0.0, 0.0] for k in ('corners', 'fwd', 'bwd')}
    per_scale = {'fwd': [], 'bwd': []}
    routes = {'fused': warp_cuda.grid_sample_onehot,
              'plain': warp.grid_sample_corners,
              'unfused': lambda f, g: warp.grid_sample_corners(
                  f, g, warp_cuda.corner_values),
              'library': lambda f, g: F.grid_sample(
                  f, g, mode='bilinear', padding_mode='zeros',
                  align_corners=True)}
    for S in (H // 8, H // 4, H // 2, H):
        frames = resize_bilinear(frames, (S, S))     # chained, as the loss
        base = torch.stack(torch.meshgrid(
            torch.arange(S, dtype=torch.float32),
            torch.arange(S, dtype=torch.float32), indexing='xy'))
        # a smooth flow, as a flow network predicts it (a coarse random
        # field of S/8 px upsampled, and 0.5 px of noise a point), carries
        # points past the border; 4 points a frame at +-1e6 px
        coarse = torch.from_numpy(flow_rng.normal(
            0.0, S / 8, (B, 2, 8, 8)).astype(np.float32))
        flow = F.interpolate(coarse, size=(S, S), mode='bilinear',
                             align_corners=True) + torch.from_numpy(
            flow_rng.normal(0.0, 0.5, (B, 2, S, S)).astype(np.float32))
        flow[:, 0, 0, :4] = torch.tensor([1e6, -1e6, 0.0, 0.0])
        flow[:, 1, 0, :4] = torch.tensor([0.0, 0.0, 1e6, -1e6])
        # [N, 2, S, S], read through its [N, S, S, 2] view, as the loss does
        grid = ((base[None] + flow) / ((S - 1) / 2.0) - 1.0).to(device)
        view = grid.permute(0, 2, 3, 1)
        iy, ix = (t.contiguous() for t in
                  warp._unnormalize(view.reshape(B, S * S, 2), S, S))
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
        # one graph a route, its backward timed with retain_graph
        leaves, outs = {}, {}
        for name, fn in routes.items():
            leaves[name] = grid.clone().requires_grad_(True)
            outs[name] = fn(frames, leaves[name].permute(0, 2, 3, 1))
        warped = {name: (outs[name].detach(), torch.autograd.grad(
            outs[name], leaves[name], cot, retain_graph=True)[0])
            for name in ('fused', 'plain')}
        torch.cuda.synchronize()
        print(f'  {S}x{S}: corners equal ({100 * outside:.2f}% zero); the '
              'fused warp equals the corner twin\'s bit for bit: forward '
              f'{bits_equal(*(warped[k][0] for k in warped))}, grid '
              f'gradient {bits_equal(*(warped[k][1] for k in warped))}')
        err_fwd = max(err_fwd, check_close(
            f'{S}x{S} warped frames', warped['fused'][0], warped['plain'][0],
            1e-5, 1e-5))
        err_bwd = max(err_bwd, check_close(
            f'{S}x{S} grid gradient', warped['fused'][1], warped['plain'][1],
            1e-4, 1e-4))

        def fwd(name):
            return lambda: routes[name](frames, view)

        def bwd(name):
            return lambda: torch.autograd.grad(outs[name], leaves[name], cot,
                                               retain_graph=True)

        def fwd_bwd_ops(name):
            def run():
                leaf = grid.detach().requires_grad_(True)
                out = routes[name](frames, leaf.permute(0, 2, 3, 1))
                torch.autograd.grad(out, leaf, cot)
            return sum(n for _, n, _ in device_parts(run))

        points, frame_bytes = B * S * S, 4 * frames.numel()
        times = {
            'corners': time_pair(
                lambda: warp_cuda.corner_values(frames, iy, ix),
                lambda: warp.corner_values(frames, iy, ix)),
            'fwd': time_pair(fwd('fused'), fwd('plain'), fwd('library')),
            'bwd': time_pair(bwd('fused'), bwd('plain'), bwd('library'))}
        unfused = {'fwd': device_ms(fwd('unfused')),
                   'bwd': device_ms(bwd('unfused'))}
        # each input read once, each output written once: the frames and
        # the coordinates or grid, then the four corners; the warped
        # frames; the cotangent and the grid gradient
        nbytes = {'corners': frame_bytes + 4 * (2 + 4) * points,
                  'fwd': frame_bytes + 4 * (2 + 1) * points,
                  'bwd': frame_bytes + 4 * (2 + 1 + 2) * points}
        for key, (k_ms, p_ms, lib_ms) in times.items():
            b_ms = bound(nbytes=nbytes[key])[0]
            for i, v in enumerate((k_ms, p_ms, lib_ms or 0.0, b_ms)):
                sums[key][i] += v
            if key != 'corners':
                per_scale[key].append({
                    'size': S, 'ms': k_ms, 'plain_ms': p_ms,
                    'library_ms': lib_ms, 'unfused_ms': unfused[key],
                    'bound_ms': b_ms})
                print(f'  {S}x{S} warp_{key}: kernel {k_ms:.4f} ms, plain '
                      f'{p_ms:.4f} ms, F.grid_sample {lib_ms:.4f} ms, K3\'s '
                      f'corners and plain ops {unfused[key]:.4f} ms; bound '
                      f'{b_ms:.4f} ms, kernel at {100 * b_ms / k_ms:.1f}% of '
                      'it')
        print(f'  {S}x{S}: device ops of one warp forward and backward: '
              f'{fwd_bwd_ops("unfused"):g} through K3\'s corners and plain '
              f'ops, {fwd_bwd_ops("fused"):g} fused')
        del leaves, outs, warped
    print('  the four scales of a step:')
    for name, key, err in (('corner_values', 'corners', err_corners),
                           ('warp_fwd', 'fwd', err_fwd),
                           ('warp_bwd', 'bwd', err_bwd)):
        k_ms, p_ms, lib_ms, b_ms = sums[key]
        kernels.append(kernel_entry(
            name, 'warp_corners.cu', 'warp_pallas.py:126', err,
            (k_ms, p_ms, None if key == 'corners' else lib_ms),
            (b_ms, 'bytes', 'bytes')))
        if key == 'corners':   # on the main path inside the fused pair
            kernels[-1]['gather_runs_inside'] = ['warp_fwd', 'warp_bwd']
        else:
            kernels[-1]['per_scale'] = per_scale[key]
    del frames, grid, view, iy, ix, got, want
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
            warps = 4 * n if config == 'recipe' else 0
            check_counts(config, counts, {
                'voxelize_fwd': n, 'voxelize_bwd': n, 'kernel_mlp_fwd': n,
                'kernel_mlp_bwd': n, 'corner_values': 0, 'warp_fwd': warps,
                'warp_bwd': warps})
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
        launches['loop'], loop_step_ms = loop_phases(
            Path(out), collated, capacity, device, card, counters,
            bare_ms['recipe'][True])
    torch.cuda.empty_cache()

    # --- 14. to 19. the data path, main() and the evaluation CLI, K1 at
    # depth 64, then sequences and the other plugins over the same set -----
    with tempfile.TemporaryDirectory(prefix='chip_smoke_data_') as out:
        launches['main'], launches['eval'], raw_main = data_phases(
            Path(out), capacity, device, card, counters, loop_step_ms)
        torch.cuda.empty_cache()

        # --- 16. K1 at depth 64 --------------------------------------------
        deep = deep_phase(vox_args, valid, capacity, (B, H, W), host[0],
                          device, counters, shapes)
        vox_entry = next(k for k in kernels if k['name'] == 'voxelize_fwd')
        vox_entry['depth_64'] = deep
        torch.cuda.empty_cache()

        # --- 17. to 19. RecurrentFlowNet, dynamic lengths, DummyFlowNet ---
        paths, planes_16 = sequence_phases(Path(out), device, card,
                                           counters, collated)
        launches.update(paths)

        # --- 20. to 22. the bake, dense training, host images -------------
        paths, bake = dense_phases(Path(out), device, card, counters,
                                   raw_main)
        launches.update(paths)
        for entry in kernels:
            if entry['name'] in ('voxelize_fwd', 'voxelize_bwd'):
                entry['planes_16'] = planes_16[entry['name'][-3:]]

        # --- 23. to 25. several ranks: the bare sharded step, main()'s
        # spawned mesh and the multi-host flags ---------------------------
        paths, mesh = mesh_phases(Path(out), collated, capacity, device,
                                  card)
        launches.update(paths)

        # --- 26. and 27. the visualize CLI and the host tools ------------
        paths, vis = visualize_phases(Path(out), capacity, device, card,
                                      counters)
        launches.update(paths)
        torch.cuda.empty_cache()

        # --- 28. the accuracy scripts over phase 14's layout -------------
        launches['accuracy'], accuracy = accuracy_phase(Path(out))

        # --- 29. the device queue: windows as CUDA graph replays, then
        # main() with the default windows over phase 14's shards ----------
        launches['window'], window = window_phase(
            Path(out), collated, capacity, device, card, counters, shapes)
        launches['window_main'], numbers = window_main_phase(
            Path(out), capacity, device, card, counters, raw_main[0])
        window.update(numbers)

        # --- 30. the window on a mesh: a one-rank NCCL group's graph
        # replays, two gloo ranks' eager windows, main() --mesh with
        # windows ---------------------------------------------------------
        paths, mesh_window = mesh_window_phase(
            Path(out), collated, capacity, device, card, counters, shapes,
            mesh['mesh_main_s'])
        launches.update(paths)

        # --- 31. oversized batches skipped unread on one rank -------------
        launches['skip_main'], skip = skip_phase(Path(out), device, card,
                                                 counters)

        # --- 32. the evaluation CLI's DevicePool over phase 14's run ------
        launches['eval_pool'], eval_pool = eval_pool_phase(
            Path(out), device, card, counters)

        # --- 33. the slow-storage file cache through main(), one rank
        # and a mesh -------------------------------------------------------
        launches['cache_main'], launches['cache_mesh_main'], cache = \
            cache_phase(Path(out), capacity, device, card, counters)

    # the main paths' launches: the recipe's bare steps, the loop, main()
    # and the evaluation CLI, then RecurrentFlowNet's step, main() and
    # evaluation, the dynamic-length run() and DummyFlowNet's, the bake,
    # dense main() and its bare step, the host-image run()s, the ranks'
    # sharded steps, the spawned meshes' main() and the multi-host main(),
    # the visualize CLI's EVFlowNet and RecurrentFlowNet runs, the
    # accuracy scripts' training and evaluation children, the recipe's
    # window steps as graph replays and main() with the default windows,
    # the recipe's sharded windows as a one-rank NCCL group's graph
    # replays and the spawned mesh's main() with windows,
    # RecurrentFlowNet's main() skipping oversized batches unread, the
    # evaluation CLI's DevicePool, and main() through each file cache
    # policy on one rank and the non-blocking one on a mesh
    paths = ('recipe', 'loop', 'main', 'eval', 'recurrent_step',
             'recurrent_main', 'recurrent_eval', 'sequences', 'dummy',
             'bake', 'dense_main', 'dense_step', 'host_images',
             'dummy_dense', 'sharded_step', 'mesh_main', 'mesh_event_main',
             'hosts_main', 'visualize', 'recurrent_visualize', 'accuracy',
             'window', 'window_main', 'mesh_window', 'mesh_window_main',
             'skip_main', 'eval_pool', 'cache_main', 'cache_mesh_main')
    for entry in kernels:
        name = entry['name']
        entry['launches'] = sum(launches[path][name] for path in paths)
        for path in paths + ('golden',):
            entry[f'{path}_launches'] = launches[path][name]

    jax_side = sorted(m for m in sys.modules if m.split('.')[0] in (
        'jax', 'flax', 'optax', 'dvs_of_training_framework_tpu', 'bench',
        'scripts', 'EVFlowNet', 'RecurrentFlowNet', 'DummyFlowNet'))
    if jax_side:
        raise AssertionError(f'the port loaded JAX-side modules: {jax_side}')

    print(json.dumps({'bake': bake}))
    print(json.dumps({'mesh': mesh}))
    print(json.dumps({'visualize': vis}))
    print(json.dumps({'accuracy': accuracy}))
    print(json.dumps({'window': window}))
    print(json.dumps({'mesh_window': mesh_window}))
    print(json.dumps({'skip': skip}))
    print(json.dumps({'eval_pool': eval_pool}))
    print(json.dumps({'cache': cache}))
    print(json.dumps({'kernels': kernels}))
    print(f'card: {card}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__mp_main__' and CACHE_PROBE_ENV in os.environ:
    # a rank that phase 33's mesh spawned: its copies held back and its
    # reads checked as in the launching process, its counts written to
    # <report>/<pid>.json
    _probe = json.loads(os.environ[CACHE_PROBE_ENV])
    CacheProbe(_probe['delay'],
               Path(_probe['report']) / f'{os.getpid()}.json').install()

if __name__ == '__main__':
    sys.exit(cache_alone() if sys.argv[1:] == ['--phase', '33'] else main())
