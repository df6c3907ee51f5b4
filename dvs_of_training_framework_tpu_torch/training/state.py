"""Train state, the training steps and the validation steps.

Counterpart of ``TrainState``, ``create_train_state``, ``make_loss_fn``,
``make_train_step``, ``make_fused_window_step``, ``make_eval_step`` and
``make_fused_eval_step`` in
``dvs_of_training_framework_tpu/training/state.py``.
PyTorch runs eagerly, so a step is a plain function: forward, the
multi-scale loss, backward, and every ``accumulation_steps`` microbatches
one optimizer update of the model's parameters in place.

The window steps take a ``data/device_queue.Window`` of K staged batches.
``make_train_step(window=K)`` steps batch ``micro_step % K`` of it.
``make_fused_window_step`` runs all K steps in one call, and
``make_fused_eval_step`` the K forwards and losses of a validation
window.  On a card a call is one replay of a CUDA graph captured over the
same K-step body (``WindowGraph``): the window is copied into the graph's
static buffer, the optimizer's scalars for its K updates into its static
table, and the per-step losses come back from its static output.  On the
CPU the same body runs the K steps eagerly, one after the other.  The
step bodies take a ``grad_fn``: ``make_update_step`` one step's,
``make_fused_update_step`` a window's, so the sharded steps of
``parallel/mesh.py`` reuse both with their reduced gradients.
"""
import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from ..data.schema import slice_window_batch
from ..losses import combined_loss
from ..ops import count_launches, launch_counts


@dataclasses.dataclass
class TrainState:
    """The gradient accumulator and the step counters.  The parameters
    live in the model and the optimizer state in the optimizer, both of
    which the step updates in place.  The accumulator, once made, is
    zeroed in place at every update, never replaced: a captured graph
    holds its address."""
    grad_acc: Optional[Dict[str, torch.Tensor]] = None
    micro_step: int = 0
    step: int = 0


def create_train_state(init_step: int = 0) -> TrainState:
    return TrainState(step=init_step)


def make_loss_fn(model, evaluator, weights, is_raw: bool = True) -> Callable:
    """``batch -> (loss, terms)`` for a device Batch: its raw ``events``
    or, with ``is_raw=False``, its dense ``data`` go to the model."""
    weights = tuple(weights)

    def loss_fn(batch):
        imsize = tuple(batch.images.shape[-2:])
        events = batch.events if is_raw else batch.data
        flows, flow_ts, flow_sample_idx = model(
            events, batch.timestamps, batch.sample_idx, imsize, raw=is_raw)
        return combined_loss(evaluator, flows, flow_ts, flow_sample_idx,
                             batch.images, batch.timestamps,
                             batch.sample_idx, weights=weights)

    return loss_fn


def step_values(loss, terms) -> torch.Tensor:
    """One step's loss and per-scale ``(smoothness, photometric,
    out_reg)`` terms as one float32 row ``[1 + 3 * scales]``."""
    return torch.stack([loss.float()]
                       + [t.float() for group in terms for t in group])


def split_values(values, scales: int):
    """``(loss[K], (smoothness, photometric, out_reg))`` of K rows of
    ``step_values``, each term ``[K, scales]``."""
    return values[:, 0], tuple(values[:, 1 + i * scales:1 + (i + 1) * scales]
                               for i in range(3))


def _make_grad_fn(loss_fn, named):
    def grad_fn(batch):
        loss, terms = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    materialize_grads=True)
        return loss, terms, dict(zip(named, grads))

    return grad_fn


@torch.no_grad()
def _accumulator(state, named):
    """The state's gradient accumulator, made (zeros) on first use."""
    if state.grad_acc is None:
        state.grad_acc = {k: torch.zeros_like(v) for k, v in named.items()}
    return state.grad_acc


@torch.no_grad()
def _accumulate(state, named, grads, inv):
    acc = _accumulator(state, named)
    for k, g in grads.items():
        acc[k].add_(g * inv)


def make_train_step(model, evaluator, optimizer, weights,
                    accumulation_steps: int, is_raw: bool = True,
                    window: int = 0):
    """Build the training step.

    Returns ``step_fn(state, batch) -> (state, (loss, terms))``; the state
    is updated in place, ``loss`` is already divided by
    ``accumulation_steps`` and ``terms`` are this microbatch's per-scale
    values.  With accumulation the optimizer applies the mean of the
    microbatch gradients on every ``accumulation_steps``-th call.  A
    parameter the loss does not reach (the quantization layer on the
    dense path, ``is_raw=False``) gets a zero gradient, as under
    ``jax.grad``, so the optimizer still decays it and moves its slow
    weights.

    With ``window = K > 0`` the step takes a staged ``Window`` of K
    batches (``data/device_queue.py``) and steps its batch
    ``micro_step % K``.
    """
    named = dict(model.named_parameters())
    return window_slots(make_update_step(
        _make_grad_fn(make_loss_fn(model, evaluator, weights, is_raw), named),
        named, optimizer, accumulation_steps), window)


def window_slots(step, window: int):
    """``step`` itself for ``window`` 0; else a step that takes a staged
    ``Window`` of ``window`` batches and steps its batch
    ``micro_step % window``."""
    if not window:
        return step

    def window_step(state, staged):
        return step(state, slice_window_batch(staged.batch,
                                              state.micro_step % window))

    return window_step


def make_update_step(grad_fn, named, optimizer, accumulation_steps: int):
    """The step around ``grad_fn(batch) -> (loss, terms, {name: grad})``:
    every call accumulates, and every ``accumulation_steps``-th applies
    the mean of the microbatch gradients (``make_train_step``; the
    sharded steps of ``parallel/mesh.py`` give it their reduced
    gradients)."""
    inv = 1.0 / accumulation_steps

    def step_fn(state, batch):
        loss, terms, grads = grad_fn(batch)
        if accumulation_steps == 1:
            optimizer.step(grads)
            state.step += 1
        else:
            _accumulate(state, named, grads, inv)
            if (state.micro_step + 1) % accumulation_steps == 0:
                optimizer.step(state.grad_acc)
                torch._foreach_zero_(list(state.grad_acc.values()))
                state.step += 1
        state.micro_step += 1
        return state, (loss.detach() * inv, terms)

    return step_fn


class WindowGraph:
    """One CUDA graph of ``run(batch, table, out, slots)`` over the K
    slots of a static window, for windows of one layout.

    ``run`` reads window batch k from ``batch`` (the static window's
    stacked Batch) and writes its step's ``step_values`` into ``out[k]``;
    ``table`` is the optimizer's scalar table or None.  Before the
    capture, ``warmup`` slots run eagerly on a side stream, which builds
    the kernels, picks cuDNN's algorithms and makes the workspaces; the
    ``state`` tensors that they change are restored after, bit for bit.
    A capture launches nothing: the kernels' launch counters give back
    what the capture counted, and each replay counts it again.  A capture
    or a replay that fails raises; nothing falls back to eager steps.
    """

    def __init__(self, run, staged, table, width, warmup, state=()):
        device = staged.storage.device
        self.window = staged.empty_like().copy_(staged)
        self.table = None if table is None else table.clone()
        self.out = torch.empty((staged.window, width), dtype=torch.float32,
                               device=device)
        self.state = list(state)
        stream = torch.cuda.current_stream(device)
        saved = [t.detach().clone() for t in self.state]
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            run(self.window.batch, self.table, self.out, range(warmup))
        stream.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(self.state, saved):
                t.copy_(s)
        del saved
        self.graph = torch.cuda.CUDAGraph()
        counted = launch_counts()
        start = time.perf_counter()
        with torch.cuda.graph(self.graph):
            run(self.window.batch, self.table, self.out,
                range(staged.window))
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - start
        self.launches = {k: n - counted[k] for k, n in launch_counts().items()}
        count_launches(self.launches, -1)
        self.pointers = [t.data_ptr() for t in self.state]
        self.replays = 0

    def __call__(self, staged, table=None, state=()):
        """Replay on ``staged`` (and ``table``); returns a copy of the
        per-slot rows ``[K, width]``."""
        if [t.data_ptr() for t in state] != self.pointers:
            raise RuntimeError('the state tensors moved since the capture: '
                               'a graph replays on the tensors it captured')
        self.window.copy_(staged)
        if table is not None:
            self.table.copy_(table, non_blocking=True)
        self.graph.replay()
        count_launches(self.launches)
        self.replays += 1
        return self.out.clone()


def _graph_for(graphs, staged, build):
    """The ``WindowGraph`` of ``staged``'s layout in ``graphs``, built by
    ``build()`` on first use."""
    key = (staged.layout, staged.size)
    if key not in graphs:
        graphs[key] = build()
    return graphs[key]


def make_fused_window_step(model, evaluator, optimizer, weights,
                           accumulation_steps: int, window: int,
                           is_raw: bool = True):
    """K train steps in one call over a staged window of K batches.

    Returns ``fused(state, staged) -> (state, (loss[K], terms))`` with
    each term ``[K, scales]``: per-step values, the loss already divided
    by ``accumulation_steps``, as ``make_train_step`` gives them one at a
    time.  The window must start at an optimizer boundary and cover
    whole ones (``window % accumulation_steps == 0``), so the updates
    fall at static slots and their scalars fill ``window /
    accumulation_steps`` rows of the optimizer's table.  On a card a call
    is one replay of the graph captured over the K-step body on the first
    window of each layout (``WindowGraph``; ``fused.graphs``), which
    captures the parameters, the optimizer state and the accumulator in
    place; on the CPU the body runs eagerly.
    """
    named = dict(model.named_parameters())
    return make_fused_update_step(
        _make_grad_fn(make_loss_fn(model, evaluator, weights, is_raw), named),
        model, optimizer, accumulation_steps, window,
        len(evaluator.shapes))


def make_fused_update_step(grad_fn, model, optimizer,
                           accumulation_steps: int, window: int, scales: int,
                           graph: bool = True):
    """The K-step body of ``make_fused_window_step`` around ``grad_fn(batch)
    -> (loss, terms, {name: grad})``, as ``make_update_step`` is the
    one-step body around it (the sharded steps of ``parallel/mesh.py``
    give it their reduced gradients).  ``scales`` is the loss's scale
    count.  With ``graph`` a window on a card is one ``WindowGraph``
    replay; without it, and on the CPU, the body runs eagerly over the
    staged window, its per-step values kept on the window's device.
    """
    if window <= 0 or window % accumulation_steps:
        raise ValueError(f'a fused window of {window} steps needs whole '
                         f'optimizer steps of {accumulation_steps}')
    named = dict(model.named_parameters())
    inv = 1.0 / accumulation_steps
    updates = window // accumulation_steps
    width = 1 + 3 * scales

    def make_body(state):
        def body(batch, table, out, slots):
            for k in slots:
                loss, terms, grads = grad_fn(slice_window_batch(batch, k))
                with torch.no_grad():
                    out[k].copy_(step_values(loss.detach() * inv, terms))
                if accumulation_steps == 1:
                    optimizer.apply(grads, table[k])
                else:
                    _accumulate(state, named, grads, inv)
                    if (k + 1) % accumulation_steps == 0:
                        optimizer.apply(state.grad_acc,
                                        table[k // accumulation_steps])
                        torch._foreach_zero_(list(state.grad_acc.values()))
        return body

    def state_tensors(state):
        return (list(model.parameters()) + list(model.buffers())
                + optimizer.tensors()
                + list((state.grad_acc or {}).values()))

    graphs = {}

    def fused(state, staged):
        if staged.window != window:
            raise ValueError(f'a window of {staged.window} batches, the step '
                             f'takes {window}')
        device = staged.storage.device
        if accumulation_steps > 1:
            _accumulator(state, named)
        table = optimizer.scalar_table(updates, device)
        body = make_body(state)
        if graph and device.type == 'cuda':
            replay = _graph_for(graphs, staged, lambda: WindowGraph(
                body, staged, table, width, warmup=accumulation_steps,
                state=state_tensors(state)))
            values = replay(staged, table, state_tensors(state))
        else:
            values = torch.empty((window, width), device=device)
            body(staged.batch, table, values, range(window))
        optimizer.advance(updates)
        state.micro_step += window
        state.step += updates
        return state, split_values(values, scales)

    fused.graphs = graphs
    return fused


def make_eval_step(model, evaluator, weights,
                   is_raw: bool = True) -> Callable:
    """Validation step: ``batch -> (loss, terms)`` with no autograd graph.
    The parameters are the model's own."""
    loss_fn = make_loss_fn(model, evaluator, weights, is_raw)

    def eval_step(batch):
        with torch.no_grad():
            return loss_fn(batch)

    return eval_step


def make_fused_eval_step(model, evaluator, weights, window: int,
                         is_raw: bool = True) -> Callable:
    """K validation steps in one call over a staged window.

    Returns ``fused(staged, n_valid=K) -> (loss[K], terms)`` with each
    term ``[K, scales]``; the caller drops the rows of the repeat-padded
    tail of a partial window, past ``n_valid``.  On a card one replay of
    a graph captured over the K forwards and losses (``WindowGraph``, one
    a window layout, ``fused.graphs``), which reads the model's live
    parameters; on the CPU the first ``n_valid`` forwards run eagerly and
    the tail's rows stay 0.
    """
    loss_fn = make_loss_fn(model, evaluator, weights, is_raw)
    scales = len(evaluator.shapes)

    def body(batch, table, out, slots):
        with torch.no_grad():
            for k in slots:
                out[k].copy_(step_values(
                    *loss_fn(slice_window_batch(batch, k))))

    graphs = {}

    def fused(staged, n_valid=window):
        if staged.window != window:
            raise ValueError(f'a window of {staged.window} batches, the step '
                             f'takes {window}')
        if staged.storage.is_cuda:
            values = _graph_for(graphs, staged, lambda: WindowGraph(
                body, staged, None, 1 + 3 * scales, warmup=1))(staged)
        else:
            values = torch.zeros((window, 1 + 3 * scales))
            body(staged.batch, None, values, range(n_valid))
        return split_values(values, scales)

    fused.graphs = graphs
    return fused
