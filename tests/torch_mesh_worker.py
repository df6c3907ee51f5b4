"""One rank of the port's sharded steps, for tests/test_torch_parallel.py
and tests/test_torch_mesh_window.py.

    python tests/torch_mesh_worker.py WORKDIR RANK WORLD PORT

Joins a gloo group of WORLD CPU ranks, reads ``WORKDIR/job.pt`` (the
weights, the batches and the cases the test wrote) and, for each case of
its world size, builds the case's mesh and runs on its shard of every
batch: the port's sharded train steps (kind ``train``), a sharded
validation pass (``eval``), staged windows through the fused window step,
slot by slot and one step at a time (``window``), the training loop with
windows and one batch at a time (``loop``), or a loop whose ranks stage
different windows (``disagree``); writes ``WORKDIR/<case>.<rank>.pt``
(losses, parameters, optimizer state, logged scalars).  Imports nothing
of JAX.
"""
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from dvs_of_training_framework_tpu_torch.data.device_queue import \
    stack_batches
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.parallel import (
    MeshGroups, check_windows_agree, initialize, make_sharded_eval_step,
    make_sharded_fused_window_step, make_sharded_train_step, parse_mesh,
    shard_of, split_batch_for_mesh)
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state)
from dvs_of_training_framework_tpu_torch.training.train import (
    make_hook_periodic, train, validate)


class ListLogger:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


def fresh(job):
    """A model from the job's weights, its loss and optimizer."""
    model = evflownet.Model(**job['model_kwargs'])
    model.load_state_dict(job['state_dict'])
    return (model, MultiScaleLoss(job['shapes']),
            construct_optimizer(job['optimizer'], model))


def run_case(job, case, groups):
    mesh = groups.mesh
    event = groups.event_index if mesh.event > 1 else None
    model, evaluator, optimizer = fresh(job)
    capacity = job['capacity']

    def prepare(collated, capacity=capacity):
        return shard_of(split_batch_for_mesh(
            collated, mesh.data, capacity, event_shards=mesh.event),
            groups.data_index, event)

    if case['kind'] == 'eval':
        def prepare_eval(collated, capacity):
            if int(collated['size']) % mesh.data:
                raise ValueError('indivisible')
            return prepare(collated, capacity // mesh.data)

        log = ListLogger()
        loss = validate(make_sharded_eval_step(model, evaluator,
                                               job['weights'], groups),
                        case['batches'], 0, log, job['tags'],
                        torch.device('cpu'),
                        event_capacity=capacity * mesh.data,
                        prepare_batch=prepare_eval)
        return {'loss': loss, 'scalars': log.scalars}
    if case['kind'] == 'window':
        return run_windows(job, case, groups, prepare)
    if case['kind'] in ('loop', 'disagree'):
        return run_loop(job, case, groups, prepare)
    step = make_sharded_train_step(
        model, evaluator, optimizer, job['weights'], case['accumulation'],
        groups,
        is_raw=case['is_raw'], event_axis=mesh.event > 1)
    state, losses = create_train_state(), []
    for collated in case['batches']:
        state, (loss, _) = step(state, prepare(collated).to('cpu'))
        losses.append(float(loss))
    return {'losses': losses, 'step': state.step,
            'state_dict': model.state_dict()}


def run_windows(job, case, groups, prepare):
    """The case's batches in staged windows of K through the fused window
    step and through the window step slot by slot, and one at a time
    through the per-step sharded step: each way's losses, parameters and
    optimizer state."""
    K, acc = case['window'], case['accumulation']
    pieces = [prepare(c) for c in case['batches']]
    windows = [stack_batches(pieces[i:i + K])
               for i in range(0, len(pieces), K)]
    out = {}
    for way in ('fused', 'slots', 'steps'):
        model, evaluator, optimizer = fresh(job)
        kwargs = dict(is_raw=case['is_raw'],
                      event_axis=groups.mesh.event > 1)
        state, losses = create_train_state(), []
        if way == 'fused':
            fused = make_sharded_fused_window_step(
                model, evaluator, optimizer, job['weights'], acc, groups, K,
                **kwargs)
            for w in windows:
                state, (loss, _) = fused(state, w)
                losses += loss.tolist()
        else:
            step = make_sharded_train_step(
                model, evaluator, optimizer, job['weights'], acc, groups,
                window=K if way == 'slots' else 0, **kwargs)
            inputs = ([w for w in windows for _ in range(K)]
                      if way == 'slots' else [b.to('cpu') for b in pieces])
            for batch in inputs:
                state, (loss, _) = step(state, batch)
                losses.append(float(loss))
        out[way] = {'losses': losses, 'step': state.step,
                    'state_dict': model.state_dict(),
                    'optimizer': optimizer.state_dict()}
    return out


def run_loop(job, case, groups, prepare):
    """``train()`` over the case's batches, with windows of K (the fused
    window step and the window check) and one batch at a time: each
    run's parameters, logged scalars, samples passed and hook calls.  A
    ``disagree`` case gives rank 1 an oversized batch that rank 0 does not
    see, and records the error the window check raises."""
    out = {}
    for window in (case['window'], 0):
        model, evaluator, optimizer = fresh(job)
        acc = case['accumulation']
        kwargs = dict(is_raw=case['is_raw'],
                      event_axis=groups.mesh.event > 1)
        step = make_sharded_train_step(model, evaluator, optimizer,
                                       job['weights'], acc, groups,
                                       window=window, **kwargs)
        fused = make_sharded_fused_window_step(
            model, evaluator, optimizer, job['weights'], acc, groups,
            window, **kwargs) if window and window % acc == 0 else None
        batches = list(case['batches'])
        if case['kind'] == 'disagree' and groups.rank == 1:
            batches.insert(1, case['oversized'])
        log, calls = ListLogger(), []
        hook = make_hook_periodic(lambda s, n: calls.append((s, n)),
                                  case['every'])
        try:
            state, samples = train(
                step, create_train_state(), batches, case['steps'], log,
                job['tags'], torch.device('cpu'), accumulation_steps=acc,
                event_capacity=job['capacity'] * groups.mesh.data,
                hooks={'record': hook}, metric_flush_steps=3,
                is_raw=case['is_raw'],
                prepare_batch=lambda c, capacity: prepare(c),
                window=window, train_step_fused=fused,
                window_check=check_windows_agree(groups.world_host_group)
                if window else None)
        except RuntimeError as error:
            return {'error': str(error)}
        out[window] = {'step': state.step, 'samples': samples,
                       'scalars': log.scalars, 'calls': calls,
                       'state_dict': model.state_dict(),
                       'optimizer': optimizer.state_dict()}
    return out


def main(workdir, rank, world, port):
    torch.set_num_threads(1)
    device = initialize(f'127.0.0.1:{port}', world, rank, 'cpu')
    job = torch.load(workdir / 'job.pt', weights_only=False)
    for case in job['cases']:
        if case['world'] != world:
            continue
        groups = MeshGroups(parse_mesh(case['mesh']), device)
        torch.save(run_case(job, case, groups),
                   workdir / f'{case["name"]}.{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         int(sys.argv[4]))
