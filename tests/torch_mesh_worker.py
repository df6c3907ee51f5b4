"""One rank of the port's sharded steps, for tests/test_torch_parallel.py.

    python tests/torch_mesh_worker.py WORKDIR RANK WORLD PORT

Joins a gloo group of WORLD CPU ranks, reads ``WORKDIR/job.pt`` (the
weights, the batches and the cases the test wrote) and, for each case of
its world size, builds the case's mesh and runs the port's sharded train
steps or a sharded validation pass on its shard of every batch; writes
``WORKDIR/<case>.<rank>.pt`` (losses, parameters, logged scalars).
Imports nothing of JAX.
"""
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.parallel import (
    MeshGroups, initialize, make_sharded_eval_step, make_sharded_train_step,
    parse_mesh, shard_of, split_batch_for_mesh)
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state)
from dvs_of_training_framework_tpu_torch.training.train import validate


class ListLogger:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


def run_case(job, case, groups):
    mesh = groups.mesh
    event = groups.event_index if mesh.event > 1 else None
    model = evflownet.Model(**job['model_kwargs'])
    model.load_state_dict(job['state_dict'])
    evaluator = MultiScaleLoss(job['shapes'])
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
    step = make_sharded_train_step(
        model, evaluator, construct_optimizer(job['optimizer'], model),
        job['weights'], case['accumulation'], groups,
        is_raw=case['is_raw'], event_axis=mesh.event > 1)
    state, losses = create_train_state(), []
    for collated in case['batches']:
        state, (loss, _) = step(state, prepare(collated).to('cpu'))
        losses.append(float(loss))
    return {'losses': losses, 'step': state.step,
            'state_dict': model.state_dict()}


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
