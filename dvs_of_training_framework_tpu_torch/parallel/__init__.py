"""Scale-out of the port: one process a device, ``torch.distributed``
process groups over a data axis and an event axis (counterpart of
``dvs_of_training_framework_tpu/parallel``)."""
from .distributed import (ShardedBatchSkipper, agree_on_drops,
                          broadcast_batches, check_windows_agree,
                          distributed_spec, initialize,
                          maybe_initialize_distributed, window_rule)
from .mesh import (MeshGroups, MeshSpec, check_replicas,
                   make_sharded_eval_step, make_sharded_fused_window_step,
                   make_sharded_grad_fn, make_sharded_train_step,
                   parse_mesh, shard_of, split_batch_for_mesh)

__all__ = ['MeshGroups', 'MeshSpec', 'ShardedBatchSkipper',
           'agree_on_drops', 'broadcast_batches', 'check_replicas',
           'check_windows_agree', 'distributed_spec', 'initialize', 'make_sharded_eval_step',
           'make_sharded_fused_window_step', 'make_sharded_grad_fn',
           'make_sharded_train_step', 'maybe_initialize_distributed',
           'parse_mesh', 'shard_of', 'split_batch_for_mesh', 'window_rule']
