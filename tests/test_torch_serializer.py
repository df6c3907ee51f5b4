"""Port parity: the checkpoint serializer.

Mirrors the JAX package's tests/training/test_serializer.py (round trip,
retention, rediscovery, finalize, bare trees, optimizer-state resume,
background writes) on the port's ``torch.save`` storage, and adds:

- resume is exact on the CPU: six straight training steps of EVFlowNet
  (depth 4, base 8, 32x32, batch 2, RANGER with the clip and EMA riders,
  a Lookahead sync at step 6) equal three steps, a checkpoint, fresh
  objects, a load and three more, every parameter and optimizer tensor
  bit for bit (``torch.equal``);
- a checkpoint and a weights-only export written by the JAX package's
  ``Serializer`` read back through ``read_params_file`` equal
  ``flax_to_torch`` of its parameters exactly;
- a file in the other framework's format, or in none, raises.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu.training.serializer import \
    Serializer as JaxSerializer
from dvs_of_training_framework_tpu_torch.data.schema import pad_batch
from dvs_of_training_framework_tpu_torch.losses import MultiScaleLoss
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.training import (
    construct_optimizer, create_train_state, make_train_step)
from dvs_of_training_framework_tpu_torch.training.serializer import (
    Serializer, load_state_file, read_params_file, save_state_file)
from dvs_of_training_framework_tpu_torch.utils.convert import flax_to_torch
from tests.test_torch_optim import flax_params
from tests.test_torch_train_step import CAPACITY, SHAPES, make_collated


def params_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {'dense.kernel': torch.from_numpy(
                rng.normal(size=(4, 3)).astype(np.float32)),
            'dense.bias': torch.from_numpy(
                rng.normal(size=(3,)).astype(np.float32))}


def test_roundtrip(tmp_path):
    ser = Serializer(tmp_path, keep_checkpoints_max=2,
                     permanent_checkpoint_interval=10)
    params = params_tree()
    opt_state = {'momentum': params_tree(1)}
    ser.checkpoint_model(params, opt_state, global_step=1,
                         samples_passed=32)
    step, p, o, extra = ser.load_checkpoint(1)
    assert step == 1
    assert int(extra['samples_passed']) == 32
    assert torch.equal(p['dense.kernel'], params['dense.kernel'])
    assert torch.equal(o['momentum']['dense.bias'],
                       opt_state['momentum']['dense.bias'])


def test_retention_policy(tmp_path):
    ser = Serializer(tmp_path, keep_checkpoints_max=2,
                     permanent_checkpoint_interval=10)
    params = params_tree()
    for step in range(1, 13):
        ser.checkpoint_model(params, {}, global_step=step)
    # permanent: 10; temporal: the last two (11, 12)
    assert ser.list_known_steps() == [10, 11, 12]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'step_10.ckpt', 'step_11.ckpt', 'step_12.ckpt']


def test_rediscovery(tmp_path):
    ser = Serializer(tmp_path, keep_checkpoints_max=5,
                     permanent_checkpoint_interval=10)
    params = params_tree()
    for step in (1, 5, 10):
        ser.checkpoint_model(params, {}, global_step=step)
    # a new serializer over the same directory finds them by file name
    ser2 = Serializer(tmp_path, keep_checkpoints_max=5,
                      permanent_checkpoint_interval=10)
    assert ser2.list_known_steps() == [1, 5, 10]
    assert ser2.has_checkpoints()


def test_finalize_weights_only(tmp_path):
    ser = Serializer(tmp_path)
    params = params_tree()
    ser.checkpoint_model(params, {'mu': 1}, global_step=3)
    out = tmp_path / 'weights.ckpt'
    ser.finalize(3, out)
    assert torch.equal(read_params_file(out)['dense.kernel'],
                       params['dense.kernel'])


def test_read_params_accepts_bare_tree(tmp_path):
    params = params_tree()
    path = tmp_path / 'bare.ckpt'
    save_state_file(path, params)
    assert torch.equal(read_params_file(path)['dense.bias'],
                       params['dense.bias'])


def test_checkpoint_copies_the_live_state(tmp_path):
    """The file holds the state at the call, though the live tensors
    change in place after it (as the optimizer updates them)."""
    ser = Serializer(tmp_path, async_write=True)
    params = params_tree()
    want = {k: v.clone() for k, v in params.items()}
    ser.checkpoint_model(params, {}, global_step=1)
    for tensor in params.values():
        tensor.add_(1.0)
    ser.wait()
    _, got, _, _ = ser.load_checkpoint(1)
    assert all(torch.equal(got[k], want[k]) for k in want)


ARGS = SimpleNamespace(optimizer='RANGER', lr=1e-3, wdw=1e-4,
                       half_life=100000, num_warmup_steps=0,
                       training_steps=10, rs=0.3, grad_clip_norm=1.0,
                       ema_decay=0.9)


def make_trainer(seed):
    model = evflownet.Model(event_representation_depth=4, base_channels=8,
                            generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith('predictor.flow') and name.endswith('bias'):
                p.copy_(torch.tensor([0.37, 0.23]))
    optimizer = construct_optimizer(ARGS, model)
    step_fn = make_train_step(model, MultiScaleLoss(SHAPES), optimizer,
                              [0.5, 1, 1], 1)
    return model, optimizer, step_fn


def all_tensors(model, optimizer):
    """Every parameter and optimizer-state tensor by a flat name, and the
    group counts."""
    out = {f'model.{k}': v for k, v in model.state_dict().items()}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, f'{prefix}{key}.')
            else:
                out[prefix + key] = value

    walk(optimizer.state_dict(), 'optimizer.')
    return out


@pytest.fixture
def one_torch_thread():
    """A CPU step's bits depend on how many threads split its reductions
    (the kernel-MLP's bias gradients, the convolutions' weight gradients):
    8 threads against 3, 5 or 1 change most of the trained tensors.  Under
    parallel test workers a parallel region need not get the threads it
    asks for, so the two runs of the resume test could split differently.
    One intra-op thread fixes the split."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_resume_restores_optimizer_state(tmp_path, one_torch_thread):
    """3 steps, a checkpoint, fresh objects, a load and 3 more steps equal
    6 straight steps bit for bit (parameters, moments, slow weights, EMA,
    counts)."""
    batches = [pad_batch(make_collated(s), CAPACITY).to('cpu')
               for s in range(3)]
    model, optimizer, step_fn = make_trainer(0)
    state = create_train_state()
    for i in range(6):
        state, _ = step_fn(state, batches[i % 3])
    straight = all_tensors(model, optimizer)

    model, optimizer, step_fn = make_trainer(0)
    state = create_train_state()
    for i in range(3):
        state, _ = step_fn(state, batches[i % 3])
    ser = Serializer(tmp_path)
    ser.checkpoint_model(model.state_dict(), optimizer.state_dict(),
                         global_step=3, samples_passed=6)

    model, optimizer, step_fn = make_trainer(1)    # other weights
    step, _, _, extra = ser.load_checkpoint(3, model=model,
                                            optimizer=optimizer)
    assert (step, extra['samples_passed']) == (3, 6)
    state = create_train_state(step)
    for i in range(3, 6):
        state, _ = step_fn(state, batches[i % 3])
    resumed = all_tensors(model, optimizer)

    assert resumed.keys() == straight.keys()
    assert 'optimizer.groups.predictor.slow.predictor.enc0.weight' in resumed
    assert 'optimizer.ema_params.predictor.enc0.weight' in resumed
    for name, want in straight.items():
        got = resumed[name]
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want), name
        else:
            assert got == want, name
    assert optimizer.groups['predictor'].count == 6


def test_async_write(tmp_path):
    ser = Serializer(tmp_path, keep_checkpoints_max=2,
                     permanent_checkpoint_interval=10, async_write=True)
    params = params_tree()
    for step in range(1, 5):
        ser.checkpoint_model(params, {}, global_step=step,
                             samples_passed=step * 8)
    ser.wait()
    assert ser.list_known_steps() == [3, 4]
    step, p, _, extra = ser.load_checkpoint(4)
    assert step == 4 and int(extra['samples_passed']) == 32
    assert torch.equal(p['dense.kernel'], params['dense.kernel'])


@pytest.mark.parametrize('surfaces_in', ['wait', 'next checkpoint'])
def test_async_write_failure_is_raised(tmp_path, surfaces_in):
    """A background write that fails raises in the caller's thread, at
    the next wait() or checkpoint, and is not lost."""
    ser = Serializer(tmp_path, async_write=True)
    (tmp_path / 'step_2.ckpt').mkdir()          # the move into place fails
    (tmp_path / 'step_2.ckpt' / 'keep').touch()
    params = params_tree()
    ser.checkpoint_model(params, {}, global_step=2)
    with pytest.raises(OSError):
        if surfaces_in == 'wait':
            ser.wait()
        else:
            ser.checkpoint_model(params, {}, global_step=3)
    ser.wait()                                  # the error is raised once
    ser.checkpoint_model(params, {}, global_step=4)
    ser.wait()
    assert ser.load_checkpoint(4)[0] == 4


def test_reads_jax_checkpoints(tmp_path):
    """A JAX checkpoint and its weights-only export give the port's
    state_dict of the same values, which loads into the port's model."""
    params = flax_params()
    jax_opt = {'mu': params, 'count': np.int32(3)}
    ser = JaxSerializer(tmp_path / 'jax')
    ser.checkpoint_model(jax.tree_util.tree_map(jnp.asarray, params),
                         jax_opt, global_step=3, samples_passed=6)
    ser.finalize(3, tmp_path / 'weights.msgpack')
    want = flax_to_torch(params)
    for path in (tmp_path / 'jax' / 'step_3.ckpt',
                 tmp_path / 'weights.msgpack'):
        got = read_params_file(path)
        assert got.keys() == want.keys()
        for name, tensor in want.items():
            assert torch.equal(got[name], tensor), name
        model = evflownet.Model(event_representation_depth=4,
                                base_channels=8)
        model.load_state_dict(got, strict=True)


def test_wrong_format_raises(tmp_path):
    ser = JaxSerializer(tmp_path)
    ser.checkpoint_model({'w': np.ones(2, np.float32)}, {}, global_step=1)
    port = Serializer(tmp_path)
    assert port.list_known_steps() == [1]
    with pytest.raises(ValueError, match='msgpack file of the JAX package'):
        port.load_checkpoint(1)
    junk = tmp_path / 'junk.ckpt'
    junk.write_bytes(b'\x00not a checkpoint')
    for loader in (load_state_file, read_params_file):
        with pytest.raises(ValueError, match='not a torch.save archive'):
            loader(junk)
