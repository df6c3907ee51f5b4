"""The evaluation CLI's ``DevicePool`` (``test.py``), against the in-turn
evaluation and against the JAX package's ``process_all``.

- ``DevicePool`` balances the jobs over its devices, as the root CLI's
  does (tests/training/test_eval_cli.py::test_device_pool_balances), and
  never runs more than ``tests_per_device`` jobs on a device at once; a
  job's exception reaches the caller.
- ``process_all`` over four checkpoints of EVFlowNet (four seeds of the
  port's initialisation) on the miniature raw sequence of
  tests/test_torch_eval_cli.py: on two CPU "devices" with two jobs each,
  every pickle and every TensorBoard scalar bit for bit the in-turn
  run's (one device, one job).
- The same checkpoints as the JAX package's checkpoints through the root
  CLI's ``process_all``: the same records at the rtol 1e-5 of
  tests/test_torch_eval_cli.py::test_process_single_pickle_matches_root_cli.
- On a machine with two cards or more, h5py and JAX (``cuda``, skipped
  without the cards): the checkpoints spread over every card equal the
  in-turn run on one card bit for bit, at one and two jobs a card.
  ``chip_smoke.py`` phase 32 makes the same check wherever it finds two
  cards.
"""
import pickle
import threading
import time
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch

from dvs_of_training_framework_tpu_torch import test as port_cli
from dvs_of_training_framework_tpu_torch.models import Model
from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from dvs_of_training_framework_tpu_torch.utils.convert import torch_to_flax
from dvs_of_training_framework_tpu_torch.utils.tb import read_events
from tests.test_torch_eval_cli import MODEL_ARGS, raw_sequence  # noqa: F401

STEPS = (1, 2, 3, 4)
CPU = torch.device('cpu')


def test_device_pool_balances():
    devices = [torch.device('cpu'), torch.device('meta')]
    calls, running, peak = [], {}, {}
    lock = threading.Lock()

    def job(args, device):
        with lock:
            running[device] = running.get(device, 0) + 1
            peak[device] = max(peak.get(device, 0), running[device])
            calls.append((args, device))
        time.sleep(0.02)
        with lock:
            running[device] -= 1

    port_cli.DevicePool(devices, tests_per_device=1)(job, list(range(6)))
    assert sorted(a for a, _ in calls) == list(range(6))
    # one job a device at a time: the free device takes the next job
    assert [d for _, d in calls].count(devices[0]) == 3
    assert peak == {d: 1 for d in devices}
    calls.clear()
    peak.clear()
    port_cli.DevicePool(devices, tests_per_device=2)(job, list(range(8)))
    assert sorted(a for a, _ in calls) == list(range(8))
    assert set(peak) == set(devices) and max(peak.values()) <= 2


def test_a_jobs_exception_reaches_the_caller():
    done = []

    def job(args, device):
        if args == 2:
            raise ValueError('job 2 failed')
        done.append(args)

    with pytest.raises(ValueError, match='job 2 failed'):
        port_cli.DevicePool([CPU, CPU], tests_per_device=1)(job,
                                                            list(range(4)))
    assert 2 not in done


@pytest.fixture
def layout(raw_sequence, tmp_path, monkeypatch):  # noqa: F811
    """The data root, the test config and a run of four checkpoints."""
    ds_dir, t0 = raw_sequence
    root = tmp_path / 'root'
    (root / 'raw').mkdir(parents=True)
    (root / 'raw' / 'mini').symlink_to(ds_dir)
    (root / 'info').mkdir()
    with h5py.File(root / 'info' / 'mini.hdf5', 'w') as f:
        f.create_dataset('set_name', data=np.array([b'mini_seq1']))
        f.create_dataset('start_time', data=np.array([t0]))
    cfg_path = tmp_path / 'cfg.json'
    cfg_path.write_text('{"mini": {"mini_seq1": {"step": [1, 2], '
                        '"start": 0.2, "stop": 1.0, "test_shape": [48, 48], '
                        '"crop_type": "central", "is_car": false}}}')
    monkeypatch.setenv('DVS_DATA_ROOT', str(root))
    run = tmp_path / 'run'
    ser = Serializer(run)
    checkpoints = {step: Model(generator=torch.Generator().manual_seed(
        10 + step)).state_dict() for step in STEPS}
    for step, state in checkpoints.items():
        ser.checkpoint_model(state, {}, global_step=step,
                             samples_passed=4 * step + 1)
    return SimpleNamespace(tmp=tmp_path, run=run, cfg=cfg_path,
                           checkpoints=checkpoints)


def process_all(cli, layout, run, out, tests_per_device, devices=None,
                **extra):
    args = SimpleNamespace(model=run, output=out, test_config=layout.cfg,
                           tests_per_device=tests_per_device, bs=4,
                           eval_batch_windows=4, **MODEL_ARGS, **extra)
    if devices is None:
        cli.process_all(args)
    else:
        cli.process_all(args, devices=devices)
    return out


def outputs(out):
    """Every pickle's bytes and every TensorBoard scalar, in order."""
    pickles = {p.name: p.read_bytes() for p in sorted(out.glob('*.pkl'))}
    scalars = [(tag, event['step'], value)
               for path in sorted((out / 'log').glob('events.out.*'))
               for event in read_events(path)
               for tag, value in event['scalars'].items()]
    return pickles, scalars


def test_the_pool_writes_what_the_in_turn_run_writes(layout):
    in_turn = outputs(process_all(port_cli, layout, layout.run,
                                  layout.tmp / 'in_turn', 1, [CPU],
                                  device='cpu'))
    pooled = outputs(process_all(port_cli, layout, layout.run,
                                 layout.tmp / 'pooled', 2, [CPU, CPU],
                                 device='cpu'))
    assert sorted(in_turn[0]) == [f'step_{s}.pkl' for s in STEPS]
    assert pooled[0] == in_turn[0]
    assert len(in_turn[1]) == 2 * 2 * len(STEPS)
    assert pooled[1] == in_turn[1]


def test_the_pool_matches_the_root_clis_process_all(layout):
    import test as root_cli
    from dvs_of_training_framework_tpu.training.serializer import \
        Serializer as JaxSerializer
    jax_run = layout.tmp / 'jax_run'
    ser = JaxSerializer(jax_run)
    for step, state in layout.checkpoints.items():
        ser.checkpoint_model(torch_to_flax(state), {}, global_step=step,
                             samples_passed=4 * step + 1)
    ser.wait()
    want = process_all(root_cli, layout, jax_run, layout.tmp / 'root', 2)
    got = process_all(port_cli, layout, layout.run, layout.tmp / 'port', 2,
                      [CPU, CPU], device='cpu')
    for step in STEPS:
        records = [[vars(r) for r in pickle.loads(
            (out / f'step_{step}.pkl').read_bytes())] for out in (got, want)]
        assert len(records[0]) == len(records[1]) == 2
        for g, w in zip(*records):
            numbers = ('mAEE', 'mpAEE', 'mMedEE')
            np.testing.assert_allclose([g[k] for k in numbers],
                                       [w[k] for k in numbers], rtol=1e-5)
            for key in g.keys() - set(numbers) - {'windows'}:
                assert g[key] == w[key], key
    got_scalars, want_scalars = outputs(got)[1], outputs(want)[1]
    assert [(t, s) for t, s, _ in got_scalars] == \
        [(t, s) for t, s, _ in want_scalars]
    np.testing.assert_allclose([v for _, _, v in got_scalars],
                               [v for _, _, v in want_scalars], rtol=1e-5)


@pytest.mark.cuda
def test_the_cards_write_what_one_card_writes(layout):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA cards or more')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cards = port_cli.pool_devices('cuda')
    assert len(cards) == torch.cuda.device_count()
    in_turn = outputs(process_all(port_cli, layout, layout.run,
                                  layout.tmp / 'one_card', 1, cards[:1],
                                  device='cuda:0'))
    for per_card in (1, 2):
        spread = outputs(process_all(port_cli, layout, layout.run,
                                     layout.tmp / f'cards_{per_card}',
                                     per_card, device='cuda'))
        assert spread == in_turn
