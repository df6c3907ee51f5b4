"""``correct`` comes out false when the timed path is broken underneath:
a run on the CPU at a tiny size, the look for a chip skipped, with each
fault that a training cell can have planted in the port, and one that
shows only from the second window on."""
import pytest
import torch

import helpers

PORT = 'dvs_of_training_framework_tpu_torch'


def state_unchanged(monkeypatch):
    from dvs_of_training_framework_tpu_torch.training import optimizers
    monkeypatch.setattr(optimizers.Optimizer, 'apply',
                        lambda self, grads, scalars: None)


def half_batch(monkeypatch):
    from dvs_of_training_framework_tpu_torch.losses import loss
    whole = loss.MultiScaleLoss.__call__

    def first_half(self, flows, flow_ts, flow_sample_idx, *rest):
        keep = flows[0].shape[0] // 2
        return whole(self, tuple(f[:keep] for f in flows), flow_ts[:keep],
                     flow_sample_idx[:keep], *rest)

    monkeypatch.setattr(loss.MultiScaleLoss, '__call__', first_half)


def loss_shifted(monkeypatch):
    from dvs_of_training_framework_tpu_torch.training import state
    split = state.split_values

    def shifted(values, scales):
        loss, terms = split(values, scales)
        return torch.cat([loss[:1], loss[:-1]]), terms

    monkeypatch.setattr(state, 'split_values', shifted)


def stale_window(monkeypatch):
    """From the second window on, each staged window holds the batches of
    the window staged before it, as a reused upload buffer would."""
    from dvs_of_training_framework_tpu_torch.data import device_queue
    stack = device_queue.stack_batches
    staged = []

    def stale(batches, **kwargs):
        staged.append(stack(batches, **kwargs))
        return staged[-2] if len(staged) > 1 else staged[-1]

    monkeypatch.setattr(device_queue, 'stack_batches', stale)


WORKLOAD = 'evflownet.recipe_b8'


def test_a_sound_run_is_correct(tmp_path, capsys, monkeypatch):
    root = helpers.tiny_checkout(tmp_path)
    code, result, err = helpers.run(root, WORKLOAD, monkeypatch=monkeypatch,
                                    capsys=capsys)
    assert code == 0 and result['correct'] is True, err


@pytest.mark.parametrize('fault', [state_unchanged, half_batch,
                                   loss_shifted])
def test_a_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    root = helpers.tiny_checkout(tmp_path)
    fault(monkeypatch)
    code, result, err = helpers.run(root, WORKLOAD, monkeypatch=monkeypatch,
                                    capsys=capsys)
    assert code == 0
    assert result['correct'] is False, err


def test_a_stale_window_fails_the_check_window(tmp_path, capsys,
                                               monkeypatch):
    root = helpers.tiny_checkout(tmp_path)
    stale_window(monkeypatch)
    code, result, err = helpers.run(root, WORKLOAD, monkeypatch=monkeypatch,
                                    capsys=capsys)
    assert code == 0
    compared = result['compared']
    assert compared['loss_gap']['value'] <= compared['loss_gap']['limit']
    assert result['correct'] is False, err
