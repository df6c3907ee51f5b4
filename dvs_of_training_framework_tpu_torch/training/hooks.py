"""Periodic training hooks: checkpointing and validation.

Counterpart of ``dvs_of_training_framework_tpu/training/hooks.py``
(reference utils/hooks/serialization.py, utils/hooks/validation.py).
The model and the optimizer hold the live state and are updated in place,
so the hooks read them directly.
"""
import copy

from .train import validate, validate_windowed


class SerializationHook:
    """Checkpoint the model and the optimizer and flush the TensorBoard
    log together, so the metric history stays aligned with the
    checkpoints across crashes."""

    def __init__(self, serializer, model, optimizer, logger):
        self.serializer = serializer
        self.model = model
        self.optimizer = optimizer
        self.logger = logger

    def __call__(self, steps: int, samples: int):
        self.serializer.checkpoint_model(
            self.model.state_dict(),
            self.optimizer.state_dict(),
            global_step=steps,
            samples_passed=samples)
        self.logger.flush()
        print(f'Flushed logs for step {steps} ({samples} passed)')


class ValidationHook:
    """Runs a validation pass over the validation loader.  Validation is
    always raw, also when training is dense (``--ev_images``): the
    validation loader serves raw events (``data/dataloader.py``)."""

    def __init__(self, eval_step, loader_factory, logger, tags, device,
                 event_capacity=2 ** 18, sequence_length=None,
                 prepare_batch=None, fused_eval_step=None, window: int = 0):
        """
        Args:
            eval_step: ``batch -> (loss, terms)`` (``state.make_eval_step``).
            loader_factory: zero-argument callable producing a fresh
                finite validation loader.
            logger: SummaryWriter.
            tags: per-scale tags.
            device: the torch device of the model.
            sequence_length: per-sample slot count for dynamic sample
                lengths, None for static lengths.
            prepare_batch: optional mesh-side batch preparation for a
                SHARDED eval_step (``parallel.make_sharded_eval_step``):
                validation then runs on every rank, each on its shard.
            fused_eval_step: optional windowed eval step
                (``state.make_fused_eval_step``); with ``window > 0`` the
                pass runs through the device queue, K batches a call
                (``train.validate_windowed``), with the same scalars.
        """
        self.prepare_batch = prepare_batch
        self.eval_step = eval_step
        self.loader_factory = loader_factory
        self.logger = logger
        self.tags = copy.deepcopy(list(tags))
        self.device = device
        self.event_capacity = event_capacity
        self.sequence_length = sequence_length
        self.fused_eval_step = fused_eval_step
        self.window = window

    def __call__(self, steps: int, samples: int):
        if self.fused_eval_step is not None and self.window > 0:
            validate_windowed(self.fused_eval_step, self.loader_factory(),
                              samples, self.logger, self.tags, self.window,
                              self.device,
                              event_capacity=self.event_capacity,
                              sequence_length=self.sequence_length)
            return
        validate(self.eval_step, self.loader_factory(), samples, self.logger,
                 self.tags, self.device, event_capacity=self.event_capacity,
                 sequence_length=self.sequence_length,
                 prepare_batch=self.prepare_batch)
