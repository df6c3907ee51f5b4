"""The port's offline data tools, each run as ``python -m
dvs_of_training_framework_tpu_torch.tools.<name>``:

- ``make_synthetic_mvsec``: simulated MVSEC-format recordings with exact
  ground-truth flow (``scripts/make_synthetic_mvsec.py``);
- ``sequence2samples``: raw sequences sliced into per-element files
  (``scripts/sequence2samples.py``);
- ``prepare_batches``: augmented, encoded training shards
  (``scripts/prepare_batches.py``);
- ``quantize_preprocessed``: a trained model's representation baked
  into dense shards on the device, for ``--ev_images``
  (``scripts/quantize_preprocessed.py``);
- ``make_info``: the info file of raw sequences, their start times
  (``scripts/make_info.py``);
- ``zero_flow_baseline`` and ``oracle_flow_baseline``: the accuracy
  protocol's yardsticks, the AEE of zero flow and of the best constant
  flow over a test matrix (``scripts/{zero,oracle}_flow_baseline.py``);
- ``aee_table``: the evaluation CLI's pickles as ACCURACY.md's table,
  EMA rows apart (``scripts/aee_table.py``);
- ``fix_events``: TensorBoard logs repaired after restarts
  (``scripts/fix_events.py``);
- ``profile_dataset``: the training loader's µs an iteration
  (``scripts/profile_dataset.py``).

They take the scripts' arguments and write the npy store
(``data/store.py``), with numpy (and scipy for the ``varied`` motion)
alone; tqdm draws progress bars where it is installed
(``utils/progress.py``).
"""
