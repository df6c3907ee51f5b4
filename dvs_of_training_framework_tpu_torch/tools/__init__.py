"""The port's offline data tools, each run as ``python -m
dvs_of_training_framework_tpu_torch.tools.<name>``:

- ``make_synthetic_mvsec``: simulated MVSEC-format recordings with exact
  ground-truth flow (``scripts/make_synthetic_mvsec.py``);
- ``sequence2samples``: raw sequences sliced into per-element files
  (``scripts/sequence2samples.py``);
- ``prepare_batches``: augmented, encoded training shards
  (``scripts/prepare_batches.py``).

They take the scripts' arguments and write the npy store
(``data/store.py``), with numpy (and scipy for the ``varied`` motion)
alone; tqdm draws progress bars where it is installed
(``utils/progress.py``).
"""
