#!/bin/bash
# The port's copy of scripts/prep_accuracy_varied.sh: build the
# spatially-varying synthetic dataset and the preprocessed shards that
# run_accuracy_varied.sh trains on, with the port's tools and JSON
# configs.  Every file is the port's npy store; neither JAX, h5py nor
# PyYAML is needed.
#
# Chain (the original's):
#   tools.make_synthetic_mvsec --motion varied   raw sequences + exact GT + info
#   tools.sequence2samples                       slice to per-frame-pair elements
#   tools.prepare_batches -s $SIZE               augment + encode -> shards
#
# Environment: TRAIN_SECS, EVAL_SECS, VAL_SECS (the three splits' seconds,
# 60, 12 and 12 as in the original), SIZE (samples, 16384), SHARDS (the
# shard directory) and PREP_ARGS (more flags for prepare_batches, e.g.
# "--min-sequence-length 2 --max-sequence-length 2" for 2-element
# samples).  A step whose output exists is skipped; prepare_batches
# resumes until SIZE samples exist.  Each tool that runs prints its
# seconds.
#
# Usage: dvs_of_training_framework_tpu_torch/scripts/prep_accuracy_varied.sh [out_root]
set -eu
REPO=$(cd "$(dirname "$0")/../.." && pwd)
cd "$REPO"
ROOT=${1:-$REPO/experiments/torch_synth_varied_layout}
SHARDS=${SHARDS:-$REPO/experiments/torch_synth_varied_shards}
SIZE=${SIZE:-16384}
PORT=dvs_of_training_framework_tpu_torch

timed() {        # timed python -m <module> ...: prints its seconds
    local t0 ms
    t0=$(date +%s%N)
    "$@"
    ms=$((($(date +%s%N) - t0) / 1000000))
    printf '=== %s: %d.%03d s ===\n' "${3##*.}" $((ms / 1000)) $((ms % 1000))
}

# the npy store writes info/synth.hdf5 as a directory: -e, not -f
if [ ! -e "$ROOT/info/synth.hdf5" ]; then
    timed python -m $PORT.tools.make_synthetic_mvsec "$ROOT" \
        --motion varied --speed 0.35 --train-secs "${TRAIN_SECS:-60}" \
        --eval-secs "${EVAL_SECS:-12}" --val-secs "${VAL_SECS:-12}"
fi

if [ ! -d "$ROOT/training/synth/outdoor_synth2" ]; then
    DVS_DATA_ROOT=$ROOT timed python -m $PORT.tools.sequence2samples \
        $PORT/config/synth_train_datasets.json
fi

# the loaders' split (train = <data_path>/outdoor_day2, val =
# outdoor_day1): alias the synthetic train and validation sequences
ln -sfn "$ROOT/training/synth/outdoor_synth2" \
    "$ROOT/training/synth/outdoor_day2"
if [ -d "$ROOT/training/synth/outdoor_synth3" ]; then
    ln -sfn "$ROOT/training/synth/outdoor_synth3" \
        "$ROOT/training/synth/outdoor_day1"
fi

# PREP_ARGS: flags, split on blanks
DVS_DATA_PATH=$ROOT/training/synth timed python -m \
    $PORT.tools.prepare_batches -o "$SHARDS" -s "$SIZE" \
    --samples-per-file 1024 ${PREP_ARGS:-}
echo "=== prep complete: $SHARDS ==="
