#!/bin/bash
# The port's copy of scripts/eval_accuracy_varied.sh: the evaluation
# protocol over a run's checkpoints with the port's evaluation CLI on its
# default device (cuda).  The validation sequence (outdoor_synth3,
# config/synth_val.json) selects the checkpoint; the test sequence
# (outdoor_synth1, config/synth_testing.json) gives the headline
# numbers.  Each matrix is scored at every kept checkpoint, then
# tools.aee_table --median prints its rows.
#
# Environment: LAYOUT (prep_accuracy_varied.sh's out_root).  Arguments
# after out_prefix go to the evaluation CLI, after the script's own
# flags, so they override them: e.g. --flownet_path RecurrentFlowNet or
# -d cpu.
#
# Usage: dvs_of_training_framework_tpu_torch/scripts/eval_accuracy_varied.sh <model_dir> [out_prefix [extra test args...]]
set -eu
MODEL_DIR=${1:?model dir}
PREFIX=${2:-$MODEL_DIR}
shift $(($# < 2 ? $# : 2))
REPO=$(cd "$(dirname "$0")/../.." && pwd)
cd "$REPO"
LAYOUT=${LAYOUT:-$REPO/experiments/torch_synth_varied_layout}
PORT=dvs_of_training_framework_tpu_torch

run_eval() {
    local config=$1 out=$2
    shift 2
    DVS_DATA_ROOT=$LAYOUT \
    PYTHONUNBUFFERED=1 \
    python -m $PORT.test -m "$MODEL_DIR" -o "$out" \
        --flownet_path EVFlowNet \
        --test-config "$config" "$@"
}

echo "=== val matrix (checkpoint selection) ==="
run_eval $PORT/config/synth_val.json "${PREFIX}_val" "$@"
python -m $PORT.tools.aee_table "${PREFIX}_val" --median

echo "=== test matrix (headline) ==="
run_eval $PORT/config/synth_testing.json "${PREFIX}_eval" "$@"
python -m $PORT.tools.aee_table "${PREFIX}_eval" --median
