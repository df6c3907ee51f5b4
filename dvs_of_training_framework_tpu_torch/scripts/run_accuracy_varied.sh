#!/bin/bash
# The port's copy of scripts/run_accuracy_varied.sh: the accuracy run's
# training command, EVFlowNet on the shards of prep_accuracy_varied.sh,
# through the port's training CLI on its default device (cuda).  A run
# that fails is restarted up to MAX_RESTARTS times, and every start
# resumes from the run's newest checkpoint.
#
# Environment: STEPS (40000), SKIP_VALIDATION (1, the default, trains
# without validation; 0 validates on the outdoor_synth3 split every -vp
# steps), MAX_RESTARTS (20), LAYOUT (prep_accuracy_varied.sh's out_root)
# and SHARDS (its shard directory).  Extra arguments go last, so they
# override the script's own flags (argparse keeps the last), e.g.
# --flownet_path RecurrentFlowNet or -d cpu.  Every 15 s the training
# process's resident memory (kB, VmRSS of /proc/<pid>/status) is
# appended to <model_dir>/rss.log.
#
# Usage: dvs_of_training_framework_tpu_torch/scripts/run_accuracy_varied.sh <model_dir> [extra train args...]
set -u
MODEL_DIR=${1:?model dir}
shift
STEPS=${STEPS:-40000}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
cd "$REPO"
LAYOUT=${LAYOUT:-$REPO/experiments/torch_synth_varied_layout}
SHARDS=${SHARDS:-$REPO/experiments/torch_synth_varied_shards}
mkdir -p "$MODEL_DIR"

SKIP_VAL_FLAG=()
if [ "${SKIP_VALIDATION:-1}" -eq 1 ]; then
    SKIP_VAL_FLAG=(--skip-validation)
fi

rss_kb() {
    local key value rest
    while read -r key value rest; do
        if [ "$key" = VmRSS: ]; then
            echo "$value"
            return
        fi
    done < "/proc/$1/status"
}

run_once() {
    DVS_DATA_PATH=$LAYOUT/training/synth \
    PYTHONUNBUFFERED=1 \
    python -m dvs_of_training_framework_tpu_torch.train \
        -m "$MODEL_DIR" \
        --flownet_path EVFlowNet \
        --preprocessed-dataset-path "$SHARDS" \
        -bs 8 -mbs 8 \
        -ne "$STEPS" \
        -lr 1e-3 --half_life 20000 --num-warmup-steps 200 \
        --checkpointing_interval 2000 --permanent_interval 10000 \
        --num_checkpoints 3 \
        "${SKIP_VAL_FLAG[@]}" \
        --allow-arguments-change --allow-obsolete-code \
        "$@" &
    TRAIN_PID=$!
    while kill -0 "$TRAIN_PID" 2>/dev/null; do
        echo "$(date +%s) $(rss_kb "$TRAIN_PID" 2>/dev/null)" \
            >> "$MODEL_DIR/rss.log"
        # 15 s between samples, but return as soon as the run ends
        for ((i = 0; i < 75; i++)); do
            kill -0 "$TRAIN_PID" 2>/dev/null || break
            sleep 0.2
        done
    done
    wait "$TRAIN_PID"
    return $?
}

for attempt in $(seq 1 "${MAX_RESTARTS:-20}"); do
    echo "=== attempt $attempt $(date) ==="
    run_once "$@"
    rc=$?
    echo "=== exited rc=$rc ==="
    if [ "$rc" -eq 0 ]; then
        echo "=== training complete ==="
        exit 0
    fi
    sleep 5
done
echo "=== gave up after restarts ==="
exit 1
