#!/usr/bin/env bash
# Evaluate under SLURM with one task per card (the reference's
# tools/slurm_test.sh): as slurm_train.sh, running
# gkgnet_tpu_torch.tools.test --multihost.
#
# Usage: gkgnet_tpu_torch/tools/slurm_test.sh <partition> <job_name> <config> <checkpoint> [extra args...]
# Environment: GPUS (8), GPUS_PER_NODE (8), CPUS_PER_TASK (5), PORT (29500),
#              SRUN_ARGS.
set -e
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
CHECKPOINT=$4
shift 4
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
SRUN_ARGS=${SRUN_ARGS:-""}
# the package from this checkout, whatever the working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
export PORT=${PORT:-29500}
exec srun -p "$PARTITION" \
    --job-name="$JOB_NAME" \
    --gres=gpu:"$GPUS_PER_NODE" \
    --ntasks="$GPUS" \
    --ntasks-per-node="$GPUS_PER_NODE" \
    --cpus-per-task="$CPUS_PER_TASK" \
    --kill-on-bad-exit=1 \
    $SRUN_ARGS \
    bash -c 'export RANK=$SLURM_PROCID WORLD_SIZE=$SLURM_NTASKS \
                    LOCAL_RANK=$SLURM_LOCALID \
                    LOCAL_WORLD_SIZE=$SLURM_NTASKS_PER_NODE \
                    MASTER_PORT=$PORT \
                    MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1);
             exec python -m gkgnet_tpu_torch.tools.test "$@" --multihost' \
    _ "$CONFIG" "$CHECKPOINT" "$@"
