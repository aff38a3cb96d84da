#!/usr/bin/env bash
# Evaluate on one host with one rank per card (the reference's
# tools/dist_test.sh): torch.distributed.run starts $GPUS ranks of
# gkgnet_tpu_torch.tools.test; each data rank scores its share of the test
# split and rank 0 prints the metrics of the whole, in dataset order.
#
# Usage: gkgnet_tpu_torch/tools/dist_test.sh <config> <checkpoint> <gpus> [extra args...]
# Environment: PORT (default 29500).
set -e
CONFIG=$1
CHECKPOINT=$2
GPUS=$3
shift 3
# the package from this checkout, whatever the working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
exec python -m torch.distributed.run \
    --nproc_per_node="$GPUS" --master_port="${PORT:-29500}" \
    -m gkgnet_tpu_torch.tools.test "$CONFIG" "$CHECKPOINT" "$@"
