#!/usr/bin/env bash
# Train on one host with one rank per card (the reference's
# tools/dist_train.sh): torch.distributed.run starts $GPUS ranks of
# gkgnet_tpu_torch.tools.train, which join the world from its environment.
# The config's mesh lays the ranks out (mesh = dict(data=None, graph=1):
# data parallel over every rank; --cfg-options mesh.graph=2 splits each
# graph conv's nodes over pairs of ranks).
#
# Usage: gkgnet_tpu_torch/tools/dist_train.sh <config> <gpus> [extra args...]
# Environment: PORT (default 29500), NNODES, NODE_RANK, MASTER_ADDR.
set -e
CONFIG=$1
GPUS=$2
shift 2
# the package from this checkout, whatever the working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
exec python -m torch.distributed.run \
    --nnodes="${NNODES:-1}" --node_rank="${NODE_RANK:-0}" \
    --master_addr="${MASTER_ADDR:-127.0.0.1}" \
    --nproc_per_node="$GPUS" --master_port="${PORT:-29500}" \
    -m gkgnet_tpu_torch.tools.train "$CONFIG" "$@"
