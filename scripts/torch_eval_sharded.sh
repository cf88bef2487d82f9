#!/bin/bash
# Trial-sharded evaluation on the PyTorch port (the counterpart of
# scripts/eval_sharded.sh): the trial budget split across SHARDS concurrent
# `python -m cover_vla_tpu_torch.run --role eval` processes by seed offset
# (shard i runs seed 7 + 1000 i), each into its own out dir, then the
# episodes of every shard merged through the port's eval.analyze.
#
#   bash scripts/torch_eval_sharded.sh [SUITE] [SHARDS] [TRIALS_PER_SHARD] \
#       [extra run.py flags...]
#   OUT=/tmp/ev bash scripts/torch_eval_sharded.sh simpler_widowx 2 1 \
#       --eval.tiny true --device cpu        # on the CPU, tiny models
#
# On one card the shards share it; with several, set CUDA_VISIBLE_DEVICES
# per shard (SHARD_GPUS="0 1 2 3" gives shard i the i-th of them). On the
# CPU, give each shard its share of the cores (OMP_NUM_THREADS). Each
# shard's log is $OUT.shard_<i>.log.
set -euo pipefail
SUITE=${1:-simpler_widowx}
SHARDS=${2:-4}
TRIALS_PER_SHARD=${3:-25}
shift $(( $# < 3 ? $# : 3 ))
OUT=${OUT:-eval_out}
read -r -a GPUS <<< "${SHARD_GPUS:-}"

pids=()
for i in $(seq 0 $((SHARDS - 1))); do
  if [ ${#GPUS[@]} -gt 0 ]; then
    export CUDA_VISIBLE_DEVICES=${GPUS[$((i % ${#GPUS[@]}))]}
  fi
  python -m cover_vla_tpu_torch.run --role eval \
    --eval.task_suite "$SUITE" \
    --eval.num_trials_per_task "$TRIALS_PER_SHARD" \
    --eval.seed $((7 + i * 1000)) \
    --eval.out_dir "$OUT/shard_$i" "$@" > "$OUT.shard_$i.log" 2>&1 &
  pids+=($!)
done
for i in "${!pids[@]}"; do
  wait "${pids[$i]}" || { tail -n 30 "$OUT.shard_$i.log"; exit 1; }
done
OUT="$OUT" python - <<'PY'
import glob
import os

from cover_vla_tpu_torch.eval.analyze import aggregate, load_episodes, render_table

eps = []
for d in sorted(glob.glob(os.path.join(os.environ["OUT"], "shard_*"))):
    eps.extend(load_episodes(d))
print(render_table(aggregate(eps)))
PY
