#!/usr/bin/env bash
# The port's verification-scaling grid on one card, as committed in
# experiments/verification_scaling_torch/results.json: the 13 GRID cells at
# 300 episodes under eager, fast and all_kernel, and under fast the oracle
# cells, verifier_int8 N=16 (int8_full) and the 24 OOD cells at 100, as five
# concurrent processes (the step is host-bound; they share the card).
#
#     bash scripts/torch_verification_scaling_grid.sh [out_dir]
#
# out_dir (default experiments/verification_scaling_torch) receives
# results.json, the episode pickles under episodes/ and one log a process.
set -euo pipefail
cd "$(dirname "$0")/.."
export VS_TORCH_OUT_DIR="${1:-experiments/verification_scaling_torch}"
mkdir -p "$VS_TORCH_OUT_DIR"
rm -f "$VS_TORCH_OUT_DIR/results.json"
eval_="python3 scripts/torch_verification_scaling.py eval --merge"
pids=()
for config in eager fast all_kernel; do
    $eval_ --config "$config" --trials 300 --no-with-oracle --no-ood \
        > "$VS_TORCH_OUT_DIR/grid_$config.log" 2>&1 &
    pids+=($!)
done
( $eval_ --config fast --trials 100 --quantize int8_full \
      --record-mode verifier_int8 --modes verifier --cells verifier,16,1 \
      --no-with-oracle --no-ood &&
  $eval_ --config fast --trials 100 --modes oracle
) > "$VS_TORCH_OUT_DIR/grid_fast_oracle_int8.log" 2>&1 &
pids+=($!)
$eval_ --config fast --trials 100 --modes first random verifier --cells none \
    --no-with-oracle > "$VS_TORCH_OUT_DIR/grid_fast_ood.log" 2>&1 &
pids+=($!)
status=0
for pid in "${pids[@]}"; do
    wait "$pid" || status=1
done
exit $status
