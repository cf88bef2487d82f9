#!/bin/bash
# The verification-scaling experiment's last stages and tools on one card,
# with the committed trees: the roofline of recorded fast and all_kernel
# E16_N16_K1 steps, `calibrate` of the committed verifier (fast, eager),
# the DAgger-round, rephrase-policy and deference cells (fast, 100
# episodes each), the OOD diagnostics under eager and fast, the DAgger
# notes and the report. The cells and diagnostics run as concurrent
# processes; results go to experiments/verification_scaling_torch/
# (results.json, ood_diagnostics.json, report.md), logs and the
# calibration metas to OUT.
#
#   bash scripts/torch_verification_scaling_tools.sh [OUT]   # ~5 min, H100
set -uo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-build/vs_tools}
ART=$PWD/$OUT/art
mkdir -p "$OUT" "$ART" "$OUT/empty"
RES=$PWD/experiments/verification_scaling_torch/results.json
P="python -u scripts/torch_verification_scaling.py"
D="python -u scripts/torch_ood_diagnostics.py"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
# 1. the roofline, alone on the card
BENCH_TRACE_DIR=$OUT/trace_fast python -u scripts/torch_roofline.py --record \
  --config fast --steps 4 > "$OUT/roofline_fast.log" 2>&1
echo "roofline fast rc $?" | tee -a "$OUT/rcs"
BENCH_TRACE_DIR=$OUT/trace_allk python -u scripts/torch_roofline.py --record \
  --config all_kernel --steps 1 > "$OUT/roofline_all_kernel.log" 2>&1
echo "roofline all_kernel rc $?" | tee -a "$OUT/rcs"
rm -rf "$OUT/trace_fast" "$OUT/trace_allk"
# 2. the committed verifier calibrated into a scratch artifact directory
export VS_TORCH_ART_DIR=$ART
$P calibrate --config fast --out verifier_params_fast.pkl \
  > "$OUT/calibrate_fast.log" 2>&1
echo "calibrate fast rc $?" | tee -a "$OUT/rcs"
$P calibrate --config eager > "$OUT/calibrate_eager.log" 2>&1
echo "calibrate eager rc $?" | tee -a "$OUT/rcs"
pct() { python -c "import json, sys; print(json.load(open(sys.argv[1]))['id_affinity'][sys.argv[2]])" "$ART/verifier_params.pkl.meta.json" "$1"; }
P05=$(pct p05)
P50=$(pct p50)
# 3. the cells and the diagnostics
$P eval --config fast --verifier-params verifier_dagger_r1.pkl \
  --record-mode verifier_dag --modes verifier --cells verifier,16,1 \
  verifier,40,1 verifier,80,1 --no-ood --no-with-oracle --merge \
  --skip-existing --results "$RES" > "$OUT/eval_dag.log" 2>&1 &
A=$!
$P eval --config fast --policy-params policy_rephrase.pkl \
  --run-name rephrase_policy --cells first,1,1 random,16,1 verifier,5,1 \
  verifier,16,1 random,5,8 verifier,5,8 verifier,16,8 oracle,16,1 \
  --no-ood --results "$RES" > "$OUT/eval_rephrase.log" 2>&1 &
B=$!
$P eval --config fast --verifier-params verifier_params.pkl --run-name defer \
  --defer-threshold "$P05" --modes verifier --cells verifier,16,1 \
  --no-with-oracle --results "$RES" > "$OUT/eval_defer.log" 2>&1 &
C=$!
$P eval --config fast --verifier-params verifier_params.pkl \
  --run-name defer_p50 --defer-threshold "$P50" --modes verifier \
  --cells verifier,16,1 --no-with-oracle --results "$RES" \
  > "$OUT/eval_defer_p50.log" 2>&1 &
E=$!
$D all --config eager --verifiers verifier_params.pkl verifier_dagger_r1.pkl \
  > "$OUT/diag_eager.log" 2>&1 &
F=$!
$D all --config fast --verifiers verifier_params.pkl verifier_dagger_r1.pkl \
  > "$OUT/diag_fast.log" 2>&1 &
G=$!
for x in A B C E F G; do wait "${!x}"; echo "$x rc $?" | tee -a "$OUT/rcs"; done
# 4. the DAgger rounds (metas from the committed directory) and the report
export VS_TORCH_ART_DIR=$PWD/$OUT/empty
$P dagger_note --config fast --results "$RES" --round 0 \
  --checkpoint verifier_params.pkl --mode verifier > "$OUT/dagger0.log" 2>&1
echo "dagger0 rc $?" | tee -a "$OUT/rcs"
$P dagger_note --config fast --results "$RES" --round 1 \
  --checkpoint verifier_dagger_r1.pkl --mode verifier_dag \
  > "$OUT/dagger1.log" 2>&1
echo "dagger1 rc $?" | tee -a "$OUT/rcs"
$P report --config fast --results "$RES" > "$OUT/report.log" 2>&1
echo "report rc $?" | tee -a "$OUT/rcs"
! grep -qv " rc 0$" "$OUT/rcs"
