#!/bin/bash
# The verification-scaling rebuild on the PyTorch port (the counterpart of
# scripts/run_r5_pipeline.sh): rephrase-augmented policy, DR + shape
# backbone, grounded-instruction DR verifier, DAgger rounds. Builds into a
# scratch artifact directory (VS_TORCH_ART_DIR) so the committed artifacts
# stay as they are; every stage runs on the card (--config fast: the decode
# and tower kernels), one after another.
#
# Usage: bash scripts/torch_run_r5_pipeline.sh phase1|dagger|evalgrid
#        DEVICE=cpu for a CPU run (add the stages' size flags by hand)
set -euo pipefail
cd "$(dirname "$0")/.."
export VS_TORCH_ART_DIR=${VS_TORCH_ART_DIR:-$PWD/build/vs_r5}
mkdir -p "$VS_TORCH_ART_DIR"
COMMON=(--config "${CONFIG:-fast}")
if [ -n "${DEVICE:-}" ]; then COMMON+=(--device "$DEVICE"); fi
P() { python -u scripts/torch_verification_scaling.py "$1" "${COMMON[@]}" "${@:2}"; }
D() { python -u scripts/torch_ood_diagnostics.py "$1" "${COMMON[@]}" \
        --art-dir "$VS_TORCH_ART_DIR" "${@:2}"; }

phase1() {
  P demos
  P train_policy                               # --rephrases defaults ON
  P pretrain_backbone                          # synthetic DR incl. shapes
  P rankdata --episodes 1500 --out rankdata.npz
  P rankdata --episodes 1500 --domain-rand --id-frac 0.15 \
     --out rankdata_dr.npz
  P train_verifier --data rankdata.npz rankdata_dr.npz \
     --out verifier_params.pkl
  # quality gates: per-task selection gain + noun grounding + backbone
  D regret --verifiers verifier_params.pkl --episodes 20
  D lang --verifiers verifier_params.pkl --data rankdata_dr.npz
  D probe --verifiers verifier_params.pkl
}

# DAgger rounds: recollect under the deployed verifier's own selection
# (ID + DR), retrain on everything; per-round quick eval cells
dagger() {
  P rankdata --episodes 1000 --out rankdata2.npz \
     --dagger-params "$VS_TORCH_ART_DIR/verifier_params.pkl" --dagger-frac 0.5
  P rankdata --episodes 1000 --domain-rand --id-frac 0.15 \
     --out rankdata2_dr.npz \
     --dagger-params "$VS_TORCH_ART_DIR/verifier_params.pkl" --dagger-frac 0.5
  P train_verifier \
     --data rankdata.npz rankdata_dr.npz rankdata2.npz rankdata2_dr.npz \
     --out verifier_r1.pkl
  D regret --verifiers verifier_params.pkl verifier_r1.pkl --episodes 20
}

# the grid of the trees trained here: ID cells + oracle + OOD + rephrase
# axis, then the report beside them
evalgrid() {
  P eval --trials 100 --n-parallel 10 --policy-params policy_params.pkl \
     --verifier-params "${VERIFIER:-verifier_params.pkl}"
  P report --art-dir "$VS_TORCH_ART_DIR"
}

"$@"
