#!/usr/bin/env bash
# The verification-scaling experiment's training stages on the port, on one
# card, in the order of the JAX script's `all` pipeline, then the eval cells
# that score what they trained against the JAX package's committed cells:
#
#   1. concurrently: demos -> train_policy -> rankdata (1,500 episodes, the
#      new policy rolled under the `fast` kernels); pretrain_backbone; and
#      on the committed data, train_verifier as the `all` pipeline's last
#      verifier stage trains it (rankdata.npz + rankdata2.npz, the committed
#      pretrained tower: verifier_committed_data.pkl), then as the committed
#      verifier_params.pkl was trained (rankdata.npz alone, that tree's own
#      vision tower, no cross-task text: verifier_r0_recipe.pkl);
#   2. concurrently, on the port's rankdata with the port's tower:
#      train_verifier at the defaults (verifier_params.pkl) and with the
#      committed verifier's recipe (verifier_chain_r0_recipe.pkl);
#   3. concurrently, 300 episodes a cell under `fast`, into results.json:
#      a_policy           the port's policy, the committed verifier:
#                         first N=1, random N=16
#      b_verifier         the committed policy, verifier_committed_data.pkl:
#                         verifier N=16, N=5
#      b0_r0_recipe       the committed policy, verifier_r0_recipe.pkl:
#                         verifier N=16, N=5
#      d_chain            the port's policy and verifier_params.pkl:
#                         first N=1, random N=16, verifier N=16
#      d0_chain_r0_recipe the port's policy, verifier_chain_r0_recipe.pkl:
#                         verifier N=16
#
#     bash scripts/torch_verification_scaling_train.sh [art_dir]
#
# art_dir (default experiments/verification_scaling_torch/trained) receives
# every artifact, its .meta.json, results.json, the episode pickles under
# episodes/ and one log a process under logs/.
set -euo pipefail
cd "$(dirname "$0")/.."
export VS_TORCH_ART_DIR="${1:-experiments/verification_scaling_torch/trained}"
mkdir -p "$VS_TORCH_ART_DIR/logs"
logs="$VS_TORCH_ART_DIR/logs"
src=experiments/verification_scaling
vs="python3 scripts/torch_verification_scaling.py"
tv="$vs train_verifier --config fast"

wait_all() {
    local status=0
    for pid in "$@"; do
        wait "$pid" || status=1
    done
    return $status
}

t0=$(date +%s)
pids=()
( $vs demos && $vs train_policy && $vs rankdata --config fast
) > "$logs/policy_rankdata.log" 2>&1 &
pids+=($!)
$vs pretrain_backbone --config fast > "$logs/pretrain_backbone.log" 2>&1 &
pids+=($!)
( $tv --data "$src/rankdata.npz" "$src/rankdata2.npz" \
      --pretrained-vision "$src/pretrained_vision.pkl" \
      --out verifier_committed_data.pkl &&
  $tv --data "$src/rankdata.npz" --no-cross-task-text \
      --pretrained-vision "$src/verifier_params.pkl" \
      --out verifier_r0_recipe.pkl
) > "$logs/train_verifier_committed_data.log" 2>&1 &
pids+=($!)
wait_all "${pids[@]}"
echo "stage group 1: $(( $(date +%s) - t0 )) s"

pids=()
$tv > "$logs/train_verifier.log" 2>&1 &
pids+=($!)
$tv --no-cross-task-text --out verifier_chain_r0_recipe.pkl \
    > "$logs/train_verifier_chain_r0_recipe.log" 2>&1 &
pids+=($!)
wait_all "${pids[@]}"
echo "stage group 2: $(( $(date +%s) - t0 )) s"

eval_="$vs eval --config fast --trials 300 --no-with-oracle --no-ood"
pids=()
$eval_ --run-name a_policy --policy-params policy_params.pkl \
    --verifier-params "$src/verifier_params.pkl" \
    --cells first,1,1 random,16,1 > "$logs/eval_a_policy.log" 2>&1 &
pids+=($!)
$eval_ --run-name b_verifier --policy-params "$src/policy_params.pkl" \
    --verifier-params verifier_committed_data.pkl \
    --cells verifier,16,1 verifier,5,1 > "$logs/eval_b_verifier.log" 2>&1 &
pids+=($!)
$eval_ --run-name b0_r0_recipe --policy-params "$src/policy_params.pkl" \
    --verifier-params verifier_r0_recipe.pkl \
    --cells verifier,16,1 verifier,5,1 > "$logs/eval_b0_r0_recipe.log" 2>&1 &
pids+=($!)
$eval_ --run-name d_chain --policy-params policy_params.pkl \
    --verifier-params verifier_params.pkl \
    --cells first,1,1 random,16,1 verifier,16,1 \
    > "$logs/eval_d_chain.log" 2>&1 &
pids+=($!)
$eval_ --run-name d0_chain_r0_recipe --policy-params policy_params.pkl \
    --verifier-params verifier_chain_r0_recipe.pkl --cells verifier,16,1 \
    > "$logs/eval_d0_chain_r0_recipe.log" 2>&1 &
pids+=($!)
wait_all "${pids[@]}"
echo "eval: $(( $(date +%s) - t0 )) s"
