"""Offline verifier retrieval harness: for each probe, the ground-truth
trajectory is hidden in a pool of `pool_size` trajectories (itself and
distractors drawn from the other samples); report top-1 accuracy, the
mean rank of the ground truth, and the mean L2 distance between the
top-ranked trajectory and the ground truth. The pools come from
`np.random.default_rng(seed)`, draw for draw as the reference harness
draws them."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cover_vla_tpu_torch.configs import VerifierConfig
from cover_vla_tpu_torch.models import verifier


@torch.no_grad()
def retrieval_test(params, cfg: VerifierConfig, images: np.ndarray,
                   text_tokens: np.ndarray, trajectories: np.ndarray,
                   pool_size: int = 20, seed: int = 0) -> Dict:
    """images: [N, H, W, 3]; text_tokens: [N, T]; trajectories: [N, Hist,
    D]. For each sample i, scores its (image, text) against {GT_i} +
    distractors from the other samples, on the device of `params`."""
    n = len(images)
    rng = np.random.default_rng(seed)
    dev = params["members"]["logit_scale"].device

    def on(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    ranks, top1, l2 = [], [], []
    for i in range(n):
        others = [j for j in range(n) if j != i]
        distractors = rng.choice(others, size=min(pool_size - 1, len(others)),
                                 replace=False)
        pool_idx = np.concatenate([[i], distractors])
        pool = trajectories[pool_idx]
        scores = verifier.score_actions(
            params, cfg, on(images[i:i + 1]), on(text_tokens[i:i + 1]),
            on(pool)).cpu().numpy()
        order = np.argsort(-scores)
        rank = int(np.where(order == 0)[0][0])
        ranks.append(rank)
        top1.append(rank == 0)
        best = pool[order[0]]
        l2.append(float(np.linalg.norm(best - trajectories[i])))

    return {
        "top1_accuracy": float(np.mean(top1)),
        "mean_rank": float(np.mean(ranks)),     # 0 = perfect
        "mean_l2_top1": float(np.mean(l2)),
        "num_samples": n,
        "pool_size": pool_size,
    }


def display_results(results: Dict) -> str:
    lines = [
        "Verifier retrieval test",
        f"  samples:        {results['num_samples']} "
        f"(pool {results['pool_size']})",
        f"  top-1 accuracy: {results['top1_accuracy']:.3f}",
        f"  mean GT rank:   {results['mean_rank']:.2f}",
        f"  mean L2@top1:   {results['mean_l2_top1']:.4f}",
    ]
    return "\n".join(lines)
