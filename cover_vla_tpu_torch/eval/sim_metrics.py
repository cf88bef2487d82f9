"""Real-to-sim fidelity statistics.

Mirrors SimplerEnv's metrics (simpler_env/utils/metrics.py:134-228):
Pearson correlation between real and sim success rates across policies,
Mean Maximum Rank Violation (MMRV), and the Kruskal-Wallis H-test on
per-episode outcomes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import stats as scipy_stats


def pearson_correlation(real: Sequence[float], sim: Sequence[float]) -> float:
    real, sim = np.asarray(real, float), np.asarray(sim, float)
    if real.std() == 0 or sim.std() == 0:
        return 0.0
    return float(np.corrcoef(real, sim)[0, 1])


def mean_maximum_rank_violation(real: Sequence[float],
                                sim: Sequence[float]) -> float:
    """For each policy pair whose sim ranking contradicts the real ranking,
    the violation is the real-performance gap; MMRV averages, per policy,
    the maximum violation it participates in."""
    real, sim = np.asarray(real, float), np.asarray(sim, float)
    n = len(real)
    max_viol = np.zeros(n)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if (sim[i] > sim[j]) != (real[i] > real[j]) \
                    and real[i] != real[j]:
                gap = abs(real[i] - real[j])
                max_viol[i] = max(max_viol[i], gap)
                max_viol[j] = max(max_viol[j], gap)
    return float(max_viol.mean())


def kruskal_wallis(real_episodes: Sequence[Sequence[float]],
                   sim_episodes: Sequence[Sequence[float]]) -> dict:
    """H-test per policy on (real vs sim) per-episode success samples;
    a high p-value means the sim distribution is indistinguishable."""
    out = []
    for r, s in zip(real_episodes, sim_episodes):
        r, s = np.asarray(r, float), np.asarray(s, float)
        if np.all(r == r[0]) and np.all(s == s[0]) and r[0] == s[0]:
            out.append({"statistic": 0.0, "pvalue": 1.0})
            continue
        stat, p = scipy_stats.kruskal(r, s)
        out.append({"statistic": float(stat), "pvalue": float(p)})
    return {"per_policy": out,
            "mean_pvalue": float(np.mean([o["pvalue"] for o in out]))}
