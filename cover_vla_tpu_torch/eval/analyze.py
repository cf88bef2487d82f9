"""Offline results analysis: success-rate aggregation from episode records.

Counterpart of bashes/analyze_success_rate.py (2,549 LoC in the reference):
parses the success-encoded episode filenames / pickles written by
eval.evaluator.save_episode, aggregates per task / per seed-period, and
renders text tables (+ optional matplotlib bar charts).
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

_FNAME_RE = re.compile(
    r"episode_(?P<task>.+)_trial(?P<trial>\d+)_seed(?P<seed>\d+)_"
    r"(?P<outcome>success|failure)\.pkl")


def extract_success_from_filename(path: str) -> Optional[Dict]:
    m = _FNAME_RE.fullmatch(os.path.basename(path))
    if not m:
        return None
    return {"task": m.group("task"), "trial": int(m.group("trial")),
            "seed": int(m.group("seed")),
            "success": m.group("outcome") == "success"}


def load_episodes(out_dir: str) -> List[Dict]:
    eps = []
    for path in sorted(glob.glob(os.path.join(out_dir, "episode_*.pkl"))):
        meta = extract_success_from_filename(path)
        if meta is None:
            continue
        try:
            with open(path, "rb") as f:
                meta["record"] = pickle.load(f)
        except Exception:
            meta["record"] = None
        eps.append(meta)
    return eps


def aggregate(episodes: List[Dict], seed_period: int = 50) -> Dict:
    """Per-task and per-seed-period success rates (the reference groups
    trials into 50-episode periods to report mean±std across periods)."""
    by_task: Dict[str, List[Dict]] = defaultdict(list)
    for ep in episodes:
        by_task[ep["task"]].append(ep)

    out = {"per_task": {}, "overall": None}
    all_success = []
    for task, eps in sorted(by_task.items()):
        succ = np.asarray([e["success"] for e in eps], dtype=float)
        all_success.extend(succ)
        periods = [succ[i:i + seed_period]
                   for i in range(0, len(succ), seed_period)]
        period_rates = [p.mean() for p in periods if len(p)]
        out["per_task"][task] = {
            "episodes": len(eps),
            "success_rate": float(succ.mean()),
            "period_mean": float(np.mean(period_rates)),
            "period_std": float(np.std(period_rates)),
            "mean_verifier_score": _mean_score(eps),
        }
    out["overall"] = float(np.mean(all_success)) if all_success else 0.0
    return out


def _mean_score(eps: List[Dict]) -> Optional[float]:
    scores = []
    for e in eps:
        rec = e.get("record") or {}
        scores.extend(s for s in rec.get("verifier_scores", [])
                      if s is not None)
    return float(np.mean(scores)) if scores else None


# Partial-credit sub-metrics from the sim's episode_stats
# (put_on_in_scene.py:122-141; reported per episode by the reference
# evaluator as Move Correct / Wrong Obj / Grasp / Src Intention —
# simpler_evaluator.py:237-246)
PARTIAL_METRICS = ("moved_correct_obj", "moved_wrong_obj",
                   "is_src_obj_grasped", "consecutive_grasp")


def partial_metric_breakdown(episodes: List[Dict]) -> Dict[str, Dict]:
    """Per-task rates of the episode_stats partial metrics."""
    by_task: Dict[str, List[Dict]] = defaultdict(list)
    for ep in episodes:
        by_task[ep["task"]].append(ep)
    out = {}
    for task, eps in sorted(by_task.items()):
        stats = [((e.get("record") or {}).get("episode_stats") or {})
                 for e in eps]
        row = {}
        for m in PARTIAL_METRICS:
            vals = [bool(s[m]) for s in stats if m in s]
            row[m] = float(np.mean(vals)) if vals else None
        row["episodes"] = len(eps)
        out[task] = row
    return out


def instruction_switch_stats(episodes: List[Dict]) -> Dict:
    """How often the verifier's stage-2 rescore switched the instruction
    away from the original, and which rephrases won
    (run_simpler_eval_with_openpi.py:354-365,409)."""
    switched_eps = 0
    total_eps = 0
    winners: Dict[str, int] = defaultdict(int)
    for e in episodes:
        rec = e.get("record") or {}
        sel = rec.get("selected_instructions") or []
        if not sel:
            continue
        total_eps += 1
        original = sel[0]
        if any(s != original for s in sel):
            switched_eps += 1
        for s in sel:
            winners[s] += 1
    return {
        "episodes_with_switch": switched_eps,
        "episodes": total_eps,
        "switch_rate": switched_eps / total_eps if total_eps else 0.0,
        "instruction_counts": dict(sorted(winners.items(),
                                          key=lambda kv: -kv[1])),
    }


def compare_runs(run_dirs: Dict[str, str], seed_period: int = 50) -> Dict:
    """Cross-run comparison (the reference analyzer's multi-run tables):
    {run_name: out_dir} -> per-task success mean±std per run."""
    runs = {}
    for name, d in run_dirs.items():
        runs[name] = aggregate(load_episodes(d), seed_period)
    tasks = sorted({t for a in runs.values() for t in a["per_task"]})
    table = {t: {name: a["per_task"].get(t) for name, a in runs.items()}
             for t in tasks}
    return {"runs": runs, "tasks": tasks, "table": table}


def render_comparison(cmp: Dict) -> str:
    names = list(cmp["runs"])
    head = f"{'task':42s}" + "".join(f" {n:>18s}" for n in names)
    lines = [head]
    for t in cmp["tasks"]:
        cells = []
        for n in names:
            row = cmp["table"][t][n]
            cells.append("            --    " if row is None else
                         f" {row['period_mean'] * 100:8.1f}%"
                         f"±{row['period_std'] * 100:4.1f}    ")
        lines.append(f"{t:42s}" + "".join(cells))
    overall = "".join(f" {cmp['runs'][n]['overall'] * 100:12.1f}%     "
                      for n in names)
    lines.append(f"{'OVERALL':42s}" + overall)
    return "\n".join(lines)


def render_partial_table(breakdown: Dict[str, Dict]) -> str:
    cols = ["eps"] + list(PARTIAL_METRICS)
    head = f"{'task':42s}" + "".join(f" {c[:14]:>15s}" for c in cols)
    lines = [head]
    for task, row in breakdown.items():
        cells = [f" {row['episodes']:>15d}"]
        for m in PARTIAL_METRICS:
            v = row[m]
            cells.append(f" {'--':>15s}" if v is None
                         else f" {v * 100:>14.1f}%")
        lines.append(f"{task:42s}" + "".join(cells))
    return "\n".join(lines)


def plot_comparison(cmp: Dict, path: str) -> Optional[str]:
    """Grouped bar chart across runs (analyze_success_rate.py's comparison
    plots)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    names = list(cmp["runs"])
    tasks = cmp["tasks"]
    width = 0.8 / max(1, len(names))
    fig, ax = plt.subplots(figsize=(max(6, len(tasks) * 1.6), 4))
    for j, n in enumerate(names):
        xs = [i + j * width for i in range(len(tasks))]
        ys, es = [], []
        for t in tasks:
            row = cmp["table"][t][n]
            ys.append((row or {}).get("period_mean", 0.0) * 100)
            es.append((row or {}).get("period_std", 0.0) * 100)
        ax.bar(xs, ys, width=width, yerr=es, capsize=2, label=n)
    ax.set_xticks([i + 0.4 - width / 2 for i in range(len(tasks))])
    ax.set_xticklabels([t.replace("widowx_", "") for t in tasks],
                       rotation=30, ha="right")
    ax.set_ylabel("success rate (%)")
    ax.set_ylim(0, 100)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def render_table(agg: Dict) -> str:
    lines = [f"{'task':42s} {'eps':>5s} {'success':>8s} {'±':>6s}"]
    for task, row in agg["per_task"].items():
        lines.append(f"{task:42s} {row['episodes']:5d} "
                     f"{row['success_rate'] * 100:7.1f}% "
                     f"{row['period_std'] * 100:5.1f}")
    lines.append(f"{'OVERALL':42s} {'':5s} {agg['overall'] * 100:7.1f}%")
    return "\n".join(lines)


def plot_success_rates(agg: Dict, path: str) -> Optional[str]:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    tasks = list(agg["per_task"])
    rates = [agg["per_task"][t]["success_rate"] * 100 for t in tasks]
    errs = [agg["per_task"][t]["period_std"] * 100 for t in tasks]
    fig, ax = plt.subplots(figsize=(max(6, len(tasks) * 1.2), 4))
    ax.bar(range(len(tasks)), rates, yerr=errs, capsize=3)
    ax.set_xticks(range(len(tasks)))
    ax.set_xticklabels([t.replace("widowx_", "") for t in tasks],
                       rotation=30, ha="right")
    ax.set_ylabel("success rate (%)")
    ax.set_ylim(0, 100)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--seed-period", type=int, default=50)
    ap.add_argument("--plot", type=str, default=None)
    ap.add_argument("--partial", action="store_true",
                    help="episode_stats partial-metric breakdown")
    ap.add_argument("--switches", action="store_true",
                    help="instruction-switch (stage-2 rephrase) stats")
    ap.add_argument("--compare", action="append", default=[],
                    metavar="NAME=DIR",
                    help="additional runs to compare against out_dir")
    args = ap.parse_args(argv)
    episodes = load_episodes(args.out_dir)
    agg = aggregate(episodes, args.seed_period)
    print(render_table(agg))
    if args.partial:
        print()
        print(render_partial_table(partial_metric_breakdown(episodes)))
    if args.switches:
        import json
        print()
        print(json.dumps(instruction_switch_stats(episodes), indent=2))
    if args.compare:
        dirs = {"main": args.out_dir}
        for spec in args.compare:
            name, _, d = spec.partition("=")
            dirs[name] = d
        cmp = compare_runs(dirs, args.seed_period)
        print()
        print(render_comparison(cmp))
        if args.plot:
            plot_comparison(cmp, args.plot.replace(".png", "_compare.png"))
    if args.plot:
        plot_success_rates(agg, args.plot)


if __name__ == "__main__":
    main()
