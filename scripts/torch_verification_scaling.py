"""Verification-scaling experiment, `eval` stage, on the PyTorch port.

The repo's verification-scaling experiment (`scripts/verification_scaling.py`)
trains a tiny π0 and a tiny verifier ensemble on the scriptable fake env and
measures how the success rate moves with the candidate count N under three
selection modes (`first`, `random`, `verifier`), plus a privileged `oracle`
ceiling and appearance-shifted OOD tasks. This script runs that grid through
the port's closed-loop episode path
(`eval.evaluator.evaluate_suite_batched` -> `engine/batched_engine.py` ->
`engine/verified_step.py` -> the towers and the hand kernels) on the
committed trained trees, and writes each cell beside the JAX package's cell
of the same grid.

It imports neither `jax` nor the JAX package nor `ml_dtypes`: the committed
pickles are read by `convert.from_jax.load_pickle`.

    python scripts/torch_verification_scaling.py eval --config fast \\
        --trials 300                       # the 13 grid cells on the card
    python scripts/torch_verification_scaling.py eval --device cpu \\
        --trials 2 --n-parallel 2 --cells first,1,1 verifier,16,1 \\
        --no-with-oracle --no-ood          # a quick check on the CPU

Inputs are read from `experiments/verification_scaling/` (or
`$VS_TORCH_SRC_DIR`) and never written. Results go to
`experiments/verification_scaling_torch/results.json` (or under
`$VS_TORCH_OUT_DIR`): one `runs` entry per attention config (`eager`,
`fast`, `all_kernel`), each with its grid, its OOD grid and the card's
`nvidia-smi` name and power limit; episode pickles go to the gitignored
`episodes/<config>/` beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import fcntl
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TASK = "widowx_carrot_on_plate"
MAX_ENV_STEPS = 60
CONFIGS = ("eager", "fast", "all_kernel")


def src_dir() -> str:
    return os.environ.get("VS_TORCH_SRC_DIR", os.path.join(
        REPO, "experiments", "verification_scaling"))


def out_dir() -> str:
    return os.environ.get("VS_TORCH_OUT_DIR", os.path.join(
        REPO, "experiments", "verification_scaling_torch"))


# ---------------------------------------------------------------------------
# the experiment's configs (scripts/verification_scaling.py:57-90)
# ---------------------------------------------------------------------------


def experiment_configs():
    from cover_vla_tpu_torch.configs import (
        GemmaConfig, Pi0Config, SiglipTextConfig, VerifierConfig, VitConfig)
    pcfg = Pi0Config(
        paligemma=GemmaConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                              num_kv_heads=1, head_dim=16, vocab_size=1024),
        expert=GemmaConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                           num_kv_heads=1, head_dim=16, vocab_size=0),
        vision=VitConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                         patch_size=14, image_size=112),
        chunk_size=4, n_action_steps=4, max_state_dim=32, max_action_dim=32,
        proj_width=64, num_denoise_steps=5, tokenizer_max_length=8)
    # VS_VISION_SCALE=big: the JAX experiment's higher-capacity verifier
    # vision tower (text.embed_dim must equal vision.width)
    big = os.environ.get("VS_VISION_SCALE", "") == "big"
    vw, vd, vm = (96, 5, 192) if big else (64, 3, 128)
    vcfg = VerifierConfig(
        vision=VitConfig(width=vw, depth=vd, mlp_dim=vm, num_heads=4,
                         patch_size=8, image_size=128, gelu_approx=False),
        text=SiglipTextConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                              vocab_size=512, context_length=16,
                              embed_dim=vw),
        text_pooling_output_dim=64, vision_pooling_output_dim=64,
        pooling_heads=4, pooling_layers=2, traj_layers=2, traj_heads=4)
    return pcfg, vcfg


def attention_configs(pcfg, vcfg, config: str):
    """(Pi0Config, VerifierConfig) of an attention config: `eager` (no
    hand kernel), `fast` (K1 in the expert's decode, K2 in the three
    towers) or `all_kernel` (K3 in the prefill too)."""
    from cover_vla_tpu_torch.configs import (
        fast_pi0_config, fast_verifier_config, replace)
    if config == "eager":
        return pcfg, vcfg
    fast_p = fast_pi0_config(pcfg)
    if config == "all_kernel":
        fast_p = replace(fast_p, attention_impl="cuda")
    elif config != "fast":
        raise ValueError(f"unknown config {config!r} (one of {CONFIGS})")
    return fast_p, fast_verifier_config(vcfg)


def load_trees(policy_file: str, verifier_file: str, pcfg, vcfg, device):
    """The committed JAX trees and statistics, placed on `device`."""
    from cover_vla_tpu_torch.convert.from_jax import (
        load_pickle, pi0_from_jax, verifier_from_jax)
    pp = pi0_from_jax(load_pickle(os.path.join(src_dir(), policy_file)),
                      pcfg, device=device)
    vp = verifier_from_jax(load_pickle(os.path.join(src_dir(), verifier_file)),
                           vcfg, device=device)
    stats = load_pickle(os.path.join(src_dir(), "stats.pkl"))
    return pp, vp, stats


# ---------------------------------------------------------------------------
# statistics and the oracle (scripts/verification_scaling.py:1103-1129)
# ---------------------------------------------------------------------------


def wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson score interval for a binomial proportion."""
    if n == 0:
        return (0.0, 0.0)
    p = k / n
    denom = 1 + z * z / n
    centre = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (max(0.0, centre - half), min(1.0, centre + half))


def two_proportion_z(k1: int, n1: int, k2: int, n2: int) -> float:
    """Pooled two-proportion z of k1/n1 against k2/n2 (0 when both are
    all successes or all failures)."""
    p = (k1 + k2) / (n1 + n2)
    se = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    return 0.0 if se == 0 else (k1 / n1 - k2 / n2) / se


def oracle_score_factory(envs):
    """Privileged progress oracle as an injected-score scorer: each
    candidate's score is the true potential gain a copy of the live env
    makes executing it (`eval/fake_expert.chunk_quality`)."""
    from cover_vla_tpu_torch.eval.fake_expert import chunk_quality

    def score_fn(exec_chunks: np.ndarray) -> np.ndarray:  # [E, KN, chunk, 7]
        e_n, kn = exec_chunks.shape[:2]
        return np.asarray(
            [[chunk_quality(envs[e], exec_chunks[e, i]) for i in range(kn)]
             for e in range(e_n)], np.float32)

    return score_fn


# ---------------------------------------------------------------------------
# one cell (scripts/verification_scaling.py:1132-1198)
# ---------------------------------------------------------------------------


def run_cell(policy_params, verifier_params, pcfg, vcfg, stats,
             mode: str, n_samples: int, trials: int, n_parallel: int,
             seed: int, out_dir=None, n_rephrases: int = 1,
             task: str = TASK, device=None):
    from cover_vla_tpu_torch.configs import CoVerConfig
    from cover_vla_tpu_torch.data.tokenizer import (
        make_policy_tokenizer, make_verifier_tokenizer)
    from cover_vla_tpu_torch.eval.evaluator import (
        EvalConfig, evaluate_suite_batched)
    from cover_vla_tpu_torch.eval.fake_env import make_fake_env
    from cover_vla_tpu_torch.eval.rephrase import load_rephrases

    if out_dir:
        shutil.rmtree(out_dir, ignore_errors=True)  # stale episode pkls
    if mode == "oracle":
        # the verifier-quality ceiling: injected oracle scores, pure
        # grouped argmax, no gripper vote
        ccfg = CoVerConfig(
            n_samples=n_samples, n_rephrases=n_rephrases, noise_std=1.0,
            selection="injected", gripper_vote=False,
            rescore_threshold=float("inf"),
            max_history=vcfg.history_length - pcfg.chunk_size)
        score_fn_factory = oracle_score_factory
    else:
        ccfg = CoVerConfig(
            n_samples=n_samples, n_rephrases=n_rephrases, noise_std=1.0,
            selection=mode, gripper_vote=mode == "verifier",
            max_history=vcfg.history_length - pcfg.chunk_size)
        score_fn_factory = None
    ecfg = EvalConfig(task_suite=task, num_trials_per_task=trials,
                      max_steps=MAX_ENV_STEPS, seed=1000, seed_period=10_000)
    out = evaluate_suite_batched(
        policy_params, verifier_params, pcfg, vcfg, ccfg, ecfg,
        n_parallel=n_parallel,
        env_fn=lambda t: make_fake_env(t, max_steps=MAX_ENV_STEPS),
        stats=stats, seed=seed,
        rephrases=load_rephrases() if n_rephrases > 1 else None,
        policy_tokenizer=make_policy_tokenizer(pcfg.paligemma.vocab_size),
        verifier_tokenizer=make_verifier_tokenizer(vcfg.text.vocab_size),
        out_dir=out_dir, score_fn_factory=score_fn_factory, device=device)
    task_stats = out["summary"]["per_task"][task]
    succ = [e["success"] for e in task_stats["per_episode"]]
    k, n = int(np.sum(succ)), len(succ)
    lo, hi = wilson_ci(k, n)
    cell = {"mode": mode, "n_samples": n_samples,
            "n_rephrases": n_rephrases, "successes": k,
            "episodes": n, "success_rate": k / n,
            "ci95": [round(lo, 4), round(hi, 4)],
            "mean_steps": task_stats["mean_steps"],
            "actions_per_sec": round(out["actions_per_sec"], 1)}
    if task != TASK:
        cell["task"] = task
    return cell


# (mode, N samples per rephrase, K rephrases): scripts/verification_scaling.py
# :1204-1224, the K=8 cells the reference's 8-rephrase x 5-sample protocol
GRID = [("first", 1, 1), ("random", 5, 1), ("random", 16, 1),
        ("random", 40, 1), ("random", 80, 1),
        ("verifier", 1, 1), ("verifier", 5, 1), ("verifier", 16, 1),
        ("verifier", 40, 1), ("verifier", 80, 1),
        ("random", 5, 8), ("verifier", 5, 8), ("verifier", 16, 8)]

ORACLE_NS = (5, 16, 40, 80)

OOD_TASKS = ("widowx_redbull_on_plate_appearance",
             "widowx_zucchini_on_towel_appearance",
             "widowx_tennis_ball_in_basket_appearance",
             "widowx_redbull_on_plate", "widowx_zucchini_on_towel",
             "widowx_tennis_ball_in_basket")
OOD_MODES = (("first", 1), ("random", 16), ("verifier", 16), ("oracle", 16))


# ---------------------------------------------------------------------------
# the results file
# ---------------------------------------------------------------------------


def card_line(dev) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def jax_cells(path: str):
    """The JAX package's committed cells, keyed as the grid keys them."""
    with open(path) as f:
        ref = json.load(f)
    grid = {(c["mode"], c["n_samples"], c.get("n_rephrases", 1)): c
            for c in ref["grid"]}
    ood = {(c["task"], c["mode"], c["n_samples"]): c
           for c in ref.get("ood_grid", [])}
    return grid, ood


def beside_jax(cell: dict, ref) -> dict:
    """`cell` with the JAX cell's successes and interval and the
    two-proportion z against it (the JAX fields stay None where JAX has
    no such cell)."""
    if ref is None:
        return {**cell, "jax_successes": None, "jax_episodes": None,
                "jax_ci95": None, "z_vs_jax": None, "in_jax_ci95": None}
    lo, hi = ref["ci95"]
    return {**cell, "jax_successes": ref["successes"],
            "jax_episodes": ref["episodes"], "jax_ci95": ref["ci95"],
            "z_vs_jax": round(two_proportion_z(
                cell["successes"], cell["episodes"], ref["successes"],
                ref["episodes"]), 4),
            "in_jax_ci95": bool(lo <= cell["success_rate"] <= hi)}


@contextlib.contextmanager
def locked_results(path: str):
    """The results dict under an exclusive lock, written back on exit
    (configs may run in concurrent processes)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            results = {"task": TASK, "runs": []}
            if os.path.exists(path):
                with open(path) as f:
                    results = json.load(f)
            yield results
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=1)
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def cell_key(c: dict):
    return (c.get("task", TASK), c["mode"], c["n_samples"],
            c.get("n_rephrases", 1))


def record(path: str, config: str, run_info: dict, cell: dict, ood: bool):
    """Put `cell` into `config`'s run, replacing a cell of the same key."""
    with locked_results(path) as results:
        run = next((r for r in results["runs"] if r["config"] == config),
                   None)
        if run is None:
            run = {"config": config, "grid": [], "ood_grid": []}
            results["runs"].append(run)
        run.update(run_info)
        cells = run["ood_grid" if ood else "grid"]
        cells[:] = [c for c in cells if cell_key(c) != cell_key(cell)]
        cells.append(cell)


# ---------------------------------------------------------------------------
# eval (scripts/verification_scaling.py:1227-1399)
# ---------------------------------------------------------------------------


def cmd_eval(args):
    import torch
    from cover_vla_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # the image ops' separable products must run in true fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    pcfg0, vcfg0 = experiment_configs()
    pcfg, vcfg = attention_configs(pcfg0, vcfg0, args.config)
    pp, vp, stats = load_trees(args.policy_params, args.verifier_params,
                               pcfg0, vcfg0, dev)
    if args.quantize != "none":
        from cover_vla_tpu_torch.ops import quant
        pp = quant.quantize_pi0_policy(pp)
        if args.quantize == "int8_full":
            vp = quant.quantize_verifier(vp)
        print(f"  quantized policy tree ({args.quantize})")

    res_path = os.path.join(out_dir(), "results.json")
    if not args.merge and os.path.exists(res_path):
        # a fresh run of this config replaces its entry; other configs'
        # runs stay
        with locked_results(res_path) as results:
            results["runs"] = [r for r in results["runs"]
                               if r["config"] != args.config]
    jax_grid, jax_ood = jax_cells(os.path.join(src_dir(), "results.json"))
    run_info = {"device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "card": card_line(dev), "torch": torch.__version__,
                "n_parallel": args.n_parallel, "seed": 7,
                "policy_params": args.policy_params,
                "verifier_params": args.verifier_params}
    episodes = os.path.join(out_dir(), "episodes", args.config)

    def rec_mode(mode):
        return args.record_mode if (args.record_mode
                                    and mode == "verifier") else mode

    def one(mode, n_samples, n_reph, trials, jax_ref, ood, name, **kw):
        t0 = time.time()
        cell = run_cell(pp, vp, pcfg, vcfg, stats, mode, n_samples,
                        trials=trials, n_parallel=args.n_parallel, seed=7,
                        out_dir=os.path.join(episodes, name),
                        n_rephrases=n_reph, device=dev, **kw)
        cell["mode"] = rec_mode(mode)
        cell["wall_s"] = round(time.time() - t0, 1)
        cell.update(config=args.config, device=run_info["device"],
                    n_parallel=args.n_parallel)
        if args.quantize != "none":
            cell["quantize"] = args.quantize
        cell = beside_jax(cell, jax_ref)
        record(res_path, args.config, run_info, cell, ood)
        ref = (f"JAX {jax_ref['successes']}/{jax_ref['episodes']} z "
               f"{cell['z_vs_jax']:+.2f}" if jax_ref else "no JAX cell")
        print(f"  {args.config:10s} {cell.get('task', TASK)[7:]:28s} "
              f"{cell['mode']:13s} N={n_samples:3d} K={n_reph}: "
              f"{cell['successes']}/{cell['episodes']} "
              f"[{cell['ci95'][0]:.2f},{cell['ci95'][1]:.2f}] ({ref}; "
              f"{cell['actions_per_sec']} actions/s, {cell['wall_s']} s)",
              flush=True)
        return cell

    ran = {}
    for mode, n_samples, n_reph in GRID:
        if args.modes and mode not in args.modes:
            continue
        if args.cells and f"{mode},{n_samples},{n_reph}" not in args.cells:
            continue
        suffix = f"_K{n_reph}" if n_reph > 1 else ""
        ran[mode, n_samples, n_reph] = one(
            mode, n_samples, n_reph, args.trials,
            jax_grid.get((rec_mode(mode), n_samples, n_reph)), False,
            f"{rec_mode(mode)}_N{n_samples}{suffix}")

    # the offline analyzer must read the verifier N=16 cell's episode
    # pickles to the same success rate
    v16 = ran.get(("verifier", 16, 1))
    if v16 is not None and not args.record_mode:
        from cover_vla_tpu_torch.eval import analyze
        agg = analyze.aggregate(analyze.load_episodes(
            os.path.join(episodes, "verifier_N16")))
        if abs(agg["per_task"][TASK]["success_rate"]
               - v16["success_rate"]) >= 1e-9:
            raise AssertionError("analyzer disagreement on verifier N=16")
        print("  analyzer cross-check of verifier N=16 ok")

    if args.with_oracle and (not args.modes or "oracle" in args.modes):
        for n_samples in ORACLE_NS:
            if args.cells and f"oracle,{n_samples},1" not in args.cells:
                continue
            one("oracle", n_samples, 1, args.trials,
                jax_grid.get(("oracle", n_samples, 1)), False,
                f"oracle_N{n_samples}")

    if args.ood:
        for task in OOD_TASKS:
            short = task.replace("widowx_", "")
            for mode, n_samples in OOD_MODES:
                if args.modes and mode not in args.modes:
                    continue
                one(mode, n_samples, 1, args.trials,
                    jax_ood.get((task, rec_mode(mode), n_samples)), True,
                    f"ood_{short}_{rec_mode(mode)}_N{n_samples}", task=task)

    # the analyzer's view of stage-2 language selection in the K=8 cell
    if ("verifier", 5, 8) in ran and not args.record_mode:
        from cover_vla_tpu_torch.eval import analyze
        switch = analyze.instruction_switch_stats(analyze.load_episodes(
            os.path.join(episodes, "verifier_N5_K8")))
        with locked_results(res_path) as results:
            run = next(r for r in results["runs"]
                       if r["config"] == args.config)
            run["instruction_switch_K8"] = switch
        print(f"  K=8 instruction switches: {switch['episodes_with_switch']}"
              f"/{switch['episodes']} episodes")
    print(f"saved {res_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("eval", help="the success-rate grid on the port")
    e.add_argument("--trials", type=int, default=100)
    e.add_argument("--n-parallel", type=int, default=10)
    e.add_argument("--with-oracle", action=argparse.BooleanOptionalAction,
                   default=True)
    e.add_argument("--modes", nargs="*", default=None,
                   help="restrict to these selection modes")
    e.add_argument("--cells", nargs="*", default=None,
                   help="restrict the ID grid (and the oracle cells) to "
                        "'mode,N,K' triples, e.g. verifier,16,1")
    e.add_argument("--merge", action="store_true",
                   help="keep this config's earlier cells (a cell run "
                        "again replaces its earlier value); without it the "
                        "config's run starts empty")
    e.add_argument("--ood", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="also run the OOD appearance-variant cells")
    e.add_argument("--verifier-params", default="verifier_params.pkl",
                   help="verifier pkl under the experiment's directory")
    e.add_argument("--policy-params", default="policy_params.pkl",
                   help="policy pkl under the experiment's directory")
    e.add_argument("--record-mode", default=None,
                   help="record verifier cells under this mode name, e.g. "
                        "verifier_int8 with --quantize int8_full")
    e.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int8_full"],
                   help="int8 (w8a8) policy, and verifier backbone under "
                        "int8_full, through ops/quant")
    e.add_argument("--device", default=None,
                   help="torch device (CUDA unless 'cpu' is named)")
    e.add_argument("--config", default="eager", choices=CONFIGS,
                   help="attention config: eager, fast (K1, K2) or "
                        "all_kernel (K1, K2, K3)")
    e.set_defaults(fn=cmd_eval)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
