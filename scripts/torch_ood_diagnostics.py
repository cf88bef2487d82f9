"""OOD failure-mode diagnostics of the verification-scaling verifier on the
PyTorch port: the counterpart of `scripts/ood_diagnostics.py`.

  probe   Is the BACKBONE the problem? One linear localisation probe
          (frozen tower features -> blob positions) fitted on
          domain-randomized synthetic frames by Adam, then its MAE per
          domain: ID frames, each OOD task's frames, fresh DR frames.
  regret  Are the HEADS the problem? Engine-native candidate slates on the
          ID task and each OOD task, every candidate labelled by the
          privileged `chunk_quality`, and each verifier's selection regret,
          top-1, gain over random (by phase) and the oracle's headroom
          (plus, beside JAX's row, the standard errors of the per-slate
          values under "se").
  lang    Does the score READ the instruction? Selection gain on grounded
          slates under the recorded shape-noun instruction, the same with
          the object noun swapped, and the ID instruction.

Trees and data are the committed ones of `experiments/verification_scaling/`
unless `--art-dir` names a directory of the port's stages to read first;
results go to `<out dir>/ood_diagnostics.json` under the attention config's
key (`experiments/verification_scaling_torch/` for the committed trees, the
artifact directory otherwise; never `experiments/verification_scaling/`).
Runs on the card unless `--device cpu` is given; `--config fast` puts K1
in the slates' proposals and K2 in every tower.

    python scripts/torch_ood_diagnostics.py all --config fast \\
        --verifiers verifier_params.pkl verifier_dagger_r1.pkl
    python scripts/torch_ood_diagnostics.py probe --device cpu \\
        --probe-frames 64 --probe-steps 20 --frames-per-domain 4
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _vs():
    """scripts/torch_verification_scaling.py: the experiment's configs,
    frames, towers, scores and directories."""
    name = "torch_verification_scaling"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


vs = _vs()
TASK, MAX_ENV_STEPS = vs.TASK, vs.MAX_ENV_STEPS
OOD_TASKS = ("widowx_redbull_on_plate", "widowx_zucchini_on_towel",
             "widowx_tennis_ball_in_basket")


def resolve(name: str, art=None) -> str:
    """A name with a directory part is a path; a bare name is read from
    `art` when it holds it, else from the committed directory."""
    if os.path.dirname(name):
        return name
    if art and os.path.exists(os.path.join(art, name)):
        return os.path.join(art, name)
    return os.path.join(vs.src_dir(), name)


def _domain_frames(n_per: int = 192, seed: int = 31):
    """Labelled frames per domain: ID, each OOD task, fresh DR."""
    from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv
    rng = np.random.default_rng(seed)
    domains = {}

    def one(task, appearance=None):
        env = FakeWidowXEnv(task, appearance=appearance)
        env.reset(seed=int(rng.integers(1 << 31)))
        env._ee = rng.uniform([-0.16, -0.16, 0.0], [0.16, 0.16, 0.2])
        if rng.random() < 0.35:
            env._grasped = True
            env._obj = env._ee.copy()
            env._gripper = 0.1
        return env.render(), np.concatenate(
            [env._ee[:2], env._obj[:2], env._target[:2],
             [float(env._grasped)]]).astype(np.float32)

    def roll(task, appearance_fn=lambda: None):
        pairs = [one(task, appearance_fn()) for _ in range(n_per)]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    domains["id"] = roll(TASK)
    for t in OOD_TASKS:
        domains[t.replace("widowx_", "")] = roll(t)
    domains["dr_fresh"] = roll(TASK, lambda: vs.random_appearance(rng))
    return domains


def features_of(vision, vcfg, raw: np.ndarray, dev, chunk: int = 64):
    """fp32 [B, patches * width] tower features of raw uint8 frames."""
    import torch
    out = []
    for i in range(0, len(raw), chunk):
        x = vs.verifier_prep(torch.from_numpy(
            np.ascontiguousarray(raw[i:i + chunk])).to(dev),
            vcfg.vision.image_size)
        out.append(vs.tower_features(vision, vcfg, x, chunk=chunk))
    return torch.cat(out)


def train_probe_head(feats, targets, steps: int, seed: int = 0):
    """The ridge head (mean squared error + 1e-5 |k|^2) trained by Adam at
    1e-3 on `default_rng(seed)` batches of 128, fp32 on the features'
    device: the port's `optim.adamw` with weight decay 0, which is
    optax.adam op for op. Returns (k, b) as numpy."""
    import torch
    from cover_vla_tpu_torch.training import optim
    d, t = feats.shape[1], targets.shape[1]
    head = {"k": torch.zeros((d, t), dtype=torch.float32, device=feats.device),
            "b": torch.zeros((t,), dtype=torch.float32, device=feats.device)}
    tx = optim.adamw(1e-3, weight_decay=0.0)
    opt = tx.init(head)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(feats), 128)).to(
            feats.device)
        f, y = feats[idx], targets[idx]

        def loss_fn():
            return (((f @ head["k"] + head["b"] - y) ** 2).mean()
                    + 1e-5 * (head["k"] ** 2).sum(), {})
        _, _, _, opt = optim.grad_step(tx, opt, head, loss_fn)
    return head["k"].detach().cpu().numpy(), head["b"].detach().cpu().numpy()


def probe_rows(k, b, feats_by_domain: dict, domains: dict) -> dict:
    """MAE per domain (world units) of the head (k, b)."""
    row = {}
    for dom, (_, dp) in domains.items():
        dy = np.concatenate([dp[:, 0:2], dp[:, 2:4], dp[:, 4:6]], 1) / 0.1
        pred = feats_by_domain[dom] @ k + b
        err = np.abs(pred - dy) * 0.1
        row[dom] = {"mae": round(float(err.mean()), 4),
                    "mae_obj": round(float(err[:, 2:4].mean()), 4),
                    "mae_target": round(float(err[:, 4:6].mean()), 4)}
    return row


def load_towers(args, vcfg0, dev) -> dict:
    from cover_vla_tpu_torch.convert.from_jax import (
        load_pickle, place_like, verifier_from_jax)
    towers = {}
    pv = resolve("pretrained_vision.pkl", args.art_dir)
    if os.path.exists(pv):
        towers["pretrained_vision"] = place_like(load_pickle(pv), None, dev)
    for name in args.verifiers:
        path = resolve(name, args.art_dir)
        if os.path.exists(path):
            towers[name] = verifier_from_jax(
                load_pickle(path), vcfg0, device=dev)["backbone"]["vision"]
    return towers


def cmd_probe(args, dev):
    import torch
    pcfg0, vcfg0 = vs.experiment_configs()
    _, vcfg = vs.attention_configs(pcfg0, vcfg0, args.config)
    towers = load_towers(args, vcfg0, dev)
    # the probe's training set: DR synthetic frames (the breadth
    # distribution)
    frames, positions, _ = vs.synth_localisation_frames(
        args.probe_frames, seed=11, id_frac=0.25)
    targets = torch.from_numpy(np.concatenate(
        [positions[:, 0:2], positions[:, 3:5], positions[:, 6:8]],
        1).astype(np.float32) / 0.1).to(dev)
    domains = _domain_frames(args.frames_per_domain)
    report = {}
    for name, vision in towers.items():
        t0 = time.time()
        k, b = train_probe_head(features_of(vision, vcfg, frames, dev),
                                targets, args.probe_steps)
        feats = {dom: features_of(vision, vcfg, df, dev).cpu().numpy()
                 for dom, (df, _) in domains.items()}
        row = probe_rows(k, b, feats, domains)
        report[name] = row
        print(f"probe[{name}] ({time.time() - t0:.0f}s): " + "  ".join(
            f"{dom}={r['mae']:.3f}(obj {r['mae_obj']:.3f})"
            for dom, r in row.items()), flush=True)
    return report


def collect_slates(task: str, episodes: int, n_parallel: int,
                   n_candidates: int, seed: int, pp, stats, pcfg, vcfg, dev):
    """Engine-native candidate slates with privileged quality labels:
    `rankdata`'s collection through BatchedCoVerEngine (injected
    selection, random execution) pointed at any task; episode seeds
    70_000 + done + j."""
    from cover_vla_tpu_torch.configs import CoVerConfig
    from cover_vla_tpu_torch.data.tokenizer import (
        make_policy_tokenizer, make_verifier_tokenizer)
    from cover_vla_tpu_torch.engine.batched_engine import (
        BatchedCoVerEngine, evaluate_batched)
    from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
    from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv
    from cover_vla_tpu_torch.eval.fake_expert import chunk_quality

    E = n_parallel
    ccfg = CoVerConfig(
        n_samples=n_candidates, n_rephrases=1, noise_std=1.0,
        selection="injected", gripper_vote=False,
        rescore_threshold=float("inf"),
        max_history=vcfg.history_length - pcfg.chunk_size)
    engine = BatchedCoVerEngine(
        pp, None, pcfg, vcfg, ccfg, num_episodes=E, stats=stats,
        policy_tokenizer=make_policy_tokenizer(pcfg.paligemma.vocab_size),
        verifier_tokenizer=make_verifier_tokenizer(vcfg.text.vocab_size),
        seed=seed, device=dev)
    frames, trajs, quals, grasped = [], [], [], []
    rng = np.random.default_rng(seed)

    def factory(envs):
        def score_fn(exec_chunks, proposal):
            live = ~engine.done
            kn = exec_chunks.shape[1]
            tr = np.asarray(proposal.trajectories.cpu())
            for e, env in enumerate(envs):
                if not live[e]:
                    continue
                q = np.array([chunk_quality(env, exec_chunks[e, i])
                              for i in range(kn)], np.float32)
                frames.append(env.render())
                trajs.append(tr[e])
                quals.append(q)
                grasped.append(bool(env._grasped))
            return rng.random((len(envs), kn)).astype(np.float32)
        return score_fn

    engine.score_fn_factory = factory
    adapter = BridgeSimplerAdapter()
    done = 0
    while done < episodes:
        envs = [FakeWidowXEnv(task, max_steps=MAX_ENV_STEPS)
                for _ in range(E)]
        evaluate_batched(engine, envs, adapter, max_steps=MAX_ENV_STEPS,
                         seeds=[70_000 + done + j for j in range(E)])
        done += E
    return (np.stack(frames), np.stack(trajs), np.stack(quals),
            np.array(grasped))


def score_slates(params, vcfg, frames, trajs, texts, dev,
                 chunk: int = 64) -> np.ndarray:
    """fp32 [B, N] cosine scores of each slate's candidates under its
    frame and instruction (`texts`: one string, or one per slate)."""
    import torch
    from cover_vla_tpu_torch.data.tokenizer import make_verifier_tokenizer
    tok = make_verifier_tokenizer(vcfg.text.vocab_size)
    texts = [texts] * len(frames) if isinstance(texts, str) else list(texts)
    vt, _ = tok.encode_batch(texts, vcfg.text.context_length)
    out = []
    with torch.no_grad():
        for i in range(0, len(frames), chunk):
            imgs = vs.verifier_prep(torch.from_numpy(np.ascontiguousarray(
                frames[i:i + chunk])).to(dev), vcfg.vision.image_size)
            out.append(vs.state_scores(
                params, vcfg, imgs,
                torch.from_numpy(vt[i:i + chunk].astype(np.int64)).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    trajs[i:i + chunk], np.float32)).to(dev)
            ).float().cpu().numpy())
    return np.concatenate(out)


def regret_row(sc: np.ndarray, q: np.ndarray, gk: np.ndarray) -> dict:
    """Selection regret, top-1, gain over a random pick, and the gain by
    phase, of the argmax of the scores `sc` over the qualities `q`."""
    picks = sc.argmax(1)
    picked = np.take_along_axis(q, picks[:, None], 1)[:, 0]
    rnd = q.mean(1)
    row = {"regret": round(float((q.max(1) - picked).mean()), 3),
           "top1": round(float((picks == q.argmax(1)).mean()), 3),
           "vs_random_gain": round(float((picked - rnd).mean()), 3)}
    # carry / release decisions (grasped) are where self-induced rollouts
    # stall if the scorer inverts
    for phase, m in (("approach", ~gk), ("carry", gk)):
        if m.any():
            row[f"gain_{phase}"] = round(float((picked[m] - rnd[m]).mean()), 3)
    return row


def regret_se(sc: np.ndarray, q: np.ndarray) -> dict:
    """Standard errors of the per-slate regret, top-1 and gain over random
    of `regret_row` (the spread of the port's own slates)."""
    picks = sc.argmax(1)
    picked = np.take_along_axis(q, picks[:, None], 1)[:, 0]
    per_slate = {"regret": q.max(1) - picked,
                 "top1": (picks == q.argmax(1)).astype(np.float64),
                 "vs_random_gain": picked - q.mean(1)}
    return {k: round(float(v.std(ddof=1) / np.sqrt(len(v))), 4)
            for k, v in per_slate.items()}


def load_verifiers(args, vcfg0, dev) -> dict:
    from cover_vla_tpu_torch.convert.from_jax import (
        load_pickle, verifier_from_jax)
    out = {}
    for name in args.verifiers:
        path = resolve(name, args.art_dir)
        if os.path.exists(path):
            out[name] = verifier_from_jax(load_pickle(path), vcfg0, device=dev)
    return out


def cmd_regret(args, dev, scores_out=None):
    """`scores_out`, when a dict, receives {(task, checkpoint): (scores,
    qualities of the kept slates)}."""
    from cover_vla_tpu_torch.convert.from_jax import load_pickle, pi0_from_jax
    from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS
    pcfg0, vcfg0 = vs.experiment_configs()
    pcfg, vcfg = vs.attention_configs(pcfg0, vcfg0, args.config)
    checkpoints = load_verifiers(args, vcfg0, dev)
    pp = pi0_from_jax(load_pickle(resolve("policy_params.pkl", args.art_dir)),
                      pcfg0, device=dev)
    stats = load_pickle(resolve("stats.pkl", args.art_dir))
    report = {}
    for task in (TASK,) + OOD_TASKS:
        t0 = time.time()
        frames, trajs, quals, grasped = collect_slates(
            task, args.episodes, args.n_parallel, args.n_candidates,
            args.seed, pp, stats, pcfg, vcfg, dev)
        short = task.replace("widowx_", "")
        instr = TASK_INSTRUCTIONS.get(task, task.replace("_", " "))
        spread = quals.max(1) - quals.min(1)
        keep = spread > 0.02
        report[short] = {"slates": int(keep.sum()),
                         "collect_s": round(time.time() - t0, 1)}
        se = {}
        for name, params in checkpoints.items():
            sc = score_slates(params, vcfg, frames[keep], trajs[keep], instr,
                              dev)
            report[short][name] = regret_row(sc, quals[keep], grasped[keep])
            se[name] = regret_se(sc, quals[keep])
            if scores_out is not None:
                scores_out[task, name] = (sc, quals[keep])
        report[short]["oracle_headroom"] = round(float(
            (quals[keep].max(1) - quals[keep].mean(1)).mean()), 3)
        # beside the JAX script's row: the standard errors of the port's
        # per-slate values
        report[short]["se"] = se
        print(f"regret[{short}] " + json.dumps(report[short]), flush=True)
    return report


def lang_slates(data: str, max_slates: int):
    """The grounded slates of a rankdata file (instruction other than the
    ID one, quality spread > 0.02), at most `max_slates` chosen by
    `default_rng(5)`, and that generator (the noun swap draws next)."""
    with np.load(data) as rd:
        if "instrs" not in rd.files:
            return None
        instrs = np.asarray(rd["instrs"])
        quals = rd["quals"]
        gmask = instrs != vs.task_instruction()
        spread = quals.max(1) - quals.min(1)
        keep = np.nonzero(gmask & (spread > 0.02))[0]
        rng = np.random.default_rng(5)
        if len(keep) > max_slates:
            keep = rng.choice(keep, max_slates, replace=False)
        return (rd["frames"][keep], rd["trajs"][keep].astype(np.float32),
                quals[keep], instrs[keep], rng)


def lang_variants(instrs, rng) -> dict:
    """The three instruction variants of the slates."""
    noun_to_shape = {n: s for s, ns in vs._SHAPE_NOUNS.items() for n in ns}
    all_nouns = sorted(noun_to_shape)

    def swap_noun(s: str) -> str:
        words = s.split()
        for i, w in enumerate(words):
            shape = noun_to_shape.get(w)
            if shape is not None:
                others = [n for n in all_nouns
                          if noun_to_shape[n] != shape]
                words[i] = others[rng.integers(len(others))]
                return " ".join(words)
        return s

    return {"grounded": [str(s) for s in instrs],
            "wrong_noun": [swap_noun(str(s)) for s in instrs],
            "id_instruction": [vs.task_instruction()] * len(instrs)}


def lang_row(scores: dict, q: np.ndarray) -> dict:
    row = {}
    for key, sc in scores.items():
        picked = np.take_along_axis(q, sc.argmax(1)[:, None], 1)[:, 0]
        row[key] = {
            "vs_random_gain": round(float((picked - q.mean(1)).mean()), 3),
            "top1": round(float((sc.argmax(1) == q.argmax(1)).mean()), 3)}
    row["noun_sensitivity"] = round(row["grounded"]["vs_random_gain"]
                                    - row["wrong_noun"]["vs_random_gain"], 3)
    return row


def cmd_lang(args, dev, scores_out=None):
    """`scores_out`, when a dict, receives {(checkpoint, variant): scores}
    and {"quals": the slates' qualities}."""
    pcfg0, vcfg0 = vs.experiment_configs()
    _, vcfg = vs.attention_configs(pcfg0, vcfg0, args.config)
    slates = lang_slates(resolve(args.data, args.art_dir), args.max_slates)
    if slates is None:
        print(f"{args.data} carries no grounded instructions; re-collect "
              "with rankdata --domain-rand")
        return None
    frames, trajs, q, instrs, rng = slates
    print(f"lang: {len(q)} grounded slates from {args.data}", flush=True)
    variants = lang_variants(instrs, rng)
    report = {"slates": int(len(q)), "data": args.data}
    if scores_out is not None:
        scores_out["quals"] = q
    for name, params in load_verifiers(args, vcfg0, dev).items():
        scores = {key: score_slates(params, vcfg, frames, trajs, texts, dev)
                  for key, texts in variants.items()}
        if scores_out is not None:
            scores_out.update({(name, k): v for k, v in scores.items()})
        report[name] = lang_row(scores, q)
        print(f"lang[{name}] " + json.dumps(report[name]), flush=True)
    return report


def out_path(args) -> str:
    return os.path.join(args.art_dir or vs.out_dir(), "ood_diagnostics.json")


def write(args, key: str, payload, card: str) -> str:
    """Put `payload` under the config's `key` in the diagnostics file
    (under an exclusive lock: configs may run as concurrent processes)."""
    import fcntl
    path = out_path(args)
    if os.path.abspath(os.path.dirname(path)) == os.path.abspath(vs.src_dir()):
        raise SystemExit(f"{path} is in the committed directory")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        blob = {}
        if os.path.exists(path):
            with open(path) as f:
                blob = json.load(f)
        section = blob.setdefault(args.config, {})
        section[key] = payload
        section["card"] = card
        with open(path + ".tmp", "w") as f:
            json.dump(blob, f, indent=1)
        os.replace(path + ".tmp", path)
    print(f"wrote {path} [{args.config}.{key}]")
    return path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=["probe", "regret", "lang", "all"])
    ap.add_argument("--verifiers", nargs="*",
                    default=["verifier_params.pkl", "verifier_dr_params.pkl"])
    ap.add_argument("--episodes", type=int, default=20)
    ap.add_argument("--n-parallel", type=int, default=10)
    ap.add_argument("--n-candidates", type=int, default=16)
    ap.add_argument("--seed", type=int, default=97,
                    help="regret's slate seed (the engine's noise and the "
                         "random execution); 97 is the JAX script's")
    ap.add_argument("--probe-frames", type=int, default=2048)
    ap.add_argument("--probe-steps", type=int, default=3000)
    ap.add_argument("--frames-per-domain", type=int, default=192)
    ap.add_argument("--data", default="rankdata_wn.npz",
                    help="grounded rankdata npz for the lang diagnostic")
    ap.add_argument("--max-slates", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (CUDA unless 'cpu' is named)")
    ap.add_argument("--config", default="eager", choices=vs.CONFIGS,
                    help="attention config: eager, fast (K1, K2) or "
                         "all_kernel (K1-K3)")
    ap.add_argument("--art-dir", default=None,
                    help="read trees and data here first, and write here")
    args = ap.parse_args(argv)
    dev = vs.stage_device(args)
    card = vs.card_line(dev)
    out = {}
    for key, fn in (("probe", cmd_probe), ("regret", cmd_regret),
                    ("lang", cmd_lang)):
        if args.cmd in (key, "all"):
            out[key] = fn(args, dev)
            if out[key] is not None:
                write(args, key, out[key], card)
    return out


if __name__ == "__main__":
    main()
