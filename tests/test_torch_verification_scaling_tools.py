"""The verification-scaling experiment's last stages on the PyTorch port
(`scripts/torch_verification_scaling.py calibrate | dagger_note | report |
all` and `eval`'s knobs) against the JAX script, at the experiment's tiny
widths on the CPU.

- `calibrate`: the prototype and the ID affinities against JAX's
  `image_text_embed` on the same frames (fp32, <= 1e-5); the stamped tree
  read by the JAX script's `_load_tree` and the port's `verifier_from_jax`.
- `run_cell`'s knobs: a cohort of the JAX `run_cell` under
  `defer_threshold`, `gripper_vote=False` and `rescore_threshold=inf`,
  every verified step replayed through the port's step under the port's
  `run_cell` config with the JAX noise (bf16 parity bounds, deferrals
  equal, picks equal wherever JAX's decision gap exceeds twice the score
  difference).
- `dagger_note`'s entries, `render_report`'s lines and `all`'s stage argv
  equal to the JAX script's; `eval`'s `--skip-existing` and its refusal of
  an unnamed knob run.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import pickle
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cover_vla_tpu.engine.verified_step as jvs
from cover_vla_tpu.models import verifier as jverifier
import cover_vla_tpu_torch.eval.evaluator as tevaluator
from cover_vla_tpu_torch.convert.from_jax import load_pickle, verifier_from_jax
from cover_vla_tpu_torch.engine.verified_step import make_verified_step_batched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "experiments", "verification_scaling")
SCRIPT = os.path.join(ROOT, "scripts", "torch_verification_scaling.py")
sys.path.insert(0, ROOT)
from chip_smoke import decision_gap  # noqa: E402  (phase 12's pick rule)
ATOL, RTOL = 0.05, 0.1          # bf16 parity (tests/test_torch_models.py)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return (_module("vs_jax_tools",
                    os.path.join(ROOT, "scripts", "verification_scaling.py")),
            _module("vs_torch_tools", SCRIPT))


@pytest.fixture(scope="module")
def calib(scripts):
    """24 synthetic frames, the JAX verifier tree, and JAX's embeddings of
    the frames under the ID instruction (its calibrate path)."""
    jscript, tscript = scripts
    frames = tscript.synth_localisation_frames(24, seed=3)[0]
    jtree = jscript._load_tree(os.path.join(ART, "verifier_params.pkl"))
    _, jvcfg = jscript.experiment_configs()
    from cover_vla_tpu.data.tokenizer import make_verifier_tokenizer
    vt, _ = make_verifier_tokenizer(jvcfg.text.vocab_size).encode_batch(
        [tscript.task_instruction()], jvcfg.text.context_length)
    prep = jscript._verifier_preprocess_fn(jvcfg)
    emb = np.asarray(jax.jit(lambda imgs, toks: jverifier.image_text_embed(
        jtree, jvcfg, imgs, toks))(np.asarray(prep(frames)),
                                   np.broadcast_to(vt[0], (len(frames),
                                                           vt.shape[1]))))
    return frames, jtree, emb


def test_calibrate_prototype_matches_jax(scripts, calib, tmp_path,
                                         monkeypatch):
    jscript, tscript = scripts
    frames, jtree, jemb = calib
    jproto = jemb.mean(0)
    jproto = jproto / np.linalg.norm(jproto)
    _, vcfg = tscript.experiment_configs()
    vp = verifier_from_jax(load_pickle(os.path.join(ART, "verifier_params.pkl")),
                           vcfg, device="cpu")
    proto, aff = tscript.calibration_prototype(vp, vcfg, frames,
                                               torch.device("cpu"))
    np.testing.assert_allclose(proto, jproto, atol=1e-5, rtol=0)
    np.testing.assert_allclose(aff, jemb @ jproto, atol=1e-5, rtol=0)

    # the stage: frames from the artifact directory's rankdata, the tree
    # from the committed directory, the stamped tree into the artifact
    # directory only
    monkeypatch.setenv("VS_TORCH_ART_DIR", str(tmp_path))
    np.savez(tmp_path / "rankdata.npz", frames=frames)
    before = os.listdir(ART)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tproto, taff, ood = tscript.main(
            ["calibrate", "--device", "cpu", "--frames", "16", "--ood-envs",
             "1", "--ood-tasks", "widowx_redbull_on_plate"])
    assert os.listdir(ART) == before
    idx = np.random.default_rng(0).permutation(24)[:16]
    want = jemb[idx].mean(0)
    np.testing.assert_allclose(tproto, want / np.linalg.norm(want),
                               atol=1e-5, rtol=0)
    assert "ID affinity (16 frames): p01=" in out.getvalue()
    assert len(ood["widowx_redbull_on_plate"]) == 5
    stamped = tmp_path / "verifier_params.pkl"
    jread = jscript._load_tree(str(stamped))
    assert set(jread) == set(jtree) | {"calibration"}
    np.testing.assert_array_equal(jread["calibration"]["prototype"],
                                  tproto.astype(np.float32))
    assert jread["calibration"]["prototype"].dtype == np.float32
    np.testing.assert_array_equal(jread["members"]["logit_scale"],
                                  jtree["members"]["logit_scale"])
    back = verifier_from_jax(load_pickle(str(stamped)), vcfg, device="cpu")
    assert torch.equal(back["calibration"]["prototype"],
                       torch.from_numpy(tproto.astype(np.float32)))
    with open(str(stamped) + ".meta.json") as f:
        meta = json.load(f)
    assert meta["stage"] == "calibrate" and meta["id_frames"] == 16


def _noise(key, ccfg, pcfg):
    shape = (ccfg.n_rephrases, ccfg.n_samples, pcfg.chunk_size,
             pcfg.max_action_dim)
    return np.asarray(jax.random.normal(key, shape, jnp.float32)) \
        * ccfg.noise_std


def test_run_cell_knobs_match_jax(scripts, calib, monkeypatch):
    """The JAX run_cell drives a cohort under the three knobs; each of its
    verified steps is replayed through the port's step under the config
    the port's run_cell builds, with the JAX noise."""
    jscript, tscript = scripts
    frames, jtree, jemb = calib
    proto = jemb.mean(0)
    proto = (proto / np.linalg.norm(proto)).astype(np.float32)
    thr = float(np.median(jemb @ proto))
    knobs = dict(gripper_vote=False, rescore_threshold=float("inf"),
                 defer_threshold=thr)
    task = "widowx_redbull_on_plate"
    monkeypatch.setattr(jscript, "MAX_ENV_STEPS", 8)
    monkeypatch.setattr(tscript, "MAX_ENV_STEPS", 8)
    jpcfg, jvcfg = jscript.experiment_configs()
    pcfg, vcfg = tscript.experiment_configs()
    with open(os.path.join(ART, "stats.pkl"), "rb") as f:
        jstats = pickle.load(f)
    jpp = jscript._load_tree(os.path.join(ART, "policy_params.pkl"))
    jvp = {**jtree, "calibration": {"prototype": proto}}
    steps, ccfgs = [], []
    real = jvs.make_verified_step_batched

    def recording(pc, vc, ccfg, stats):
        step = real(pc, vc, ccfg, stats)

        def run(pp, vp, keys, *inputs):
            out = step(pp, vp, keys, *inputs)
            steps.append(([np.array(x) for x in inputs], np.stack(
                [_noise(k, ccfg, jpcfg) for k in keys]), out))
            return out
        return run

    monkeypatch.setattr(jvs, "make_verified_step_batched", recording)
    jcell = jscript.run_cell(jpp, jvp, jpcfg, jvcfg, jstats, "verifier", 16,
                             trials=2, n_parallel=2, seed=7, task=task,
                             **knobs)
    assert len(steps) == 2

    tpp, tvp, tstats = tscript.load_trees(
        "policy_params.pkl", "verifier_params.pkl", pcfg, vcfg, "cpu")
    tvp = tscript.stamp_calibration(tvp, proto)
    real_eval = tevaluator.evaluate_suite_batched

    def capturing(pp, vp, pc, vc, ccfg, *a, **kw):
        ccfgs.append(ccfg)
        return real_eval(pp, vp, pc, vc, ccfg, *a, **kw)

    monkeypatch.setattr(tevaluator, "evaluate_suite_batched", capturing)
    tcell = tscript.run_cell(tpp, tvp, pcfg, vcfg, tstats, "verifier", 16,
                             trials=2, n_parallel=2, seed=7, task=task,
                             device="cpu", **knobs)
    assert set(tcell) == set(jcell)
    assert tcell["defer_threshold"] == jcell["defer_threshold"] == thr
    (ccfg,) = ccfgs
    assert (ccfg.gripper_vote, ccfg.rescore_threshold,
            ccfg.defer_threshold) == (False, float("inf"), thr)

    t_step = make_verified_step_batched(pcfg, vcfg, ccfg, tstats,
                                        device="cpu")
    decided = deferred = 0
    for inputs, noise, want in steps:
        got = t_step(tpp, tvp, *inputs, noise=noise)
        ws, gs = np.asarray(want.scores), got.scores.numpy()
        np.testing.assert_allclose(gs, ws, atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(got.deferred.numpy(),
                                      np.asarray(want.deferred))
        deferred += int(np.asarray(want.deferred).sum())
        dev = float(np.abs(gs - ws).max())
        for e in range(len(ws)):
            if want.deferred[e] or decision_gap(
                    ws[e], 16, ccfg.rescore_threshold) > 2 * dev:
                decided += 1
                assert int(got.winner_idx[e]) == int(want.winner_idx[e])
                np.testing.assert_allclose(
                    got.exec_chunk[e].numpy(), np.asarray(want.exec_chunk[e]),
                    atol=ATOL, rtol=RTOL)
    assert decided >= 1 and deferred >= 1


def _port_results(grid):
    return {"task": "widowx_carrot_on_plate", "runs": [
        {"config": "fast", "grid": grid, "ood_grid": []}]}


def test_dagger_note_matches_jax(scripts, tmp_path, monkeypatch):
    jscript, tscript = scripts
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    shutil.copy(os.path.join(ART, "results.json"), jdir)
    shutil.copy(os.path.join(ART, "verifier_dagger_r1.pkl.meta.json"), jdir)
    with open(os.path.join(ART, "results.json")) as f:
        grid = json.load(f)["grid"]
    res_path = tdir / "results.json"
    with open(res_path, "w") as f:
        json.dump(_port_results(grid), f)
    monkeypatch.setattr(jscript, "ART_DIR", str(jdir))
    monkeypatch.setenv("VS_TORCH_ART_DIR", str(tmp_path / "empty"))
    for rnd, ckpt, mode in ((1, "verifier_dagger_r1.pkl", "verifier_dag"),
                            (0, "verifier_params.pkl", "verifier")):
        with contextlib.redirect_stdout(io.StringIO()):
            jscript.cmd_dagger_note(argparse.Namespace(
                round=rnd, checkpoint=ckpt, mode=mode))
            tscript.main(["dagger_note", "--config", "fast", "--results",
                          str(res_path), "--round", str(rnd), "--checkpoint",
                          ckpt, "--mode", mode])
    with open(jdir / "results.json") as f:
        want = json.load(f)["dagger_rounds"]
    with open(res_path) as f:
        got = json.load(f)["runs"][0]["dagger_rounds"]
    assert got == want
    assert [r["round"] for r in got] == [0, 1]
    assert got[1]["data"] == 21798 and got[1]["n16"]["successes"] == 49


@pytest.mark.parametrize("case", ["committed", "deference"])
def test_render_report_matches_jax(scripts, tmp_path, monkeypatch, case):
    """The JAX report's lines, but for its Reproduce paragraph and the
    reference README's citation; the `deference` case adds the
    no-deference ablation the committed results lack."""
    jscript, tscript = scripts
    (tmp_path / "docs").mkdir()
    with open(os.path.join(ART, "results.json")) as f:
        res = json.load(f)
    with open(os.path.join(ART, "ood_diagnostics.json")) as f:
        diag = json.load(f)
    if case == "deference":
        res["ood_ablation_nodefer"] = [
            dict(c) for c in res["ood_grid"] if c["mode"] == "verifier"]
        for c in res["ood_grid"]:
            if c["mode"] == "verifier":
                c["defer_threshold"] = 0.95
                c["successes"] += 3
                c["success_rate"] = c["successes"] / c["episodes"]
    with open(tmp_path / "results.json", "w") as f:
        json.dump(res, f)
    shutil.copy(os.path.join(ART, "ood_diagnostics.json"), tmp_path)
    monkeypatch.setattr(jscript, "REPO", str(tmp_path))
    monkeypatch.setattr(jscript, "ART_DIR", str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        jscript.cmd_report(argparse.Namespace())
    with open(tmp_path / "docs" / "verification_scaling.md") as f:
        want = f.read().splitlines()
    cut = want.index(next(line for line in want
                          if line.startswith("Reproduce:")))
    got = tscript.render_report(res, diag, tscript.REPRODUCE).splitlines()
    # the reference README's citation: JAX cites it by an absolute path on
    # the machine it was written on, the port by its path in the reference
    # repository
    cite = re.compile(r"\(`[^`]*reference/README\.md:136-155`\)")
    assert cite.search(want[2]) and cite.search(got[2])
    assert [cite.sub("(cite)", line) for line in got[:cut]] == \
        [cite.sub("(cite)", line) for line in want[:cut]]
    assert got[cut:] == tscript.REPRODUCE[1:]
    assert "torch_verification_scaling.py" in got[-1]
    if case == "deference":
        assert "### Ablation: verification without phase-aware deference" \
            in got


def test_report_of_port_runs(scripts, tmp_path):
    """The port's `report`: the runs of a config in the JAX schema (the
    rephrase-policy run, the deference run's OOD verifier cells as the
    shipping arm), each cell beside JAX's, written beside the results."""
    _, tscript = scripts
    with open(os.path.join(ART, "results.json")) as f:
        ref = json.load(f)

    def port(cells, **extra):
        return [{**c, "jax_successes": c["successes"], "jax_episodes":
                 c["episodes"], "z_vs_jax": 0.0, **extra} for c in cells]

    ood_v = [c for c in ref["ood_grid"] if c["mode"] == "verifier"]
    results = {"task": "widowx_carrot_on_plate", "runs": [
        {"config": "fast", "grid": port(ref["grid"]),
         "ood_grid": port(ref["ood_grid"]), "dagger_rounds": []},
        {"config": "fast", "name": "rephrase_policy",
         "policy_params": "experiments/verification_scaling/"
                          "policy_rephrase.pkl",
         "grid": port(ref["rephrase_policy_grid"]["cells"]), "ood_grid": []},
        {"config": "fast", "name": "defer", "grid": [],
         "ood_grid": [{**c, "defer_threshold": 0.95, "jax_successes": None}
                      for c in ood_v]}]}
    res = tscript.report_results(results, "fast")
    assert res["rephrase_policy_grid"]["policy"] == "policy_rephrase.pkl"
    assert len(res["ood_ablation_nodefer"]) == len(ood_v) == 6
    assert all("defer_threshold" in c for c in res["ood_grid"]
               if c["mode"] == "verifier")
    assert res["trials_per_cell"] == 300
    path = tmp_path / "results.json"
    with open(path, "w") as f:
        json.dump(results, f)
    with contextlib.redirect_stdout(io.StringIO()):
        out = tscript.main(["report", "--config", "fast", "--results",
                            str(path)])
    assert out == str(tmp_path / "report.md")
    with open(out) as f:
        md = f.read()
    assert "## The port beside the JAX package" in md
    assert "### Ablation: verification without phase-aware deference" in md
    assert "| rephrase_policy | carrot_on_plate | verifier N=16 | 52/100 " \
           "| 52/100 | +0.00 |" in md


def test_all_runs_the_jax_stage_sequence(scripts, monkeypatch, tmp_path):
    jscript, tscript = scripts
    seen = {"jax": [], "port": []}
    for name in ("demos", "train_policy", "rankdata", "pretrain_backbone",
                 "train_verifier", "eval", "report"):
        monkeypatch.setattr(jscript, f"cmd_{name}", lambda a, n=name: seen[
            "jax"].append((n, a)))
        monkeypatch.setattr(tscript, f"cmd_{name}", lambda a, n=name: seen[
            "port"].append((n, a)))
    monkeypatch.setattr(jscript, "_force_platform", lambda platform: None)
    monkeypatch.setattr(sys, "argv", ["verification_scaling.py", "all"])
    monkeypatch.setenv("VS_TORCH_ART_DIR", str(tmp_path))
    jscript.main()
    tscript.main(["all", "--device", "cpu", "--config", "fast", "--art-dir",
                  str(tmp_path)])
    assert [n for n, _ in seen["port"]] == [n for n, _ in seen["jax"]]
    keys = ("dagger_params", "out", "data", "steps", "episodes", "trials")
    for (n, j), (_, t) in zip(seen["jax"], seen["port"]):
        for key in keys:
            if hasattr(j, key):
                want = getattr(j, key)
                if key == "dagger_params" and want:
                    want = os.path.join(str(tmp_path),
                                        os.path.basename(want))
                assert getattr(t, key) == want, (n, key)
        assert (t.device, t.config, t.art_dir) == ("cpu", "fast",
                                                   str(tmp_path))
    port_eval = [t for n, t in seen["port"] if n == "eval"][0]
    assert (port_eval.policy_params, port_eval.verifier_params) == (
        "policy_params.pkl", "verifier_params.pkl")


def test_eval_skip_existing_and_named_knob_runs(scripts, tmp_path,
                                                monkeypatch):
    _, tscript = scripts
    monkeypatch.setenv("VS_TORCH_OUT_DIR", str(tmp_path))
    cell = {"mode": "verifier_dag", "n_samples": 16, "n_rephrases": 1,
            "successes": 1, "episodes": 2}
    with open(tmp_path / "results.json", "w") as f:
        json.dump(_port_results([cell]), f)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tscript.main(["eval", "--device", "cpu", "--config", "fast",
                      "--verifier-params", "verifier_dagger_r1.pkl",
                      "--record-mode", "verifier_dag", "--modes", "verifier",
                      "--cells", "verifier,16,1", "--no-ood",
                      "--no-with-oracle", "--merge", "--skip-existing"])
    assert "kept (--skip-existing)" in out.getvalue()
    with open(tmp_path / "results.json") as f:
        assert json.load(f)["runs"][0]["grid"] == [cell]
    with pytest.raises(SystemExit, match="name the run"):
        tscript.main(["eval", "--device", "cpu", "--defer-threshold", "0.9",
                      "--cells", "verifier,16,1", "--no-ood"])


LAUNCHERS = ("torch_eval_sharded.sh", "torch_train_pi0.slurm",
             "torch_train_verifier.slurm", "torch_run_r5_pipeline.sh",
             "torch_verification_scaling_tools.sh")


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_parses(name):
    import subprocess
    path = os.path.join(ROOT, "scripts", name)
    proc = subprocess.run(["bash", "-n", path], capture_output=True,
                          text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr
    with open(path) as f:
        text = f.read()
    assert "cover_vla_tpu_torch" in text or "torch_" in text
    if name.endswith(".slurm"):
        for word in ("torch.distributed.run", "SLURM_NNODES", "SLURM_NODEID",
                     "--nproc_per_node \"${GPUS_PER_NODE:-1}\""):
            assert word in text


def test_eval_sharded_on_the_cpu(tmp_path):
    """Two shards of one trial each of the tiny eval role, merged by the
    port's eval.analyze: every task's two episodes in one table."""
    import subprocess
    env = {**os.environ, "OUT": str(tmp_path / "ev"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        ["bash", os.path.join(ROOT, "scripts", "torch_eval_sharded.sh"),
         "simpler_widowx", "2", "1", "--eval.tiny", "true", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(p.name for p in (tmp_path / "ev").iterdir()) == [
        "shard_0", "shard_1"]
    assert sorted({p.name.split("_seed")[1].split("_")[0]
                   for p in (tmp_path / "ev").glob("*/*.pkl")}) == ["1007", "7"]
    rows = [line.split() for line in proc.stdout.splitlines()
            if line.startswith("widowx_")]
    assert len(rows) == 4 and all(r[1] == "2" for r in rows)


PORT = os.path.join(ROOT, "experiments", "verification_scaling_torch")


def _committed():
    with open(os.path.join(PORT, "results.json")) as f:
        res = json.load(f)
    return res, {(r["config"], r.get("name")): r for r in res["runs"]}


def test_committed_dagger_and_rephrase_cells():
    """The card's DAgger-round and rephrase-policy cells (fast, 100
    episodes) beside JAX's: each within |z| < 2.58, with the rounds."""
    _, runs = _committed()
    fast = runs["fast", None]
    assert "H100" in fast["card"]
    dag = {c["n_samples"]: c for c in fast["grid"]
           if c["mode"] == "verifier_dag"}
    assert sorted(dag) == [16, 40, 80]
    rp = runs["fast", "rephrase_policy"]
    assert rp["policy_params"].endswith("policy_rephrase.pkl")
    assert len(rp["grid"]) == 8
    for c in list(dag.values()) + rp["grid"]:
        assert c["episodes"] == c["jax_episodes"] == 100
        assert abs(c["z_vs_jax"]) < 2.58, c
        assert c["verifier_params"].endswith("verifier_dagger_r1.pkl") \
            if c["mode"] == "verifier_dag" else "verifier_params" not in c
    rounds = fast["dagger_rounds"]
    assert [(r["round"], r["mode"]) for r in rounds] == [
        (0, "verifier"), (1, "verifier_dag")]
    assert rounds[1]["data"] == 21798 and rounds[1]["val_regret"] == 1.1976
    assert rounds[1]["n16"] == dag[16] and rounds[1]["n80"] == dag[80]


@pytest.mark.parametrize("name", ["defer", "defer_p50"])
def test_committed_deference_runs(name):
    """The calibrated committed verifier under the ID p05 / p50 thresholds
    (calibrate's meta on the card): verifier N=16 on the ID task and the
    six OOD tasks, each cell stamped with its threshold and no JAX cell."""
    _, runs = _committed()
    run = runs["fast", name]
    with open(os.path.join(PORT, "calibration",
                           "verifier_params.pkl.meta.json")) as f:
        meta = json.load(f)
    thr = meta["id_affinity"]["p05" if name == "defer" else "p50"]
    cells = run["grid"] + run["ood_grid"]
    assert len(cells) == 7 and "H100" in run["card"]
    for c in cells:
        assert (c["mode"], c["n_samples"]) == ("verifier", 16)
        assert c["defer_threshold"] == thr and c["jax_successes"] is None


def test_committed_diagnostics_beside_jax():
    """Under eager the card's `lang` rows within 0.005 of JAX's committed
    ones and `probe`'s MAE within 10% per domain."""
    with open(os.path.join(ART, "ood_diagnostics.json")) as f:
        ref = json.load(f)
    with open(os.path.join(PORT, "ood_diagnostics.json")) as f:
        got = json.load(f)
    assert "H100" in got["eager"]["card"] and "H100" in got["fast"]["card"]
    for ckpt in ("verifier_params.pkl", "verifier_dagger_r1.pkl"):
        for key in ("grounded", "wrong_noun", "id_instruction"):
            for m in ("vs_random_gain", "top1"):
                assert abs(got["eager"]["lang"][ckpt][key][m]
                           - ref["lang"][ckpt][key][m]) <= 0.005
    for tower in ("pretrained_vision", "verifier_params.pkl"):
        for dom, row in ref["probe"][tower].items():
            assert abs(got["eager"]["probe"][tower][dom]["mae"]
                       / row["mae"] - 1) <= 0.1, (tower, dom)


def test_committed_report_is_its_results(scripts):
    """report.md is `report` of the committed results and diagnostics."""
    _, tscript = scripts
    res, _ = _committed()
    with open(os.path.join(PORT, "ood_diagnostics.json")) as f:
        diag = json.load(f)["fast"]
    with open(os.path.join(PORT, "report.md")) as f:
        md = f.read()
    assert md == tscript.render_report(
        tscript.report_results(res, "fast"), diag, tscript.REPRODUCE,
        extra=tscript.beside_jax_lines(res, "fast"))
