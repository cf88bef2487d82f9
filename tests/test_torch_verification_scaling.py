"""The verification-scaling experiment's eval stage on the PyTorch port
(`scripts/torch_verification_scaling.py`) against the JAX package, on the
committed trained trees of `experiments/verification_scaling/`.

- The port's loader (`convert.from_jax.load_pickle`, no `ml_dtypes`, no
  JAX package) reads every leaf byte for byte as JAX's `pickle.load` does.
- Lockstep episodes: the JAX engine drives two fake-env episodes for 8
  env steps (2 verified steps) at the experiment's widths, with its own
  key schedule; at every verified step the port's eager step runs on the
  same inputs with the JAX noise. Candidates and scores are held to the
  bf16 parity bound (tests/test_torch_models.py: atol 0.05, rtol 0.1);
  the picks must agree wherever JAX's decision gap exceeds twice the
  step's largest score difference, and trained weights must give such
  steps.
- The script's `eval` on the CPU for two cells, and its import with
  `jax`, the JAX package and `ml_dtypes` blocked.
- The committed port grid (`experiments/verification_scaling_torch/
  results.json`, card runs) under each config, in the manner of
  tests/test_verification_scaling.py.
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.configs import CoVerConfig as JCoVerConfig
from cover_vla_tpu.data.tokenizer import (
    make_policy_tokenizer as j_policy_tok,
    make_verifier_tokenizer as j_verifier_tok)
from cover_vla_tpu.engine.batched_engine import (
    BatchedCoVerEngine as JEngine, evaluate_batched as j_evaluate_batched)
from cover_vla_tpu.engine.verified_step import (
    make_propose_step_batched as j_make_propose,
    make_verified_step_batched as j_make_fused)
from cover_vla_tpu.eval.adapters import BridgeSimplerAdapter as JAdapter
from cover_vla_tpu.eval.fake_env import make_fake_env as j_make_fake_env
from cover_vla_tpu.eval.rephrase import load_rephrases

from cover_vla_tpu_torch.configs import CoVerConfig
from cover_vla_tpu_torch.convert.from_jax import (
    load_pickle, pi0_from_jax, verifier_from_jax)
from cover_vla_tpu_torch.engine.verified_step import (
    make_propose_step_batched, make_verified_step_batched)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "experiments", "verification_scaling")
PORT_RESULTS = os.path.join(ROOT, "experiments", "verification_scaling_torch",
                            "results.json")
SCRIPT = os.path.join(ROOT, "scripts", "torch_verification_scaling.py")
sys.path.insert(0, ROOT)
from chip_smoke import decision_gap  # noqa: E402  (phase 12's pick rule)
ATOL, RTOL = 0.05, 0.1          # bf16 parity (tests/test_torch_models.py)
E, TICKS = 2, 8


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return (_module("vs_jax_script",
                    os.path.join(ROOT, "scripts", "verification_scaling.py")),
            _module("vs_torch_script", SCRIPT))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", ["policy_params.pkl", "verifier_params.pkl"])
def test_loader_reads_the_jax_pickles_byte_equal(name):
    with open(os.path.join(ART, name), "rb") as f:
        want = dict(_leaves(pickle.load(f)))
    got = dict(_leaves(load_pickle(os.path.join(ART, name))))
    assert got.keys() == want.keys()
    bf16 = 0
    for path, w in want.items():
        g = got[path]
        if w.dtype.name == "bfloat16":
            bf16 += 1
            assert g.dtype == np.uint16, path
            w = w.view(np.uint16)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path
    assert bf16 == (30 if name == "policy_params.pkl" else 0)


def test_loader_stats_and_placement(scripts):
    with open(os.path.join(ART, "stats.pkl"), "rb") as f:
        want = pickle.load(f)
    got = load_pickle(os.path.join(ART, "stats.pkl"))
    assert type(got).__module__ == "cover_vla_tpu_torch.data.stats"
    for field in ("action", "proprio"):
        for k, w in dataclasses.asdict(getattr(want, field)).items():
            g = getattr(getattr(got, field), k)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    assert (got.num_transitions, got.num_trajectories) == (
        want.num_transitions, want.num_trajectories)
    # the uint16 leaves become bf16 against the port's reference tree
    jscript, tscript = scripts
    pcfg, vcfg = tscript.experiment_configs()
    # the same configs, up to the eager backend's name ("xla" in JAX)
    for got, want in zip((pcfg, vcfg), jscript.experiment_configs()):
        assert json.dumps(dataclasses.asdict(got), sort_keys=True).replace(
            '"eager"', '"xla"') == json.dumps(dataclasses.asdict(want),
                                              sort_keys=True)
    pp, vp, _ = tscript.load_trees("policy_params.pkl", "verifier_params.pkl",
                                   pcfg, vcfg, "cpu")
    with open(os.path.join(ART, "policy_params.pkl"), "rb") as f:
        jpp = pickle.load(f)
    for path, w in _leaves(jpp):
        t = pp
        for k in path.strip("/").split("/"):
            t = t[k]
        assert str(t.dtype) == f"torch.{w.dtype.name}", path
        if w.dtype.name == "bfloat16":
            assert t.view(torch.int16).numpy().view(np.uint16).tobytes() \
                == w.view(np.uint16).tobytes(), path
    # any other global of the JAX package or ml_dtypes is refused by name
    for module, name in (("cover_vla_tpu.configs", "Pi0Config"),
                         ("cover_vla_tpu.data.stats", "os"),
                         ("ml_dtypes", "float8_e4m3fn"), ("os", "system")):
        blob = (b"\x80\x04c" + module.encode() + b"\n" + name.encode()
                + b"\n.")
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"refuse_{os.getpid()}.pkl")
        with open(path, "wb") as f:
            f.write(blob)
        try:
            with pytest.raises(pickle.UnpicklingError, match=name):
                load_pickle(path)
        finally:
            os.remove(path)


def _noise(key, ccfg, pcfg):
    shape = (ccfg.n_rephrases, ccfg.n_samples, pcfg.chunk_size,
             pcfg.max_action_dim)
    return np.asarray(jax.random.normal(key, shape, jnp.float32)) \
        * ccfg.noise_std


@pytest.mark.parametrize("n,k", [(16, 1), (5, 8)])
def test_lockstep_episodes_match_jax_on_trained_trees(scripts, n, k):
    jscript, tscript = scripts
    pcfg, vcfg = tscript.experiment_configs()
    jpcfg, jvcfg = jscript.experiment_configs()
    jpp = jscript._load_tree(os.path.join(ART, "policy_params.pkl"))
    jvp = jscript._load_tree(os.path.join(ART, "verifier_params.pkl"))
    with open(os.path.join(ART, "stats.pkl"), "rb") as f:
        jstats = pickle.load(f)
    tpp, tvp, tstats = tscript.load_trees(
        "policy_params.pkl", "verifier_params.pkl", pcfg, vcfg, "cpu")
    hist = vcfg.history_length - pcfg.chunk_size
    jccfg = JCoVerConfig(n_samples=n, n_rephrases=k, max_history=hist)
    tccfg = CoVerConfig(n_samples=n, n_rephrases=k, max_history=hist)
    j_fused = j_make_fused(jpcfg, jvcfg, jccfg, jstats)
    j_prop = j_make_propose(jpcfg, jvcfg, jccfg, jstats)
    t_fused = make_verified_step_batched(pcfg, vcfg, tccfg, tstats,
                                         device="cpu")
    t_prop = make_propose_step_batched(pcfg, vcfg, tccfg, tstats,
                                       device="cpu")
    steps = []

    def step_fn(pp, vp, keys, raw, prop, lt, lm, vt, hist_, hlen):
        want = j_fused(pp, vp, keys, raw, prop, lt, lm, vt, hist_, hlen)
        wprop = j_prop(pp, keys, raw, prop, lt, lm, hist_, hlen)
        noise = np.stack([_noise(key, jccfg, jpcfg) for key in keys])
        got = t_fused(tpp, tvp, raw, prop, lt, lm, vt, hist_, hlen,
                      noise=noise)
        gprop = t_prop(tpp, raw, prop, lt, lm, hist_, hlen, noise=noise)
        steps.append((want, wprop, got, gprop))
        return want

    engine = JEngine(jpp, jvp, jpcfg, jvcfg, jccfg, num_episodes=E,
                     stats=jstats,
                     policy_tokenizer=j_policy_tok(jpcfg.paligemma.vocab_size),
                     verifier_tokenizer=j_verifier_tok(jvcfg.text.vocab_size),
                     rephrases=load_rephrases() if k > 1 else None,
                     seed=7, step_fn=step_fn)
    envs = [j_make_fake_env("widowx_carrot_on_plate", max_steps=60)
            for _ in range(E)]
    j_evaluate_batched(engine, envs, JAdapter(stats=jstats), max_steps=TICKS,
                       seeds=[1000 + e for e in range(E)])
    assert len(steps) == TICKS // pcfg.chunk_size

    decided = 0
    for want, wprop, got, gprop in steps:
        np.testing.assert_allclose(gprop.exec_chunks.numpy(),
                                   np.asarray(wprop.exec_chunks),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(gprop.verifier_chunks.numpy(),
                                   np.asarray(wprop.verifier_chunks),
                                   atol=ATOL, rtol=RTOL)
        ws, gs = np.asarray(want.scores), got.scores.numpy()
        np.testing.assert_allclose(gs, ws, atol=ATOL, rtol=RTOL)
        dev = float(np.abs(gs - ws).max())
        for e in range(E):
            if decision_gap(ws[e], n, jccfg.rescore_threshold) > 2 * dev:
                decided += 1
                assert int(got.winner_idx[e]) == int(want.winner_idx[e])
                np.testing.assert_allclose(
                    got.exec_chunk[e].numpy(), np.asarray(want.exec_chunk[e]),
                    atol=ATOL, rtol=RTOL)
    assert decided >= 1, "no pick was decided by a gap above the deviation"


def test_eval_on_the_cpu_writes_the_cells(scripts, tmp_path, monkeypatch):
    def digest():
        h = hashlib.sha256()
        for name in sorted(os.listdir(ART)):
            h.update(name.encode())
            with open(os.path.join(ART, name), "rb") as f:
                h.update(f.read())
        return h.hexdigest()

    before = digest()
    _, tscript = scripts
    monkeypatch.setenv("VS_TORCH_OUT_DIR", str(tmp_path))
    tscript.main(["eval", "--device", "cpu", "--trials", "2",
                  "--n-parallel", "2", "--cells", "first,1,1",
                  "verifier,16,1", "--no-with-oracle", "--no-ood"])
    with open(tmp_path / "results.json") as f:
        res = json.load(f)
    (run,) = res["runs"]
    assert run["config"] == "eager" and run["device"] == "cpu"
    assert run["card"] == "cpu" and run["n_parallel"] == 2
    assert [(c["mode"], c["n_samples"]) for c in run["grid"]] == [
        ("first", 1), ("verifier", 16)]
    for c in run["grid"]:
        assert set(c) >= {"successes", "episodes", "success_rate", "ci95",
                          "mean_steps", "actions_per_sec", "wall_s", "config",
                          "device", "n_parallel", "jax_successes",
                          "jax_ci95", "z_vs_jax"}
        assert c["episodes"] == 2 and 0 <= c["successes"] <= 2
        assert c["jax_episodes"] == 300
    assert len(os.listdir(tmp_path / "episodes" / "eager" / "verifier_N16")) \
        == 2
    assert digest() == before


def test_script_imports_without_jax(tmp_path):
    """The script's import, its loader, every training stage and
    `calibrate` (tiny sizes, into a tmp artifact directory), and
    `scripts/torch_ood_diagnostics.py probe` and `scripts/torch_roofline.py`
    with `jax`, the JAX package and `ml_dtypes` blocked; the tree it writes
    names `ml_dtypes.bfloat16`."""
    code = ("import sys\n"
            "for m in ('jax', 'cover_vla_tpu', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('s', {SCRIPT!r})\n"
            "s = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(s)\n"
            "pcfg, vcfg = s.experiment_configs()\n"
            "pp, vp, stats = s.load_trees('policy_params.pkl',\n"
            "    'verifier_params.pkl', pcfg, vcfg, 'cpu')\n"
            "assert pp['vision']['pos_emb'].dtype.is_floating_point\n"
            "cpu = ['--device', 'cpu']\n"
            "s.main(['demos', *cpu, '--n-demos', '2'])\n"
            "s.main(['train_policy', *cpu, '--steps', '1', '--batch', '2'])\n"
            "s.main(['rankdata', *cpu, '--episodes', '4', '--n-parallel',\n"
            "        '2', '--n-candidates', '2'])\n"
            "s.main(['pretrain_backbone', *cpu, '--steps', '1', '--batch',\n"
            "        '2', '--synthetic', '12'])\n"
            "s.main(['train_verifier', *cpu, '--steps', '1', '--batch', '2'])\n"
            "with open(s.output_path('policy_params.pkl'), 'rb') as f:\n"
            "    assert b'ml_dtypes' in f.read()\n"
            "s.main(['calibrate', *cpu, '--frames', '4', '--ood-envs', '1',\n"
            "        '--ood-tasks', 'widowx_redbull_on_plate'])\n"
            "def load(name):\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            f"        name, {os.path.dirname(SCRIPT)!r} + '/' + name + '.py')\n"
            "    m = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(m)\n"
            "    return m\n"
            "od = load('torch_ood_diagnostics')\n"
            "od.main(['probe', *cpu, '--probe-frames', '8', '--probe-steps',\n"
            "         '2', '--frames-per-domain', '1', '--verifiers',\n"
            "         'verifier_params.pkl', '--art-dir', s.art_dir()])\n"
            "rf = load('torch_roofline')\n"
            "try:\n"
            "    rf.roofline({'traceEvents': []}, 1)\n"
            "except RuntimeError:\n"
            "    pass\n"
            "assert not any(k == 'jax' or k.startswith(('jax.',\n"
            "    'cover_vla_tpu.', 'ml_dtypes')) for k, v in\n"
            "    sys.modules.items() if v is not None)\n")
    env = {**os.environ, "VS_TORCH_ART_DIR": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert sorted(p.name for p in tmp_path.glob("*.meta.json")) == [
        f"{n}.meta.json" for n in ("demos.npz", "policy_params.pkl",
                                   "pretrained_vision.pkl", "rankdata.npz",
                                   "verifier_params.pkl")]


def _port_runs():
    """Each config's default run (named runs hold other trees or knobs)."""
    with open(PORT_RESULTS) as f:
        return {r["config"]: r for r in json.load(f)["runs"]
                if r.get("name") is None}


@pytest.mark.parametrize("config", ["eager", "fast", "all_kernel"])
def test_committed_port_grid(config):
    """The port's grid on the card under each config: the verifier at N=16
    clears random at N=16 with non-overlapping 95% intervals, no verifier
    cell falls below the plain π0 baseline, more candidates do not hurt
    the verifier, and every cell is the JAX cell's size."""
    run = _port_runs()[config]
    assert run["device"] != "cpu" and "H100" in run["card"]
    cells = {(c["mode"], c["n_samples"], c["n_rephrases"]): c
             for c in run["grid"]}
    assert len([c for c in cells if c[0] in ("first", "random", "verifier")]
               ) == 13
    v16, r16 = cells[("verifier", 16, 1)], cells[("random", 16, 1)]
    assert v16["ci95"][0] > r16["ci95"][1], (v16["ci95"], r16["ci95"])
    base = cells[("first", 1, 1)]
    for (mode, n, k), c in cells.items():
        if mode.startswith("verifier"):
            assert c["success_rate"] >= base["success_rate"], (mode, n, k)
        if mode in ("first", "random", "verifier"):
            assert c["episodes"] == 300 and c["jax_episodes"] == 300
    assert cells[("verifier", 40, 1)]["success_rate"] >= \
        cells[("verifier", 5, 1)]["success_rate"] - 0.05


def test_committed_port_oracle_ceiling():
    cells = {(c["mode"], c["n_samples"], c["n_rephrases"]): c
             for c in _port_runs()["fast"]["grid"]}
    o16, r16 = cells[("oracle", 16, 1)], cells[("random", 16, 1)]
    assert o16["ci95"][0] > r16["ci95"][1]
    assert cells[("oracle", 40, 1)]["success_rate"] >= \
        cells[("oracle", 5, 1)]["success_rate"] - 0.05
