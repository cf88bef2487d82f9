"""The verification-scaling experiment's `rankdata` stage on the PyTorch port
against the JAX script's, and every training stage of the port's script
end to end on the CPU.

- One rankdata cohort (E = 2 episodes, domain-randomized scenes with
  wrong-noun slates) in lockstep: the JAX script's `cmd_rankdata` drives
  the episodes with the committed policy; at every chunk boundary the
  port's propose step runs on the same inputs with JAX's noise, and the
  port's `RankdataCollector` labels the port's candidates on the same envs.
  The records are the same: frames, positions and instructions byte-equal,
  trajectories to the bf16 parity bound (tests/test_torch_models.py: atol
  0.05, rtol 0.1) but for the gripper of candidates whose raw gripper
  binarised the other way (counted), the execution mix equal, and each candidate's quality
  within the chunk's own Lipschitz bound of JAX's (the potential moves by
  at most the end effector's displacement, so by at most the sum of the
  two chunks' per-step xyz differences) wherever the two chunks reach the
  same grasp and success state. The npz schema is JAX's.
- `demos`, `train_policy`, `rankdata` (random / oracle, then DAgger),
  `pretrain_backbone`, `train_verifier` and `eval` through `main([...])` at
  `--steps 2` and small batches into a tmp artifact directory: each writes
  its artifact and its `.meta.json`, the next stage reads it from there,
  and the committed experiment directory is left as it was.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import cover_vla_tpu.engine.batched_engine as jbe
from cover_vla_tpu.engine.verified_step import (
    make_propose_step_batched as j_make_propose)

from cover_vla_tpu_torch.configs import CoVerConfig
from cover_vla_tpu_torch.convert.from_jax import load_pickle, pi0_from_jax
from cover_vla_tpu_torch.engine.verified_step import make_propose_step_batched
from cover_vla_tpu_torch.eval.fake_expert import chunk_quality

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "experiments", "verification_scaling")
ATOL, RTOL = 0.05, 0.1
E, N = 2, 4


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return (_module("vs_jax_script_stages",
                    os.path.join(ROOT, "scripts", "verification_scaling.py")),
            _module("vs_torch_script_stages",
                    os.path.join(ROOT, "scripts",
                                 "torch_verification_scaling.py")))


def _rank_args(**kw):
    base = dict(policy_params=os.path.join(ART, "policy_params.pkl"),
                n_candidates=N, n_parallel=E, noise_std=1.0, oracle_frac=0.3,
                dagger_params="", dagger_frac=0.5, wrong_noun_frac=0.5,
                domain_rand=True, id_frac=0.25, episodes=E,
                out="rankdata.npz")
    base.update(kw)
    return argparse.Namespace(**base)


def _discrete_end(env, chunk):
    """(grasped, success) after executing `chunk` on a copy of `env`."""
    import copy
    sim = copy.deepcopy(env)
    for a in chunk:
        _, _, done, trunc, _ = sim.step(np.asarray(a, np.float64))
        if done or trunc:
            break
    return bool(sim._grasped), bool(sim.episode_stats["success"])


def test_rankdata_cohort_matches_jax(scripts, tmp_path, monkeypatch, capsys):
    jscript, tscript = scripts
    monkeypatch.setattr(jscript, "ART_DIR", str(tmp_path))
    for name in ("demos.npz", "stats.pkl"):
        os.symlink(os.path.join(ART, name), tmp_path / name)
    pcfg, vcfg = tscript.experiment_configs()
    jpcfg, jvcfg = jscript.experiment_configs()
    tpp = pi0_from_jax(load_pickle(os.path.join(ART, "policy_params.pkl")),
                       pcfg, device="cpu")
    tstats = load_pickle(os.path.join(ART, "stats.pkl"))
    args = _rank_args()
    tccfg = CoVerConfig(n_samples=N, n_rephrases=1, noise_std=1.0,
                        selection="injected", gripper_vote=False,
                        rescore_threshold=float("inf"),
                        max_history=vcfg.history_length - pcfg.chunk_size)
    t_prop = make_propose_step_batched(pcfg, vcfg, tccfg, tstats,
                                       device="cpu")
    collector = tscript.RankdataCollector(args, np.random.default_rng(123))
    checks = {"boundaries": 0, "candidates": 0, "discrete_differs": 0,
              "max_dq": 0.0, "flips": 0}

    class Lockstep(jbe.BatchedCoVerEngine):
        """The JAX engine, also running the port's propose step on the
        same inputs and noise and the port's collector on the same envs."""

        def __init__(self, *a, **kw):
            ccfg = a[4]
            j_prop = j_make_propose(a[2], a[3], ccfg, kw["stats"])

            def propose(pp, keys, raw, prop, lt, lm, hist, hlen):
                want = j_prop(pp, keys, raw, prop, lt, lm, hist, hlen)
                noise = np.stack([np.asarray(jax.random.normal(
                    k, (1, N, jpcfg.chunk_size, jpcfg.max_action_dim),
                    jnp.float32)) for k in keys])
                self.port = t_prop(tpp, raw, prop, lt, lm, hist, hlen,
                                   noise=noise)
                self.jax_prop = want
                return want

            super().__init__(*a, **kw, step_fn=(
                propose, jbe.make_select_step_batched(ccfg)))

        @property
        def score_fn_factory(self):
            return self._factory

        @score_fn_factory.setter
        def score_fn_factory(self, factory):
            self._factory = None if factory is None else self._both(factory)

        def _both(self, factory):
            port_factory = collector.factory(self)

            def for_envs(envs):
                jfn, tfn = factory(envs), port_factory(envs)

                def score_fn(exec_chunks, proposal):
                    tex = self.port.exec_chunks.numpy()
                    # a raw gripper near 0.5 may binarise the other way:
                    # the six motion dims are held, flips counted
                    np.testing.assert_allclose(tex[..., :6],
                                               exec_chunks[..., :6],
                                               atol=ATOL, rtol=RTOL)
                    checks["flips"] += int((tex[..., 6] != exec_chunks[
                        ..., 6]).any(-1).sum())
                    for e in np.nonzero(~self.done)[0]:
                        for i in range(N):
                            t, j = tex[e, i], exec_chunks[e, i]
                            if _discrete_end(envs[e], t) != \
                                    _discrete_end(envs[e], j):
                                checks["discrete_differs"] += 1
                                continue
                            step = np.clip(t[:, :3], -0.05, 0.05) - \
                                np.clip(j[:, :3], -0.05, 0.05)
                            bound = np.linalg.norm(step, axis=-1).sum()
                            dq = abs(chunk_quality(envs[e], t)
                                     - chunk_quality(envs[e], j))
                            checks["candidates"] += 1
                            checks["max_dq"] = max(checks["max_dq"], dq)
                            assert dq <= bound + 1e-6, (dq, bound)
                    checks["boundaries"] += 1
                    tfn(tex, proposal=self.port)
                    return jfn(exec_chunks, proposal)
                return score_fn
            return for_envs

    monkeypatch.setattr(jbe, "BatchedCoVerEngine", Lockstep)
    jscript.cmd_rankdata(args)
    out = capsys.readouterr().out
    with np.load(tmp_path / "rankdata.npz") as f:
        want = {k: f[k] for k in f.files}
    got = collector.arrays()
    assert set(got) == set(want) == {"frames", "trajs", "quals",
                                     "positions", "instrs"}
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
    s = len(want["frames"])
    assert want["frames"].shape == (s, 256, 256, 3)
    assert want["trajs"].shape == (s, N, 10, 7)
    assert want["positions"].shape == (s, 11)
    assert got["frames"].tobytes() == want["frames"].tobytes()
    assert got["positions"].tobytes() == want["positions"].tobytes()
    assert list(got["instrs"]) == list(want["instrs"])
    np.testing.assert_allclose(got["trajs"][..., :6], want["trajs"][..., :6],
                               atol=ATOL, rtol=RTOL)
    grip_off = (got["trajs"][..., 6] != want["trajs"][..., 6]).any(-1)
    assert grip_off.sum() <= 2 * checks["flips"]
    # the recorded qualities: within the largest per-candidate deviation
    # held to its bound above, but for candidates whose chunks reach
    # another grasp / success state
    off = np.abs(got["quals"] - want["quals"]) > checks["max_dq"] + 1e-6
    assert off.sum() <= 2 * checks["discrete_differs"], off.sum()
    assert checks["boundaries"] >= 10 and checks["candidates"] >= 100
    assert checks["discrete_differs"] <= 0.05 * checks["candidates"]
    mix = json.loads(re.search(r"exec mix (\{.*?\})", out).group(1)
                     .replace("'", '"'))
    assert collector.counters == mix
    assert mix.get("wrong_noun", 0) >= 1
    assert any(i != jscript.TASK.replace("widowx_", "")
               for i in got["instrs"])


def test_every_stage_runs_on_the_cpu(scripts, tmp_path, monkeypatch):
    _, tscript = scripts

    def digest():
        h = hashlib.sha256()
        for name in sorted(os.listdir(ART)):
            h.update(name.encode())
            with open(os.path.join(ART, name), "rb") as f:
                h.update(f.read())
        return h.hexdigest()

    before = digest()
    art = tmp_path / "trained"
    monkeypatch.setenv("VS_TORCH_ART_DIR", str(art))
    monkeypatch.setenv("VS_TORCH_OUT_DIR", str(tmp_path / "grid"))
    cpu = ["--device", "cpu"]
    tscript.main(["demos", *cpu, "--n-demos", "3"])
    tscript.main(["train_policy", *cpu, "--steps", "2", "--batch", "4"])
    tscript.main(["rankdata", *cpu, "--episodes", "4", "--n-parallel", "2",
                  "--n-candidates", "4"])
    tscript.main(["pretrain_backbone", *cpu, "--steps", "2", "--batch", "4",
                  "--synthetic", "40"])
    tscript.main(["train_verifier", *cpu, "--steps", "2", "--batch", "4",
                  "--color-aug"])
    tscript.main(["rankdata", *cpu, "--episodes", "2", "--n-parallel", "2",
                  "--n-candidates", "4", "--dagger-params",
                  "verifier_params.pkl", "--dagger-frac", "1.0", "--out",
                  "rankdata2.npz"])
    for name in ("demos.npz", "policy_params.pkl", "rankdata.npz",
                 "pretrained_vision.pkl", "verifier_params.pkl",
                 "rankdata2.npz"):
        assert (art / name).exists(), name
        with open(art / f"{name}.meta.json") as f:
            meta = json.load(f)
        assert name == "demos.npz" or meta["launches"] == {
            "shared_prefix_gqa": 0, "mha_dense": 0, "prefix_gqa": 0}
    with open(art / "rankdata.npz.meta.json") as f:
        rank = json.load(f)
    assert rank["summary"]["states"] > 32 and rank["summary"]["episodes"] == 4
    assert rank["committed_summary"]["states"] == 13340
    with open(art / "rankdata2.npz.meta.json") as f:
        mix = json.load(f)["summary"]["exec_mix"]
    assert mix["dagger"] > 0 and mix["random"] == mix["oracle"] == 0
    with open(art / "verifier_params.pkl.meta.json") as f:
        vmeta = json.load(f)
    assert vmeta["data_files"] == ["rankdata.npz"]
    assert vmeta["freeze_backbone"] is True
    with np.load(art / "rankdata.npz") as f:
        assert f["frames"].dtype == np.uint8 and f["trajs"].shape[1:] == (
            4, 10, 7) and f["positions"].shape[1:] == (11,)
    with open(art / "pretrained_vision.pkl.meta.json") as f:
        pmeta = json.load(f)
    assert set(pmeta["probe_localisation_error"]) == {"port",
                                                      "committed_jax"}
    # eval of the trained trees goes to the artifact directory's results
    tscript.main(["eval", *cpu, "--trials", "2", "--n-parallel", "2",
                  "--cells", "first,1,1", "verifier,16,1", "--no-with-oracle",
                  "--no-ood", "--policy-params", "policy_params.pkl",
                  "--verifier-params", "verifier_params.pkl",
                  "--run-name", "d_chain"])
    with open(art / "results.json") as f:
        (run,) = json.load(f)["runs"]
    assert run["name"] == "d_chain" and run["config"] == "eager"
    assert run["policy_params"].endswith("trained/policy_params.pkl")
    assert [c["jax_successes"] for c in run["grid"]] == [97, 143]
    assert not (tmp_path / "grid").exists()
    assert digest() == before
