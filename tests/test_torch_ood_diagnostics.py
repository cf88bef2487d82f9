"""`scripts/torch_ood_diagnostics.py` against the JAX script
`scripts/ood_diagnostics.py`, on the committed trees at the experiment's
tiny widths on the CPU.

- `lang` and `regret` on the same slates (a cut of the committed
  `rankdata_wn.npz` with rendered scenes as its frames; `regret`'s
  collection replaced by those slates on both sides): each row equal to
  JAX's to 1e-6 and the same argmax picks
  wherever JAX's top-two gap exceeds twice the largest score difference
  (the JAX scores captured from its jitted scorer).
- `probe`'s ridge head after 20 Adam steps on 64 frames' features: the
  port's `optim.adamw` (weight decay 0) against the JAX script's optax
  head on the same features and batches, <= 1e-4; the port's `probe` end
  to end at tiny sizes.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "experiments", "verification_scaling")
SLATES = 160                   # states cut from rankdata_wn.npz


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def diag():
    return (_module("ood_jax_diag",
                    os.path.join(ROOT, "scripts", "ood_diagnostics.py")),
            _module("ood_torch_diag",
                    os.path.join(ROOT, "scripts", "torch_ood_diagnostics.py")))


@pytest.fixture(scope="module")
def art(diag, tmp_path_factory):
    """A directory with the first SLATES states of the committed
    rankdata_wn.npz (rendered synthetic scenes in place of its frames,
    whose 2.9 GB load would dominate the file) and links to the committed
    trees."""
    d = tmp_path_factory.mktemp("ood_art")
    with np.load(os.path.join(ART, "rankdata_wn.npz")) as rd:
        cut = {k: rd[k][:SLATES] for k in rd.files if k != "frames"}
    cut["frames"] = diag[1].vs.synth_localisation_frames(SLATES, seed=7)[0]
    np.savez(d / "rankdata_wn.npz", **cut)
    for name in ("verifier_params.pkl", "verifier_dagger_r1.pkl",
                 "policy_params.pkl", "stats.pkl", "demos.npz",
                 "pretrained_vision.pkl"):
        os.symlink(os.path.join(ART, name), d / name)
    return d


def _capture_jit(monkeypatch, outs):
    """jax.jit whose compiled functions also append their [B, N] outputs
    (the scorers')."""
    real = jax.jit

    def jit(fn, *a, **kw):
        compiled = real(fn, *a, **kw)

        def run(*args):
            out = compiled(*args)
            if np.ndim(out) == 2:           # scores, not preprocessed images
                outs.append(np.asarray(out))
            return out
        return run
    monkeypatch.setattr(jax, "jit", jit)


def _same_picks(want: np.ndarray, got: np.ndarray) -> int:
    """Picks equal wherever JAX's top-two gap exceeds twice the largest
    score difference; returns how many such slates there were."""
    dev = float(np.abs(got - want).max())
    assert dev < 1e-4
    top = np.sort(want, axis=1)
    decided = top[:, -1] - top[:, -2] > 2 * dev
    np.testing.assert_array_equal(got.argmax(1)[decided],
                                  want.argmax(1)[decided])
    return int(decided.sum())


def _run_jax(jdiag, monkeypatch, art, cmd, args):
    monkeypatch.setattr(jdiag, "ART_DIR", str(art))
    path = art / "ood_diagnostics.json"
    if path.exists():
        path.unlink()
    with contextlib.redirect_stdout(io.StringIO()):
        cmd(args)
    with open(path) as f:
        return json.load(f)


def test_lang_matches_jax(diag, art, monkeypatch):
    jdiag, tdiag = diag
    outs = []
    _capture_jit(monkeypatch, outs)
    want = _run_jax(jdiag, monkeypatch, art, jdiag.cmd_lang, argparse.Namespace(
        data="rankdata_wn.npz", verifiers=["verifier_params.pkl"],
        max_slates=24))["lang"]
    monkeypatch.undo()
    args = argparse.Namespace(data="rankdata_wn.npz", art_dir=str(art),
                              verifiers=["verifier_params.pkl"],
                              max_slates=24, config="eager")
    scores = {}
    with contextlib.redirect_stdout(io.StringIO()):
        got = tdiag.cmd_lang(args, torch.device("cpu"), scores_out=scores)
    assert got == want
    assert want["slates"] == 24
    decided = 0
    for key, jscores in zip(("grounded", "wrong_noun", "id_instruction"),
                            outs):
        decided += _same_picks(jscores, scores["verifier_params.pkl", key])
    assert decided >= 24


def test_regret_matches_jax(diag, art, monkeypatch):
    jdiag, tdiag = diag
    with np.load(art / "rankdata_wn.npz") as rd:
        slates = (rd["frames"][:40], rd["trajs"][:40].astype(np.float32),
                  rd["quals"][:40], rd["positions"][:40, 9] > 0.5)
    outs = []
    _capture_jit(monkeypatch, outs)
    monkeypatch.setattr(jdiag, "OOD_TASKS", ())
    monkeypatch.setattr(jdiag, "_collect_slates", lambda *a, **k: slates)
    want = _run_jax(jdiag, monkeypatch, art, jdiag.cmd_regret,
                    argparse.Namespace(
                        verifiers=["verifier_params.pkl",
                                   "verifier_dagger_r1.pkl"],
                        episodes=1, n_parallel=1, n_candidates=16))["regret"]
    monkeypatch.undo()
    monkeypatch.setattr(tdiag, "OOD_TASKS", ())
    monkeypatch.setattr(tdiag, "collect_slates", lambda *a, **k: slates)
    args = argparse.Namespace(
        verifiers=["verifier_params.pkl", "verifier_dagger_r1.pkl"],
        episodes=1, n_parallel=1, n_candidates=16, art_dir=str(art),
        config="eager", seed=97)
    scores = {}
    with contextlib.redirect_stdout(io.StringIO()):
        got = tdiag.cmd_regret(args, torch.device("cpu"), scores_out=scores)
    for row in (want, got):
        row["carrot_on_plate"].pop("collect_s")
    se = got["carrot_on_plate"].pop("se")
    assert got == want
    assert sorted(se) == ["verifier_dagger_r1.pkl", "verifier_params.pkl"]
    assert all(0 < v < 1 for s in se.values() for v in s.values())
    assert want["carrot_on_plate"]["slates"] >= 30
    decided = sum(_same_picks(j, scores[tdiag.TASK, name][0])
                  for j, name in zip(outs, ("verifier_params.pkl",
                                            "verifier_dagger_r1.pkl")))
    assert decided >= 40


def test_probe_head_matches_optax(diag):
    """20 steps on 64 frames' features: the JAX script's head (jax.grad,
    optax.adam) and the port's on the same features and batches."""
    _, tdiag = diag
    pcfg, vcfg = tdiag.vs.experiment_configs()
    from cover_vla_tpu_torch.convert.from_jax import load_pickle, place_like
    tower = place_like(load_pickle(os.path.join(ART, "pretrained_vision.pkl")),
                       None, torch.device("cpu"))
    frames, positions, _ = tdiag.vs.synth_localisation_frames(64, seed=11)
    targets = np.concatenate([positions[:, 0:2], positions[:, 3:5],
                              positions[:, 6:8]], 1).astype(np.float32) / 0.1
    feats = tdiag.features_of(tower, vcfg, frames, torch.device("cpu"))
    k, b = tdiag.train_probe_head(feats, torch.from_numpy(targets), 20)

    ftr = feats.numpy()
    head = {"k": jnp.zeros((ftr.shape[1], 6), jnp.float32),
            "b": jnp.zeros((6,), jnp.float32)}
    tx = optax.adam(1e-3)
    opt = tx.init(head)

    @jax.jit
    def step(head, opt, f, y):
        def loss(h):
            return jnp.mean((f @ h["k"] + h["b"] - y) ** 2) \
                + 1e-5 * jnp.sum(h["k"] ** 2)
        g = jax.grad(loss)(head)
        up, opt = tx.update(g, opt, head)
        return optax.apply_updates(head, up), opt

    rng = np.random.default_rng(0)
    for _ in range(20):
        idx = rng.integers(0, len(ftr), 128)
        head, opt = step(head, opt, ftr[idx], targets[idx])
    np.testing.assert_allclose(k, np.asarray(head["k"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(b, np.asarray(head["b"]), atol=1e-4, rtol=0)
    assert np.abs(k).max() > 1e-3          # the head moved


def test_probe_end_to_end(diag, art, tmp_path, monkeypatch):
    """The port's `probe` at tiny sizes: a row per tower and domain,
    written under the config's key of the artifact directory's file; the
    committed directory is never written."""
    _, tdiag = diag
    monkeypatch.setenv("VS_TORCH_OUT_DIR", str(tmp_path))
    before = os.listdir(ART)
    with contextlib.redirect_stdout(io.StringIO()):
        out = tdiag.main(["probe", "--device", "cpu", "--probe-frames", "16",
                          "--probe-steps", "2", "--frames-per-domain", "2",
                          "--verifiers", "verifier_params.pkl", "absent.pkl"])
    assert os.listdir(ART) == before
    assert sorted(out["probe"]) == ["pretrained_vision", "verifier_params.pkl"]
    for row in out["probe"].values():
        assert list(row) == ["id", "redbull_on_plate", "zucchini_on_towel",
                             "tennis_ball_in_basket", "dr_fresh"]
        assert all(np.isfinite(r["mae"]) for r in row.values())
    with open(tmp_path / "ood_diagnostics.json") as f:
        written = json.load(f)
    assert written["eager"]["probe"] == out["probe"]
    assert written["eager"]["card"] == "cpu"
