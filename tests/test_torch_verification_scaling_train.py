"""The verification-scaling experiment's training stages on the PyTorch port
(`scripts/torch_verification_scaling.py` demos / train_policy / rankdata /
pretrain_backbone / train_verifier) against the JAX script's own code
(`scripts/verification_scaling.py`, loaded as a module with its `ART_DIR`
moved to a tmp dir), at small sizes on the CPU.

- `demos`: the npz arrays byte-equal, the statistics equal, each side's
  `stats.pkl` read by the other.
- The synthetic localisation frames and the appearance, grounded and
  wrong-noun instruction draws byte-equal for the same `default_rng`.
- The augmentations given their draws equal to the `jnp` ops the JAX
  closures apply (written out here from verification_scaling.py:633-648
  and :954-985): images byte-equal, labels and trajectories equal.
- The stages' schedule equal to optax's `warmup_cosine_decay_schedule(0,
  ...)` at every count.
- Three optimizer steps of each stage on the same batch against the JAX
  step (fp32 trees): `train_policy` through `train_pi0.make_train_step`
  with the script's optax AdamW and the flow noise and times injected;
  `pretrain_backbone` through `siglip.vit_forward` + MSE + optax AdamW;
  `train_verifier` through the regression and listwise steps under
  `inject_hyperparams(optax.adamw)` from the committed verifier. Losses
  within 1e-5; parameters within 1e-4 everywhere and 1e-5 in all but 1e-4
  of the elements (the verifier: VERIFIER_SHARE), attention key biases
  within one lr (their gradient is zero in exact arithmetic) — the bounds
  of tests/test_torch_training.py.
- Trees cross-load: the port's `save_pickle` is read by the JAX script's
  `_load_tree` with `ml_dtypes.bfloat16` leaves, and JAX's
  `pi0.sample_actions` on it equals the port's (the bf16 parity bound of
  tests/test_torch_models.py, atol 0.05 / rtol 0.1); a JAX-written tree
  goes through the port's loader bit for bit.
"""

import argparse
import importlib.util
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cover_vla_tpu.configs import replace as j_replace
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.models import siglip as jsiglip
from cover_vla_tpu.models import verifier as jverifier
from cover_vla_tpu.ops.image import resize_bicubic_pil as j_bicubic
from cover_vla_tpu.training import train_pi0 as jtrain_pi0
from cover_vla_tpu.training import train_verifier as jtrain_verifier

from cover_vla_tpu_torch.configs import replace
from cover_vla_tpu_torch.convert.from_jax import (
    load_pickle, pi0_from_jax, place_like, verifier_from_jax)
from cover_vla_tpu_torch.models import pi0
from cover_vla_tpu_torch.training import optim, train_pi0, train_verifier
from cover_vla_tpu_torch.utils.tree import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "experiments", "verification_scaling")
LOSS_ATOL, PARAM_ATOL, ADAMW_SHARE = 1e-5, 1e-5, 1e-4
ATOL, RTOL = 0.05, 0.1          # bf16 parity (tests/test_torch_models.py)
# The verifier's text-aware pooling attends over tokens that differ
# little, so its query / key projections get gradients near the rounding
# level, which Adam divides by their own RMS: after three steps 8.2e-4
# (regression) and 1.7e-4 (listwise) of the elements sit beyond 1e-5, the
# largest 3.0e-5 (measured); every element stays within 1e-4.
VERIFIER_SHARE = 2e-3


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return (_module("vs_jax_script_train",
                    os.path.join(ROOT, "scripts", "verification_scaling.py")),
            _module("vs_torch_script_train",
                    os.path.join(ROOT, "scripts",
                                 "torch_verification_scaling.py")))


@pytest.fixture
def arts(scripts, tmp_path, monkeypatch):
    """(JAX art dir, port art dir), both under tmp_path."""
    jscript, _ = scripts
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    monkeypatch.setattr(jscript, "ART_DIR", str(jdir))
    monkeypatch.setenv("VS_TORCH_ART_DIR", str(tdir))
    return jdir, tdir


def _jflat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _hold_params(tparams, jtree, lr, share=ADAMW_SHARE):
    """The bounds of tests/test_torch_training.py after a few steps."""
    want = _jflat(jtree)
    diff = {k: np.abs(v.detach().numpy() - want[k]).ravel()
            for k, v in flatten(tparams).items()}
    assert set(diff) == set(want)
    kb = [k for k in diff if k.endswith("attn.k.bias")]
    d = np.concatenate([v for k, v in diff.items() if k not in kb])
    assert float((d > PARAM_ATOL).mean()) <= share, d.max()
    assert float(d.max()) <= 1e-4
    for k in kb:
        assert float(diff[k].max()) <= lr, k


# ---------------------------------------------------------------------------
# demos, synthetic frames, instruction draws
# ---------------------------------------------------------------------------


def test_demos_byte_equal_and_statistics_cross_read(scripts, arts):
    jscript, tscript = scripts
    jdir, tdir = arts
    jscript.cmd_demos(argparse.Namespace(n_demos=3, demo_noise=0.008))
    tscript.main(["demos", "--device", "cpu", "--n-demos", "3"])
    with np.load(jdir / "demos.npz") as want, np.load(tdir / "demos.npz") as got:
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k
    with open(jdir / "stats.pkl", "rb") as f:
        jstats = pickle.load(f)
    with open(tdir / "stats.pkl", "rb") as f:
        port_in_jax = pickle.load(f)        # the JAX package's classes
    assert type(port_in_jax) is type(jstats)
    jax_in_port = load_pickle(str(jdir / "stats.pkl"))
    own = load_pickle(str(tdir / "stats.pkl"))
    for field in ("action", "proprio"):
        for k in ("mean", "std", "p01", "p99", "minimum", "maximum"):
            w = getattr(getattr(jstats, field), k)
            for got in (port_in_jax, jax_in_port, own):
                g = getattr(getattr(got, field), k)
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert (own.num_transitions, own.num_trajectories) == (
        jstats.num_transitions, jstats.num_trajectories)
    assert os.path.exists(tdir / "demos.npz.meta.json")


def test_synthetic_frames_and_instruction_draws(scripts):
    jscript, tscript = scripts
    for want, got in zip(jscript._synth_localisation_frames(16),
                         tscript.synth_localisation_frames(16)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    j_rng, t_rng = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(40):
        ap = jscript._random_appearance(j_rng)
        assert tscript.random_appearance(t_rng) == ap
        assert tscript.grounded_instruction(t_rng, ap) == \
            jscript._grounded_instruction(j_rng, ap)
        for d in ap["distractors"]:
            assert tscript.wrong_noun_instruction(t_rng, ap, d["shape"]) \
                == jscript._wrong_noun_instruction(j_rng, ap, d["shape"])
    assert t_rng.random() == j_rng.random()
    # the localisation targets (scripts/verification_scaling.py:573-585)
    _, positions, shapes = tscript.synth_localisation_frames(8)
    y = tscript.localisation_targets(positions, shapes)
    assert y.shape == (8, 7 + 5 + 3) and y.dtype == np.float32
    np.testing.assert_array_equal(y[:, :7], np.concatenate(
        [positions[:, 0:2], positions[:, 3:5], positions[:, 6:8],
         positions[:, 9:10]], 1) / np.float32(0.1))
    assert set(np.unique(y[:, 7:])) == {0.0, 2.0}


# ---------------------------------------------------------------------------
# augmentations given their draws
# ---------------------------------------------------------------------------


def _jnp_pretrain_aug(img, y, dy, dx, fh, fv):
    """scripts/verification_scaling.py:633-648 with the draws given."""
    img = jnp.roll(img, (dy, dx), axis=(0, 1))
    y = y.at[0:6:2].add(dx / 40.0)
    y = y.at[1:6:2].add(dy / 40.0)
    img = jnp.where(fh, img[:, ::-1], img)
    y = jnp.where(fh, y.at[0:6:2].multiply(-1.0), y)
    img = jnp.where(fv, img[::-1], img)
    y = jnp.where(fv, y.at[1:6:2].multiply(-1.0), y)
    return img, y


def _jnp_verifier_aug(img, tr, dy, dx, fh, fv, perm, scale, offset,
                      color_aug, pad_val=-5.0):
    """scripts/verification_scaling.py:954-985 with the draws given."""
    img = jnp.roll(img, (dy, dx), axis=(0, 1))
    pad = jnp.all(tr == pad_val, axis=-1, keepdims=True)
    img = jnp.where(fh, img[:, ::-1], img)
    img = jnp.where(fv, img[::-1], img)
    sign = jnp.ones((7,)).at[0].set(jnp.where(fh, -1.0, 1.0)
                                    ).at[1].set(jnp.where(fv, -1.0, 1.0))
    tr = jnp.where(pad, tr, tr * sign)
    if color_aug:
        img = img.astype(jnp.float32)[..., perm]
        img = img * scale + offset
        img = jnp.clip(img, 0.0, 255.0)
    return img, tr


def _draws(rng, b, shift):
    return {"dy": rng.integers(-shift, shift + 1, b),
            "dx": rng.integers(-shift, shift + 1, b),
            "fh": rng.random(b) < 0.5, "fv": rng.random(b) < 0.5,
            "perm": np.stack([rng.permutation(3) for _ in range(b)]),
            "scale": rng.uniform(0.6, 1.4, (b, 3)).astype(np.float32),
            "offset": rng.uniform(-40, 40, (b, 3)).astype(np.float32)}


def _tdraws(d, keys):
    return {k: torch.from_numpy(np.asarray(d[k])) for k in keys}


def test_pretrain_augmentation_matches_jnp(scripts):
    _, tscript = scripts
    rng = np.random.default_rng(0)
    b = 8
    img = rng.integers(0, 256, (b, 48, 40, 3)).astype(np.uint8)
    y = rng.standard_normal((b, 15)).astype(np.float32)
    d = _draws(rng, b, 16)
    d["fh"][:2], d["fv"][:2] = [True, False], [False, True]
    gi, gy = tscript.pretrain_augment(
        torch.from_numpy(img), torch.from_numpy(y),
        **_tdraws(d, ("dy", "dx", "fh", "fv")))
    for i in range(b):
        wi, wy = _jnp_pretrain_aug(jnp.asarray(img[i]), jnp.asarray(y[i]),
                                   int(d["dy"][i]), int(d["dx"][i]),
                                   bool(d["fh"][i]), bool(d["fv"][i]))
        assert gi[i].numpy().tobytes() == np.asarray(wi).tobytes(), i
        np.testing.assert_array_equal(gy[i].numpy(), np.asarray(wy))


@pytest.mark.parametrize("color_aug", [False, True])
def test_verifier_augmentation_matches_jnp(scripts, color_aug):
    _, tscript = scripts
    rng = np.random.default_rng(1)
    b = 8
    img = rng.integers(0, 256, (b, 40, 48, 3)).astype(np.uint8)
    tr = rng.standard_normal((b, 4, 10, 7)).astype(np.float32)
    tr[:, :, :3] = -5.0                         # top-padded histories
    d = _draws(rng, b, 24)
    d["fh"][:2], d["fv"][:2] = [True, False], [False, True]
    gi, gt = tscript.verifier_augment(
        torch.from_numpy(img), torch.from_numpy(tr),
        **_tdraws(d, ("dy", "dx", "fh", "fv", "perm", "scale", "offset")),
        color_aug=color_aug, pad_value=-5.0)
    assert gi.dtype == (torch.float32 if color_aug else torch.uint8)
    for i in range(b):
        wi, wt = _jnp_verifier_aug(
            jnp.asarray(img[i]), jnp.asarray(tr[i]), int(d["dy"][i]),
            int(d["dx"][i]), bool(d["fh"][i]), bool(d["fv"][i]),
            jnp.asarray(d["perm"][i]), jnp.asarray(d["scale"][i]),
            jnp.asarray(d["offset"][i]), color_aug)
        np.testing.assert_array_equal(gi[i].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gt[i].numpy(), np.asarray(wt))
    assert (gt[:, :, :3] == -5.0).all()         # padding stays padding


def test_the_draws_cover_their_ranges(scripts):
    _, tscript = scripts
    gen = torch.Generator().manual_seed(0)
    p = tscript.pretrain_draws(gen, 4096, "cpu")
    assert p["dy"].min() == -16 and p["dx"].max() == 16
    v = tscript.verifier_draws(gen, 4096, "cpu")
    assert v["dy"].min() == -24 and v["dx"].max() == 24
    assert 0.45 < float(v["fh"].float().mean()) < 0.55
    assert (v["perm"].sort(dim=-1).values == torch.arange(3)).all()
    assert 0.6 <= float(v["scale"].min()) and float(v["scale"].max()) < 1.4
    assert -40 <= float(v["offset"].min()) and float(v["offset"].max()) < 40


# ---------------------------------------------------------------------------
# the schedule and the stage steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps,cap", [(2, 50), (37, 50), (1500, 50),
                                       (4000, 50), (20000, 100)])
def test_stage_schedule_matches_optax(scripts, steps, cap):
    _, tscript = scripts
    lr = 1e-3
    warm = min(cap, max(1, steps // 10))
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warm,
                                              max(steps, warm + 1))
    got = tscript.stage_schedule(lr, steps, cap)
    counts = np.arange(steps + 1)
    w = np.asarray(jax.vmap(want)(counts))
    g = np.asarray([got(int(c)) for c in counts])
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * lr)
    assert g[0] == 0.0 and g[-1] < 1e-9


def _policy_data(tscript, pcfg, n=12, seed=0):
    rng = np.random.default_rng(seed)
    with np.load(os.path.join(ART, "demos.npz")) as d:
        frames = d["frames"][:n]
    lt = rng.integers(0, pcfg.paligemma.vocab_size, (3, 8))
    lm = np.ones((3, 8), bool)
    lm[1, 6:] = False
    return {"frames": torch.from_numpy(frames),
            "state": torch.from_numpy(rng.standard_normal(
                (n, 32)).astype(np.float32)),
            "actions": torch.from_numpy(rng.standard_normal(
                (n, pcfg.chunk_size, 32)).astype(np.float32)),
            "lang_tokens": torch.from_numpy(lt).long(),
            "lang_masks": torch.from_numpy(lm)}


def test_train_policy_steps_match_jax(scripts, monkeypatch):
    jscript, tscript = scripts
    tpcfg, _ = tscript.experiment_configs()
    jpcfg, _ = jscript.experiment_configs()
    tpcfg = replace(tpcfg, compute_dtype="float32")
    jpcfg = j_replace(jpcfg, compute_dtype="float32")
    lr, steps, b = 1e-3, 20, 4
    jparams = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jpi0.init_pi0(jax.random.PRNGKey(0), jpcfg))
    jtx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, lr, min(50, max(1, steps // 10)), steps), weight_decay=1e-5)
    js = jtrain_pi0.TrainState(jax.tree_util.tree_map(jnp.asarray, jparams),
                               jtx.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jtrain_pi0.make_train_step(jpcfg, jtx)
    ttx = optim.adamw(tscript.stage_schedule(lr, steps, 50),
                      weight_decay=1e-5)
    tp = pi0_from_jax(jparams, tpcfg, device="cpu")
    ts = train_pi0.TrainState(tp, ttx.init(flatten(tp)), optim.counter())
    tstep = train_pi0.make_train_step(tpcfg, ttx)
    data = _policy_data(tscript, tpcfg)
    prep = jscript._policy_preprocess_fn(jpcfg)
    rng = np.random.default_rng(0)
    # the flow noise and times, injected on both sides (the jitted JAX
    # step calls its samplers only while tracing: one draw for all steps)
    noise = rng.standard_normal((b, tpcfg.chunk_size, 32)).astype(np.float32)
    time = rng.uniform(0.001, 1.0, b).astype(np.float32)
    monkeypatch.setattr(jpi0, "sample_noise",
                        lambda key, shape, std=1.0: jnp.asarray(noise))
    monkeypatch.setattr(jpi0, "sample_flow_time",
                        lambda key, n: jnp.asarray(time))
    jstep = jax.jit(jstep)
    for i in range(3):
        idx = rng.integers(0, len(data["state"]), b)
        v = rng.integers(0, 3, b)
        batch = tscript.policy_batch(data, idx, v, tpcfg)
        # the engine's uint8 LANCZOS4 chain against the JAX script's (the
        # uint8 resize is bit-exact; XLA's fused normalisation is within
        # an ulp of it)
        want_imgs = np.asarray(prep(data["frames"][idx].numpy()))
        np.testing.assert_allclose(batch["images"][:, 0].numpy(), want_imgs,
                                   rtol=0, atol=2e-7)
        jbatch = {k: jnp.asarray(x.numpy()) for k, x in batch.items()}
        js, jm = jstep(js, jax.random.PRNGKey(i), jbatch)
        ts, tm = tstep(ts, None, batch, noise=torch.from_numpy(noise),
                       time=torch.from_numpy(time))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=0, atol=LOSS_ATOL)
    _hold_params(ts.params, js.params, lr)


def test_pretrain_backbone_steps_match_jax(scripts):
    jscript, tscript = scripts
    _, tvcfg = tscript.experiment_configs()
    _, jvcfg = jscript.experiment_configs()
    lr, steps, b = 1e-3, 20, 4
    vision = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), jverifier.init_verifier(
            jax.random.PRNGKey(7), jvcfg, num_members=1)["backbone"]["vision"])
    frames, positions, shapes = tscript.synth_localisation_frames(b)
    y = tscript.localisation_targets(positions, shapes)
    p_dim = tvcfg.vision.num_patches * tvcfg.vision.width
    head = {"kernel": (np.random.default_rng(8).standard_normal(
        (p_dim, y.shape[1])) * p_dim ** -0.5).astype(np.float32),
            "bias": np.zeros((y.shape[1],), np.float32)}

    def loss_fn(tree, images, yy):      # verification_scaling.py:611-616
        out = jsiglip.vit_forward(tree["vision"], jvcfg.vision, images)
        feats = out.last_attn_out.astype(jnp.float32)
        pred = feats.reshape(feats.shape[0], -1) @ tree["head"]["kernel"] \
            + tree["head"]["bias"]
        return jnp.mean((pred - yy) ** 2)

    jtx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, lr, min(100, max(1, steps // 10)), steps), weight_decay=1e-5)
    jtree = jax.tree_util.tree_map(jnp.asarray,
                                   {"vision": vision, "head": head})
    jopt = jtx.init(jtree)

    @jax.jit
    def jstep(tree, opt, images, yy):
        loss, grads = jax.value_and_grad(loss_fn)(tree, images, yy)
        upd, opt = jtx.update(grads, opt, tree)
        return optax.apply_updates(tree, upd), opt, loss

    ttree = place_like({"vision": vision, "head": head}, None, "cpu")
    ttx = optim.adamw(tscript.stage_schedule(lr, steps, 100),
                      weight_decay=1e-5)
    topt = ttx.init(flatten(ttree))
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        draws = tscript.pretrain_draws(gen, b, "cpu")
        f_b, y_b = tscript.pretrain_augment(
            torch.from_numpy(frames), torch.from_numpy(y), **draws)
        images = tscript.verifier_prep(f_b, tvcfg.vision.image_size)
        want_images = ((j_bicubic(jnp.asarray(f_b.numpy(), jnp.float32),
                                  128, 128) / 255.0) - 0.5) / 0.5
        np.testing.assert_allclose(images.numpy(), np.asarray(want_images),
                                   rtol=0, atol=1e-6)
        jtree, jopt, jloss = jstep(jtree, jopt, jnp.asarray(images.numpy()),
                                   jnp.asarray(y_b.numpy()))
        tloss, topt = tscript.pretrain_update(ttx, topt, ttree, tvcfg,
                                              images, y_b)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6,
                                   atol=LOSS_ATOL)
    _hold_params(ttree, jtree, lr)


def _rankdata_part(n=40, seed=0):
    """A rankdata-like part with every stratum: spreads above and below 5,
    ID and grounded instructions, padded histories."""
    rng = np.random.default_rng(seed)
    quals = rng.uniform(-0.5, 0.5, (n, 16)).astype(np.float32)
    quals[: n // 3, 0] += 8.0                   # high-stakes states
    trajs = rng.standard_normal((n, 16, 10, 7)).astype(np.float32) * 0.02
    trajs[:, :, :4] = -5.0
    with np.load(os.path.join(ART, "demos.npz")) as d:
        frames = d["frames"][:n]
    instrs = np.asarray(["put carrot on plate"] * (n // 2)
                        + ["put the red cube on the towel"] * (n - n // 2))
    positions = np.zeros((n, 11), np.float32)
    return {"frames": frames, "trajs": trajs, "quals": quals,
            "positions": positions, "instrs": instrs}


@pytest.mark.parametrize("objective", ["regression", "listwise"])
def test_train_verifier_steps_match_jax(scripts, tmp_path, monkeypatch,
                                        objective):
    jscript, tscript = scripts
    _, tvcfg = tscript.experiment_configs()
    _, jvcfg = jscript.experiment_configs()
    monkeypatch.setenv("VS_TORCH_ART_DIR", str(tmp_path))
    np.savez(tmp_path / "rd.npz", **_rankdata_part())
    args = argparse.Namespace(
        data=["rd.npz"], dr_phase="all", min_spread=0.02, rephrases=True,
        cross_task_text=True, batch=6, augment=True, color_aug=True,
        objective=objective)
    data = tscript.verifier_data(args, tvcfg, "cpu")
    assert data["strata"][0] > 0 and data["strata"][1] > 0
    lr, steps = 1e-3, 20
    jtx = optax.inject_hyperparams(optax.adamw)(learning_rate=0.0,
                                                weight_decay=1e-5)
    # the committed verifier as the start (the stage's --init-params warm
    # start): a random tree's text-aware pooling sees near-identical
    # tokens, so its query/key gradients are rounding noise that Adam's
    # first update turns into +-lr on both sides
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jscript._load_tree(os.path.join(ART, "verifier_params.pkl")))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jtrain_verifier.FullVerifierTrainState(jp, jtx.init(jp),
                                                jnp.zeros((), jnp.int32))
    make = {"regression": lambda cfg, tx, tb: (
        jtrain_verifier.make_regression_train_step(
            cfg, tx, q_scale=1.0, train_backbone=tb)),
            "listwise": lambda cfg, tx, tb: (
        jtrain_verifier.make_listwise_train_step(
            cfg, tx, tau=1.0, train_backbone=tb))}[objective]
    jstep = jax.jit(make(jvcfg, jtx, False))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(50, max(1, steps // 10)), steps)
    ttx = optim.adamw(tscript.stage_schedule(lr, steps, 50),
                      weight_decay=1e-5)
    tp = verifier_from_jax(params, tvcfg, device="cpu")
    ts = train_verifier.FullVerifierTrainState(tp, ttx.init(flatten(tp)),
                                               optim.counter())
    tstep = (train_verifier.make_regression_train_step(
        tvcfg, ttx, q_scale=1.0, train_backbone=False)
        if objective == "regression" else
        train_verifier.make_listwise_train_step(
            tvcfg, ttx, tau=1.0, train_backbone=False))
    gen = torch.Generator().manual_seed(3)
    for i in range(3):
        batch = tscript.verifier_batch(data, gen, args, tvcfg, -5.0)
        # the lr injected per step (verification_scaling.py:1050-1053)
        opt = js.opt_state._replace(hyperparams={
            **js.opt_state.hyperparams,
            "learning_rate": jnp.asarray(sched(i), jnp.float32)})
        js = jtrain_verifier.FullVerifierTrainState(js.params, opt, js.step)
        js, jm = jstep(js, {k: jnp.asarray(v.numpy())
                            for k, v in batch.items()})
        ts, tm = tstep(ts, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=0, atol=LOSS_ATOL)
    _hold_params(ts.params, js.params, lr, share=VERIFIER_SHARE)
    # the regression targets are the standardized slates
    if objective == "regression":
        q = batch["qualities"].numpy()
        np.testing.assert_allclose(q.mean(1), 0.0, atol=1e-5)


def test_selection_regret_and_state_scores(scripts):
    jscript, tscript = scripts
    _, tvcfg = tscript.experiment_configs()
    _, jvcfg = jscript.experiment_configs()
    jvp = jscript._load_tree(os.path.join(ART, "verifier_params.pkl"))
    tvp = verifier_from_jax(load_pickle(os.path.join(
        ART, "verifier_params.pkl")), tvcfg, device="cpu")
    part = _rankdata_part(n=3)
    imgs = tscript.verifier_prep(torch.from_numpy(part["frames"]), 128)
    toks = np.random.default_rng(0).integers(0, 512, (3, 16))
    got = tscript.state_scores(tvp, tvcfg, imgs, torch.from_numpy(toks),
                               torch.from_numpy(part["trajs"])).numpy()
    for s in range(3):
        want = np.asarray(jverifier.score_actions(
            jvp, jvcfg, jnp.asarray(imgs[s:s + 1].numpy()),
            jnp.asarray(toks[s:s + 1]), jnp.asarray(part["trajs"][s])))
        np.testing.assert_allclose(got[s], want, rtol=0, atol=1e-5)
    regret, top1 = tscript.selection_regret(
        np.array([[0.1, 0.9], [0.8, 0.2]]), np.array([[1.0, 3.0],
                                                      [1.0, 4.0]]))
    assert regret == pytest.approx(1.5) and top1 == 0.5


# ---------------------------------------------------------------------------
# trees across the packages
# ---------------------------------------------------------------------------


def test_trees_cross_load(scripts, tmp_path):
    jscript, tscript = scripts
    tpcfg, _ = tscript.experiment_configs()
    jpcfg, _ = jscript.experiment_configs()
    tp = pi0.init_pi0(3, tpcfg, device="cpu")
    path = str(tmp_path / "port_policy.pkl")
    tscript.save_pickle(path, tp)
    jtree = jscript._load_tree(path)
    leaves = _jflat(jtree)
    bf16 = [k for k, v in leaves.items() if v.dtype.name == "bfloat16"]
    assert len(bf16) == 30                      # as in the committed policy
    for k, v in flatten(tp).items():
        w = leaves[k]
        if v.dtype == torch.bfloat16:
            assert w.view(np.uint16).tobytes() == \
                v.detach().view(torch.int16).numpy().tobytes(), k
        else:
            assert w.dtype == np.float32 and w.tobytes() == \
                v.detach().numpy().tobytes(), k
    with open(path, "rb") as f:
        assert b"ml_dtypes" in f.read()
    # JAX's sample_actions on the port-written tree against the port's
    rng = np.random.default_rng(0)
    s = jpcfg.vision.image_size
    images = rng.uniform(-1, 1, (2, 1, s, s, 3)).astype(np.float32)
    toks = rng.integers(0, 1024, (2, 8)).astype(np.int32)
    masks = np.ones((2, 8), bool)
    state = rng.standard_normal((2, 32)).astype(np.float32)
    noise = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    want = np.asarray(jpi0.sample_actions(
        jax.tree_util.tree_map(jnp.asarray, jtree), jpcfg,
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.ones((2, 1), bool),
        jnp.asarray(toks), jnp.asarray(masks), jnp.asarray(state),
        num_candidates=3, noise=jnp.asarray(noise)))
    got = pi0.sample_actions(
        tp, tpcfg, torch.from_numpy(images), torch.ones((2, 1), dtype=bool),
        torch.from_numpy(toks).long(), torch.from_numpy(masks),
        torch.from_numpy(state), num_candidates=3,
        noise=torch.from_numpy(noise)).float().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # a JAX-written tree through the port's loader, bit for bit
    jp = jpi0.init_pi0(jax.random.PRNGKey(5), jpcfg)
    jpath = str(tmp_path / "jax_policy.pkl")
    jscript._save_tree(jpath, jp)
    back = pi0_from_jax(load_pickle(jpath), tpcfg, device="cpu")
    want_leaves = _jflat(jp)
    for k, v in flatten(back).items():
        w = want_leaves[k]
        if w.dtype.name == "bfloat16":
            assert v.dtype == torch.bfloat16
            assert v.view(torch.int16).numpy().tobytes() == \
                w.view(np.uint16).tobytes(), k
        else:
            assert v.numpy().tobytes() == w.tobytes(), k
    # and the port's own round trip
    again = pi0_from_jax(load_pickle(path), tpcfg, device="cpu")
    for k, v in flatten(again).items():
        assert torch.equal(v, flatten(tp)[k].detach()), k
