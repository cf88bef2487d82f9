"""PyTorch port vs the JAX package: the episode-sharded verified step
(`make_verified_step_sharded`) on tiny configs with fp32 weights, the
JAX step on a 2-device CPU mesh against the port's in two gloo processes
(tests/torch_dist_worker.py), with the JAX step's own noise injected.
Bounds as tests/test_sharded_engine.py holds the JAX sharded step to its
batched one: exec_chunk rtol 1e-2 / atol 5e-4, winners equal. The port's
2-process step against its own batched step on the same CPU: within 1e-5,
picks equal; with the noise (and selection="random"'s winners) drawn from
a generator, the draws are the batched step's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from cover_vla_tpu import configs as jconfigs
from cover_vla_tpu.data.stats import DatasetStatistics as JStats
from cover_vla_tpu.engine.verified_step import (
    make_verified_step_sharded as j_make_sharded)
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.models import verifier as jverifier

from cover_vla_tpu_torch import configs
from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax, verifier_from_jax
from cover_vla_tpu_torch.utils.tree import flatten

from torch_dist_worker import run_ranks

E, K, N = 4, 2, 2
DISCRETE = ("winner_idx", "winner_group", "used_stage2", "deferred")
FLOATS = ("exec_chunk", "verifier_chunk", "scores", "raw_gripper",
          "max_score")


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)


def _episodes():
    pcfg, vcfg = configs.tiny_pi0_config(), configs.tiny_verifier_config()
    rng = np.random.default_rng(0)
    t = pcfg.tokenizer_max_length
    raw = rng.integers(0, 256, (E, 256, 256, 3), dtype=np.uint8)
    proprio = rng.uniform(-0.1, 0.1, (E, 7)).astype(np.float32)
    lt = rng.integers(0, pcfg.paligemma.vocab_size, (E, K, t)).astype(np.int32)
    lm = np.ones((E, K, t), bool)
    lm[1, 1, t - 2:] = False
    vt = rng.integers(0, vcfg.text.vocab_size,
                      (E, vcfg.text.context_length)).astype(np.int32)
    hist = rng.uniform(-0.5, 0.5, (E, 6, 7)).astype(np.float32)
    hist_len = np.array([6, 2, 0, 4], np.int32)
    return raw, proprio, lt, lm, vt, hist, hist_len


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX mesh step's result, each rank's results)."""
    jp, jv = jconfigs.tiny_pi0_config(), jconfigs.tiny_verifier_config()
    jpp = _f32(jpi0.init_pi0(jax.random.PRNGKey(0), jp))
    jvp = _f32(jverifier.init_verifier(jax.random.PRNGKey(1), jv,
                                       num_members=2))
    jc = jconfigs.CoVerConfig(n_samples=N, n_rephrases=K)
    episodes = _episodes()
    keys = jax.random.split(jax.random.PRNGKey(3), E)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    with mesh:
        ref = j_make_sharded(jp, jv, jc, JStats.from_json(), mesh)(
            jpp, jvp, keys, *episodes)
        assert len(ref.exec_chunk.sharding.device_set) == 2
    noise = np.stack([np.asarray(jax.random.normal(
        keys[e], (K, N, jp.chunk_size, jp.max_action_dim), jnp.float32))
        * jc.noise_std for e in range(E)])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tpp = pi0_from_jax(np_tree(jpp), configs.tiny_pi0_config(), device="cpu")
    tvp = verifier_from_jax(np_tree(jvp), configs.tiny_verifier_config(),
                            device="cpu")
    d = tmp_path_factory.mktemp("sharded_step")
    torch.save({"policy": flatten(tpp), "verifier": flatten(tvp),
                "episodes": episodes, "noise": noise}, d / "in.pt")
    run_ranks("verified_step", d)
    outs = [torch.load(d / f"out{r}.pt", weights_only=False)["verified_step"]
            for r in range(2)]
    return ref, outs


def test_sharded_step_matches_jax_mesh_step(runs):
    ref, outs = runs
    for out in outs:             # every rank holds all E episodes
        got = out["verifier"]["injected"]
        np.testing.assert_allclose(got["exec_chunk"].numpy(),
                                   np.asarray(ref.exec_chunk),
                                   rtol=1e-2, atol=5e-4)
        np.testing.assert_array_equal(got["winner_idx"].numpy(),
                                      np.asarray(ref.winner_idx))
        for name in DISCRETE:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
            assert got[name].shape == (E,)


@pytest.mark.parametrize("sel", ["verifier", "random"])
def test_two_ranks_equal_the_one_rank_step(runs, sel):
    _, outs = runs
    for out in outs:
        o = out[sel]
        # injected noise without a generator leaves "random"'s picks to
        # each process's default generator
        for mode in ("injected", "drawn") if sel == "verifier" else ("drawn",):
            got, want = o[mode], o[f"batched_{mode}"]
            assert set(got) == set(want)
            for name in DISCRETE:
                assert torch.equal(got[name], want[name]), (mode, name)
                assert got[name].dtype == want[name].dtype
            for name in FLOATS:
                torch.testing.assert_close(got[name], want[name], rtol=0,
                                           atol=1e-5, msg=f"{mode} {name}")
    # both ranks return the same gathered result
    for name in DISCRETE + FLOATS:
        assert torch.equal(outs[0][sel]["drawn"][name],
                           outs[1][sel]["drawn"][name]), name


def test_episodes_must_divide_over_the_ranks(runs):
    _, outs = runs
    assert all(out[sel]["odd_refused"] for out in outs
               for sel in ("verifier", "random"))
