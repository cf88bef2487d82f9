"""PyTorch port vs the JAX package: the scripted expert and its datasets
(`eval/fake_expert.py`), and the injected-score selection arms that use
its privileged oracle (the cases of tests/test_injected_selection.py)
through the port's engine and evaluator.

The expert and the datasets are host numpy code copied into the port, so
they must be byte-equal. The selection cases run the tiny fp32 models of
both packages on the same weights, with the JAX key schedule's noise
injected into the port (tests/test_torch_engine.py's bounds: floats
within 1e-4, discrete state equal)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu import configs as jconfigs
from cover_vla_tpu.data.stats import DatasetStatistics as JStats
from cover_vla_tpu.engine.verified_step import (
    make_propose_step_batched as j_make_propose,
    make_select_step_batched as j_make_select,
    make_verified_step_batched as j_make_fused)
from cover_vla_tpu.eval import fake_expert as jexpert
from cover_vla_tpu.eval.evaluator import (
    EvalConfig as JEvalConfig, evaluate_suite_batched as j_evaluate_suite)
from cover_vla_tpu.eval.fake_env import (
    FakeWidowXEnv as JEnv, make_fake_env as j_make_fake_env)
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.models import verifier as jverifier

from cover_vla_tpu_torch import configs
from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax, verifier_from_jax
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.engine import verified_step
from cover_vla_tpu_torch.eval import fake_expert
from cover_vla_tpu_torch.eval.evaluator import (
    EvalConfig, evaluate_suite_batched)
from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv, make_fake_env
from cover_vla_tpu_torch.models import verifier

ATOL = 1e-4
TASK = "widowx_carrot_on_plate"


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def demos():
    kw = dict(n_episodes=3, max_steps=30, seed=5)
    return jexpert.collect_demos(**kw), fake_expert.collect_demos(**kw)


def test_collect_demos_byte_equal(demos):
    ref, got = demos
    assert set(got) == set(ref)
    for k in ("frames", "proprios", "actions", "episode", "t_in_ep"):
        _same(got[k], ref[k])
    assert got["n_episodes"] == ref["n_episodes"] == 3
    assert got["expert_success_rate"] == ref["expert_success_rate"]
    assert got["frames"].dtype == np.uint8
    assert got["episode"].tolist() == sorted(got["episode"].tolist())
    assert set(got["episode"].tolist()) == {0, 1, 2}


def test_statistics_and_datasets_byte_equal(demos):
    ref, got = demos
    jst, st = jexpert.fit_statistics(ref), fake_expert.fit_statistics(got)
    for field in ("action", "proprio"):
        for name in ("mean", "std", "p01", "p99", "minimum", "maximum"):
            _same(getattr(getattr(st, field), name),
                  getattr(getattr(jst, field), name))
    assert (st.num_transitions, st.num_trajectories) == \
        (jst.num_transitions, jst.num_trajectories)
    pol = fake_expert.build_policy_dataset(got, st, chunk_size=4)
    jpol = jexpert.build_policy_dataset(ref, jst, chunk_size=4)
    assert set(pol) == set(jpol) == {"frames", "state", "actions"}
    for k in pol:
        _same(pol[k], jpol[k])
    ver = fake_expert.build_verifier_dataset(got, chunk_size=4, max_history=6)
    jver = jexpert.build_verifier_dataset(ref, chunk_size=4, max_history=6)
    for k in ver:
        _same(ver[k], jver[k])
    negs = fake_expert.build_ranking_negatives(
        ver["action_histories"], 6, np.random.default_rng(3))
    jnegs = jexpert.build_ranking_negatives(
        jver["action_histories"], 6, np.random.default_rng(3))
    _same(negs, jnegs)
    assert negs.shape[1] == 5
    for fn, args in (("normalize_action", (got["actions"], st)),
                     ("normalize_proprio", (got["proprios"], st)),
                     ("exec_to_verifier_format", (got["actions"],))):
        _same(getattr(fake_expert, fn)(*args), getattr(jexpert, fn)(*args))


def test_expert_oracle_equal():
    """`expert_action` (with its noise), `task_potential` and
    `chunk_quality` along one scripted episode; the quality oracle leaves
    the live env untouched."""
    env, jenv = FakeWidowXEnv(TASK, max_steps=40), JEnv(TASK, max_steps=40)
    env.reset(seed=11)
    jenv.reset(seed=11)
    rng, jrng = np.random.default_rng(2), np.random.default_rng(2)
    probe = np.random.default_rng(9).uniform(-0.05, 0.05, (3, 4, 7))
    probe[..., 6] = np.sign(probe[..., 6])
    for _ in range(40):
        assert fake_expert.task_potential(env) == jexpert.task_potential(jenv)
        for chunk in probe:
            before = env._ee.copy()
            assert fake_expert.chunk_quality(env, chunk) == \
                jexpert.chunk_quality(jenv, chunk)
            np.testing.assert_array_equal(env._ee, before)
        a = fake_expert.expert_action(env, rng, noise=0.01)
        _same(a, jexpert.expert_action(jenv, jrng, noise=0.01))
        _, _, done, trunc, _ = env.step(a)
        jenv.step(a)
        if done or trunc:
            break
    assert fake_expert.task_potential(env) == jexpert.task_potential(jenv)


# ---------------------------------------------------------------------------
# injected-score selection (tests/test_injected_selection.py's cases)
# ---------------------------------------------------------------------------

E = 2
JP, JV = jconfigs.tiny_pi0_config(), jconfigs.tiny_verifier_config()
TP, TV = configs.tiny_pi0_config(), configs.tiny_verifier_config()
JCCFG = jconfigs.CoVerConfig(n_samples=3, n_rephrases=2, selection="injected")
TCCFG = configs.CoVerConfig(n_samples=3, n_rephrases=2, selection="injected")
STATS = DatasetStatistics.from_json()


@pytest.fixture(scope="module")
def weights():
    f32 = lambda tree: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), tree)
    jpp = f32(jpi0.init_pi0(jax.random.PRNGKey(0), JP))
    jvp = f32(jverifier.init_verifier(jax.random.PRNGKey(1), JV, 1))
    tpp = pi0_from_jax(jax.tree_util.tree_map(np.asarray, jpp), TP,
                       device="cpu")
    tvp = verifier_from_jax(jax.tree_util.tree_map(np.asarray, jvp), TV,
                            device="cpu")
    return jpp, jvp, tpp, tvp


def _noise(key, ccfg):
    shape = (ccfg.n_rephrases, ccfg.n_samples, JP.chunk_size,
             JP.max_action_dim)
    return np.asarray(jax.random.normal(key, shape, jnp.float32)) \
        * ccfg.noise_std


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    k, t = JCCFG.n_rephrases, JP.tokenizer_max_length
    keys = jax.random.split(jax.random.PRNGKey(3), E)
    return dict(
        raw=rng.integers(0, 255, (E, 256, 256, 3)).astype(np.uint8),
        prop=rng.uniform(-0.1, 0.1, (E, 7)).astype(np.float32),
        lt=rng.integers(0, JP.paligemma.vocab_size, (E, k, t)).astype(np.int32),
        lm=np.ones((E, k, t), bool),
        vt=rng.integers(0, JV.text.vocab_size,
                        (E, JV.text.context_length)).astype(np.int32),
        hist=rng.uniform(-1, 1, (E, JCCFG.max_history, 7)).astype(np.float32),
        hlen=np.asarray([2, 0], np.int32),
        keys=keys, noise=np.stack([_noise(kk, JCCFG) for kk in keys]))


def _propose(weights, i):
    jpp, _, tpp, _ = weights
    ref = j_make_propose(JP, JV, JCCFG, JStats.from_json())(
        jpp, i["keys"], i["raw"], i["prop"], i["lt"], i["lm"], i["hist"],
        i["hlen"])
    got = verified_step.make_propose_step_batched(
        TP, TV, TCCFG, STATS, device="cpu")(
        tpp, i["raw"], i["prop"], i["lt"], i["lm"], i["hist"], i["hlen"],
        noise=i["noise"])
    return ref, got


def test_injected_with_verifier_scores_equals_the_jax_fused_step(
        weights, inputs):
    """The port's propose -> host verifier scoring -> select against the
    JAX package's fused verifier step on the same noise: the same winners
    and stage-2 flags, actions and scores within 1e-4."""
    _, jvp, _, tvp = weights
    i = inputs
    jfused = j_make_fused(JP, JV, dataclasses.replace(
        JCCFG, selection="verifier"), JStats.from_json())(
        weights[0], jvp, i["keys"], i["raw"], i["prop"], i["lt"], i["lm"],
        i["vt"], i["hist"], i["hlen"])
    _, prop = _propose(weights, i)
    scores = torch.stack([verifier.score_actions(
        tvp, TV, verified_step._verifier_image(
            torch.from_numpy(i["raw"][e:e + 1]), TV.vision.image_size),
        torch.from_numpy(i["vt"][e:e + 1]).long(), prop.trajectories[e])
        for e in range(E)])
    got = verified_step.make_select_step_batched(TCCFG, device="cpu")(
        scores, prop.exec_chunks, prop.verifier_chunks, prop.raw_grippers)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jfused.scores),
                               atol=ATOL, rtol=0)
    for name in ("winner_idx", "winner_group", "used_stage2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jfused, name)), name)
    for name in ("exec_chunk", "verifier_chunk", "max_score"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(jfused, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_injected_selection_semantics_equal(weights, inputs):
    """The gate and the grouped argmax on hand-made score vectors, and
    threshold=inf, in both packages over their own proposals."""
    ref, prop = _propose(weights, inputs)
    kn = JCCFG.n_rephrases * JCCFG.n_samples
    gate = np.full((E, kn), -1.0, np.float32)
    gate[:, 0], gate[:, kn - 1] = 0.2, 5.0      # stage 1 accepts candidate 0
    grouped = np.zeros((E, JCCFG.n_rephrases, JCCFG.n_samples), np.float32)
    grouped[:, 1, :], grouped[:, 1, 2], grouped[:, 0, 1] = 1.0, 3.0, 2.0
    big0 = np.zeros((E, kn), np.float32)
    big0[:, 0] = 100.0
    cases = [({}, gate, 0, False), ({}, grouped.reshape(E, kn),
                                    JCCFG.n_samples + 2, True),
             (dict(rescore_threshold=float("inf"), gripper_vote=False),
              big0, 0, True)]
    for kw, scores, winner, stage2 in cases:
        got = verified_step.make_select_step_batched(
            dataclasses.replace(TCCFG, **kw), device="cpu")(
            scores, prop.exec_chunks, prop.verifier_chunks, prop.raw_grippers)
        want = j_make_select(dataclasses.replace(JCCFG, **kw))(
            scores, ref.exec_chunks, ref.verifier_chunks, ref.raw_grippers)
        assert got.winner_idx.tolist() == [winner] * E
        assert got.used_stage2.tolist() == [stage2] * E
        for name in ("winner_idx", "winner_group", "used_stage2"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        for name in ("exec_chunk", "verifier_chunk", "max_score",
                     "raw_gripper"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       atol=ATOL, rtol=0, err_msg=name)
    # threshold=inf without the vote returns the winner's chunk verbatim
    np.testing.assert_array_equal(got.exec_chunk.numpy(),
                                  prop.exec_chunks[:, 0].numpy())


def test_injected_oracle_through_the_batched_evaluators(weights, monkeypatch):
    """The oracle arm end to end through both packages' suite evaluators
    (propose/select, cohort env stepping, history): the privileged
    chunk_quality scores every candidate, and the episodes agree."""
    jpp, jvp, tpp, tvp = weights
    jc = dataclasses.replace(JCCFG, n_rephrases=1, gripper_vote=False,
                             rescore_threshold=float("inf"))
    tc = dataclasses.replace(TCCFG, n_rephrases=1, gripper_vote=False,
                             rescore_threshold=float("inf"))
    calls = {"jax": [], "torch": []}

    def factory(name, quality):
        def make(envs):
            def score_fn(exec_chunks):
                calls[name].append(exec_chunks)
                e_n, kn = exec_chunks.shape[:2]
                return np.asarray([[quality(envs[e], exec_chunks[e, c])
                                    for c in range(kn)] for e in range(e_n)],
                                  np.float32)
            return score_fn
        return make

    # the JAX BatchedCoVerEngine(seed=0)'s noise: one split per step, then
    # one key per episode
    key, noises = jax.random.PRNGKey(0), []
    for _ in range(4):
        key, sub = jax.random.split(key)
        noises.append(np.stack([_noise(k, jc)
                                for k in jax.random.split(sub, E)]))
    it = iter(noises)
    make_propose = verified_step.make_propose_step_batched

    def replaying_propose(*args, **kw):
        propose = make_propose(*args, **kw)
        return lambda *a, generator=None: propose(*a, noise=next(it))
    monkeypatch.setattr(verified_step, "make_propose_step_batched",
                        replaying_propose)

    kw = dict(task_suite="simpler_carrot_on_plate", num_trials_per_task=2,
              max_steps=8)
    ref = j_evaluate_suite(jpp, jvp, JP, JV, jc, JEvalConfig(**kw),
                           n_parallel=2, seed=0,
                           env_fn=lambda t: j_make_fake_env(t, max_steps=8),
                           score_fn_factory=factory("jax",
                                                    jexpert.chunk_quality))
    got = evaluate_suite_batched(tpp, tvp, TP, TV, tc, EvalConfig(**kw),
                                 n_parallel=2, seed=0, device="cpu",
                                 env_fn=lambda t: make_fake_env(t, max_steps=8),
                                 score_fn_factory=factory(
                                     "torch", fake_expert.chunk_quality))
    assert len(calls["torch"]) == len(calls["jax"]) == 2
    for g, r in zip(calls["torch"], calls["jax"]):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)
    assert got["summary"]["total_episodes"] == 2
    assert got["summary"]["per_task"] == ref["summary"]["per_task"]

    with pytest.raises(ValueError):
        evaluate_suite_batched(tpp, tvp, TP, TV, tc, EvalConfig(**kw),
                               n_parallel=2, seed=0, device="cpu",
                               env_fn=lambda t: make_fake_env(t, max_steps=8))
