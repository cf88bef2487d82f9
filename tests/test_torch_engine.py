"""PyTorch port vs the JAX package: the closed-loop evaluation path on tiny
fp32 configs on the CPU — propose/select, `CoVerEngine`,
`BatchedCoVerEngine`, the lockstep and pipelined evaluators and the suite
evaluator over the fake environment.

The two packages draw their noise from different generators, so the tests
replay the JAX engines' key schedule with `jax.random` and hand each
verified step's noise to the port through its step function. Float
results are compared at atol 1e-4 (fp32 weights, different summation
orders); discrete state (winners, instruction switches, history lengths,
step counts) must be equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu import configs as jconfigs
from cover_vla_tpu.data.stats import DatasetStatistics as JStats
from cover_vla_tpu.data.tokenizer import HashTokenizer as JHash
from cover_vla_tpu.engine.batched_engine import (
    BatchedCoVerEngine as JBatched, evaluate_batched as j_evaluate_batched)
from cover_vla_tpu.engine.cover_engine import CoVerEngine as JEngine
from cover_vla_tpu.engine.verified_step import (
    make_propose_step_batched as j_make_propose)
from cover_vla_tpu.eval.adapters import BridgeSimplerAdapter as JAdapter
from cover_vla_tpu.eval.evaluator import (
    CoVerEvaluator as JEvaluator, EvalConfig as JEvalConfig)
from cover_vla_tpu.eval.fake_env import FakeWidowXEnv as JEnv
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.models import verifier as jverifier

from cover_vla_tpu_torch import configs
from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax, verifier_from_jax
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
from cover_vla_tpu_torch.engine import (
    BatchedCoVerEngine, CoVerEngine, evaluate_batched)
from cover_vla_tpu_torch.engine.batched_engine import (
    evaluate_batched_pipelined)
from cover_vla_tpu_torch.engine.verified_step import (
    _verifier_image, make_propose_step_batched, make_select_step_batched,
    make_verified_step, make_verified_step_batched)
from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
from cover_vla_tpu_torch.eval.evaluator import (
    CoVerEvaluator, EvalConfig, evaluate_suite_batched, summarize)
from cover_vla_tpu_torch.eval.fake_env import (
    FakeWidowXEnv, get_image_from_obs_dict, make_fake_env)
from cover_vla_tpu_torch.eval.rephrase import load_rephrases
from cover_vla_tpu_torch.models import verifier

E, K, N, TICKS = 2, 2, 2, 8
ATOL = 1e-4
TASK = "widowx_carrot_on_plate"
JP, JV = jconfigs.tiny_pi0_config(), jconfigs.tiny_verifier_config()
TP, TV = configs.tiny_pi0_config(), configs.tiny_verifier_config()
STATS = DatasetStatistics.from_json()
REPHRASES = load_rephrases()
NOISE_SHAPE = (K, N, JP.chunk_size, JP.max_action_dim)


def _ccfgs(**kw):
    return (jconfigs.CoVerConfig(n_samples=N, n_rephrases=K, **kw),
            configs.CoVerConfig(n_samples=N, n_rephrases=K, **kw))


def _toks(cls):
    return dict(policy_tokenizer=cls(JP.paligemma.vocab_size),
                verifier_tokenizer=cls(JV.text.vocab_size, add_bos=False))


@pytest.fixture(scope="module")
def weights():
    f32 = lambda tree: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), tree)
    jpp = f32(jpi0.init_pi0(jax.random.PRNGKey(0), JP))
    jvp = f32(jverifier.init_verifier(jax.random.PRNGKey(1), JV,
                                      num_members=2))
    tpp = pi0_from_jax(jax.tree_util.tree_map(np.asarray, jpp), TP,
                       device="cpu")
    tvp = verifier_from_jax(jax.tree_util.tree_map(np.asarray, jvp), TV,
                            device="cpu")
    return jpp, jvp, tpp, tvp


def _normal(key, std):
    return np.asarray(jax.random.normal(key, NOISE_SHAPE, jnp.float32)) * std


def single_noises(seed, steps, std=1.0):
    """The noise of each verified step of the JAX CoVerEngine(seed): it
    splits its key once per step and the step draws from the sub-key."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(_normal(sub, std))
    return out


def batched_noises(seed, steps, e=E, std=1.0):
    """Likewise for the JAX BatchedCoVerEngine(seed): one split per step,
    then one key per episode."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.stack([_normal(k, std)
                             for k in jax.random.split(sub, e)]))
    return out


def replaying(step_fn, noises):
    """`step_fn` with the generator argument replaced by the next entry of
    `noises` (one per verified step)."""
    it = iter(noises)

    def fn(*args, generator=None):
        return step_fn(*args, noise=next(it))
    return fn


def _episode_arrays(seed=0):
    rng = np.random.default_rng(seed)
    t = TP.tokenizer_max_length
    return dict(
        raw=rng.integers(0, 256, (E, 256, 256, 3), dtype=np.uint8),
        prop=rng.uniform(-0.1, 0.1, (E, 7)).astype(np.float32),
        lt=rng.integers(0, TP.paligemma.vocab_size, (E, K, t)).astype(np.int32),
        lm=np.ones((E, K, t), bool),
        vt=rng.integers(0, TV.text.vocab_size,
                        (E, TV.text.context_length)).astype(np.int32),
        hist=rng.uniform(-1, 1, (E, 6, 7)).astype(np.float32),
        hlen=np.asarray([2, 0], np.int32))


# ---------------------------------------------------------------------------
# propose / select
# ---------------------------------------------------------------------------


def test_propose_matches_jax_and_select_equals_fused_step(weights):
    """propose -> verifier scores on the side -> select reproduces the
    fused step: the two paths are one program cut at the score vector."""
    jpp, _, tpp, tvp = weights
    jc, tc = _ccfgs(selection="injected")
    i = _episode_arrays()
    keys = jax.random.split(jax.random.PRNGKey(3), E)
    noise = np.stack([_normal(k, 1.0) for k in keys])

    ref = j_make_propose(JP, JV, jc, JStats.from_json())(
        jpp, keys, i["raw"], i["prop"], i["lt"], i["lm"], i["hist"], i["hlen"])
    prop = make_propose_step_batched(TP, TV, tc, STATS, device="cpu")(
        tpp, i["raw"], i["prop"], i["lt"], i["lm"], i["hist"], i["hlen"],
        noise=noise)
    for name in ("exec_chunks", "verifier_chunks", "trajectories",
                 "raw_grippers"):
        got = getattr(prop, name)
        assert got.shape == np.asarray(getattr(ref, name)).shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, name)),
                                   atol=ATOL, rtol=0, err_msg=name)

    fused = make_verified_step_batched(
        TP, TV, configs.replace(tc, selection="verifier"), STATS,
        device="cpu")(tpp, tvp, i["raw"], i["prop"], i["lt"], i["lm"],
                      i["vt"], i["hist"], i["hlen"], noise=noise)
    scores = torch.stack([verifier.score_actions(
        tvp, TV, _verifier_image(torch.from_numpy(i["raw"][e:e + 1]),
                                 TV.vision.image_size),
        torch.from_numpy(i["vt"][e:e + 1]).long(), prop.trajectories[e])
        for e in range(E)])
    torch.testing.assert_close(scores, fused.scores, atol=1e-5, rtol=0)
    sel = make_select_step_batched(tc, device="cpu")(
        scores.numpy(), prop.exec_chunks, prop.verifier_chunks,
        prop.raw_grippers)
    assert torch.equal(sel.winner_idx, fused.winner_idx)
    assert torch.equal(sel.winner_group, fused.winner_group)
    assert torch.equal(sel.used_stage2, fused.used_stage2)
    assert not sel.deferred.any()
    for name in ("exec_chunk", "verifier_chunk", "raw_gripper"):
        torch.testing.assert_close(getattr(sel, name), getattr(fused, name),
                                   atol=0, rtol=0)


def test_injected_selection_semantics(weights):
    """Scores that prefer one candidate make it win through the two-stage
    gate; the fused step refuses the mode; the engine needs a score_fn and
    passes the proposal to scorers that ask for it."""
    _, _, tpp, tvp = weights
    _, tc = _ccfgs(selection="injected", rescore_threshold=0.5)
    with pytest.raises(ValueError, match="make_propose_step"):
        make_verified_step_batched(TP, TV, tc, STATS, device="cpu")

    rng = np.random.default_rng(1)
    chunks = torch.from_numpy(
        rng.uniform(-1, 1, (E, K * N, 4, 7)).astype(np.float32))
    grips = torch.from_numpy(rng.uniform(0, 1, (E, K * N, 4, 1)
                                         ).astype(np.float32))
    scores = np.full((E, K * N), -1.0, np.float32)
    scores[0, 0] = 0.9          # stage 1 accepts candidate 0
    scores[1, 3] = 0.4          # stage 2: group 1 has the best mean
    sel = make_select_step_batched(
        configs.replace(tc, gripper_vote=False), device="cpu")(
        scores, chunks, chunks, grips)
    assert sel.winner_idx.tolist() == [0, 3]
    assert sel.winner_group.tolist() == [0, 1]
    assert sel.used_stage2.tolist() == [False, True]
    np.testing.assert_allclose(sel.max_score.numpy(), [0.9, 0.4])
    torch.testing.assert_close(sel.exec_chunk[1], chunks[1, 3])
    torch.testing.assert_close(sel.raw_gripper[1], grips[1, 3, :, 0])

    engine = BatchedCoVerEngine(tpp, tvp, TP, TV, tc, num_episodes=E,
                                seed=0, device="cpu", **_toks(HashTokenizer))
    i = _episode_arrays()
    with pytest.raises(ValueError, match="score_fn"):
        engine.step(i["raw"], i["prop"])
    seen = {}

    def score_fn(exec_chunks, proposal):
        seen["shape"] = exec_chunks.shape
        seen["traj"] = tuple(proposal.trajectories.shape)
        out = np.zeros((E, K * N), np.float32)
        out[:, 2] = 1.0
        return out
    engine.reset(["task a", "task b"])
    engine.score_fn = score_fn
    actions = engine.step(i["raw"], i["prop"])
    assert actions.shape == (E, 7)
    assert seen == {"shape": (E, K * N, 4, 7),
                    "traj": (E, K * N, TV.history_length, 7)}
    # candidate 2 = language group 1, candidate 0 within it
    assert engine.selected_instructions == [["task a"], ["task b"]]
    np.testing.assert_allclose(engine.last_scores, [1.0, 1.0])


# ---------------------------------------------------------------------------
# engines against the JAX engines over the fake env
# ---------------------------------------------------------------------------


def _observe(envs, obs, adapter, image_fn):
    imgs = np.stack([image_fn(env, o) for env, o in zip(envs, obs)])
    props = np.stack([adapter.preprocess_proprio({"agent": o["agent"]})
                      for o in obs]).astype(np.float32)
    return imgs, props


@pytest.mark.parametrize("threshold", [0.1, 2.0])
def test_cover_engine_matches_jax(weights, threshold):
    """One episode, 8 ticks = 2 verified steps. threshold 2.0 sends every
    step through stage 2, so the instruction can switch to a rephrase."""
    jpp, jvp, tpp, tvp = weights
    jc, tc = _ccfgs(rescore_threshold=threshold)
    jeng = JEngine(jpp, jvp, JP, JV, jc, rephrases=REPHRASES, seed=5,
                   **_toks(JHash))
    teng = CoVerEngine(tpp, tvp, TP, TV, tc, rephrases=REPHRASES, seed=5,
                       device="cpu", **_toks(HashTokenizer))
    teng._step_fn = replaying(
        make_verified_step(TP, TV, tc, STATS, device="cpu"),
        single_noises(5, TICKS // TP.chunk_size))
    jenv, tenv = JEnv(TASK, max_steps=TICKS), FakeWidowXEnv(TASK, max_steps=TICKS)
    (jo, _), (to, _) = jenv.reset(seed=3), tenv.reset(seed=3)
    jeng.reset(jenv.get_language_instruction())
    teng.reset(tenv.get_language_instruction())
    jad, tad = JAdapter(), BridgeSimplerAdapter()
    for _ in range(TICKS):
        ja = jeng.step(jo["image"], jad.preprocess_proprio(
            {"agent": jo["agent"]}).astype(np.float32))
        ta = teng.step(to["image"], tad.preprocess_proprio(
            {"agent": to["agent"]}).astype(np.float32))
        np.testing.assert_allclose(ta, ja, atol=ATOL, rtol=0)
        assert teng.last_raw_gripper == pytest.approx(jeng.last_raw_gripper,
                                                      abs=ATOL)
        # both envs take the JAX action, so they stay byte-identical
        jo, to = jenv.step(ja)[0], tenv.step(ja)[0]
        assert to["image"].tobytes() == jo["image"].tobytes()
    np.testing.assert_allclose(teng._history, jeng._history, atol=ATOL, rtol=0)
    assert teng._history_len == jeng._history_len == 6
    assert teng.task == jeng.task and teng.original_task == jeng.original_task
    assert len(teng.records) == len(jeng.records) == 2
    for tr, jr in zip(teng.records, jeng.records):
        assert (tr.t, tr.used_stage2, tr.winner_idx, tr.selected_instruction) \
            == (jr.t, jr.used_stage2, jr.winner_idx, jr.selected_instruction)
        assert tr.max_score == pytest.approx(jr.max_score, abs=ATOL)
        np.testing.assert_allclose(tr.execute_action, jr.execute_action,
                                   atol=ATOL, rtol=0)
    if threshold == 2.0:
        assert all(r.used_stage2 for r in teng.records)


def _batched_pair(weights, seed, threshold=2.0, steps=TICKS // 4):
    jpp, jvp, tpp, tvp = weights
    jc, tc = _ccfgs(rescore_threshold=threshold)
    jeng = JBatched(jpp, jvp, JP, JV, jc, num_episodes=E,
                    rephrases=REPHRASES, seed=seed, **_toks(JHash))
    teng = BatchedCoVerEngine(
        tpp, tvp, TP, TV, tc, num_episodes=E, rephrases=REPHRASES, seed=seed,
        device="cpu", **_toks(HashTokenizer),
        step_fn=replaying(
            make_verified_step_batched(TP, TV, tc, STATS, device="cpu"),
            batched_noises(seed, steps)))
    return jeng, teng


def test_batched_engine_matches_jax(weights):
    jeng, teng = _batched_pair(weights, seed=7)
    jenvs = [JEnv(TASK, max_steps=TICKS) for _ in range(E)]
    tenvs = [FakeWidowXEnv(TASK, max_steps=TICKS) for _ in range(E)]
    jobs = [env.reset(seed=s)[0] for s, env in enumerate(jenvs)]
    tobs = [env.reset(seed=s)[0] for s, env in enumerate(tenvs)]
    jeng.reset([env.get_language_instruction() for env in jenvs])
    teng.reset([env.get_language_instruction() for env in tenvs])
    jad, tad = JAdapter(), BridgeSimplerAdapter()
    for _ in range(TICKS):
        ja = jeng.step(*_observe(jenvs, jobs, jad, lambda env, o: o["image"]))
        ta = teng.step(*_observe(tenvs, tobs, tad, get_image_from_obs_dict))
        assert ta.shape == (E, 7)
        np.testing.assert_allclose(ta, ja, atol=ATOL, rtol=0)
        jobs = [env.step(a)[0] for env, a in zip(jenvs, ja)]
        tobs = [env.step(a)[0] for env, a in zip(tenvs, ja)]
    np.testing.assert_allclose(teng._history, jeng._history, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(teng._history_len, jeng._history_len)
    assert teng.tasks == jeng.tasks
    assert teng.original_tasks == jeng.original_tasks
    assert teng.selected_instructions == jeng.selected_instructions
    assert all(len(s) == 2 for s in teng.selected_instructions)
    np.testing.assert_allclose(teng.last_scores, jeng.last_scores, atol=ATOL,
                               rtol=0)


def test_evaluate_batched_matches_jax(weights):
    jeng, teng = _batched_pair(weights, seed=2, threshold=0.1)
    ref = j_evaluate_batched(
        jeng, [JEnv(TASK, max_steps=TICKS) for _ in range(E)], JAdapter(),
        max_steps=TICKS, seeds=[4, 5])
    got = evaluate_batched(
        teng, [FakeWidowXEnv(TASK, max_steps=TICKS) for _ in range(E)],
        BridgeSimplerAdapter(), max_steps=TICKS, seeds=[4, 5])
    assert got["success"] == ref["success"]
    assert got["steps"] == ref["steps"] == [TICKS] * E
    assert got["selected_instructions"] == ref["selected_instructions"]
    assert got["success_rate"] == ref["success_rate"]


def test_batched_engine_equals_single_engines(weights):
    """Row e of the batched engine == a CoVerEngine fed row e's noise."""
    _, _, tpp, tvp = weights
    _, tc = _ccfgs(rescore_threshold=2.0)
    noises = batched_noises(11, TICKS // 4)
    batched = BatchedCoVerEngine(
        tpp, tvp, TP, TV, tc, num_episodes=E, rephrases=REPHRASES,
        device="cpu", **_toks(HashTokenizer),
        step_fn=replaying(make_verified_step_batched(TP, TV, tc, STATS,
                                                     device="cpu"), noises))
    singles = []
    for e in range(E):
        eng = CoVerEngine(tpp, tvp, TP, TV, tc, rephrases=REPHRASES,
                          device="cpu", **_toks(HashTokenizer))
        eng._step_fn = replaying(
            make_verified_step(TP, TV, tc, STATS, device="cpu"),
            [n[e] for n in noises])
        singles.append(eng)
    envs = [FakeWidowXEnv(TASK, max_steps=TICKS) for _ in range(E)]
    obs = [env.reset(seed=20 + s)[0] for s, env in enumerate(envs)]
    tasks = [env.get_language_instruction() for env in envs]
    batched.reset(tasks)
    for eng, task in zip(singles, tasks):
        eng.reset(task)
    adapter = BridgeSimplerAdapter()
    for _ in range(TICKS):
        imgs, props = _observe(envs, obs, adapter, get_image_from_obs_dict)
        actions = batched.step(imgs, props)
        for e, eng in enumerate(singles):
            np.testing.assert_allclose(eng.step(imgs[e], props[e]),
                                       actions[e], atol=1e-5, rtol=0)
        obs = [env.step(a)[0] for env, a in zip(envs, actions)]
    for e, eng in enumerate(singles):
        np.testing.assert_allclose(eng._history, batched._history[e],
                                   atol=1e-5, rtol=0)
        assert eng.task == batched.tasks[e]
        assert [r.selected_instruction for r in eng.records] == \
            batched.selected_instructions[e]


def _fresh(weights, seed, ccfg=None):
    _, _, tpp, tvp = weights
    return BatchedCoVerEngine(tpp, tvp, TP, TV, ccfg or _ccfgs()[1],
                              num_episodes=E, rephrases=REPHRASES, seed=seed,
                              device="cpu", **_toks(HashTokenizer))


def test_pipelined_matches_sequential(weights):
    """Two-cohort pipelined evaluation == running each cohort alone (the
    engines draw from generators with the same seeds)."""
    envs = lambda: [FakeWidowXEnv(TASK, max_steps=TICKS) for _ in range(E)]
    adapter = BridgeSimplerAdapter()
    out_p = evaluate_batched_pipelined(
        _fresh(weights, 0), _fresh(weights, 1), envs(), envs(), adapter,
        max_steps=TICKS, seeds_a=[0, 1], seeds_b=[2, 3])
    out_a = evaluate_batched(_fresh(weights, 0), envs(), adapter,
                             max_steps=TICKS, seeds=[0, 1])
    out_b = evaluate_batched(_fresh(weights, 1), envs(), adapter,
                             max_steps=TICKS, seeds=[2, 3])
    assert out_p["success"] == out_a["success"] + out_b["success"]
    assert out_p["steps"] == out_a["steps"] + out_b["steps"]
    assert out_p["selected_instructions"] == (
        out_a["selected_instructions"] + out_b["selected_instructions"])


def test_step_async_defers_state_until_resolved(weights):
    eng = _fresh(weights, 0)
    eng.reset(["task a", "task b"])
    i = _episode_arrays()
    resolve = eng.step_async(i["raw"], i["prop"])
    # enqueued, not resolved: no history, no instruction record yet
    assert eng._history_len.tolist() == [0, 0]
    assert eng.selected_instructions == [[], []]
    actions = resolve()
    assert actions.shape == (E, 7) and eng._history_len.tolist() == [1, 1]
    assert [len(s) for s in eng.selected_instructions] == [1, 1]
    assert set(np.unique(actions[:, 6])) <= {-1.0, 1.0}


def test_done_episode_state_freezes(weights):
    eng = _fresh(weights, 0)
    eng.reset(["task a", "task b"])
    i = _episode_arrays()
    eng.step(i["raw"], i["prop"])
    eng.mark_done(0)
    h0, l0, t0 = eng._history[0].copy(), int(eng._history_len[0]), eng.tasks[0]
    n0 = len(eng.selected_instructions[0])
    for _ in range(TP.chunk_size):
        eng.step(i["raw"], i["prop"])
    np.testing.assert_array_equal(eng._history[0], h0)
    assert int(eng._history_len[0]) == l0 and eng.tasks[0] == t0
    assert len(eng.selected_instructions[0]) == n0
    assert int(eng._history_len[1]) == l0 + TP.chunk_size
    assert len(eng.selected_instructions[1]) == n0 + 1


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------


def test_evaluate_suite_batched_with_padding(weights):
    """Cohorts of n_parallel, the last one padded with fresh seeds and the
    padding dropped; pipelined mode covers cohort pairs; the injected mode
    binds a scorer to each cohort's envs."""
    _, _, tpp, tvp = weights
    cfg = EvalConfig(task_suite="simpler_carrot_on_plate",
                     num_trials_per_task=3, max_steps=TICKS)
    kw = dict(n_parallel=2, seed=0, device="cpu", rephrases=REPHRASES,
              env_fn=lambda task: make_fake_env(task, max_steps=TICKS),
              **_toks(HashTokenizer))
    _, tc = _ccfgs()
    out = evaluate_suite_batched(tpp, tvp, TP, TV, tc, cfg, **kw)
    s = out["summary"]
    assert s["total_episodes"] == 3          # padding episode dropped
    assert s["per_task"][TASK]["episodes"] == 3
    assert [ep["seed"] for ep in s["per_task"][TASK]["per_episode"]] == [7, 8, 9]
    assert all(len(ep["selected_instructions"]) == TICKS // 4
               for ep in s["per_task"][TASK]["per_episode"])
    assert out["actions_per_sec"] > 0
    out_p = evaluate_suite_batched(tpp, tvp, TP, TV, tc, cfg, pipelined=True,
                                   **kw)
    assert out_p["summary"]["total_episodes"] == 3
    # cohort A of the pipelined pair is the first cohort of the plain run
    assert (out_p["summary"]["per_task"][TASK]["per_episode"][:2]
            == s["per_task"][TASK]["per_episode"][:2])

    injected = configs.replace(tc, selection="injected")
    with pytest.raises(ValueError, match="score_fn_factory"):
        evaluate_suite_batched(tpp, tvp, TP, TV, injected, cfg, **kw)
    cohorts = []

    def factory(envs):
        cohorts.append(len(envs))
        return lambda exec_chunks: -np.abs(exec_chunks[:, :, 0, 0])
    out_i = evaluate_suite_batched(tpp, tvp, TP, TV, injected, cfg,
                                   score_fn_factory=factory, **kw)
    assert cohorts == [2, 2] and out_i["summary"]["total_episodes"] == 3
    with pytest.raises(ValueError, match="google_robot"):
        evaluate_suite_batched(
            tpp, tvp, TP, TV, tc,
            EvalConfig(task_suite="simpler_google_move_near"), **kw)


def test_cover_evaluator_matches_jax(weights, tmp_path):
    """CoVerEvaluator.run_episode over the fake env against the JAX
    evaluator with the replayed noise; summarize/save_episode records."""
    jpp, jvp, tpp, tvp = weights
    jc, tc = _ccfgs(rescore_threshold=2.0)
    jeng = JEngine(jpp, jvp, JP, JV, jc, rephrases=REPHRASES, seed=9,
                   **_toks(JHash))
    teng = CoVerEngine(tpp, tvp, TP, TV, tc, rephrases=REPHRASES, seed=9,
                       device="cpu", **_toks(HashTokenizer))
    teng._step_fn = replaying(
        make_verified_step(TP, TV, tc, STATS, device="cpu"),
        single_noises(9, TICKS // 4))
    kw = dict(task_suite="simpler_carrot_on_plate", num_trials_per_task=1,
              max_steps=TICKS, num_steps_wait=1, save_frames=True)
    ref = JEvaluator(jeng, JEvalConfig(**kw)).run_episode(
        JEnv(TASK, max_steps=TICKS + 1), TASK, trial=0, seed=7)
    evaluator = CoVerEvaluator(teng, EvalConfig(out_dir=str(tmp_path), **kw),
                               env_fn=lambda t: make_fake_env(
                                   t, max_steps=TICKS + 1))
    got = evaluator.run_episode(make_fake_env(TASK, max_steps=TICKS + 1),
                                TASK, trial=0, seed=7)
    assert (got.success, got.num_steps, got.selected_instructions,
            got.episode_stats) == (ref.success, ref.num_steps,
                                   ref.selected_instructions,
                                   ref.episode_stats)
    np.testing.assert_allclose(got.verifier_scores, ref.verifier_scores,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.stack(got.execute_actions),
                               np.stack(ref.execute_actions), atol=ATOL, rtol=0)
    assert len(got.frames) == len(ref.frames) == TICKS
    assert got.frames[0].tobytes() == ref.frames[0].tobytes()

    summary = summarize([got, dataclasses.replace(got, success=True)])
    assert summary["total_episodes"] == 2
    assert summary["per_task"][TASK]["success_rate"] == 0.5
    with pytest.raises(ValueError, match="fractal"):
        evaluator._task_adapter("google_robot_pick_coke_can")

    # the evaluate() loop: seeds from cfg.seed, one pickle per episode
    teng._step_fn = make_verified_step(TP, TV, tc, STATS, device="cpu")
    out = evaluator.evaluate()
    assert out["summary"]["total_episodes"] == 1
    assert out["episodes"][0].seed == 7
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".pkl"] == [
        f"episode_{TASK}_trial0_seed7_failure.pkl"]
