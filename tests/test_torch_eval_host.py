"""PyTorch port vs the JAX package: the host (numpy) side of the
evaluation path on seeded inputs — tokenizers, the fake environment,
benchmark registry, rephrase store, adapters, geometry and the host
LANCZOS4 resize. These are integer or float64 numpy computations copied
into the port, so every comparison is exact unless a tolerance is stated."""

import numpy as np
import pytest

from cover_vla_tpu.data import tokenizer as jtok
from cover_vla_tpu.data.stats import DatasetStatistics as JStats
from cover_vla_tpu.eval import adapters as jadapters
from cover_vla_tpu.eval import benchmark as jbench
from cover_vla_tpu.eval import fake_env as jenv
from cover_vla_tpu.eval import fractal_adapters as jfractal
from cover_vla_tpu.eval import rephrase as jrephrase
from cover_vla_tpu.ops import image as jimage
from cover_vla_tpu.utils import geometry as jgeo

from cover_vla_tpu_torch.data import tokenizer as ttok
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.eval import adapters as tadapters
from cover_vla_tpu_torch.eval import benchmark as tbench
from cover_vla_tpu_torch.eval import fake_env as tenv
from cover_vla_tpu_torch.eval import fractal_adapters as tfractal
from cover_vla_tpu_torch.eval import rephrase as trephrase
from cover_vla_tpu_torch.ops import image as timage
from cover_vla_tpu_torch.utils import geometry as tgeo

PROMPTS = ["put carrot on plate", "Stack the GREEN block on the yellow block",
           "", "a " * 40 + "long prompt that is cut"]


@pytest.mark.parametrize("vocab,add_bos,max_len", [(1024, True, 8),
                                                   (257_152, True, 72),
                                                   (256_000, False, 64)])
def test_hash_tokenizer_ids_identical(vocab, add_bos, max_len):
    ref = jtok.HashTokenizer(vocab, add_bos=add_bos).encode_batch(PROMPTS, max_len)
    got = ttok.HashTokenizer(vocab, add_bos=add_bos).encode_batch(PROMPTS, max_len)
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_tokenizer_factories_fall_back_like_the_reference(tmp_path):
    # no tokenizer files here: both packages fall back to the hash
    # tokenizer with the same ids, and refuse under strict=True
    missing = str(tmp_path / "no_such_tokenizer")
    for make_j, make_t, kw in [
            (jtok.make_policy_tokenizer, ttok.make_policy_tokenizer,
             dict(hf_path=missing)),
            (jtok.make_verifier_tokenizer, ttok.make_verifier_tokenizer,
             dict(hf_path=missing)),
            (jtok.make_verifier_tokenizer, ttok.make_verifier_tokenizer, {})]:
        ref, got = make_j(512, **kw), make_t(512, **kw)
        assert isinstance(got, ttok.HashTokenizer)
        for r, g in zip(ref.encode_batch(PROMPTS, 16),
                        got.encode_batch(PROMPTS, 16)):
            np.testing.assert_array_equal(g, r)
    with pytest.raises(RuntimeError, match="tokenizer"):
        ttok.make_policy_tokenizer(512, hf_path=missing, strict=True)
    with pytest.raises(RuntimeError, match="tokenizer"):
        ttok.make_verifier_tokenizer(512, strict=True)


def test_file_tokenizer_ids_identical(tmp_path):
    tokenizers = pytest.importorskip("tokenizers")
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(
            "[UNK] put the carrot on plate stack green block \n".split(" "))},
        unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    path = str(tmp_path / "tokenizer.json")
    tok.save(path)
    for kw in (dict(), dict(append_newline=False, add_bos=False)):
        ref = jtok.FileTokenizer(path, **kw).encode_batch(PROMPTS, 12)
        got = ttok.FileTokenizer(path, **kw).encode_batch(PROMPTS, 12)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)
    assert isinstance(ttok.make_policy_tokenizer(16, hf_path=path),
                      ttok.FileTokenizer)


@pytest.mark.parametrize("task", [
    "widowx_carrot_on_plate", "widowx_stack_cube", "widowx_redbull_on_plate",
    "widowx_zucchini_on_towel", "widowx_tennis_ball_in_basket",
    "widowx_carrot_on_plate_unseen_lighting",
    "widowx_redbull_on_plate_appearance"])
def test_fake_env_frames_and_dynamics_byte_equal(task):
    """Same seed and same actions: frames byte-equal, observations, rewards
    and episode stats equal at every tick (ID and OOD appearances)."""
    ref, got = jenv.make_fake_env(task, max_steps=10), tenv.make_fake_env(
        task, max_steps=10)
    assert got.get_language_instruction() == ref.get_language_instruction()
    (ro, _), (go, _) = ref.reset(seed=123), got.reset(seed=123)
    rng = np.random.default_rng(0)
    for t in range(10):
        assert go["image"].tobytes() == ro["image"].tobytes()
        assert tenv.get_image_from_obs_dict(got, go).tobytes() == \
            jenv.get_image_from_obs_dict(ref, ro).tobytes()
        np.testing.assert_array_equal(go["agent"]["eef_pos"],
                                      ro["agent"]["eef_pos"])
        action = np.concatenate([rng.uniform(-0.06, 0.06, 6),
                                 [rng.choice([-1.0, 1.0])]])
        ro, rr, rd, rt, ri = ref.step(action)
        go, gr, gd, gt, gi = got.step(action)
        assert (gr, gd, gt, gi) == (rr, rd, rt, ri)
    assert gt and rt          # truncated at max_steps on both sides


def test_benchmark_registry_and_rephrases_equal():
    assert tbench.TASK_MAP == jbench.TASK_MAP
    assert tbench.TASK_INSTRUCTIONS == jbench.TASK_INSTRUCTIONS
    for name in ("simpler_widowx", "SIMPLER_OOD", "widowx_stack_cube"):
        tb, jb = tbench.get_benchmark(name)(), jbench.get_benchmark(name)()
        assert tb.tasks == jb.tasks and tb.n_tasks == jb.n_tasks
        assert isinstance(tb.make(tb.get_task(0)), tenv.FakeWidowXEnv)
    with pytest.raises(KeyError):
        tbench.get_benchmark("no_such_suite")
    store = trephrase.load_rephrases()
    assert store == jrephrase.load_rephrases()
    assert len(store["put carrot on plate"]) >= 7


def test_rephrase_store_round_trip(tmp_path):
    path = str(tmp_path / "r.json")
    trephrase.save_rephrases({"do x": ["please do x", "x, do it"]}, path)
    assert jrephrase.load_rephrases(path) == {"do x": ["please do x",
                                                       "x, do it"]}


def test_geometry_host_functions_equal():
    rng = np.random.default_rng(1)
    for _ in range(20):
        q = rng.standard_normal(4)
        rpy = rng.uniform(-np.pi, np.pi, 3)
        np.testing.assert_array_equal(tgeo.quat2mat(q), jgeo.quat2mat(q))
        m = jgeo.euler2mat(rpy)
        np.testing.assert_array_equal(tgeo.euler2mat(rpy), m)
        np.testing.assert_array_equal(tgeo.mat2euler(m), jgeo.mat2euler(m))
        np.testing.assert_array_equal(tgeo.euler_to_rotvec_np(rpy),
                                      jgeo.euler_to_rotvec_np(rpy))
        (ta, tang), (ja, jang) = (tgeo.euler2axangle(*rpy),
                                  jgeo.euler2axangle(*rpy))
        np.testing.assert_array_equal(ta, ja)
        assert tang == jang
    # gimbal lock and zero rotation take the same branches
    lock = jgeo.euler2mat(np.array([0.3, np.pi / 2, 0.0]))
    np.testing.assert_array_equal(tgeo.mat2euler(lock), jgeo.mat2euler(lock))
    axis, angle = tgeo.euler2axangle(0.0, 0.0, 0.0)
    assert angle == 0.0 and axis.tolist() == [1.0, 0.0, 0.0]


@pytest.mark.parametrize("src,dst", [((256, 256), (224, 224)),
                                     ((480, 640), (224, 224)),
                                     ((97, 131), (56, 56)),
                                     ((224, 224), (224, 224))])
def test_host_lanczos4_bit_exact(src, dst):
    img = np.random.default_rng(2).integers(0, 256, (*src, 3), dtype=np.uint8)
    ref = jimage.resize_lanczos4_uint8(img, *dst)
    got = timage.resize_lanczos4_uint8(img, *dst)
    assert got.dtype == np.uint8 and got.shape == (*dst, 3)
    np.testing.assert_array_equal(got, ref)
    # the port's device path gives the same bytes as its host path
    import torch
    dev = timage.resize_lanczos4_uint8_device(torch.from_numpy(img)[None], *dst)
    np.testing.assert_array_equal(dev[0].numpy(), got)


def _obs(rng):
    quat = rng.standard_normal(4)
    eef = np.concatenate([rng.uniform(-0.3, 0.3, 3), quat / np.linalg.norm(quat),
                          [rng.uniform(0, 1)]]).astype(np.float32)
    return {"observation.images.top": rng.integers(0, 256, (256, 256, 3),
                                                   dtype=np.uint8),
            "observation.state": {"agent": {"eef_pos": eef}},
            "task": "put carrot on plate"}


@pytest.mark.parametrize("norm", ["bound", "gaussian"])
def test_bridge_adapter_equal(norm):
    rng = np.random.default_rng(3)
    kw = dict(action_normalization_type=norm, state_normalization_type=norm)
    ref = jadapters.BridgeSimplerAdapter(stats=JStats.from_json(), **kw)
    got = tadapters.BridgeSimplerAdapter(stats=DatasetStatistics.from_json(),
                                         **kw)
    obs = _obs(rng)
    r, g = ref.preprocess(obs), got.preprocess(obs)
    for key in ("observation.images.top", "observation.state"):
        np.testing.assert_array_equal(g[key], r[key])
    assert g["task"] == r["task"]
    np.testing.assert_array_equal(
        got.preprocess_proprio(obs["observation.state"]),
        ref.preprocess_proprio(obs["observation.state"]))
    actions = rng.uniform(-1, 1, (4, 7))
    actions[:, 6] = rng.uniform(0, 1, 4)
    np.testing.assert_array_equal(got.postprocess(actions),
                                  ref.postprocess(actions))
    np.testing.assert_array_equal(got.postprocess_verifier(actions),
                                  ref.postprocess_verifier(actions))
    assert tadapters.lanczos4_resize_uint8(
        obs["observation.images.top"], 224, 224).tobytes() == \
        jadapters.lanczos4_resize_uint8(
            obs["observation.images.top"], 224, 224).tobytes()


def test_sticky_and_fractal_adapters_and_ensembler_equal():
    rng = np.random.default_rng(4)
    grips = rng.uniform(0, 1, 40)
    pairs = [
        (jadapters.BridgeSimplerStickyGripperAdapter(sticky_steps=2),
         tadapters.BridgeSimplerStickyGripperAdapter(sticky_steps=2)),
        (jfractal.EDREulerSimplerAdapter(), tfractal.EDREulerSimplerAdapter()),
        (jfractal.EDRSimplerAdapter(), tfractal.EDRSimplerAdapter())]
    obs = _obs(rng)["observation.state"]
    for ref, got in pairs:
        ref.reset(), got.reset()
        assert [got.postprocess_gripper(g) for g in grips] == \
            [ref.postprocess_gripper(g) for g in grips]
        assert got.postprocess_gripper_verifier(0.4) == \
            ref.postprocess_gripper_verifier(0.4)
        np.testing.assert_array_equal(got.preprocess_proprio(obs),
                                      ref.preprocess_proprio(obs))
    ref, got = jadapters.ActionEnsembler(4), tadapters.ActionEnsembler(4)
    for _ in range(6):
        chunk = rng.standard_normal((4, 7))
        np.testing.assert_array_equal(got.ensemble(chunk), ref.ensemble(chunk))
