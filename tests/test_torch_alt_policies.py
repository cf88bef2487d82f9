"""PyTorch port vs the JAX package: the alternative policy families
(`serving/alt_policies.py`: Magma token bins, SpatialVLA postprocess, the
HF generate seam, the scripted and generic wrappers), the legacy
baselines (`serving/legacy_policies.py`: an RT-1 SavedModel, the Octo
wrapper) and the mock robot devices (`robot/devices.py`). The cases of
tests/test_alt_policy_decode.py and tests/test_legacy_policies.py, run
through both packages; all are host computations, so results are equal."""

import numpy as np
import pytest

from cover_vla_tpu.data.stats import (
    DatasetStatistics as JStats, FieldStats as JField)
from cover_vla_tpu.robot import devices as jdevices
from cover_vla_tpu.serving import alt_policies as jalt
from cover_vla_tpu.serving import legacy_policies as jlegacy

from cover_vla_tpu_torch.data.stats import DatasetStatistics, FieldStats
from cover_vla_tpu_torch.robot import devices
from cover_vla_tpu_torch.serving import alt_policies as alt
from cover_vla_tpu_torch.serving import legacy_policies as legacy
from cover_vla_tpu_torch.serving.policy_service import WebsocketPolicyServer

VOCAB = 50_000


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _stats(p01, p99, cls=DatasetStatistics, field=FieldStats):
    p01, p99 = np.asarray(p01, float), np.asarray(p99, float)
    return cls(
        action=field(mean=(p01 + p99) / 2, std=np.ones_like(p01),
                     p01=p01, p99=p99, minimum=p01, maximum=p99),
        proprio=field(mean=np.zeros(7), std=np.ones(7), p01=-np.ones(7),
                      p99=np.ones(7), minimum=-np.ones(7),
                      maximum=np.ones(7)),
        num_transitions=1, num_trajectories=1)


def _both_stats(p01, p99):
    return _stats(p01, p99), _stats(p01, p99, JStats, JField)


def test_magma_decode_equal():
    for bins in (256, 64):
        _same(alt.magma_bin_centers(bins), jalt.magma_bin_centers(bins))
    c = alt.magma_bin_centers(256)
    assert len(c) == 255 and abs(c[127]) < 1e-12
    rng = np.random.default_rng(0)
    action_ids = VOCAB - np.asarray([10, 20, 30, 40, 50, 60, 70])
    cases = [np.asarray([VOCAB - 1, VOCAB - 2, VOCAB - 128, VOCAB - 254,
                         VOCAB - 255, VOCAB, VOCAB - 10_000]),
             np.concatenate([np.arange(32), action_ids, [2]]),
             rng.integers(VOCAB - 300, VOCAB + 5, (2, 9))]
    for ids in cases:
        _same(alt.magma_decode_tokens(ids, VOCAB),
              jalt.magma_decode_tokens(ids, VOCAB))
    _same(alt.magma_decode_tokens(cases[1], VOCAB),
          alt.magma_decode_tokens(action_ids, VOCAB))


def test_denormalize_and_exec_conversion_equal():
    st, jst = _both_stats([-2, -2, -2, -1, -1, -1, 0], [2, 2, 2, 1, 1, 1, 1])
    rng = np.random.default_rng(1)
    for a in [np.asarray([0.5, -0.5, 0.0, 1.0, -1.0, 0.0, 0.9]),
              *rng.uniform(-1, 1, (4, 7))]:
        for mask in (None, np.asarray([True] * 3 + [False] * 4)):
            _same(alt.masked_denormalize_bound(a, st, mask),
                  jalt.masked_denormalize_bound(a, jst, mask))
        for binarize in (False, True):
            _same(alt.euler_action_to_exec(a, binarize),
                  jalt.euler_action_to_exec(a, binarize))
    out = alt.masked_denormalize_bound(
        np.asarray([0.5, -0.5, 0.0, 1.0, -1.0, 0.0, 0.9]), st)
    np.testing.assert_allclose(out, [1.0, -1.0, 0.0, 1.0, -1.0, 0.0, 0.9])


def test_magma_and_spatialvla_wrappers_equal():
    st, jst = _both_stats([-0.05] * 6 + [0.0], [0.05] * 6 + [1.0])
    ids = VOCAB - np.asarray([128, 3, 250, 128, 64, 200, 128])
    got = alt.MagmaPolicyWrapper(lambda obs: ids, VOCAB, stats=st).infer({})
    want = jalt.MagmaPolicyWrapper(lambda obs: ids, VOCAB, stats=jst).infer({})
    _same(got["actions"], want["actions"])
    assert got["actions"][6] in (-1.0, 1.0)
    # the default statistics are the vendored Bridge table in both
    _same(alt.MagmaPolicyWrapper(lambda obs: ids, VOCAB).infer({})["actions"],
          jalt.MagmaPolicyWrapper(lambda obs: ids, VOCAB).infer({})["actions"])

    rng = np.random.default_rng(2)
    chunks = iter(rng.uniform(-0.05, 0.05, (8, 3, 7)))
    jchunks = iter(np.random.default_rng(2).uniform(-0.05, 0.05, (8, 3, 7)))
    for temp in (-0.8, None):
        w = alt.SpatialVLAPolicyWrapper(lambda obs: next(chunks),
                                        chunk_size=3, ensemble_temp=temp)
        jw = jalt.SpatialVLAPolicyWrapper(lambda obs: next(jchunks),
                                          chunk_size=3, ensemble_temp=temp)
        for t in range(4):
            if t == 2:
                w.reset()
                jw.reset()
            _same(w.infer({})["actions"], jw.infer({})["actions"])
        with pytest.raises(NotImplementedError):
            w.switch_model("x")


def test_hf_model_wrapper_equal():
    """HFModelPolicyWrapper: the adapter's postprocess over a decoded
    chunk, in queue mode and ensembled."""
    rng = np.random.default_rng(3)
    chunk = rng.uniform(-0.05, 0.05, (4, 7))
    chunk[:, 6] = rng.uniform(0, 1, 4)
    for temp in (None, -0.8):
        w = alt.HFModelPolicyWrapper(lambda obs: obs["x"], lambda t: chunk,
                                     chunk_size=4, ensemble_temp=temp)
        jw = jalt.HFModelPolicyWrapper(lambda obs: obs["x"], lambda t: chunk,
                                       chunk_size=4, ensemble_temp=temp)
        for t in range(6):
            _same(w.infer({"x": t})["actions"], jw.infer({"x": t})["actions"])
        with pytest.raises(NotImplementedError):
            w.switch_model("x")


def test_magma_drives_a_real_hf_model_equal():
    """The HF seam with an actual transformers causal LM (a tiny random
    GPT-2): constrained greedy ids through both packages' generate
    functions, and the Magma chain over them."""
    torch = pytest.importorskip("torch")
    pytest.importorskip("transformers")
    from transformers import GPT2Config, GPT2LMHeadModel

    vocab = 600
    torch.manual_seed(0)
    model = GPT2LMHeadModel(GPT2Config(
        vocab_size=vocab, n_positions=64, n_embd=32, n_layer=2, n_head=2,
        eos_token_id=0, pad_token_id=0)).eval()

    def build_inputs(obs):
        ids = [(7 * len(obs.get("instruction", ""))) % vocab + 1, 3, 5]
        return {"input_ids": torch.tensor([ids], dtype=torch.long)}

    lo, hi = vocab - 256, vocab
    gen = alt.hf_causal_generate_fn(model, build_inputs, max_new_tokens=8,
                                    allowed_token_range=(lo, hi))
    jgen = jalt.hf_causal_generate_fn(model, build_inputs, max_new_tokens=8,
                                      allowed_token_range=(lo, hi))
    obs = {"instruction": "pick up the carrot"}
    ids = gen(obs)
    assert isinstance(ids, np.ndarray) and ids.shape == (3 + 8,)
    assert (ids[3:] >= lo).all() and (ids[3:] < hi).all()
    np.testing.assert_array_equal(ids, jgen(obs))
    np.testing.assert_array_equal(ids, gen(obs))        # greedy: repeatable
    st, jst = _both_stats([-0.2] * 7, [0.2] * 7)
    _same(alt.MagmaPolicyWrapper(gen, vocab, stats=st).infer(obs)["actions"],
          jalt.MagmaPolicyWrapper(jgen, vocab, stats=jst).infer(obs)["actions"])


def test_scripted_policy_behind_the_ports_server():
    """ScriptedPolicyWrapper answers the server's verbs as the JAX wrapper
    answers its direct calls."""
    server = WebsocketPolicyServer(alt.ScriptedPolicyWrapper(gain=0.4))
    ref = jalt.ScriptedPolicyWrapper(gain=0.4)
    rng = np.random.default_rng(4)
    for t in range(4):
        obs = ({"agent": {"eef_pos": rng.uniform(-0.1, 0.1, 8)}}
               if t % 2 == 0 else {"image": np.zeros((4, 4, 3), np.uint8)})
        _same(server.dispatch({"type": "infer", "obs": obs})["actions"],
              ref.infer(obs)["actions"])
    assert server.dispatch({"type": "reset"}) == {"status": "ok"}
    server.dispatch({"type": "switch_model", "path": "unused"})


def test_mock_robot_readings_equal():
    rng = np.random.default_rng(5)
    for seed in (0, 7):
        cam, jcam = devices.MockCamera(32, 24, seed), \
            jdevices.MockCamera(32, 24, seed)
        with pytest.raises(RuntimeError):
            cam.read()
        cam.connect()
        jcam.connect()
        for _ in range(9):
            _same(cam.read(), jcam.read())
    robot, jrobot = devices.make_mock_robot(5), jdevices.make_mock_robot(5)
    with pytest.raises(RuntimeError):
        robot.act(np.zeros(5))
    robot.connect()
    jrobot.connect()
    for _ in range(6):
        target = rng.uniform(-1, 1, 5)
        robot.act(target)
        jrobot.act(target)
        got, want = robot.observe(), jrobot.observe()
        _same(got["positions"], want["positions"])
        _same(got["images"]["top"], want["images"]["top"])
    robot.disconnect()
    with pytest.raises(RuntimeError):
        robot.observe()


def _make_rt1_savedmodel(path):
    tf = pytest.importorskip("tensorflow")

    class M(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec([1, 256, 320, 3], tf.uint8, name="image"),
            tf.TensorSpec([1, 512], tf.float32,
                          name="natural_language_embedding")])
        def __call__(self, image, natural_language_embedding):
            m = tf.reduce_mean(tf.cast(image, tf.float32)) / 255.0
            e = tf.reduce_mean(natural_language_embedding)
            wv = tf.stack([m, e, m - e])[None] * 2.0 - 0.5
            return {
                "world_vector": tf.clip_by_value(wv, -1.0, 1.0),
                "rotation_delta": tf.clip_by_value(-wv, -1.0, 1.0),
                "gripper_closedness_action": tf.reshape(m * 2 - 1, [1, 1]),
                "terminate_episode": tf.zeros([1, 3]),
            }

    m = M()
    tf.saved_model.save(m, path, signatures=m.__call__)
    return path


def test_rt1_savedmodel_policy_equal(tmp_path):
    path = _make_rt1_savedmodel(str(tmp_path / "rt1"))
    pol, jpol = legacy.RT1SavedModelPolicy(path), \
        jlegacy.RT1SavedModelPolicy(path)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
    for task in ("pick coke can", "open the drawer"):
        pol.reset(task)
        jpol.reset(task)
        raw, jraw = pol.step(img), jpol.step(img)
        assert set(raw) == set(jraw) >= {"world_vector", "rotation_delta",
                                         "gripper_closedness_action"}
        for k in raw:
            _same(raw[k], jraw[k])
        assert (np.abs(raw["world_vector"]) <= 0.05 + 1e-6).all()
        flat = pol.select_action(img)
        _same(flat, jpol.select_action(img))
        assert flat.shape == (7,) and flat[6] in (-1.0, 1.0)


def test_hash_sentence_embedding_equal():
    for text in ("pick coke can", "Pick Coke Can ", "open drawer", ""):
        _same(legacy._hash_sentence_embedding(text),
              jlegacy._hash_sentence_embedding(text))
    a = legacy._hash_sentence_embedding("pick coke can")
    np.testing.assert_allclose(np.linalg.norm(a), 1.0, rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(image_size=64, horizon=2,
                                     pred_action_horizon=4, exec_horizon=2),
                                dict(image_size=32, action_ensemble_temp=-0.8)])
def test_octo_wrapper_equal(kw):
    """The image-history window, its pad mask, the exec queue and the
    ensembler, with the model's sample function as a plug-in."""
    def sampler(log):
        def sample_actions(images, pad_mask, task, seed):
            log.append((images.copy(), pad_mask.copy(), task, seed))
            base = float(images.mean()) + seed
            return base + np.tile(np.arange(4, dtype=np.float32)[:, None],
                                  (1, 7))
        return sample_actions

    log, jlog = [], []
    pol = legacy.OctoPolicyWrapper(sampler(log), **kw)
    jpol = jlegacy.OctoPolicyWrapper(sampler(jlog), **kw)
    pol.reset("put spoon on towel")
    jpol.reset("put spoon on towel")
    rng = np.random.default_rng(0)
    for t in range(5):
        f = rng.integers(0, 255, (96, 128, 3)).astype(np.uint8)
        _same(pol.select_action(f, seed=t), jpol.select_action(f, seed=t))
    assert len(log) == len(jlog) > 0
    for (im, pm, task, seed), (jim, jpm, jtask, jseed) in zip(log, jlog):
        _same(im, jim)
        _same(pm, jpm)
        assert (task, seed) == (jtask, jseed)
    assert log[0][1].tolist() == [[False, True]]
