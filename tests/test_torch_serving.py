"""PyTorch port vs the JAX package: the serving path on the CPU.

msgpack-numpy frames byte-equal to the JAX codec's; the port's websocket
server answering the JAX client and the JAX server answering the port's
client; the traceback frame on error; `Pi0PolicyWrapper` (noise_std 0)
and `CoVerPolicyWrapper` (int8_full, the JAX engine's noise replayed)
against the JAX wrappers on the same tiny weights; `switch_model`, the
policy factory and the remote evaluator over the fake environment."""

import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu import configs as jconfigs
from cover_vla_tpu.data.tokenizer import HashTokenizer as JHash
from cover_vla_tpu.engine import CoVerEngine as JEngine
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.models import verifier as jverifier
from cover_vla_tpu.serving import msgpack_numpy as jmpn
from cover_vla_tpu.serving import policy_service as jservice
from cover_vla_tpu.serving import policy_wrapper as jwrapper

from cover_vla_tpu_torch import configs
from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax, verifier_from_jax
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
from cover_vla_tpu_torch.engine import CoVerEngine
from cover_vla_tpu_torch.engine.verified_step import make_verified_step
from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv
from cover_vla_tpu_torch.eval.remote_evaluator import (
    RemoteEvaluator, switch_and_evaluate)
from cover_vla_tpu_torch.models import factory, pi0fast
from cover_vla_tpu_torch.ops import quant
from cover_vla_tpu_torch.serving import (
    CoVerPolicyWrapper, Pi0PolicyWrapper, WebsocketPolicyClient,
    WebsocketPolicyServer)
from cover_vla_tpu_torch.serving import msgpack_numpy as mpn

ATOL = 1e-4          # fp32 wrappers, port vs JAX
INT8_ATOL = 2e-2     # int8 (bf16 compute), port vs JAX


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)


@pytest.fixture(scope="module")
def weights():
    jpp = _f32(jpi0.init_pi0(jax.random.PRNGKey(0),
                             jconfigs.tiny_pi0_config()))
    jvp = _f32(jverifier.init_verifier(jax.random.PRNGKey(1),
                                       jconfigs.tiny_verifier_config(),
                                       num_members=2))
    tpp = pi0_from_jax(jax.tree_util.tree_map(np.asarray, jpp),
                       configs.tiny_pi0_config(), device="cpu")
    tvp = verifier_from_jax(jax.tree_util.tree_map(np.asarray, jvp),
                            configs.tiny_verifier_config(), device="cpu")
    return jpp, jvp, tpp, tvp


def _obs(rng):
    eef = np.array([0.1, 0.0, 0.2, 1.0, 0.0, 0.0, 0.0, 0.6], np.float64)
    return {"image": rng.integers(0, 255, (96, 128, 3), dtype=np.uint8),
            "state": {"agent": {"eef_pos": eef}},
            "task": "put carrot on plate"}


class EchoPolicy:
    def __init__(self):
        self.resets = 0
        self.model = "initial"

    def infer(self, obs):
        return {"actions": np.asarray(obs["state"]) * 2,
                "dtype": np.asarray(obs["state"]).dtype.str}

    def reset(self):
        self.resets += 1

    def switch_model(self, path):
        self.model = path


class FailingPolicy(EchoPolicy):
    def infer(self, obs):
        raise ValueError("boom")


# ---------------------------------------------------------------------------
# codec and transport
# ---------------------------------------------------------------------------


def test_msgpack_frames_byte_equal():
    rng = np.random.default_rng(0)
    objs = [
        {"image": rng.integers(0, 255, (32, 32, 3)).astype(np.uint8),
         "state": np.linspace(0, 1, 7).astype(np.float32),
         "task": "put carrot on plate", "n": 3, "x": 1.5, "none": None,
         "nested": {"x": np.arange(4, dtype=np.int64),
                    "s": np.float32(2.5), "i": np.int16(-3)},
         "list": [np.zeros((2, 0), np.float64), True, b"raw"]},
        {"actions": rng.standard_normal((4, 7)), "score": np.float64(0.25),
         "instruction": "open the drawer"},
        {"error": "Traceback (most recent call last):\n..."},
    ]
    for obj in objs:
        frame = mpn.packb(obj)
        assert frame == jmpn.packb(obj)
        assert mpn.unpackb(frame).keys() == jmpn.unpackb(frame).keys()
    back = mpn.unpackb(mpn.packb(objs[0]))
    np.testing.assert_array_equal(back["image"], objs[0]["image"])
    assert back["nested"]["x"].dtype == np.int64
    assert back["nested"]["s"] == 2.5 and back["task"] == objs[0]["task"]


@pytest.mark.parametrize("server_side,client_side", [
    ("port", "jax"), ("jax", "port"), ("port", "port")])
def test_websocket_round_trip_across_packages(server_side, client_side):
    policy = EchoPolicy()
    port = _free_port()
    server_cls = (WebsocketPolicyServer if server_side == "port"
                  else jservice.WebsocketPolicyServer)
    client_cls = (WebsocketPolicyClient if client_side == "port"
                  else jservice.WebsocketPolicyClient)
    server = server_cls(policy, host="127.0.0.1", port=port,
                        metadata={"name": "echo", "side": server_side})
    server.serve_in_thread()
    client = client_cls("127.0.0.1", port, retry_interval_s=0.2,
                        max_retries=20)
    try:
        assert client.metadata == {"name": "echo", "side": server_side}
        out = client.infer({"state": np.array([1.0, 2.0], np.float32)})
        np.testing.assert_array_equal(out["actions"], [2.0, 4.0])
        assert out["actions"].dtype == np.float32 and out["dtype"] == "<f4"
        client.reset()
        assert policy.resets == 1
        client.switch_model("/some/ckpt")
        assert policy.model == "/some/ckpt"
    finally:
        client.close()
        if server_side == "port":
            server.stop()


def test_server_error_sends_traceback_then_closes():
    port = _free_port()
    server = WebsocketPolicyServer(FailingPolicy(), host="127.0.0.1",
                                   port=port)
    server.serve_in_thread()
    client = jservice.WebsocketPolicyClient("127.0.0.1", port,
                                            retry_interval_s=0.2,
                                            max_retries=20)
    try:
        with pytest.raises(RuntimeError, match="ValueError: boom"):
            client.infer({"state": np.array([1.0])})
        # the server closed the connection after the traceback frame
        with pytest.raises(Exception):
            client.infer({"state": np.array([1.0])})
    finally:
        server.stop()


def test_dispatch_without_transport():
    """The verb dispatch runs on decoded requests, without websockets."""
    policy = EchoPolicy()
    server = WebsocketPolicyServer(policy)
    out = server.dispatch({"type": "infer", "obs": {"state": np.ones(2)}})
    np.testing.assert_array_equal(out["actions"], [2.0, 2.0])
    assert server.dispatch({"state": np.ones(1)})["actions"][0] == 2.0
    assert server.dispatch({"type": "reset"}) == {"status": "ok"}
    assert server.dispatch({"type": "switch_model", "path": "p"}) == \
        {"status": "ok"} and policy.model == "p"


# ---------------------------------------------------------------------------
# policy wrappers
# ---------------------------------------------------------------------------


def test_pi0_wrapper_matches_jax(weights):
    """noise_std 0: the flow starts from zeros in both packages, so the
    served actions are deterministic and comparable; 6 calls cross one
    chunk boundary (the host queue)."""
    jpp, _, tpp, _ = weights
    jw = jwrapper.Pi0PolicyWrapper(jpp, jconfigs.tiny_pi0_config(),
                                   tokenizer=JHash(1024), noise_std=0.0)
    tw = Pi0PolicyWrapper(tpp, configs.tiny_pi0_config(),
                          tokenizer=HashTokenizer(1024), noise_std=0.0,
                          device="cpu")
    rng = np.random.default_rng(1)
    for i in range(6):
        obs = _obs(rng)
        ja, ta = jw.infer(obs)["actions"], tw.infer(obs)["actions"]
        assert ta.shape == (7,)
        np.testing.assert_allclose(ta, ja, atol=ATOL, rtol=0, err_msg=str(i))
    tw.reset()
    assert tw._queue == []


def test_pi0_wrapper_int8_and_switch_model(weights):
    _, _, tpp, _ = weights
    w = Pi0PolicyWrapper(tpp, configs.tiny_pi0_config(), quantize="int8",
                         device="cpu")
    assert w.params["paligemma"]["layers"]["q"].dtype == torch.int8
    assert w.params["vision"]["blocks"]["attn"]["q"]["kernel"].dtype == \
        torch.int8
    out = w.infer(_obs(np.random.default_rng(2)))
    assert np.isfinite(out["actions"]).all() and len(w._queue) == 3
    before = w.params
    with pytest.raises(FileNotFoundError):
        w.switch_model("/no/such/checkpoint")
    # the served parameters and the queue stay as they were
    assert w.params is before and len(w._queue) == 3
    with pytest.raises(ValueError, match="quantize"):
        Pi0PolicyWrapper(tpp, configs.tiny_pi0_config(), quantize="int4",
                         device="cpu")


def test_cover_wrapper_int8_full_matches_jax(weights):
    """int8_full on both sides (policy and verifier backbone); one verified
    step with the JAX engine's noise replayed into the port's engine."""
    jpp, jvp, tpp, tvp = weights
    k = n = 2
    jc = jconfigs.CoVerConfig(n_samples=n, n_rephrases=k)
    tc = configs.CoVerConfig(n_samples=n, n_rephrases=k)
    jp, jv = jconfigs.tiny_pi0_config(), jconfigs.tiny_verifier_config()
    tp, tv = configs.tiny_pi0_config(), configs.tiny_verifier_config()
    jeng = JEngine(jpp, jvp, jp, jv, jc, seed=4,
                   policy_tokenizer=JHash(1024),
                   verifier_tokenizer=JHash(512, add_bos=False))
    teng = CoVerEngine(tpp, tvp, tp, tv, tc, seed=4, device="cpu",
                       policy_tokenizer=HashTokenizer(1024),
                       verifier_tokenizer=HashTokenizer(512, add_bos=False))
    _, sub = jax.random.split(jax.random.PRNGKey(4))
    noise = np.array(jax.random.normal(
        sub, (k, n, tp.chunk_size, tp.max_action_dim), jnp.float32))
    step = make_verified_step(tp, tv, tc, DatasetStatistics.from_json(),
                              device="cpu")
    teng._step_fn = lambda *a, generator=None: step(*a, noise=noise)
    jwr = jwrapper.CoVerPolicyWrapper(jeng, quantize="int8_full")
    twr = CoVerPolicyWrapper(teng, quantize="int8_full")
    assert quant.is_quantized(teng.policy_params["expert"]["layers"])
    assert teng.verifier_params["backbone"]["vision"]["blocks"]["mlp"][
        "fc1"]["kernel"].dtype == torch.int8
    rng = np.random.default_rng(3)
    obs = {"reset_task": "put carrot on plate",
           "image": rng.integers(0, 255, (64, 64, 3), dtype=np.uint8),
           "proprio": rng.uniform(-0.1, 0.1, 7).astype(np.float32)}
    jo, to = jwr.infer(obs), twr.infer(obs)
    assert to["actions"].shape == (7,) and to["instruction"] == jo["instruction"]
    np.testing.assert_allclose(to["actions"], np.asarray(jo["actions"]),
                               atol=INT8_ATOL, rtol=0)
    assert to["score"] == pytest.approx(jo["score"], abs=INT8_ATOL)
    assert teng.records[-1].winner_idx == jeng.records[-1].winner_idx
    with pytest.raises(FileNotFoundError):
        twr.switch_model("verifier:/no/such.pt")


# ---------------------------------------------------------------------------
# factory and remote evaluation
# ---------------------------------------------------------------------------


def test_factory_builds_both_families():
    w = factory.make_policy("pi0", tiny=True, device="cpu", quantize="int8",
                            noise_std=0.0)
    assert isinstance(w, Pi0PolicyWrapper) and w.device.type == "cpu"
    assert w.params["expert"]["layers"]["down"].dtype == torch.int8
    assert np.isfinite(w.infer(_obs(np.random.default_rng(4)))["actions"]).all()
    f = factory.make_policy("pi0fast", tiny=True, device="cpu", seed=3)
    assert isinstance(f, pi0fast.Pi0FastPolicy)
    s = f.cfg.vision.image_size
    a = f.select_action(np.zeros((1, 1, s, s, 3), np.float32),
                        np.zeros((1, 7), np.float32), ["pick the cube"])
    assert a.shape == (1, 7) and np.isfinite(a).all()
    # given parameters are served as they are
    g = factory.make_policy("pi0fast", tiny=True, device="cpu",
                            params=f.params)
    assert g.params is f.params
    with pytest.raises(ValueError, match="unknown policy family"):
        factory.make_policy("octo", device="cpu")


def test_pi0fast_served_through_dispatch(monkeypatch):
    """pi0-FAST answers the serving verbs: one generation fills the
    n_action_steps queue, reset empties it, switch_model to a missing
    checkpoint raises and keeps the parameters."""
    f = factory.make_policy("pi0fast", tiny=True, device="cpu", seed=2)
    generations = []
    orig = pi0fast.generate_action_tokens
    monkeypatch.setattr(pi0fast, "generate_action_tokens",
                        lambda *a: generations.append(1) or orig(*a))
    server = WebsocketPolicyServer(f)
    rng = np.random.default_rng(5)
    obs = {"image": rng.integers(0, 255, (80, 100, 3), dtype=np.uint8),
           "state": rng.uniform(-1, 1, 7).astype(np.float32),
           "task": "pick the cube"}
    req = mpn.unpackb(mpn.packb({"type": "infer", "obs": obs}))
    outs = [server.dispatch(req)["actions"] for _ in range(3)]
    assert all(a.shape == (7,) and np.isfinite(a).all() for a in outs)
    assert len(generations) == 1
    assert server.dispatch({"type": "reset"}) == {"status": "ok"}
    server.dispatch(req)
    assert len(generations) == 2
    before = f.params
    with pytest.raises(FileNotFoundError):
        server.dispatch({"type": "switch_model", "path": "/ckpt"})
    assert f.params is before


def test_remote_evaluation_over_the_fake_env():
    policy = factory.make_policy("pi0", tiny=True, device="cpu", seed=1)
    port = _free_port()
    server = WebsocketPolicyServer(policy, "127.0.0.1", port,
                                   metadata={"model": "pi0"})
    server.serve_in_thread()
    client = WebsocketPolicyClient("127.0.0.1", port, retry_interval_s=0.2,
                                   max_retries=30)
    try:
        ev = RemoteEvaluator(client, max_steps=5)
        envs = [FakeWidowXEnv("widowx_carrot_on_plate", max_steps=5)
                for _ in range(2)]
        out = ev.evaluate(envs)
        assert len(out["episodes"]) == 2
        assert all(e["steps"] <= 5 for e in out["episodes"])
        assert 0.0 <= out["success_rate"] <= 1.0
        assert out["episodes"][0]["task"] == "put carrot on plate"
        # a checkpoint that does not exist: the server answers with its
        # traceback and the client raises
        with pytest.raises(RuntimeError, match="FileNotFoundError"):
            switch_and_evaluate(client, ["/ckpt/a"], lambda: envs[:1],
                                max_steps=2)
    finally:
        client.close()
        server.stop()


def test_switch_and_evaluate_iterates_checkpoints():
    seen = []

    class Scripted(EchoPolicy):
        def infer(self, obs):
            return {"actions": np.zeros(7)}

        def switch_model(self, path):
            seen.append(path)

    port = _free_port()
    server = WebsocketPolicyServer(Scripted(), "127.0.0.1", port)
    server.serve_in_thread()
    client = WebsocketPolicyClient("127.0.0.1", port, retry_interval_s=0.2,
                                   max_retries=30)
    try:
        out = switch_and_evaluate(
            client, ["a", "b"],
            lambda: [FakeWidowXEnv("widowx_carrot_on_plate", max_steps=3)],
            max_steps=3)
        assert seen == ["a", "b"] and sorted(out) == ["a", "b"]
        assert out["a"]["episodes"][0]["steps"] == 3
    finally:
        client.close()
        server.stop()
