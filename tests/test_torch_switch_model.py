"""PyTorch port: checkpoint switching on the served wrappers, mirroring
tests/test_switch_model.py on the CPU.

The swap, the queue reset and a bad path that leaves the parameters as
they were (against the JAX wrapper switched to the same weights); the
cover wrapper's policy and `verifier:` switches, after which the engine
still runs; remote checkpoint iteration over a localhost websocket; the
int8 re-quantization on a switch; and `Pi0FastPolicy.switch_model`."""

import os
import socket

import numpy as np
import jax
import pytest
import torch

from cover_vla_tpu import configs as jconfigs
from cover_vla_tpu.convert import blob as jblob
from cover_vla_tpu.convert import checkpoints as jcheckpoints
from cover_vla_tpu.convert import pi0fast_from_torch as jfastconv
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.serving import policy_wrapper as jwrapper

from cover_vla_tpu_torch import configs
from cover_vla_tpu_torch.convert import checkpoints
from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax, pi0fast_from_jax
from cover_vla_tpu_torch.convert.verifier_to_torch import save_merged_ensemble
from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
from cover_vla_tpu_torch.engine import CoVerEngine
from cover_vla_tpu_torch.models import pi0, pi0fast, verifier
from cover_vla_tpu_torch.ops import quant
from cover_vla_tpu_torch.serving import CoVerPolicyWrapper, Pi0PolicyWrapper

from tests.test_torch_convert import (
    _fast_cfgs, _pi0fast_sd, assert_trees_equal)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _obs(seed):
    rng = np.random.default_rng(seed)
    eef = np.array([0.1, 0.0, 0.2, 1.0, 0.0, 0.0, 0.0, 0.6])
    return {"image": rng.integers(0, 255, (64, 64, 3), dtype=np.uint8),
            "state": {"agent": {"eef_pos": eef}}, "task": "put carrot on plate"}


def test_pi0_wrapper_switch_model(tmp_path):
    """Both wrappers switch to the same weights (the JAX one from orbax,
    the port's from the blob the JAX package writes of that tree); the
    queue is cleared; a bad path keeps the served parameters."""
    cfg = configs.tiny_pi0_config()
    jp2 = jpi0.init_pi0(jax.random.PRNGKey(9), jconfigs.tiny_pi0_config())
    jck = jcheckpoints.save_params(str(tmp_path / "jck2"), jp2)
    ck2 = tmp_path / "ck2"
    ck2.mkdir()
    jblob.save_tree(str(ck2 / "params.blob"), _np_tree(jp2))

    jw = jwrapper.Pi0PolicyWrapper(
        jpi0.init_pi0(jax.random.PRNGKey(0), jconfigs.tiny_pi0_config()),
        jconfigs.tiny_pi0_config())
    jw.switch_model(jck)
    w = Pi0PolicyWrapper(pi0.init_pi0(0, cfg, device="cpu"), cfg,
                         device="cpu")
    w._queue = [np.zeros(7)]                 # cleared by the switch
    w.switch_model(str(ck2))
    assert w._queue == []
    assert_trees_equal(w.params, pi0_from_jax(_np_tree(jw.params), cfg,
                                              device="cpu"))
    before = w.params
    with pytest.raises(FileNotFoundError):
        w.switch_model(str(tmp_path / "nope"))
    assert w.params is before
    assert np.isfinite(w.infer(_obs(1))["actions"]).all()


def test_pi0_wrapper_switch_requantizes(tmp_path):
    """int8 serving keeps its mode across a switch: the switched weights
    are quantized as `quantize_pi0_policy` quantizes them."""
    cfg = configs.tiny_pi0_config()
    p2 = pi0.init_pi0(7, cfg, device="cpu")
    ck = checkpoints.save_params(str(tmp_path / "ck"), p2)
    w = Pi0PolicyWrapper(pi0.init_pi0(0, cfg, device="cpu"), cfg,
                         quantize="int8", device="cpu")
    w.switch_model(ck)
    assert w.params["paligemma"]["layers"]["q"].dtype == torch.int8
    assert_trees_equal(w.params, quant.quantize_pi0_policy(p2))
    assert np.isfinite(w.infer(_obs(2))["actions"]).all()


@pytest.mark.parametrize("quantize", ["none", "int8_full"])
def test_cover_wrapper_switch_model(tmp_path, quantize):
    """Policy switch, `verifier:` switch to a blob directory and to a
    heads-only merged .pt (which reuses the served, possibly int8,
    backbone); the switched engine still runs."""
    pcfg, vcfg = configs.tiny_pi0_config(), configs.tiny_verifier_config()
    ccfg = configs.CoVerConfig(n_samples=2, n_rephrases=2)
    pp2 = pi0.init_pi0(9, pcfg, device="cpu")
    vp2 = verifier.init_verifier(8, vcfg, num_members=2, device="cpu")
    vp3 = verifier.init_verifier(5, vcfg, num_members=2, device="cpu")
    pck = checkpoints.save_params(str(tmp_path / "p2"), pp2)
    vck = checkpoints.save_params(str(tmp_path / "v2"), vp2)
    merged = str(tmp_path / "heads.pt")
    save_merged_ensemble(merged, vp3["members"], vcfg)

    eng = CoVerEngine(pi0.init_pi0(0, pcfg, device="cpu"),
                      verifier.init_verifier(1, vcfg, num_members=2,
                                             device="cpu"),
                      pcfg, vcfg, ccfg, device="cpu",
                      policy_tokenizer=HashTokenizer(pcfg.paligemma.vocab_size),
                      verifier_tokenizer=HashTokenizer(vcfg.text.vocab_size,
                                                       add_bos=False))
    eng.reset("stack the blocks")
    w = CoVerPolicyWrapper(eng, quantize=quantize)
    w.switch_model(pck)
    assert_trees_equal(eng.policy_params, pp2 if quantize == "none"
                       else quant.quantize_pi0_policy(pp2))
    w.switch_model("verifier:" + vck)
    assert_trees_equal(eng.verifier_params, vp2)
    backbone = eng.verifier_params["backbone"]
    w.switch_model("verifier:" + merged)
    assert eng.verifier_params["backbone"] is backbone
    assert_trees_equal(eng.verifier_params["members"], vp3["members"])
    before = eng.verifier_params
    with pytest.raises(FileNotFoundError):
        w.switch_model("verifier:" + str(tmp_path / "missing.pt"))
    assert eng.verifier_params is before

    rng = np.random.default_rng(0)
    out = w.infer({"image": rng.integers(0, 255, (256, 256, 3),
                                         dtype=np.uint8),
                   "proprio": rng.uniform(-0.1, 0.1, 7).astype(np.float32)})
    assert out["actions"].shape == (7,) and np.isfinite(out["actions"]).all()


def test_remote_checkpoint_iteration(tmp_path):
    """switch_and_evaluate drives the switch_model verb over a localhost
    websocket for each checkpoint and evaluates again."""
    pytest.importorskip("websockets")
    pytest.importorskip("msgpack")
    from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv
    from cover_vla_tpu_torch.eval.remote_evaluator import switch_and_evaluate
    from cover_vla_tpu_torch.serving import (
        WebsocketPolicyClient, WebsocketPolicyServer)

    cfg = configs.tiny_pi0_config()
    params = [pi0.init_pi0(i, cfg, device="cpu") for i in range(2)]
    cks = [checkpoints.save_params(str(tmp_path / f"ck{i}"), p)
           for i, p in enumerate(params)]
    wrapper = Pi0PolicyWrapper(pi0.init_pi0(7, cfg, device="cpu"), cfg,
                               device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = WebsocketPolicyServer(wrapper, "127.0.0.1", port,
                                   metadata={"model": "pi0"})
    server.serve_in_thread()
    client = WebsocketPolicyClient("127.0.0.1", port, retry_interval_s=0.2,
                                   max_retries=30)
    try:
        out = switch_and_evaluate(
            client, cks,
            lambda: [FakeWidowXEnv("widowx_carrot_on_plate", max_steps=3)],
            max_steps=3)
        assert set(out) == set(cks)
        for res in out.values():
            assert 0.0 <= res["success_rate"] <= 1.0
        # the last switched checkpoint is what the server now holds
        assert_trees_equal(wrapper.params, params[-1])
        with pytest.raises(RuntimeError, match="FileNotFoundError"):
            client.switch_model(str(tmp_path / "missing"))
        assert_trees_equal(wrapper.params, params[-1])
    finally:
        client.close()
        server.stop()


def test_pi0fast_switch_model(tmp_path):
    """Pi0FastPolicy loads a lerobot pi0-FAST .safetensors through
    convert_pi0fast (equal to the JAX conversion) and a blob directory;
    the queue resets; a bad path keeps the parameters."""
    from safetensors.numpy import save_file
    jcfg, cfg = _fast_cfgs()
    sd = _pi0fast_sd("model.pi0_paligemma.")
    src = str(tmp_path / "fast.safetensors")
    save_file(sd, src)
    policy = pi0fast.Pi0FastPolicy(pi0fast.init_pi0fast(0, cfg, device="cpu"),
                                   cfg, device="cpu")
    policy._queue = [np.zeros((1, 7))]
    policy.switch_model(src)
    assert policy._queue == []
    want = pi0fast_from_jax(_np_tree(jfastconv.convert_pi0fast(sd, jcfg)),
                            cfg, device="cpu")
    assert_trees_equal(policy.params, want)
    assert os.path.isdir(src + ".torchcache")

    other = pi0fast.init_pi0fast(4, cfg, device="cpu")
    policy.switch_model(checkpoints.save_params(str(tmp_path / "b"), other))
    assert_trees_equal(policy.params, other)
    before = policy.params
    with pytest.raises(FileNotFoundError):
        policy.switch_model(str(tmp_path / "none.npz"))
    assert policy.params is before
    s = cfg.vision.image_size
    a = policy.select_action(np.zeros((1, 1, s, s, 3), np.float32),
                             np.zeros((1, 7), np.float32), ["pick the cube"])
    assert a.shape == (1, 7) and np.isfinite(a).all()
