"""PyTorch port vs the JAX package: the `run.py` entry point on the CPU.

Every YAML of config/ and the CLI cases of tests/test_cli_analysis.py
parse to the same config in both packages; a tiny `build_server` in pi0
and cover mode answers through the server's verb dispatch; a tiny
`role_eval` runs two lockstep episodes over the fake environment; the
roles not ported yet stop with SystemExit."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from cover_vla_tpu import run as jrun
from cover_vla_tpu.utils import cli as jcli

from cover_vla_tpu_torch import configs, run
from cover_vla_tpu_torch.convert import checkpoints
from cover_vla_tpu_torch.convert.verifier_to_torch import save_merged_ensemble
from cover_vla_tpu_torch.models import pi0, verifier
from cover_vla_tpu_torch.utils import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "config", "*.yaml")))


def _both(argv):
    return (dataclasses.asdict(cli.parse(run.RunCfg, argv)),
            dataclasses.asdict(jcli.parse(jrun.RunCfg, argv)))


def test_config_classes_match_field_for_field():
    for port_cls, jax_cls in ((run.TrainCfg, jrun.TrainCfg),
                              (run.ServeCfg, jrun.ServeCfg),
                              (run.EvalCfg, jrun.EvalCfg),
                              (run.RunCfg, jrun.RunCfg)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
        assert [f.name for f in dataclasses.fields(port_cls)] == \
            [f.name for f in dataclasses.fields(jax_cls)]


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_repo_yaml_parses_the_same(path):
    port, ref = _both(["--config", path])
    assert port == ref


@pytest.mark.parametrize("argv", [
    ["--role", "train", "--train.batch_size", "8", "--train.lr", "1e-3",
     "--eval.tiny", "true"],
    ["--role", "serve_policy", "--serve.mode", "cover", "--serve.port",
     "9001", "--serve.quantize", "int8_full"],
    ["--eval.n_parallel", "4", "--eval.pipelined", "yes",
     "--eval.selection", "random"],
], ids=["train_overrides", "serve_overrides", "eval_overrides"])
def test_cli_overrides_parse_the_same(argv):
    port, ref = _both(argv)
    assert port == ref
    assert port["serve"]["host"] == "0.0.0.0"     # defaults preserved


def test_cli_yaml_with_include(tmp_path):
    (tmp_path / "model.yaml").write_text("batch_size: 16\nlr: 2.0e-4\n")
    main = tmp_path / "main.yaml"
    main.write_text("role: train\ntrain: !include model.yaml\n")
    port, ref = _both(["--config", str(main)])
    assert port == ref and port["train"]["batch_size"] == 16
    port, ref = _both(["--config", str(main), "--train.batch_size", "4"])
    assert port == ref and port["train"]["batch_size"] == 4


def test_cli_rejects_unknown():
    for parse_fn, cls in ((cli.parse, run.RunCfg), (jcli.parse, jrun.RunCfg)):
        with pytest.raises(SystemExit):
            parse_fn(cls, ["--nonexistent.option", "3"])


@pytest.mark.parametrize("role", ["bench"])
def test_unported_roles_stop(role, monkeypatch):
    """Every role of the JAX package is ported: `--role bench` runs the
    port's benchmark on the given device with an empty argument list (the
    command line holds the role's own arguments, which the JAX role passes
    on to bench.py's parser by mistake)."""
    from cover_vla_tpu_torch import bench
    calls = []
    monkeypatch.setattr(bench, "main",
                        lambda argv=None, device=None: calls.append(
                            (argv, device)))
    run.main(["--role", role], device="cpu")
    assert calls == [([], "cpu")]
    run.main(["--role", role, "--device", "cpu"])
    assert calls[1] == ([], "cpu")


def test_unknown_role_stops():
    with pytest.raises(SystemExit, match=r"unknown role.*\|bench\)"):
        run.main(["--role", "dance"])


def _infer_request(rng, cover: bool, first: bool):
    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    if cover:
        obs = {"image": img, "proprio": np.zeros(7, np.float32)}
        if first:
            obs["reset_task"] = "put carrot on plate"
    else:
        obs = {"image": img, "task": "put carrot on plate",
               "state": {"agent": {"eef_pos": np.array(
                   [0.1, 0.0, 0.2, 1.0, 0.0, 0.0, 0.0, 0.6])}}}
    return {"type": "infer", "obs": obs}


@pytest.mark.parametrize("mode", ["pi0", "cover"])
def test_build_server_answers_through_dispatch(tmp_path, mode):
    """--role serve_policy, tiny, from a blob checkpoint (with
    --serve.allow_hash_tokenizer): infer x3, reset, infer, and a
    switch_model through the verb dispatch."""
    pcfg = configs.tiny_pi0_config()
    ck = checkpoints.save_params(str(tmp_path / "p"),
                                 pi0.init_pi0(3, pcfg, device="cpu"))
    serve = run.ServeCfg(mode=mode, tiny=True, n_samples=2, n_rephrases=2,
                         checkpoint=ck, allow_hash_tokenizer=True)
    server = run.build_server(run.RunCfg(role="serve_policy", serve=serve),
                              device="cpu")
    assert server.metadata == {"model": mode}
    rng = np.random.default_rng(0)
    for i in range(3):
        out = server.dispatch(_infer_request(rng, mode == "cover", i == 0))
        assert out["actions"].shape == (7,)
        assert np.isfinite(out["actions"]).all()
    assert server.dispatch({"type": "reset"}) == {"status": "ok"}
    ck2 = checkpoints.save_params(str(tmp_path / "p2"),
                                  pi0.init_pi0(4, pcfg, device="cpu"))
    assert server.dispatch({"type": "switch_model", "path": ck2}) == \
        {"status": "ok"}
    out = server.dispatch(_infer_request(rng, mode == "cover", True))
    assert np.isfinite(out["actions"]).all()


def test_build_server_refusals(tmp_path):
    """A checkpoint without real tokenizer artifacts is refused unless
    --serve.allow_hash_tokenizer; a heads-only merged .pt cannot be the
    first verifier checkpoint (it carries no backbone) — in both
    packages."""
    pcfg, vcfg = configs.tiny_pi0_config(), configs.tiny_verifier_config()
    ck = checkpoints.save_params(str(tmp_path / "p"),
                                 pi0.init_pi0(3, pcfg, device="cpu"))
    with pytest.raises(RuntimeError, match="tokenizer"):
        run.build_server(run.RunCfg(serve=run.ServeCfg(tiny=True,
                                                        checkpoint=ck)),
                         device="cpu")
    pt = str(tmp_path / "heads.pt")
    save_merged_ensemble(pt, verifier.init_verifier(
        2, vcfg, num_members=2, device="cpu")["members"], vcfg)
    with pytest.raises(ValueError, match="heads-only"):
        run.build_server(run.RunCfg(serve=run.ServeCfg(
            mode="cover", tiny=True, verifier_checkpoint=pt)), device="cpu")
    with pytest.raises(ValueError, match="heads-only"):
        jrun.build_server(jrun.RunCfg(serve=jrun.ServeCfg(
            mode="cover", tiny=True, verifier_checkpoint=pt)))
    with pytest.raises(SystemExit, match="quantize"):
        run.build_server(run.RunCfg(serve=run.ServeCfg(tiny=True,
                                                        quantize="int4")),
                         device="cpu")


def test_role_eval_lockstep_over_the_fake_env(tmp_path, capsys):
    """--role eval --eval.n_parallel 2, tiny, policy and verifier from
    blob checkpoints: two lockstep episodes over the fake environment."""
    pcfg, vcfg = configs.tiny_pi0_config(), configs.tiny_verifier_config()
    pck = checkpoints.save_params(str(tmp_path / "p"),
                                  pi0.init_pi0(0, pcfg, device="cpu"))
    vck = checkpoints.save_params(str(tmp_path / "v"), verifier.init_verifier(
        1, vcfg, num_members=3, device="cpu"))
    cfg = run.RunCfg(role="eval", eval=run.EvalCfg(
        task_suite="simpler_carrot_on_plate", num_trials_per_task=2,
        max_steps=8, n_samples=2, n_rephrases=2, n_parallel=2, tiny=True,
        policy_checkpoint=pck, verifier_checkpoint=vck,
        allow_hash_tokenizer=True, out_dir=str(tmp_path / "out")))
    run.role_eval(cfg, device="cpu")
    out = json.loads(capsys.readouterr().out)
    assert out["total_episodes"] == 2
    assert 0.0 <= out["overall_success_rate"] <= 1.0
    assert out["actions_per_sec"] > 0


def test_tree_utils_match_the_jax_package():
    import jax
    import jax.numpy as jnp
    import torch
    from cover_vla_tpu import configs as jconfigs
    from cover_vla_tpu import utils as jutils
    from cover_vla_tpu.models import pi0 as jpi0
    from cover_vla_tpu_torch import utils
    from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax

    jp = jpi0.init_pi0(jax.random.PRNGKey(0), jconfigs.tiny_pi0_config())
    cfg = configs.tiny_pi0_config()
    tp = pi0_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                      device="cpu")
    assert utils.count_params(tp) == jutils.count_params(jp)
    assert utils.param_bytes(tp) == jutils.param_bytes(jp)
    cast = utils.cast_tree(tp, torch.float32)
    want = pi0_from_jax(jax.tree_util.tree_map(
        np.asarray, jutils.cast_tree(jp, jnp.float32)), cfg, device="cpu")
    from tests.test_torch_convert import assert_trees_equal
    assert_trees_equal(cast, want)
    assert utils.param_bytes(cast) == jutils.param_bytes(
        jutils.cast_tree(jp, jnp.float32))
    assert utils.get_class_from_path(
        "cover_vla_tpu_torch.run.RunCfg") is run.RunCfg


def test_metrics_sink_and_monitor(tmp_path):
    """The JSONL sink writes the JAX package's record schema; the monitor
    utilities time, log, silence stdout, report no CUDA memory as
    unavailable and write a profiler trace."""
    import logging
    import torch
    from cover_vla_tpu.utils import metrics_sink as jsink
    from cover_vla_tpu_torch.utils import metrics_sink, monitor

    records = []
    for mod, name in ((metrics_sink, "port.jsonl"), (jsink, "jax.jsonl")):
        sinks = mod.make_sinks(jsonl_path=str(tmp_path / name))
        sinks.log({"loss": np.float32(0.5), "top1": 1}, step=3)
        sinks.log({"val/loss": 0.25})
        sinks.close()
        with open(tmp_path / name) as f:
            recs = [json.loads(line) for line in f]
        records.append([{k: v for k, v in r.items() if k != "_time"}
                        for r in recs])
    assert records[0] == records[1]

    timer = monitor.Timer()
    assert timer.elapsed() >= 0.0
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    logger = monitor.setup_logger("cover_vla_tpu_torch.test_monitor")
    logger.addHandler(Keep())
    logger.info("ready")
    assert seen == ["ready"]
    if not torch.cuda.is_available():
        assert monitor.log_device_memory() == {"cuda": {
            "available": False, "reason": "no CUDA device in this process"}}
    with monitor.blockprint():
        print("hidden")
    with monitor.profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert os.path.isfile(tmp_path / "trace" / "trace.json")
