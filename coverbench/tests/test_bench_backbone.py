"""A configuration's backbone module, found by name: the split reference
computes the bits the reference computed before the split, and a backbone
registered under another name, with hand kernels of its own and neither K1
nor K3, reaches every consumer with no other file touched."""

import copy
import json
import os
import sys
import time
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from coverbench import backbones, fake_env, harness, reference, trace
from coverbench import run as run_mod
from coverbench import yardstick
from coverbench.backbones import gemma
from coverbench.tests import frozen_reference
from coverbench.tests.tiny import (episode_inputs, make_weights, tiny_cell,
                                   tiny_config)


@pytest.mark.parametrize("dtype, levels", [("float32", None),
                                           ("bfloat16", None),
                                           ("bfloat16", 127)])
def test_split_reference_is_bit_equal(dtype, levels):
    torch.set_num_threads(2)
    cell = tiny_cell("w8a8" if levels else "bf16")
    cfg = copy.deepcopy(cell.config)
    cfg["dtype"] = dtype
    wts = make_weights(cfg, cell, gemma)
    args = (wts, cfg, *episode_inputs(cfg, cell))
    new = reference.episode(*args, levels, "cpu")
    old = frozen_reference.episode(*args, levels, "cpu")
    assert set(new) == set(old)
    for key in old:
        assert torch.equal(new[key], old[key]), key


def test_missing_backbone_names_its_file():
    with pytest.raises(FileNotFoundError,
                       match="coverbench/backbones/no_such_stack.py"):
        backbones.load({"name": "x", "backbone": "no_such_stack"})


LATENT = "void latent_decode<576>(P)"


@pytest.fixture
def doubled(monkeypatch):
    """A backbone registered as `gemma_doubled`: Gemma with its prompt
    embeddings doubled in the reference, a visible mark on each other
    hook, and one hand kernel of its own, K9, in place of K1 and K3."""
    from cover_vla_tpu_torch.configs import replace
    mod = types.ModuleType("coverbench.backbones.gemma_doubled")
    mod.__dict__.update({k: v for k, v in vars(gemma).items()
                         if not k.startswith("__")})

    def port_configs(config, traffic):
        pcfg, *rest = gemma.port_configs(config, traffic)
        return (replace(pcfg, attention_impl="eager"), *rest)

    def embed(pw, pol, image, ids, num):
        img, txt = gemma.embed(pw, pol, image, ids, num)
        return 2 * img, [2 * t for t in txt]

    def weight_rule(path, shape):
        if path[-1] == "final_norm":
            return 0.0, 0.5
        return gemma.weight_rule(path, shape)

    mod.port_configs, mod.embed, mod.weight_rule = (port_configs, embed,
                                                    weight_rule)
    mod.policy_flops = lambda policy, k, n: gemma.policy_flops(
        policy, k, n) + 1.0
    mod.KERNELS = {"K9": lambda name: "latent_decode<" in name}
    mod.kernel_work = lambda policy, rows, n: {"K9": (1.0, 2.0, 3)}
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def test_backbone_found_by_name(doubled):
    mod = doubled
    cell = tiny_cell()
    cfg = copy.deepcopy(cell.config)
    cfg["backbone"] = "gemma_doubled"
    assert backbones.load(cfg) is mod

    pcfg = harness.port_configs(cfg, cell.traffic)[0]
    assert pcfg.attention_impl == "eager"

    wts = make_weights(cfg, cell, mod)
    assert bool((wts["policy"]["expert"]["final_norm"] == 0.5).all())
    base = make_weights(cell.config, cell, gemma)
    assert not bool((base["policy"]["expert"]["final_norm"] == 0.5).all())

    args = (wts, *episode_inputs(cfg, cell))
    ours = reference.episode(args[0], cfg, *args[1:], None, "cpu")
    theirs = reference.episode(args[0], cell.config, *args[1:], None, "cpu")
    assert not torch.equal(ours["actions"], theirs["actions"])

    assert yardstick.analytic_flops(cfg, 2, 3, 4) == pytest.approx(
        yardstick.analytic_flops(cell.config, 2, 3, 4) + 4.0)

    e, k = cell.traffic["episodes_per_cohort"], cell.traffic["n_rephrases"]
    b = SimpleNamespace(lang_tokens=np.zeros((e, k, 8), np.int32),
                        originals=[fake_env.TASK_INSTRUCTIONS[t]
                                   for t in fake_env.ID_TASKS][:e],
                        cohort=0, generation=0, in_episode=0)
    work = harness.kernel_work([b], [b], cfg, {}, k, 2)
    assert work["K9"] == [3.0, 6.0, 3]
    assert set(work) == {"K2", "K9"}

    k1 = "void (anonymous namespace)::decode_wgmma_kernel<256>(P)"
    for name, ours_, gemmas in ((LATENT, "K9", "other"), (k1, "other", "K1")):
        ev = {"ph": "X", "cat": "kernel", "name": name, "ts": 0, "dur": 5,
              "args": {}}
        assert yardstick.category(ev, None, mod.KERNELS) == ours_
        assert yardstick.category(ev, None, gemma.KERNELS) == gemmas
    s = trace.summarize({"traceEvents": [ev]}, 1e-5, 1, mod.KERNELS)
    assert s["by_category"]["other"]["launches"] == 1


def _with_device_events(exported):
    """The CPU build's profiler traces no device: the exported trace with
    device kernels added under the host's first operator, K1's and K3's
    symbols among them."""
    def wrap(prof):
        t = exported(prof)
        ops = [e for e in t["traceEvents"] if e.get("cat") == "cpu_op"]
        t0 = float(ops[0]["ts"])
        names = ("void (anonymous namespace)::decode_wgmma_kernel<256>(P)",
                 "void (anonymous namespace)::flash_wgmma_kernel<256, 2, "
                 "true>(W)", LATENT, "nvjet_tst_64x96_h_bz_NNT",
                 "void at::native::elementwise_kernel<128, 2>(f)")
        t["traceEvents"] += [
            {"ph": "X", "cat": "kernel", "name": n, "ts": t0 + 10 * i,
             "dur": 5, "tid": 7, "args": {}} for i, n in enumerate(names)]
        return t
    return wrap


def test_backbone_without_k1_k3_reads_every_per_layer_metric(doubled,
                                                             monkeypatch):
    """A traced run of a cell whose backbone has neither K1 nor K3: every
    per-layer reader BENCHMARK.json names reads the run's context, and the
    rooflines of kernels the backbone does not run read nothing."""
    torch.set_num_threads(2)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        per_layer = json.load(f)["per_layer"]
    monkeypatch.setattr(harness, "_exported",
                        _with_device_events(harness._exported))
    cell = tiny_cell(ticks=16)
    cell.config["backbone"] = "gemma_doubled"
    cell.per_layer = per_layer
    names = [m["name"] for m in per_layer]
    out = harness.run(cell, 13, 1.0, True, "cpu", time.perf_counter(),
                      metric_readers=run_mod.metric_readers(names))
    # the reference doubles the prompt embeddings, the program does not
    assert not out.correct
    assert "k1_roofline" not in out.metrics
    assert "k3_roofline" not in out.metrics
    assert out.metrics["launches_per_boundary"]["value"] > 0
    assert out.device["busy_s"] > 0
