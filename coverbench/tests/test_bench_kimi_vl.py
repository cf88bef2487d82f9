"""The `kimi_vl` backbone: its configuration file against the published
config.json's keys, a traced tiny CPU run that reads every per-layer
metric its cell owes (the MoE's and the latent decode's among them, and
no K1 or K3 roofline), the reference's isolation from the program, and
the model FLOPs and the kernels' work against hand counts at the full
configuration."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from coverbench import harness, reference, yardstick
from coverbench import run as run_mod
from coverbench.backbones import kimi_vl
from coverbench.tests.tiny import episode_inputs, make_weights
from coverbench.tests.tiny_kimi import full_config, tiny_kimi_cell

CELL = "pi0_kimivl_bf16.E64_N5_K8"
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

# Kimi-VL-A3B-Instruct's text config as its config.json publishes it
PUBLISHED = {
    "vocab_size": 163840, "max_position_embeddings": 131072,
    "hidden_size": 2048, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "n_shared_experts": 2, "n_routed_experts": 64,
    "ep_size": 1, "routed_scaling_factor": 2.446, "kv_lora_rank": 512,
    "q_lora_rank": None, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "qk_nope_head_dim": 128, "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "num_experts_per_tok": 6, "moe_layer_freq": 1,
    "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "seq_aux": True, "num_key_value_heads": 16,
    "hidden_act": "silu", "rms_norm_eps": 1e-05, "rope_theta": 800000,
    "rope_scaling": None, "attention_bias": False,
    "tie_word_embeddings": False}


def test_configuration_is_the_published_one():
    cfg = full_config()
    for key, value in PUBLISHED.items():
        assert cfg[key] == value, key
        assert cfg["policy"]["paligemma"][key] == value, key
    assert set(cfg["policy"]["paligemma"]) == set(PUBLISHED)
    traffic = {"n_samples": 5, "n_rephrases": 8}
    pcfg = kimi_vl.port_configs(cfg, traffic)[0]
    lm = pcfg.paligemma
    assert (lm.width, lm.depth, lm.num_heads, lm.mlp_dim, lm.kv_lora_rank,
            lm.qk_nope_dim, lm.qk_rope_dim, lm.v_head_dim, lm.num_experts,
            lm.experts_per_token, lm.moe_dim, lm.num_shared_experts,
            lm.first_dense, lm.routed_scaling, lm.vocab_size, lm.rope_theta,
            lm.rms_eps) == (2048, 27, 16, 11264, 512, 128, 64, 128, 64, 6,
                            1408, 2, 1, 2.446, 163840, 800000.0, 1e-5)
    assert (lm.num_dense, lm.num_moe) == (1, 26)
    assert pcfg.attention_impl == "cuda"
    ex = pcfg.expert
    assert (ex.width, ex.depth, ex.num_heads, ex.mlp_dim, ex.num_experts,
            ex.kv_lora_rank, ex.qk_head_dim, ex.v_head_dim) == \
        (1024, 27, 16, 4096, 0, 512, 192, 128)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == []
    bad = dict(cfg["policy"]["paligemma"], scoring_func="softmax")
    with pytest.raises(ValueError, match="scoring_func"):
        kimi_vl.port_stack(bad)


def test_weights_draw_norms_around_one_and_a_bias():
    cell = tiny_kimi_cell()
    wts = make_weights(cell.config, cell, kimi_vl)["policy"]["paligemma"]
    for name in ("input_ln", "kv_ln", "post_ln"):
        w = wts["layers"][name].float()
        assert 0.9 < w.mean().item() < 1.1 and w.std().item() > 0.05
    bias = wts["moe"]["bias"]
    assert bias.dtype == torch.float32 and bias.std().item() > 0.02


def _with_device_events(exported):
    """The CPU build's profiler traces no device: the exported trace with
    device kernels added, each joined through `External id` to a host
    operator: K2, K3, a GEMM and an elementwise kernel under the first
    operator, an elementwise kernel at the start of each prefix, denoise
    and tower span, the routed experts' grouped product under each
    `moe.block` span and an elementwise kernel under each `mla.decode`
    span."""
    def wrap(prof):
        t = exported(prof)
        events = t["traceEvents"]
        ops = [e for e in events if e.get("cat") == "cpu_op"
               and "External id" in e.get("args", {})]
        added = []

        def kernel(name, op, dur=5):
            added.append({"ph": "X", "cat": "kernel", "name": name,
                          "ts": float(op["ts"]) + 1, "dur": dur, "tid": 7,
                          "args": {"External id": op["args"]["External id"]}})

        first = ops[0]
        for name in ("void (anonymous namespace)::flash_wgmma_kernel<64, 3, "
                     "false>(W)", "void (anonymous namespace)::flash_wgmma_"
                     "kernel<256, 2, true>(W)", "nvjet_tst_64x96_h_bz_NNT",
                     "void at::native::elementwise_kernel<128, 2>(f)"):
            kernel(name, first)
        moe_gemm = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_"
                    "kernel_for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17"
                    "GroupProblemShapeIN4cute5tupleIJiiiEEEEE")
        ew = "void at::native::elementwise_kernel<128, 4>(f)"
        # an operator of each span: the first one of an outer span (before
        # any inner span opens), the last one of an inner span
        for span, name, at in (("pi0.prefix", ew, 0), ("pi0.denoise", ew, 0),
                               ("step.verifier_towers", ew, 0),
                               ("moe.block", moe_gemm, -1),
                               ("mla.decode", ew, -1)):
            for s in (e for e in events if e.get("cat") == "user_annotation"
                      and e.get("name") == span):
                inside = [o for o in ops if o.get("tid") == s.get("tid")
                          and s["ts"] <= o["ts"] <= s["ts"] + s["dur"]]
                kernel(name, inside[at])
        events += added
        return t
    return wrap


def test_traced_run_reads_every_metric_the_cell_owes(monkeypatch):
    torch.set_num_threads(2)
    owed = harness.load_cell(CELL).per_layer
    names = [m["name"] for m in owed]
    assert {"moe_ms_per_boundary", "mla_decode_ms_per_boundary",
            "moe_gemm_roofline"} <= set(names)
    assert "k1_roofline" not in names and "k3_roofline" not in names
    monkeypatch.setattr(harness, "_exported",
                        _with_device_events(harness._exported))
    for table, peak in ((yardstick.PEAK_FLOPS, 989e12),
                        (yardstick.PEAK_HBM_BYTES, 3.35e12)):
        monkeypatch.setitem(table, "cpu", peak)
    cell = tiny_kimi_cell(ticks=16)
    cell.per_layer = owed
    out = harness.run(cell, 2 ** 33 + 17, 1.0, True, "cpu",
                      time.perf_counter(),
                      metric_readers=run_mod.metric_readers(names))
    assert out.correct, out.compared
    assert set(out.metrics) == set(names), set(names) - set(out.metrics)
    assert out.metrics["moe_ms_per_boundary"]["value"] > 0
    assert out.metrics["mla_decode_ms_per_boundary"]["value"] > 0
    # the Gemma path's copies (25 at 10 Euler steps): the frames' 10, the
    # suffix mask and one a step, 4 for the verifier; the MoE and the
    # latent decode add none
    steps = cell.config["policy"]["num_denoise_steps"]
    assert out.metrics["h2d_copies_per_boundary"]["value"] == 15 + steps


def test_reference_imports_nothing_of_the_program(tmp_path):
    """The Kimi-VL reference runs a whole episode, in bf16 and on the int4
    grid of the control, in a process where neither the program nor the
    JAX package can be imported, bit-equal to this process's run."""
    torch.set_num_threads(2)
    cell = tiny_kimi_cell()
    args = (make_weights(cell.config, cell, kimi_vl), cell.config,
            *episode_inputs(cell.config, cell))
    torch.save(args, tmp_path / "args.pt")
    code = ("import sys, torch; torch.set_num_threads(2); "
            "sys.modules['cover_vla_tpu_torch'] = None; "
            "sys.modules['cover_vla_tpu'] = None; "
            "from coverbench import reference; "
            "args = torch.load(sys.argv[1], weights_only=False); "
            "torch.save({lv: reference.episode(*args, lv, 'cpu') "
            "for lv in (None, 7)}, sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "args.pt"),
                    str(tmp_path / "out.pt")], cwd=ROOT, check=True,
                   timeout=300)
    got = torch.load(tmp_path / "out.pt")
    for levels, out in got.items():
        want = reference.episode(*args, levels, "cpu")
        for key in want:
            assert torch.equal(out[key], want[key]), (levels, key)
    assert not torch.equal(got[None]["actions"], got[7]["actions"])


def test_policy_flops_and_kernel_work_by_hand():
    pol = full_config()["policy"]
    k, n = 8, 5
    p_len, s_len, steps = 256 + 72, 5, 10
    # per layer: q 2048 x 16 x 192, kv_a 2048 x 576, kv_b 512 x 16 x 256,
    # o 2048 x 2048
    attn = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    assert attn == 13_762_560
    # layer 0: SwiGLU 3 x 2048 x 11264; layers 1-26: router 2048 x 64,
    # 6 routed + 2 shared experts of 3 x 2048 x 1408
    lm = 27 * attn + 3 * 2048 * 11264 + 26 * (2048 * 64 + 8 * 3 * 2048 * 1408)
    expert = 27 * (1024 * 3072 + 1024 * 576 + 512 * 4096 + 2048 * 1024
                   + 3 * 1024 * 4096)
    prefill = 2 * lm * k * p_len + 2 * 27 * k * p_len * p_len * 16 * 320
    dec = steps * k * n * s_len
    decode = 2 * expert * dec + 2 * 27 * dec * (p_len + s_len) * 16 * 320
    assert kimi_vl.policy_flops(pol, k, n) == pytest.approx(prefill + decode,
                                                            rel=1e-12)
    # a boundary of 64 episodes: ~0.93 PFLOP in the backbone and expert
    assert 0.9e15 < 64 * (prefill + decode) < 0.96e15

    rows = [256 + 12] * 300 + [256 + 20] * 212            # 512 prompts
    work = kimi_vl.kernel_work(pol, rows, n)
    tokens = 512 * p_len
    routed = tokens * 6
    moe_flops = 26 * 2 * routed * 3 * 2048 * 1408
    moe_bytes = 26 * (64 * 3 * 2048 * 1408 * 2
                      + routed * (2048 + 2816 + 1408 + 2048) * 2)
    nbytes, flops, launches = work["MOE"]
    # 167,936 tokens a layer in 6 passes of 32,768, two products a pass
    assert launches == 2 * 26 * 6
    assert nbytes * launches == pytest.approx(moe_bytes, rel=1e-12)
    assert flops * launches == pytest.approx(moe_flops, rel=1e-12)
    k3_bytes, k3_flops, k3_launches = work["K3"]
    pairs = 300 * 268 ** 2 + 212 * 276 ** 2
    assert k3_launches == 27
    assert k3_flops == pytest.approx(4 * 16 * 192 * pairs, rel=1e-12)
    q = 512 * p_len * 16 * 192 * 2
    assert k3_bytes == pytest.approx(2 * q + 2 * q + 512 * p_len * p_len)
    # the symbols the trace names them by
    grouped = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel"
               "_for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblem"
               "ShapeIN4cute5tupleIJiiiEEEE")
    k3 = "void (anonymous namespace)::flash_wgmma_kernel<256, 2, true>(W)"
    ev = {"cat": "kernel", "args": {}}
    assert yardstick.category(dict(ev, name=grouped), None,
                              kimi_vl.KERNELS) == "MOE"
    assert yardstick.category(dict(ev, name=k3), None,
                              kimi_vl.KERNELS) == "K3"
    assert yardstick.category(
        dict(ev, name="void at::cuda::detail::prepare_grouped_gemm_data<"
             "cutlass::bfloat16_t>(x)"), None, kimi_vl.KERNELS) == "gemm_bf16"


def test_moe_launches_follow_the_programs_passes():
    """`moe_work` declares the grouped products the program launches: two
    a pass of the program's chunk of tokens, so `moe_gemm_roofline`'s
    share of kept launches compares like with like."""
    from cover_vla_tpu_torch.models import mla_moe
    assert kimi_vl.MOE_CHUNK_TOKENS == mla_moe.MOE_CHUNK_TOKENS
    g = full_config()["policy"]["paligemma"]
    chunk = kimi_vl.MOE_CHUNK_TOKENS
    one, two = kimi_vl.moe_work(g, chunk), kimi_vl.moe_work(g, chunk + 1)
    assert (one[2], two[2]) == (2 * 26, 2 * 26 * 2)
    assert two[1] / one[1] == pytest.approx((chunk + 1) / chunk, rel=1e-12)


def test_reference_prefill_keeps_every_head_and_layer():
    """The reference's cache is the explicit keys [c W_UK | k_pe] (the
    rope key the same for every head) and values of every layer."""
    cell = tiny_kimi_cell()
    cfg = cell.config
    pw = make_weights(cfg, cell, kimi_vl)["policy"]
    pol = cfg["policy"]
    g = pol["paligemma"]
    p_len = 7
    emb = torch.randn(2, p_len, g["hidden_size"])
    pos = torch.arange(p_len).expand(2, p_len)
    mask = torch.ones(2, p_len, p_len, dtype=torch.bool)
    cache = kimi_vl.prefill(pw, pol, emb, pos, mask,
                            reference.Numerics("float32"))
    assert len(cache) == g["num_hidden_layers"]
    k, v = cache[0]
    assert k.shape == (2, p_len, 4, 24) and v.shape == (2, p_len, 4, 16)
    assert torch.equal(k[..., 16:], k[:, :, :1, 16:].expand_as(k[..., 16:]))
