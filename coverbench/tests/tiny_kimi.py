"""The Kimi-VL configuration at tiny widths for the CPU tests: the
configuration file's structure, three layers (one dense, two of 8
experts, top 3, 1 shared: the last layer's feed-forward feeds no cache,
so one MoE layer alone would not reach the actions) and an MLA expert of
the same attention geometry, with the tiny vision tower, verifier and mix
of `tiny.py`."""

from __future__ import annotations

import copy
import json
import os

from coverbench import harness
from coverbench.tests.tiny import tiny_cell

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLA = dict(num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, rope_theta=10000)


def full_config() -> dict:
    with open(os.path.join(HERE, "configs", "pi0_kimivl_bf16.json")) as f:
        return json.load(f)


def tiny_kimi_config(dtype: str = "bfloat16") -> dict:
    cfg = full_config()
    small = tiny_cell().config
    cfg["dtype"] = dtype
    pol = cfg["policy"]
    pol["paligemma"].update(hidden_size=64, num_hidden_layers=3,
                            intermediate_size=128, moe_intermediate_size=32,
                            n_routed_experts=8, num_experts_per_tok=3,
                            n_shared_experts=1, vocab_size=1024, **MLA)
    pol["expert"].update(hidden_size=32, num_hidden_layers=3,
                         intermediate_size=64, **MLA)
    for key in ("vision", "proj_width", "num_denoise_steps",
                "tokenizer_max_length"):
        pol[key] = copy.deepcopy(small["policy"][key])
    cfg["verifier"] = copy.deepcopy(small["verifier"])
    return cfg


def tiny_kimi_cell(dtype: str = "bfloat16", **kw) -> harness.Cell:
    cell = tiny_cell(**kw)
    cell.config = tiny_kimi_config(dtype)
    return cell
