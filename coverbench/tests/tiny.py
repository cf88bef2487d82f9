"""A cell at tiny widths for the CPU tests: the configuration files'
structure with the program's tiny test sizes, and a small traffic mix;
one episode's inputs and the weights for the reference at those sizes."""

from __future__ import annotations

import copy
import json
import os

import torch

from coverbench import fake_env, harness, weights

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_config(route: str = "bf16") -> dict:
    with open(os.path.join(HERE, "configs", "pi0_cover_bf16.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["gemm_route"] = route
    pol = cfg["policy"]
    pol["paligemma"].update(width=64, depth=2, mlp_dim=128, num_heads=4,
                            num_kv_heads=1, head_dim=16, vocab_size=1024)
    pol["expert"].update(width=32, depth=2, mlp_dim=64, num_heads=4,
                         num_kv_heads=1, head_dim=16)
    pol["vision"].update(width=32, depth=2, mlp_dim=64, num_heads=4,
                         patch_size=14, image_size=56)
    pol.update(proj_width=32, num_denoise_steps=3, tokenizer_max_length=8)
    ver = cfg["verifier"]
    ver["vision"].update(width=32, depth=2, mlp_dim=64, num_heads=4,
                         patch_size=16, image_size=64)
    ver["text"].update(width=32, depth=2, mlp_dim=64, num_heads=4,
                       vocab_size=512, context_length=16, embed_dim=32)
    ver.update(members=2, text_pooling_output_dim=16,
               vision_pooling_output_dim=16, pooling_heads=4,
               pooling_layers=2, traj_layers=2, traj_heads=4)
    return cfg


def tiny_cell(route: str = "bf16", e: int = 4, n: int = 2, k: int = 2,
              ticks: int = 8, limits=None) -> harness.Cell:
    traffic = {"name": "tiny", "episodes_per_cohort": e, "cohorts": 2,
               "n_samples": n, "n_rephrases": k, "episode_ticks": ticks}
    limits = dict({"sample": {"boundaries": 3, "episodes_per_boundary": 2},
                   "flip_margin": 0.1},
                  **(limits or {"action_rms": 0.05, "score_gap": 0.05,
                                "action_gap": 0.1, "pick_mismatch": 0,
                                "decode_mismatch": 0, "vote_mismatch": 0,
                                "engine_mismatch": 0}))
    return harness.Cell(
        name="tiny", config=tiny_config(route), traffic=traffic,
        limits=limits,
        end_to_end=[{"name": "verified_actions_per_s", "unit": "actions/s"},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[], chips=1)


def episode_inputs(cfg, cell, seed=3):
    """One episode's inputs, as the comparison hands them to the
    reference."""
    pol = cfg["policy"]
    k, n = cell.traffic["n_rephrases"], cell.traffic["n_samples"]
    env = fake_env.FakeWidowXEnv(fake_env.ID_TASKS[1])
    obs = env.reset(seed)
    task = env.instruction
    gen = torch.Generator().manual_seed(seed)
    hist = torch.randn(cfg["cover"]["max_history"], 7, generator=gen)
    noise = torch.randn(k, n, pol["chunk_size"], pol["max_action_dim"],
                        generator=gen)
    stats = {"action": {"p01": [-0.05] * 6 + [0.0],
                        "p99": [0.05] * 6 + [1.0]},
             "proprio": {"p01": [-0.3] * 7, "p99": [0.3] * 7}}
    return (stats, obs["image"], fake_env.proprio(obs["eef_pos"]),
            [task, "pick up the thing", task][:k], task, hist.numpy(), 3,
            noise)


def make_weights(cfg, cell, bb, seed=5):
    """The benchmark's weights for a configuration, in the program's tree
    layout, on the CPU."""
    from cover_vla_tpu_torch.models import verifier
    pcfg, vcfg, _, members = bb.port_configs(cfg, cell.traffic)
    meta = {"policy": bb.policy_meta(pcfg),
            "verifier": verifier.init_verifier(0, vcfg, members,
                                               device="meta")}
    return weights.make(meta, seed, "cpu", bb)
