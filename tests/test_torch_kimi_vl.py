"""π0 over Kimi-VL-A3B's MLA + MoE language model (`models/mla_moe.py`,
`ops/moe.py`, `ops/mla.py`) against the benchmark's plain reference
(`coverbench/backbones/kimi_vl.py`) at tiny widths on the CPU: the MoE
layer, the routing's semantics, the absorbed decode against explicit
up-projected attention, K3's twin at head dim 192 with padded values,
`pi0.sample_actions` end to end in fp32 and bf16, three faults that the
comparison must see, the spans, and the refusals. Kernel-on-card tests
carry the `cuda` marker and skip without a GPU."""

import copy
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from coverbench import reference, weights
from coverbench.backbones import kimi_vl
from coverbench.tests.tiny_kimi import tiny_kimi_config
from cover_vla_tpu_torch.configs import (
    fast_pi0_config, replace, tiny_kimi_pi0_config, tiny_pi0_config)
from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
from cover_vla_tpu_torch.engine.verified_step import _policy_image
from cover_vla_tpu_torch.models import mla_moe, pi0, verifier
from cover_vla_tpu_torch.ops import cuda_attention, mla, moe
from cover_vla_tpu_torch.utils import monitor

TRAFFIC = {"n_samples": 2, "n_rephrases": 3}
K, N = TRAFFIC["n_rephrases"], TRAFFIC["n_samples"]
# fp32 on both sides: the same math in another order (explicit keys
# against absorbed queries, one loop per expert against grouped products)
FP32_TOL = 2e-5


def _leaves(tree, fn):
    return {k: (_leaves(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    """The tiny configuration, the benchmark's weights for it (bf16 and a
    float32 copy), and one episode's inputs."""
    torch.set_num_threads(2)
    cfg = tiny_kimi_config("bfloat16")
    pcfg, vcfg, _, members = kimi_vl.port_configs(cfg, TRAFFIC)
    meta = {"policy": kimi_vl.policy_meta(pcfg),
            "verifier": verifier.init_verifier(0, vcfg, members,
                                               device="meta")}
    wts = weights.make(meta, 11, "cpu", kimi_vl)
    from coverbench import fake_env
    env = fake_env.FakeWidowXEnv(fake_env.ID_TASKS[2])
    obs = env.reset(5)
    task = env.instruction
    prompts = [task, "grab the object and move it", task + " now"][:K]
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn(K, N, pcfg.chunk_size, pcfg.max_action_dim,
                        generator=gen)
    stats = {"action": {"p01": [-0.05] * 6 + [0.0],
                        "p99": [0.05] * 6 + [1.0]},
             "proprio": {"p01": [-0.3] * 7, "p99": [0.3] * 7}}
    return dict(cfg=cfg, pcfg=pcfg, wts=wts["policy"],
                wts32=_leaves(wts["policy"], lambda t: t.float()),
                raw=obs["image"], proprio=fake_env.proprio(obs["eef_pos"]),
                prompts=prompts, noise=noise, stats=stats)


def _program(s, pcfg, pw, **kw):
    """The port's sample_actions on the episode -> [K * N, chunk, 7]."""
    pol = s["cfg"]["policy"]
    img = _policy_image(torch.from_numpy(s["raw"])[None],
                        pol["vision"]["image_size"])
    tok = HashTokenizer(pol["paligemma"]["vocab_size"])
    toks, masks = tok.encode_batch(s["prompts"], pol["tokenizer_max_length"])
    st = s["stats"]["proprio"]
    p01, p99 = (torch.tensor(st[k]) for k in ("p01", "p99"))
    prop = torch.from_numpy(np.asarray(s["proprio"], np.float32))
    state = torch.zeros(1, pcfg.max_state_dim)
    state[0, :7] = (2 * (prop - p01) / (p99 - p01 + 1e-8) - 1).clamp(-1, 1)
    with torch.no_grad():
        out = pi0.sample_actions(
            pi0.ParamTree(pw), pcfg, img[:, None],
            torch.ones((1, 1), dtype=torch.bool), torch.from_numpy(toks),
            torch.from_numpy(masks), state.expand(K, -1), num_candidates=N,
            noise=s["noise"], **kw)
    return out[..., :7].reshape(K * N, pcfg.chunk_size, 7)


def _reference(s, dtype, pw):
    cfg = copy.deepcopy(s["cfg"])
    cfg["dtype"] = dtype
    num = reference.Numerics(dtype)
    with torch.no_grad():
        actions, _, _ = reference.propose(
            pw, cfg["policy"], s["stats"], s["raw"], s["proprio"],
            s["prompts"], s["noise"], num, "cpu", kimi_vl)
    return actions


def _fp32_config(pcfg):
    return replace(pcfg, compute_dtype="float32", attention_impl="eager",
                   decode_attn_impl="eager",
                   vision=replace(pcfg.vision, attn_impl="eager"))


# ---------------------------------------------------------------------------
# The MoE layer and its routing
# ---------------------------------------------------------------------------


def _moe_layer(seed=0, t=40, w=32, e=8, m=16, ms=16):
    g = torch.Generator().manual_seed(seed)
    lw = {"router": torch.randn(w, e, generator=g) * w ** -0.5,
          "bias": torch.randn(e, generator=g) * 0.05,
          "gate_up": torch.randn(e, w, 2 * m, generator=g) * w ** -0.5,
          "down": torch.randn(e, m, w, generator=g) * m ** -0.5,
          "shared_gate_up": torch.randn(w, 2 * ms, generator=g) * w ** -0.5,
          "shared_down": torch.randn(ms, w, generator=g) * ms ** -0.5}
    gcfg = {"num_experts_per_tok": 3, "routed_scaling_factor": 2.446,
            "n_routed_experts": e}
    return torch.randn(t, w, generator=g), lw, gcfg


def test_moe_layer_given_the_references_routing():
    x, lw, g = _moe_layer()
    num = reference.Numerics("float32")
    routing = kimi_vl._route(lw, g, x)
    want = kimi_vl._moe(lw, g, x, num, routing)
    got = moe.routed_experts(x, *routing, lw["gate_up"], lw["down"]) \
        + moe.swiglu(x, lw["shared_gate_up"], lw["shared_down"])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_moe_layer_end_to_end():
    """The program's route, dispatch, grouped products and combine, in
    the stack's chunks, against the reference's router and loop."""
    x, lw, g = _moe_layer(seed=1, t=70)
    cfg = replace(tiny_kimi_pi0_config().paligemma, width=32, moe_dim=16,
                  num_shared_experts=1, experts_per_token=3)
    params = {"moe": {k: v[None] for k, v in lw.items()}}
    old = mla_moe.MOE_CHUNK_TOKENS
    try:
        mla_moe.MOE_CHUNK_TOKENS = 32      # three chunks, the last short
        got = mla_moe._ffn(params, cfg, cfg.num_dense, x)
    finally:
        mla_moe.MOE_CHUNK_TOKENS = old
    want = kimi_vl._moe(lw, g, x, reference.Numerics("float32"))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_routing_semantics():
    x, lw, g = _moe_layer(seed=2, t=64)
    scores = torch.sigmoid(x @ lw["router"])
    idx, w = moe.route(x, lw["router"], torch.zeros(8), 3, 2.446)
    # times the scaling; normalised to 1 before it
    torch.testing.assert_close(w.sum(-1), torch.full((64,), 2.446))
    torch.testing.assert_close(
        w, scores.gather(-1, idx) / scores.gather(-1, idx).sum(-1, True)
        * 2.446)
    # a bias on an expert that none chose makes every token choose it,
    # and its weight is still its score's, not score + bias
    unchosen = [e for e in range(8) if not (idx == e).any()]
    target = unchosen[0] if unchosen else int(scores.mean(0).argmin())
    bias = torch.zeros(8)
    bias[target] = 10.0
    idx_b, w_b = moe.route(x, lw["router"], bias, 3, 2.446)
    assert bool((idx_b == target).any(-1).all())
    picked = scores.gather(-1, idx_b)
    torch.testing.assert_close(
        w_b, picked / picked.sum(-1, keepdim=True) * 2.446)
    assert not torch.equal(idx_b, idx)


# ---------------------------------------------------------------------------
# Attention: the absorbed decode, K3's twin at head dim 192
# ---------------------------------------------------------------------------


def _explicit_decode(q_nope, q_pe, k_nope, k_pe, v, kv_pre, w_uk, w_uv,
                     prefix_pad, suffix_mask):
    """Joint attention over explicit up-projected prefix keys and values."""
    b, n, s, h, dn = q_nope.shape
    r = w_uk.shape[0]
    c, kp = kv_pre[..., :r], kv_pre[..., r:]
    k_pre = torch.cat([torch.einsum("bpr,rhd->bphd", c, w_uk),
                       kp[:, :, None].expand(-1, -1, h, -1)], -1)
    v_pre = torch.einsum("bpr,rhd->bphd", c, w_uv)
    q = torch.cat([q_nope, q_pe], -1)
    k_suf = torch.cat([k_nope, k_pe[..., None, :].expand(-1, -1, -1, h, -1)],
                      -1)
    scale = q.shape[-1] ** -0.5
    s_pre = torch.einsum("bnshd,bphd->bnshp", q, k_pre) * scale
    s_pre = s_pre.masked_fill(~prefix_pad[:, None, None, None], -1e30)
    s_suf = torch.einsum("bnshd,bnthd->bnsht", q, k_suf) * scale
    s_suf = s_suf.masked_fill(~suffix_mask[:, None, :, None], -1e30)
    p = torch.softmax(torch.cat([s_pre, s_suf], -1), -1)
    p_len = kv_pre.shape[1]
    out = torch.einsum("bnshp,bphd->bnshd", p[..., :p_len], v_pre) \
        + torch.einsum("bnsht,bnthd->bnshd", p[..., p_len:], v)
    return out.reshape(b, n, s, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_absorbed_decode_equals_explicit(dtype):
    g = torch.Generator().manual_seed(4)
    b, n, s, h, dn, dr, dv, r, p_len = 3, 2, 5, 4, 16, 8, 16, 32, 11

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    args = (rnd(b, n, s, h, dn), rnd(b, n, s, h, dr), rnd(b, n, s, h, dn),
            rnd(b, n, s, dr), rnd(b, n, s, h, dv), rnd(b, p_len, r + dr),
            rnd(r, h, dn) * r ** -0.5, rnd(r, h, dv) * r ** -0.5)
    pad = torch.ones(b, p_len, dtype=torch.bool)
    pad[0, 7:] = False
    pad[2, 3:] = False
    blk = torch.tensor([1] + [2] * (s - 1))
    smask = (blk[None] <= blk[:, None]).expand(b, s, s)
    got = mla.absorbed_decode(*args, pad, smask)
    want = _explicit_decode(*(a.float() for a in args), pad, smask)
    assert got.dtype == dtype and got.shape == (b, n, s, h * dv)
    # bf16: the absorbed query, the probabilities and the latent output
    # are rounded to bf16 where the explicit form rounds nothing
    tol = 1e-5 if dtype == torch.float32 else 0.03
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


def test_k3_twin_at_head_dim_192_with_padded_values():
    g = torch.Generator().manual_seed(5)
    b, p_len, h = 2, 13, 3
    q, k = (torch.randn(b, p_len, h, 192, generator=g) for _ in range(2))
    v = torch.randn(b, p_len, h, 128, generator=g)
    valid = torch.ones(b, p_len, dtype=torch.bool)
    valid[1, 9:] = False
    mask = valid[:, None] & valid[:, :, None]
    got = cuda_attention.prefix_gqa_plain(
        q, k, F.pad(v, (0, 64)), mask).view(b, p_len, h, 192)
    assert bool((got[..., 128:] == 0).all())
    r = (lambda t: t.to(torch.bfloat16).float())
    s = torch.einsum("bqhd,bkhd->bhqk", r(q), r(k)) / math.sqrt(192)
    s = s.masked_fill(~mask[:, None], -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), r(v))
    torch.testing.assert_close(got[..., :128][valid], want[valid],
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# π0 end to end against the reference
# ---------------------------------------------------------------------------


def test_sample_actions_fp32_equals_reference(setup):
    s = setup
    got = _program(s, _fp32_config(s["pcfg"]), s["wts32"])
    want = _reference(s, "float32", s["wts32"])
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=0)


def test_sample_actions_bf16_near_reference(setup):
    """The benchmark's path (K3's twin, bf16 weights and stream) against
    the reference rounded to bf16 where the configuration stores it. The
    two round at different points (the absorbed query and latent output,
    the probabilities, the grouped products' sums), which moves these
    actions by ~1e-2; a routing choice within rounding of a tie may flip.
    The tolerance stays well under what each fault below moves."""
    s = setup
    got = _program(s, s["pcfg"], s["wts"])
    want = _reference(s, "bfloat16", s["wts"])
    diff = (got - want).abs()
    assert diff.max().item() < 0.05, diff.max().item()
    assert diff.square().mean().sqrt().item() < 0.01


def _faulty_route(fault):
    def route(x, router, bias, k, scaling):
        scores = torch.sigmoid(x.float() @ router.float())
        idx = torch.topk(scores + bias.float(), k, dim=-1).indices
        if fault == "bias_as_weight":
            w = (scores + bias.float()).gather(-1, idx)
            return idx, w / w.sum(-1, keepdim=True) * scaling
        return idx, scores.gather(-1, idx) * scaling      # not normalised
    return route


@pytest.mark.parametrize("fault", ["no_shared_experts", "bias_as_weight",
                                   "unnormalised_topk"])
def test_each_fault_fails_the_comparison(setup, fault, monkeypatch):
    s = setup
    pw = s["wts32"]
    if fault == "no_shared_experts":
        pw = copy.deepcopy(pw)
        pw["paligemma"]["moe"]["shared_down"].zero_()
    else:
        monkeypatch.setattr(moe, "route", _faulty_route(fault))
    got = _program(s, _fp32_config(s["pcfg"]), pw)
    want = _reference(s, "float32", s["wts32"])
    assert (got - want).abs().max().item() > 50 * FP32_TOL


# ---------------------------------------------------------------------------
# The cache, the spans, the refusals
# ---------------------------------------------------------------------------


def test_latent_cache_and_spans(setup):
    s = setup
    pcfg = s["pcfg"]
    with monitor.recording():
        _program(s, pcfg, s["wts"])
    spans = monitor.drain()
    by_sid = {r.sid: r for r in spans}
    names = {r.name for r in spans}
    assert {"moe.block", "mla.decode"} <= names
    moe_blocks = [r for r in spans if r.name == "moe.block"]
    # one MoE layer, one prefix of K prompts of P tokens
    p_len = pcfg.prefix_len
    assert len(moe_blocks) == pcfg.paligemma.num_moe
    assert all(r.counts["moe_rows"] == K * p_len * 3 for r in moe_blocks)
    assert {by_sid[r.parent].name for r in moe_blocks} == {"pi0.prefix"}
    decodes = [r for r in spans if r.name == "mla.decode"]
    assert len(decodes) == pcfg.expert.depth * pcfg.num_denoise_steps
    assert {by_sid[r.parent].name for r in decodes} == {"pi0.denoise"}

    with torch.no_grad():
        cache = pi0.compute_prefix_cache(
            pi0.ParamTree(s["wts"]), pcfg,
            torch.zeros(1, 1, 56, 56, 3), torch.ones(1, 1, dtype=torch.bool),
            torch.ones(K, 8, dtype=torch.long),
            torch.ones(K, 8, dtype=torch.bool)).cache
    lm = pcfg.paligemma
    assert cache["kv"].shape == (lm.depth, K, p_len,
                                 lm.kv_lora_rank + lm.qk_rope_dim)
    assert set(cache) == {"kv", "kv_b"}


def test_refusals(setup):
    from cover_vla_tpu_torch.models.factory import make_policy
    from cover_vla_tpu_torch.ops.quant import quantize_pi0_policy
    s = setup
    tree = pi0.ParamTree(s["wts"])
    with pytest.raises(NotImplementedError, match="MLA \\+ MoE"):
        quantize_pi0_policy(tree)
    with pytest.raises(NotImplementedError, match="MLA \\+ MoE"):
        kimi_vl.quantize(tree)
    with pytest.raises(NotImplementedError, match="training"):
        b = 2
        pi0.flow_matching_loss(
            tree, s["pcfg"], torch.zeros(b, 1, 56, 56, 3),
            torch.ones(b, 1, dtype=torch.bool),
            torch.ones(b, 8, dtype=torch.long),
            torch.ones(b, 8, dtype=torch.bool), torch.zeros(b, 32),
            torch.zeros(b, 4, 32))
    with pytest.raises(NotImplementedError, match="MLA \\+ MoE"):
        make_policy("pi0", params=tree, device="cpu")
    with pytest.raises(ValueError, match="both"):
        pi0.init_pi0(0, replace(tiny_pi0_config(),
                                expert=tiny_kimi_pi0_config().expert),
                     device="meta")


def test_gemma_path_keeps_its_cache():
    """The Gemma backbone's prefix cache is still {"k", "v"}."""
    pcfg = tiny_pi0_config()
    params = pi0.init_pi0(0, pcfg, device="cpu")
    with torch.no_grad():
        cache = pi0.compute_prefix_cache(
            params, pcfg, torch.zeros(1, 1, 56, 56, 3),
            torch.ones(1, 1, dtype=torch.bool), torch.ones(2, 8,
                                                           dtype=torch.long),
            torch.ones(2, 8, dtype=torch.bool)).cache
    assert set(cache) == {"k", "v"}


# ---------------------------------------------------------------------------
# On the card: the MoE and the absorbed decode never wait for the host
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_moe_and_decode_do_not_synchronise_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    x, lw, g = _moe_layer(seed=6, t=300, w=64, m=32, ms=32)
    x = x.to(dev, torch.bfloat16)
    lw = {k: v.to(dev, torch.float32 if k == "bias" else torch.bfloat16)
          for k, v in lw.items()}
    b, n, s, h, dn, dr, dv, r, p_len = 4, 5, 5, 16, 128, 64, 128, 512, 40
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    dec = (rnd(b, n, s, h, dn), rnd(b, n, s, h, dr), rnd(b, n, s, h, dn),
           rnd(b, n, s, dr), rnd(b, n, s, h, dv), rnd(b, p_len, r + dr),
           rnd(r, h, dn) * 0.05, rnd(r, h, dv) * 0.05,
           torch.ones(b, p_len, dtype=torch.bool, device=dev),
           torch.ones(b, s, s, dtype=torch.bool, device=dev))
    # the stacks: a tiny backbone's prefill (K3) and the expert's decode
    pcfg = tiny_kimi_pi0_config()
    params = pi0.init_pi0(0, pcfg, device=dev)
    pb, pl = 3, 24
    emb = torch.randn(pb, pl, pcfg.paligemma.width, generator=gen, device=dev)
    pos = torch.arange(pl, device=dev).expand(pb, pl)
    pad = torch.ones(pb, pl, dtype=torch.bool, device=dev)
    pad[:, 20:] = False
    mask = pad[:, None] & pad[:, :, None]
    suf = torch.randn(pb, 2, 5, pcfg.expert.width, generator=gen, device=dev)
    smask = torch.ones(pb, 5, 5, dtype=torch.bool, device=dev)

    def stacks():
        _, cache = mla_moe.prefill(params["paligemma"], pcfg.paligemma, emb,
                                   pos, mask, attn_impl="cuda")
        return mla_moe.decode_shared_prefix(params["expert"], pcfg.expert,
                                            suf, pos[:, :5] + 20, cache, pad,
                                            smask)

    with torch.no_grad():
        stacks()                                # builds and loads K3
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            idx, w = moe.route(x, lw["router"], lw["bias"], 3, 2.446)
            y = moe.routed_experts(x, idx, w, lw["gate_up"], lw["down"])
            out = mla.absorbed_decode(*dec)
            stacks()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    want = torch.zeros(x.shape, dtype=torch.float32, device=dev)
    for e in range(lw["gate_up"].shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        want[tok] += w[tok, slot, None] * moe.swiglu(
            x[tok].float(), lw["gate_up"][e].float(), lw["down"][e].float())
    torch.testing.assert_close(y.float(), want, atol=0.05, rtol=0.05)
    ref = _explicit_decode(*(a.float() for a in dec[:8]), *dec[8:])
    torch.testing.assert_close(out.float(), ref, atol=0.05, rtol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("p_len,n_pad", [(328, 40), (129, 69)])
def test_k3_at_head_dim_192_on_card(p_len, n_pad):
    """K3 at the MLA prefill's shapes: 16 query and key heads of 192, the
    values zero-padded from 128, trailing padding."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    b, h = 3, 16
    q, k = (torch.randn(b, p_len, h, 192, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    v = F.pad(torch.randn(b, p_len, h, 128, generator=g, device=dev,
                          dtype=torch.bfloat16), (0, 64))
    valid = torch.ones(b, p_len, dtype=torch.bool, device=dev)
    valid[:, p_len - n_pad:] = False
    mask = (valid[:, None] & valid[:, :, None]).contiguous()
    got = cuda_attention.prefix_gqa(q, k, v, mask, out_dtype=torch.float32)
    want = cuda_attention.prefix_gqa_plain(q, k, v, mask,
                                           out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    assert bool((got.view(b, p_len, h, 192)[..., 128:] == 0).all())
