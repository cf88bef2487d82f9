"""PyTorch port vs the JAX package: the int8 (w8a8) serving path,
`ops/quant.py` and its dispatch through `gemma._mm` and `siglip._vmm`, on
the CPU.

The grids (int8 weights, activations, scales) and the int32 accumulators
must be bit-equal to the JAX package's on the same inputs. The int8
forwards compute in bf16 and are held to atol 2e-2 against the JAX int8
path on the same weights (the ViT's O(1) token features to the bf16
parity bound, see VIT_TOL); the int8-vs-bf16 bounds of the JAX package's own
tests (tests/test_quant.py) are held for the port too."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu import configs as jconfigs
from cover_vla_tpu.data.stats import DatasetStatistics as JStats
from cover_vla_tpu.engine.verified_step import (
    make_verified_step_batched as j_make_batched)
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.models import siglip as jsiglip
from cover_vla_tpu.models import verifier as jverifier
from cover_vla_tpu.ops import quant as jquant

from cover_vla_tpu_torch import configs
from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax, verifier_from_jax
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.engine.verified_step import make_verified_step_batched
from cover_vla_tpu_torch.models import gemma, pi0, siglip, verifier
from cover_vla_tpu_torch.models.params import ParamTree
from cover_vla_tpu_torch.ops import quant

INT8_ATOL = 2e-2        # port int8 vs JAX int8, bf16 compute
# The ViT's token features after the final LayerNorm are O(1) bf16 values:
# unquantized, the two packages' bf16 towers already differ by up to 0.031
# there (one bf16 ulp at |x| = 2-4 is 0.016-0.031), and an activation that
# rounds one bf16 ulp apart can land on the neighbouring int8 code. They
# are held to the bf16 parity bound of tests/test_torch_models.py (the JAX
# package's fast-vs-exact bound); actions and scores to INT8_ATOL.
VIT_TOL = dict(atol=0.05, rtol=0.1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_pair(x32):
    """The same bf16 values in both packages."""
    jx = jnp.asarray(x32, jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)


def _leaves(tree, prefix=""):
    out = {}
    for k in tree:
        v = tree[k]
        path = f"{prefix}/{k}"
        if isinstance(v, (dict, ParamTree)):
            out.update(_leaves(v, path))
        else:
            out[path] = v
    return out


@pytest.fixture(scope="module")
def trees():
    """bf16 JAX trees and the port's copies."""
    jpp = jpi0.init_pi0(jax.random.PRNGKey(0), jconfigs.tiny_pi0_config())
    jvp = jverifier.init_verifier(jax.random.PRNGKey(1),
                                  jconfigs.tiny_verifier_config(),
                                  num_members=2)
    tpp = pi0_from_jax(jax.tree_util.tree_map(np.asarray, jpp),
                       configs.tiny_pi0_config(), device="cpu")
    tvp = verifier_from_jax(jax.tree_util.tree_map(np.asarray, jvp),
                            configs.tiny_verifier_config(), device="cpu")
    return jpp, jvp, tpp, tvp


# ---------------------------------------------------------------------------
# grids and accumulators: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_weight_and_quant_act_bit_equal(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 96, 40)) * 0.05).astype(np.float32)
    w[1, :, 7] = 0.0                       # an all-zero column: the floor
    x = (rng.standard_normal((2, 5, 96)) * 3.0).astype(np.float32)
    x[0, 2] = 0.0                          # an all-zero token
    if dtype == "fp32":
        jw, tw, jx, tx = jnp.asarray(w), _t(w), jnp.asarray(x), _t(x)
    else:
        (jw, tw), (jx, tx) = _bf16_pair(w), _bf16_pair(x)
    jq, js = jquant.quantize_weight(jw)
    tq, ts = quant.quantize_weight(tw)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == (3, 96, 40) and ts.shape == (3, 1, 40)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # stored column-major: one layer's [K, N] slice has strides (1, K)
    assert tq[0].stride() == (1, 96)
    jaq, jas = jquant.quant_act(jx)
    taq, tas = quant.quant_act(tx)
    np.testing.assert_array_equal(taq.numpy(), np.asarray(jaq))
    np.testing.assert_array_equal(tas.numpy(), np.asarray(jas))
    # half-way points round to even, as jnp.round does
    half = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    np.testing.assert_array_equal(quant.quant_act(_t(half))[0].numpy(),
                                  np.asarray(jquant.quant_act(half)[0]))


@pytest.mark.parametrize("lead", [(1,), (7,), (2, 3, 4)])
def test_int8_matmul_accumulators_and_outputs_equal(lead):
    rng = np.random.default_rng(1)
    k, n = 64, 48
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    jxq, jxs = jquant.quant_act(x)
    jwq, jws = jquant.quantize_weight(w)
    txq, txs = quant.quant_act(_t(x))
    twq, tws = quant.quantize_weight(_t(w))
    jacc = jax.lax.dot_general(jxq, jwq, (((len(lead),), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tacc = quant.int8_accumulate(txq, twq)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jo = jquant.int8_matmul(jxq, jxs, jwq, jws, out_dtype=jdt)
        to = quant.int8_matmul(txq, txs, twq, tws, out_dtype=tdt)
        assert to.dtype == tdt
        np.testing.assert_array_equal(_np(to), _np(jo))


def test_quantized_trees_equal_jax(trees):
    jpp, jvp, tpp, tvp = trees
    for jt, tt in ((jquant.quantize_pi0_policy(jpp),
                    quant.quantize_pi0_policy(tpp)),
                   (jquant.quantize_verifier(jvp),
                    quant.quantize_verifier(tvp))):
        jl = _leaves(jt)
        tl = _leaves(tt)
        assert sorted(jl) == sorted(tl)
        for path, jv in jl.items():
            tv = tl[path]
            assert str(tv.dtype).replace("torch.", "") == str(jv.dtype), path
            np.testing.assert_array_equal(_np(tv), _np(jv), err_msg=path)
    qp = quant.quantize_pi0_policy(tpp)
    assert quant.is_quantized(qp["paligemma"]["layers"])
    assert not quant.is_quantized(tpp["paligemma"]["layers"])
    assert qp["vision"]["blocks"]["attn"]["q"]["kernel"].dtype == torch.int8
    # vision=False leaves the tower as it was, the very same tensors
    novis = quant.quantize_pi0_policy(tpp, vision=False)
    assert novis["vision"] is tpp["vision"]
    assert novis["vision"]["blocks"]["attn"]["q"]["kernel"].dtype == \
        torch.bfloat16
    # the verifier's text tower and heads are untouched
    qv = quant.quantize_verifier(tvp)
    assert qv["backbone"]["text"] is tvp["backbone"]["text"]
    assert qv["members"] is tvp["members"]
    # unquantized leaves are shared, not copied
    assert qp["state_proj"]["kernel"].data_ptr() == \
        tpp["state_proj"]["kernel"].data_ptr()


def test_quantized_stack_keeps_bf16_activations_and_cache(trees, monkeypatch):
    """No int8 activation reaches a matmul in the wrong dtype and the KV
    cache of prefill and the AR decode stays bf16 under int8."""
    _, _, tpp, _ = trees
    cfg = configs.tiny_pi0_config()
    qp = quant.quantize_pi0_policy(tpp)
    layers = qp["paligemma"]["layers"]
    assert gemma._dtype(layers) == torch.bfloat16
    seen = []
    orig = quant.int8_matmul

    def spy(xq, xs, wq, ws, out_dtype=torch.bfloat16):
        seen.append((xq.dtype, wq.dtype, out_dtype))
        return orig(xq, xs, wq, ws, out_dtype)
    monkeypatch.setattr(quant, "int8_matmul", spy)
    rng = np.random.default_rng(2)
    b, p = 2, 7
    emb = _t(rng.standard_normal((b, p, cfg.paligemma.width)).astype(
        np.float32))
    pad = torch.ones((b, p), dtype=torch.bool)
    pos = torch.arange(p)[None].expand(b, p)
    hidden, cache = gemma.prefill(qp["paligemma"], cfg.paligemma, emb, pos,
                                  pad[:, None, :] & pad[:, :, None],
                                  return_hidden=True)
    assert cache["k"].dtype == cache["v"].dtype == torch.bfloat16
    assert seen and all(s == (torch.int8, torch.int8, torch.bfloat16)
                        for s in seen)
    semb = _t(rng.standard_normal((b, 3, cfg.suffix_len, cfg.expert.width)
                                  ).astype(np.float32))
    spos = (p + torch.arange(cfg.suffix_len))[None].expand(b, -1)
    smask = torch.ones((b, cfg.suffix_len, cfg.suffix_len), dtype=torch.bool)
    out = gemma.decode_shared_prefix(qp["expert"], cfg.expert, semb, spos,
                                     cache, pad, smask)
    assert out.shape == semb.shape and torch.isfinite(out).all()
    toks = gemma.ar_generate(qp["paligemma"], cfg.paligemma, emb, pad, 3,
                             eos_id=1)
    assert toks.dtype == torch.int32 and toks.shape == (b, 3)


# ---------------------------------------------------------------------------
# int8 forwards against the JAX int8 path (bf16 compute, atol 2e-2)
# ---------------------------------------------------------------------------


def test_int8_forwards_match_jax(trees):
    jpp, jvp, tpp, tvp = trees
    jc, tc = jconfigs.tiny_pi0_config(), configs.tiny_pi0_config()
    jqp, tqp = jquant.quantize_pi0_policy(jpp), quant.quantize_pi0_policy(tpp)
    rng = np.random.default_rng(3)
    v = jc.vision
    imgs = rng.uniform(-1, 1, (1, 1, v.image_size, v.image_size, 3)).astype(
        np.float32)
    toks = rng.integers(0, jc.paligemma.vocab_size,
                        (2, jc.tokenizer_max_length)).astype(np.int32)
    masks = np.ones((2, jc.tokenizer_max_length), bool)
    masks[1, -3:] = False
    state = rng.uniform(-1, 1, (2, jc.max_state_dim)).astype(np.float32)
    noise = rng.standard_normal((2, 4, jc.chunk_size, jc.max_action_dim)
                                ).astype(np.float32)
    ref = jpi0.sample_actions(jqp, jc, None, imgs, np.ones((1, 1), bool),
                              toks, masks, state, num_candidates=4,
                              noise=noise)
    got = pi0.sample_actions(tqp, tc, _t(imgs), torch.ones((1, 1), dtype=bool),
                             _t(toks), _t(masks), _t(state), num_candidates=4,
                             noise=_t(noise))
    np.testing.assert_allclose(_np(got), _np(ref), atol=INT8_ATOL, rtol=0)

    jv, tv = jconfigs.tiny_verifier_config(), configs.tiny_verifier_config()
    jqv, tqv = jquant.quantize_verifier(jvp), quant.quantize_verifier(tvp)
    img = rng.uniform(-1, 1, (2, jv.vision.image_size, jv.vision.image_size,
                              3)).astype(np.float32)
    jo = jsiglip.vit_forward(jqv["backbone"]["vision"], jv.vision, img)
    to = siglip.vit_forward(tqv["backbone"]["vision"], tv.vision, _t(img))
    np.testing.assert_allclose(_np(to.tokens), _np(jo.tokens), **VIT_TOL)
    np.testing.assert_allclose(_np(to.last_attn_out), _np(jo.last_attn_out),
                               **VIT_TOL)
    vt = rng.integers(0, jv.text.vocab_size,
                      (1, jv.text.context_length)).astype(np.int32)
    hist = rng.uniform(-1, 1, (4, jv.history_length, 7)).astype(np.float32)
    js = jverifier.score_actions(jqv, jv, img[:1], vt, hist)
    ts = verifier.score_actions(tqv, tv, _t(img[:1]), _t(vt), _t(hist))
    np.testing.assert_allclose(_np(ts), _np(js), atol=INT8_ATOL, rtol=0)


def test_int8_batched_verified_step_matches_jax(trees):
    """int8_full trees (policy and verifier backbone) through the batched
    verified step, with the JAX step's own noise injected: the same
    picks, floats within atol 2e-2."""
    jpp, jvp, tpp, tvp = trees
    e, k, n = 2, 2, 2
    pcfg, vcfg = configs.tiny_pi0_config(), configs.tiny_verifier_config()
    rng = np.random.default_rng(4)
    t = pcfg.tokenizer_max_length
    episodes = (rng.integers(0, 256, (e, 256, 256, 3), dtype=np.uint8),
                rng.uniform(-0.1, 0.1, (e, 7)).astype(np.float32),
                rng.integers(0, pcfg.paligemma.vocab_size, (e, k, t)
                             ).astype(np.int32),
                np.ones((e, k, t), bool),
                rng.integers(0, vcfg.text.vocab_size,
                             (e, vcfg.text.context_length)).astype(np.int32),
                rng.uniform(-0.5, 0.5, (e, 6, 7)).astype(np.float32),
                np.array([6, 3], np.int32))
    jc = jconfigs.CoVerConfig(n_samples=n, n_rephrases=k)
    keys = jax.random.split(jax.random.PRNGKey(5), e)
    ref = j_make_batched(jconfigs.tiny_pi0_config(),
                         jconfigs.tiny_verifier_config(), jc,
                         JStats.from_json())(
        jquant.quantize_pi0_policy(jpp), jquant.quantize_verifier(jvp),
        keys, *episodes)
    noise = np.stack([np.asarray(jax.random.normal(
        keys[i], (k, n, pcfg.chunk_size, pcfg.max_action_dim), jnp.float32))
        for i in range(e)])
    got = make_verified_step_batched(
        pcfg, vcfg, configs.CoVerConfig(n_samples=n, n_rephrases=k),
        DatasetStatistics.from_json(), device="cpu")(
        quant.quantize_pi0_policy(tpp), quant.quantize_verifier(tvp),
        *episodes, noise=noise)
    for name in ("winner_idx", "winner_group", "used_stage2"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("exec_chunk", "verifier_chunk", "scores", "max_score",
                 "raw_gripper"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(ref, name)), atol=INT8_ATOL,
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the CPU route of the csrc/quant.cu wrappers: the plain twins, no launch
# ---------------------------------------------------------------------------

# the main path's contraction widths (so400m's 1152 and 4304 among them) and
# row counts on both sides of _int_mm's 17-row minimum
MAIN_K = (1024, 1152, 4304, 16384)
MAIN_M = (1, 16, 17, 300)


@pytest.mark.parametrize("k", MAIN_K)
@pytest.mark.parametrize("m", MAIN_M)
def test_cpu_route_takes_plain_twins_and_folds_the_bias(m, k):
    """CPU tensors take the plain twins and launch nothing; the grid is the
    JAX package's at the main path's widths; a bias passed to int8_matmul
    equals `int8_matmul(...) + bias` bit for bit, in bf16 and fp32."""
    rng = np.random.default_rng(m * 7 + k)
    n = 40
    jx, x = _bf16_pair(rng.standard_normal((m, k)).astype(np.float32) * 3)
    w = _t((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    quant.reset_launch_counts()
    xq, xs = quant.quant_act(x)
    pq, ps = quant.quant_act_plain(x)
    assert torch.equal(xq, pq) and torch.equal(xs, ps)
    jq, js = jquant.quant_act(jx)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(js))
    wq, ws = quant.quantize_weight(w)
    acc = quant.int8_accumulate(xq, wq)
    for dt in (torch.bfloat16, torch.float32):
        b = _t(rng.standard_normal(n).astype(np.float32)).to(dt)
        out = quant.int8_matmul(xq, xs, wq, ws, out_dtype=dt)
        assert out.dtype == dt
        assert torch.equal(out, quant.rescale_plain(acc, xs, ws, dt))
        with_bias = quant.int8_matmul(xq, xs, wq, ws, out_dtype=dt, bias=b)
        assert with_bias.dtype == dt and torch.equal(with_bias, out + b)
    assert quant.launch_counts == {"act_quant": 0, "rescale": 0}


def test_int8_step_sites_feed_what_the_kernels_take(trees, monkeypatch):
    """Every quantized site of the int8_full verified step hands the
    wrappers what the CUDA kernels take (contiguous bf16/fp32 activations,
    fp32 scales, a bias in the output's dtype): one quant a quantized input
    (4 a Gemma layer pass or ViT block) and one rescale a product."""
    _, _, tpp, tvp = trees
    pcfg, vcfg = configs.tiny_pi0_config(), configs.tiny_verifier_config()
    calls = {"act_quant": 0, "rescale": 0}
    orig_quant, orig_mm = quant.quant_act, quant.int8_matmul

    def spy_quant(x):
        assert x.dtype in (torch.bfloat16, torch.float32) and \
            x.is_contiguous(), (x.dtype, x.stride())
        calls["act_quant"] += 1
        return orig_quant(x)

    def spy_mm(xq, xs, wq, ws, out_dtype=torch.bfloat16, bias=None):
        assert xq.is_contiguous() and xs.is_contiguous() and \
            ws.is_contiguous() and xs.dtype == ws.dtype == torch.float32
        assert out_dtype in (torch.bfloat16, torch.float32)
        assert bias is None or (bias.dtype == out_dtype
                                and bias.is_contiguous()
                                and bias.numel() == wq.shape[-1])
        calls["rescale"] += 1
        return orig_mm(xq, xs, wq, ws, out_dtype, bias)
    monkeypatch.setattr(quant, "quant_act", spy_quant)
    monkeypatch.setattr(quant, "int8_matmul", spy_mm)
    e, k, n = 2, 2, 2
    rng = np.random.default_rng(6)
    t = pcfg.tokenizer_max_length
    episodes = (rng.integers(0, 256, (e, 256, 256, 3), dtype=np.uint8),
                rng.uniform(-0.1, 0.1, (e, 7)).astype(np.float32),
                rng.integers(0, pcfg.paligemma.vocab_size, (e, k, t)
                             ).astype(np.int32),
                np.ones((e, k, t), bool),
                rng.integers(0, vcfg.text.vocab_size,
                             (e, vcfg.text.context_length)).astype(np.int32),
                rng.uniform(-0.5, 0.5, (e, 6, 7)).astype(np.float32),
                np.array([6, 3], np.int32))
    noise = rng.standard_normal((e, k, n, pcfg.chunk_size,
                                 pcfg.max_action_dim)).astype(np.float32)
    make_verified_step_batched(
        pcfg, vcfg, configs.CoVerConfig(n_samples=n, n_rephrases=k),
        DatasetStatistics.from_json(), device="cpu")(
        quant.quantize_pi0_policy(tpp), quant.quantize_verifier(tvp),
        *episodes, noise=noise)
    gemma_passes = pcfg.paligemma.depth \
        + pcfg.expert.depth * pcfg.num_denoise_steps
    vit_blocks = pcfg.vision.depth + vcfg.vision.depth
    assert calls == {"act_quant": 4 * (gemma_passes + vit_blocks),
                     "rescale": 7 * gemma_passes + 6 * vit_blocks}


# ---------------------------------------------------------------------------
# the port's own int8-vs-bf16 bounds (the JAX package's tests/test_quant.py)
# ---------------------------------------------------------------------------


def test_int8_matmul_exact_on_grid_points():
    rng = np.random.default_rng(0)
    w_int = rng.integers(-127, 128, (16, 8)).astype(np.float32)
    x_int = rng.integers(-127, 128, (4, 16)).astype(np.float32)
    wq, ws = quant.quantize_weight(_t(w_int))
    xq, xs = quant.quant_act(_t(x_int))
    out = quant.int8_matmul(xq, xs, wq, ws, out_dtype=torch.float32)
    x_deq = xq.float().numpy() * xs.numpy()
    w_deq = quant.dequantize_weight(wq, ws, torch.float32).numpy()
    np.testing.assert_allclose(out.numpy(), x_deq @ w_deq, rtol=1e-5,
                               atol=1e-3)


def test_weight_quant_error_bound():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 64, 48)).astype(np.float32) * 0.05
    assert quant.quant_error_stats(w)["rel_rms_err"] < 0.01
    wq, ws = quant.quantize_weight(_t(w))
    err = np.abs(quant.dequantize_weight(wq, ws, torch.float32).numpy()
                 - w).max()
    assert err <= np.abs(w).max() / 127.0 + 1e-6


def test_int8_close_to_bf16_within_jax_bounds(trees):
    _, _, tpp, tvp = trees
    cfg = configs.tiny_pi0_config()
    qp = quant.quantize_pi0_policy(tpp)
    rng = np.random.default_rng(3)
    v, w = cfg.vision, cfg.paligemma
    imgs = _t(rng.uniform(-1, 1, (1, 1, v.image_size, v.image_size, 3)
                          ).astype(np.float32))
    toks = _t(rng.integers(0, w.vocab_size, (1, cfg.tokenizer_max_length)))
    masks = torch.ones((1, cfg.tokenizer_max_length), dtype=torch.bool)
    state = torch.zeros((1, cfg.max_state_dim))
    noise = _t(rng.standard_normal((1, 4, cfg.chunk_size, cfg.max_action_dim)
                                   ).astype(np.float32))

    def run(p):
        return pi0.sample_actions(p, cfg, imgs, torch.ones((1, 1), dtype=bool),
                                  toks, masks, state, num_candidates=4,
                                  noise=noise).numpy()

    a_bf, a_q = run(tpp), run(qp)
    assert a_q.shape == a_bf.shape and np.isfinite(a_q).all()
    rms = np.sqrt((a_bf ** 2).mean()) + 1e-9
    assert np.abs(a_q - a_bf).max() / rms < 0.15

    vcfg = configs.tiny_verifier_config()
    qv = quant.quantize_verifier(tvp)
    img = _t(rng.uniform(-1, 1, (1, vcfg.vision.image_size,
                                 vcfg.vision.image_size, 3)).astype(np.float32))
    vt = _t(rng.integers(0, 50, (1, vcfg.text.context_length)))
    acts = _t(rng.uniform(-1, 1, (4, vcfg.history_length, vcfg.action_dim)
                          ).astype(np.float32))
    s_bf = verifier.score_actions(tvp, vcfg, img, vt, acts).numpy()
    s_q = verifier.score_actions(qv, vcfg, img, vt, acts).numpy()
    assert np.isfinite(s_q).all()
    assert np.abs(s_q - s_bf).max() / (s_bf.max() - s_bf.min() + 1e-9) < 0.25

    imgs2 = _t(rng.uniform(-1, 1, (2, vcfg.vision.image_size,
                                   vcfg.vision.image_size, 3)).astype(np.float32))
    t = siglip.vit_forward(tvp["backbone"]["vision"], vcfg.vision,
                           imgs2).tokens.float().numpy()
    tq = siglip.vit_forward(qv["backbone"]["vision"], vcfg.vision,
                            imgs2).tokens.float().numpy()
    assert np.isfinite(tq).all()
    assert np.abs(tq - t).max() / (float(np.sqrt(t.var())) + 1e-9) < 0.25


# ---------------------------------------------------------------------------
# the card's int8 GEMM (cuBLASLt through torch._int_mm)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch._int_mm has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 17, 300])
def test_int8_accumulate_on_card_equals_cpu(cuda_device, m):
    rng = np.random.default_rng(m)
    x = _t(rng.standard_normal((m, 256)).astype(np.float32))
    w = _t((rng.standard_normal((256, 512)) * 0.02).astype(np.float32))
    xq, _ = quant.quant_act(x)
    wq, _ = quant.quantize_weight(w)
    quant.reset_int_mm_calls()
    got = quant.int8_accumulate(xq.to(cuda_device), wq.to(cuda_device))
    assert quant.int_mm_calls["int_mm"] == 1
    assert torch.equal(got.cpu(), quant.int8_accumulate(xq, wq))


# (K, N) of the main path's products: PaliGemma's, the expert's, so400m's
# and ViT-L's, and an odd pair that takes the kernels' one-element path
CARD_KN = ((2048, 16384), (16384, 2048), (1024, 4096), (4096, 1024),
           (1152, 4304), (4304, 1152), (1001, 37))


@pytest.mark.cuda
@pytest.mark.parametrize("kn", CARD_KN)
@pytest.mark.parametrize("m", MAIN_M)
def test_quant_kernels_on_card_equal_plain_twins(cuda_device, m, kn):
    """csrc/quant.cu's act_quant and rescale against the plain twins run on
    the same card tensors: bit-equal, bf16 and fp32 in and out, with and
    without a bias; each call launches one kernel."""
    k, n = kn
    gen = torch.Generator(device=cuda_device).manual_seed(m * 7 + k)
    w = torch.randn((k, n), generator=gen, device=cuda_device) * 0.02
    wq, ws = quant.quantize_weight(w)
    for dt in (torch.bfloat16, torch.float32):
        x = (torch.randn((m, k), generator=gen, device=cuda_device) * 3).to(dt)
        if m > 1:
            x[1] = 0.0                      # an all-zero token: the floor
        x[0, :3] = torch.tensor([0.5, -2.5, 1e-30])
        quant.reset_launch_counts()
        xq, xs = quant.quant_act(x)
        assert quant.launch_counts == {"act_quant": 1, "rescale": 0}
        pq, ps = quant.quant_act_plain(x)
        assert torch.equal(xq, pq) and torch.equal(xs, ps)
        # _int_mm takes widths that are multiples of 8: the odd pair's
        # accumulator is the CPU's exact product
        acc = (quant.int8_accumulate(xq, wq) if k % 8 == n % 8 == 0 else
               quant.int8_accumulate(xq.cpu(), wq.cpu()).to(cuda_device))
        for bias in (None, (torch.randn(n, generator=gen,
                                        device=cuda_device)).to(dt)):
            got = quant.rescale(acc, xs, ws, dt, bias)
            assert torch.equal(got, quant.rescale_plain(acc, xs, ws, dt, bias))
        assert quant.launch_counts == {"act_quant": 1, "rescale": 2}


@pytest.mark.cuda
def test_act_quant_bf16_exhaustive_on_card(cuda_device):
    """Every (amax, x) pair a bf16 row can hold, each positive finite bf16
    amax with each finite bf16 x of |x| <= amax, through the act_quant
    kernel and its plain twin: bit-equal. (The kernel divides a bf16 row by
    its scale with a reciprocal and one FMA residual step, not the IEEE
    division; this is what shows the two agree.)"""
    vals = torch.arange(65536, dtype=torch.int32, device=cuda_device).to(
        torch.int16).view(torch.bfloat16)
    finite = vals[torch.isfinite(vals)]            # 65,280, both zeros
    amaxes = finite[finite > 0]                     # 32,639
    width = 16384                                   # amax, then 16,383 x
    chunks = -(-finite.numel() // (width - 1))
    xcols = torch.cat([finite, finite.new_zeros(
        chunks * (width - 1) - finite.numel())]).reshape(chunks, width - 1)
    for a in amaxes.split(4096):
        lim = a[:, None, None]
        rows = torch.cat([lim.expand(-1, chunks, 1),
                          torch.minimum(torch.maximum(xcols[None], -lim), lim)],
                         dim=-1).reshape(-1, width)
        q, s = quant.quant_act(rows)
        pq, ps = quant.quant_act_plain(rows)
        assert torch.equal(s, ps)
        assert torch.equal(q, pq), (
            f"{int((q != pq).sum())} codes differ, first at amax "
            f"{rows[(q != pq).any(1)][0, 0].item()}")

