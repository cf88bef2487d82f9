"""PyTorch port vs the JAX package: Gemma prefill/decode, SigLIP towers,
pi0 sampling with injected noise and verifier scoring, on tiny configs
with the same weights (carried across by convert/from_jax) on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.configs import (
    tiny_pi0_config as j_tiny_pi0, tiny_verifier_config as j_tiny_verifier,
    replace as j_replace)
from cover_vla_tpu.models import gemma as jgemma
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.models import siglip as jsiglip
from cover_vla_tpu.models import verifier as jverifier
from cover_vla_tpu.ops import pallas_attention
from cover_vla_tpu.ops.masks import make_att_2d_masks

from cover_vla_tpu_torch.configs import (
    tiny_pi0_config, tiny_verifier_config, replace)
from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax, verifier_from_jax
from cover_vla_tpu_torch.models import gemma, pi0, siglip, verifier
from cover_vla_tpu_torch.ops import cuda_attention

TOL = {"fp32": dict(actions=dict(atol=1e-4, rtol=0),
                    scores=dict(atol=1e-5, rtol=0)),
       # the JAX package's own fast-vs-exact bound for bf16 paths
       "bf16": dict(actions=dict(atol=0.05, rtol=0.1),
                    scores=dict(atol=0.05, rtol=0.1))}


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def setup(request):
    mode = request.param
    cdt = "float32" if mode == "fp32" else "bfloat16"
    jp_cfg = j_replace(j_tiny_pi0(), compute_dtype=cdt)
    tp_cfg = replace(tiny_pi0_config(), compute_dtype=cdt)
    jpp = jpi0.init_pi0(jax.random.PRNGKey(0), jp_cfg)
    jvp = jverifier.init_verifier(jax.random.PRNGKey(1), j_tiny_verifier(),
                                  num_members=3)
    if mode == "fp32":
        jpp, jvp = _f32(jpp), _f32(jvp)
    tpp = pi0_from_jax(_numpy(jpp), tp_cfg, device="cpu")
    tvp = verifier_from_jax(_numpy(jvp), tiny_verifier_config(), device="cpu")
    return mode, (jp_cfg, jpp, jvp), (tp_cfg, tpp, tvp)


def _policy_inputs(cfg, rng, b=2, bi=1):
    s = cfg.vision.image_size
    t = cfg.tokenizer_max_length
    images = rng.uniform(-1, 1, (bi, 1, s, s, 3)).astype(np.float32)
    img_masks = np.ones((bi, 1), bool)
    toks = rng.integers(0, cfg.paligemma.vocab_size, (b, t)).astype(np.int32)
    lmask = np.ones((b, t), bool)
    lmask[1, t - 3:] = False                      # prefix padding
    state = rng.uniform(-1, 1, (b, cfg.max_state_dim)).astype(np.float32)
    return images, img_masks, toks, lmask, state


def _t(x):
    return torch.from_numpy(np.array(x))


def test_weights_carry_across_exactly(setup):
    _, (_, jpp, _), (_, tpp, _) = setup
    np.testing.assert_array_equal(
        _np(tpp["paligemma"]["layers"]["q"]),
        _np(jpp["paligemma"]["layers"]["q"]))
    assert tpp["paligemma"]["layers"]["q"].dtype == {
        "float32": torch.float32, "bfloat16": torch.bfloat16}[
            str(jpp["paligemma"]["layers"]["q"].dtype)]


def test_from_jax_rejects_foreign_trees(setup):
    _, (_, jpp, _), (tc, _, _) = setup
    tree = _numpy(jpp)
    tree["expert"]["layers"]["q"] = tree["expert"]["layers"]["q"][:, :, :8]
    with pytest.raises(ValueError, match="expert/layers/q"):
        pi0_from_jax(tree, tc, device="cpu")
    tree = _numpy(jpp)
    del tree["state_proj"]
    with pytest.raises(KeyError, match="state_proj"):
        pi0_from_jax(tree, tc, device="cpu")


def test_gemma_prefill_and_decode_match(setup, monkeypatch):
    mode, (jc, jpp, _), (tc, tpp, _) = setup
    rng = np.random.default_rng(0)
    b, p, n, s = 2, 9, 3, 5
    g = jc.paligemma
    emb = rng.standard_normal((b, p, g.width)).astype(np.float32)
    pad = np.ones((b, p), bool)
    pad[1, 6:] = False
    mask = np.array(make_att_2d_masks(pad, np.zeros((b, p), np.int32)))
    pos = np.cumsum(pad, axis=1).astype(np.int32) - 1
    jh, jcache = jgemma.prefill(jpp["paligemma"], g, emb, pos, mask,
                                return_hidden=True)
    th, tcache = gemma.prefill(tpp["paligemma"], tc.paligemma, _t(emb),
                               _t(pos), _t(mask), return_hidden=True)
    tol = TOL[mode]["actions"]
    valid = pad[:, :, None]
    np.testing.assert_allclose(np.where(valid, _np(th), 0),
                               np.where(valid, _np(jh), 0), **tol)
    np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]), **tol)

    e = jc.expert
    semb = rng.standard_normal((b, n, s, e.width)).astype(np.float32)
    spos = (pad.sum(1)[:, None] + np.arange(s)[None]).astype(np.int32)
    smask = np.tril(np.ones((s, s), bool))[None].repeat(b, 0)
    jout = jgemma.decode_shared_prefix(jpp["expert"], e, semb, spos, jcache,
                                       pad, smask)
    tout = gemma.decode_shared_prefix(tpp["expert"], tc.expert, _t(semb),
                                      _t(spos), tcache, _t(pad), _t(smask))
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)

    # prefill through kernel K3's wrapper (on the CPU: its plain twin)
    # against the JAX prefill through the Pallas kernel in interpret mode.
    # Rows of padding queries are compared nowhere: there the port follows
    # the eager path (mean of V over the real keys), the Pallas kernel the
    # mean over its 128-padded key block; no valid row reads them.
    orig = pallas_attention.pallas_prefix_gqa
    monkeypatch.setattr(
        pallas_attention, "pallas_prefix_gqa",
        lambda q, k, v, m: orig(q, k, v, m, interpret=True))
    jh2, jcache2 = jgemma.prefill(jpp["paligemma"], g, emb, pos, mask,
                                  return_hidden=True, attn_impl="pallas")
    cuda_attention.reset_launch_counts()
    th2, tcache2 = gemma.prefill(tpp["paligemma"], tc.paligemma, _t(emb),
                                 _t(pos), _t(mask), return_hidden=True,
                                 attn_impl="cuda")
    assert cuda_attention.launch_counts["prefix_gqa"] == 0    # CPU: twin
    assert th2.dtype == tpp["paligemma"]["layers"]["q"].dtype
    np.testing.assert_allclose(np.where(valid, _np(th2), 0),
                               np.where(valid, _np(jh2), 0), **tol)
    kvalid = pad[None, :, :, None, None]
    for name in ("k", "v"):
        np.testing.assert_allclose(np.where(kvalid, _np(tcache2[name]), 0),
                                   np.where(kvalid, _np(jcache2[name]), 0),
                                   **tol)
    # "cuda" and "eager" agree on every row, padding rows included (bf16
    # rounding of q/k/v inside the kernel path bounds the difference)
    np.testing.assert_allclose(_np(th2), _np(th), atol=0.05, rtol=0.1)


def test_siglip_towers_match(setup):
    mode, (_, _, jvp), (_, _, tvp) = setup
    jv = j_tiny_verifier()
    tv = tiny_verifier_config()
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, jv.vision.image_size, jv.vision.image_size,
                              3)).astype(np.float32)
    jo = jsiglip.vit_forward(jvp["backbone"]["vision"], jv.vision, img)
    to = siglip.vit_forward(tvp["backbone"]["vision"], tv.vision, _t(img))
    tol = TOL[mode]["actions"]
    np.testing.assert_allclose(_np(to.tokens), _np(jo.tokens), **tol)
    np.testing.assert_allclose(_np(to.last_attn_out), _np(jo.last_attn_out),
                               **tol)
    toks = rng.integers(0, jv.text.vocab_size,
                        (2, jv.text.context_length)).astype(np.int32)
    jt = jsiglip.text_forward(jvp["backbone"]["text"], jv.text, toks)
    tt = siglip.text_forward(tvp["backbone"]["text"], tv.text, _t(toks))
    np.testing.assert_allclose(_np(tt.seq_features), _np(jt.seq_features),
                               **tol)


@pytest.mark.parametrize("bi", [1, 2])
def test_pi0_sample_actions_matches(setup, bi):
    mode, (jc, jpp, _), (tc, tpp, _) = setup
    rng = np.random.default_rng(2)
    images, im, toks, lm, state = _policy_inputs(jc, rng, b=2, bi=bi)
    n = 3
    noise = rng.standard_normal((2, n, jc.chunk_size, jc.max_action_dim)
                                ).astype(np.float32)
    if bi == 1:
        ref = jpi0.sample_actions(jpp, jc, None, images, im, toks, lm, state,
                                  num_candidates=n, noise=noise)
    else:   # one image per prompt row: the JAX package runs rows apart
        ref = np.concatenate([np.asarray(jpi0.sample_actions(
            jpp, jc, None, images[i:i + 1], im[i:i + 1], toks[i:i + 1],
            lm[i:i + 1], state[i:i + 1], num_candidates=n,
            noise=noise[i:i + 1])) for i in range(2)])
    got = pi0.sample_actions(tpp, tc, _t(images), _t(im), _t(toks), _t(lm),
                             _t(state), num_candidates=n, noise=_t(noise))
    assert got.shape == (2, n, jc.chunk_size, jc.max_action_dim)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[mode]["actions"])


def test_verifier_score_actions_matches(setup):
    mode, (_, _, jvp), (_, _, tvp) = setup
    jv = j_tiny_verifier()
    tv = tiny_verifier_config()
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (1, jv.vision.image_size, jv.vision.image_size,
                              3)).astype(np.float32)
    toks = rng.integers(0, jv.text.vocab_size,
                        (1, jv.text.context_length)).astype(np.int32)
    hist = rng.uniform(-1, 1, (6, jv.history_length, 7)).astype(np.float32)
    hist[:3, :4] = jv.action_padding_value         # top-padded histories
    ref = jverifier.score_actions(jvp, jv, img, toks, hist)
    got = verifier.score_actions(tvp, tv, _t(img), _t(toks), _t(hist))
    assert got.shape == (6,)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[mode]["scores"])
