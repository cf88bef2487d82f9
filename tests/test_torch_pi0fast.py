"""PyTorch port vs the JAX package: the FAST action tokenizer, the pi0-FAST
prompt and token mapping, `gemma.lm_logits` / `gemma.ar_generate` and the
`Pi0FastPolicy` queue, on the tiny config with fp32 weights on the CPU.

Host code (tokenizer, prompts, token mapping) must agree exactly: token
ids, strings, and decoded actions within 1e-6. Logits agree within 1e-4
and the greedy tokens exactly; on a token mismatch the test reports the
top-2 logit gap of the JAX decode at the first differing step, since only
a near tie can flip a greedy pick."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.data import fast_tokenizer as jfast
from cover_vla_tpu.models import gemma as jgemma
from cover_vla_tpu.models import pi0fast as jpi0fast

from cover_vla_tpu_torch.convert.from_jax import pi0fast_from_jax
from cover_vla_tpu_torch.data import fast_tokenizer as tfast
from cover_vla_tpu_torch.models import gemma, pi0fast

LOGIT_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jpi0fast.tiny_pi0fast_config()
    tcfg = pi0fast.tiny_pi0fast_config()
    jp = _f32(jpi0fast.init_pi0fast(jax.random.PRNGKey(0), jcfg))
    tp = pi0fast_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                          device="cpu")
    return jcfg, jp, tcfg, tp


def _prompt_inputs(cfg, rng, b=2):
    s = cfg.vision.image_size
    images = rng.uniform(-1, 1, (b, 1, s, s, 3)).astype(np.float32)
    toks = rng.integers(3, cfg.paligemma.vocab_size, (b, 12)).astype(np.int32)
    masks = np.ones((b, 12), bool)
    masks[:, 9:] = False
    masks[1, 6:] = False            # rows of different lengths
    return images, np.ones((b, 1), bool), toks, masks


# ---------------------------------------------------------------------------
# host: FAST tokenizer, token mapping, prompts
# ---------------------------------------------------------------------------


def test_fast_tokenizer_matches_without_bpe():
    rng = np.random.default_rng(0)
    actions = np.clip(rng.standard_normal((3, 8, 7)) * 0.3, -1, 1)
    jt, tt = jfast.FastActionTokenizer(scale=100.0), \
        tfast.FastActionTokenizer(scale=100.0)
    jids, tids = jt.encode(actions), tt.encode(actions)
    assert tids == jids
    np.testing.assert_allclose(tt.decode(tids), jt.decode(jids), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tt.decode(tids), actions, atol=0.02)


def test_fast_tokenizer_matches_with_bpe():
    rng = np.random.default_rng(1)
    actions = np.clip(rng.standard_normal((8, 6, 7)) * 0.2, -1, 1)
    corpus = [list(c) for c in jfast.FastActionTokenizer(scale=20.0)
              .encode(actions)]
    jbpe = jfast.SimpleBPE(base_vocab=256).train(corpus, 50)
    tbpe = tfast.SimpleBPE(base_vocab=256).train(corpus, 50)
    assert tbpe.merges == jbpe.merges and tbpe.vocab_size == jbpe.vocab_size
    jt = jfast.FastActionTokenizer(scale=20.0, bpe=jbpe)
    tt = tfast.FastActionTokenizer(scale=20.0, bpe=tbpe)
    jids, tids = jt.encode(actions), tt.encode(actions)
    assert tids == jids
    assert sum(map(len, tids)) < actions.shape[1] * actions.shape[2] * 8
    np.testing.assert_allclose(tt.decode(tids), jt.decode(jids), atol=1e-6,
                               rtol=0)


def test_fast_relaxed_decoding_matches():
    kw = dict(scale=10.0, time_horizon=4, action_dim=2)
    jt, tt = jfast.FastActionTokenizer(**kw), tfast.FastActionTokenizer(**kw)
    for toks in ([[130, 130]], [list(np.full(20, 128))], [[]]):
        got = tt.decode(toks, time_horizon=4, action_dim=2)
        assert got.shape == (1, 4, 2) and np.isfinite(got).all()
        np.testing.assert_allclose(got, jt.decode(toks, time_horizon=4,
                                                  action_dim=2), atol=1e-6)
    a = np.random.default_rng(2).uniform(-3, 5, (2, 4, 3))
    np.testing.assert_array_equal(tfast.normalize_actions_minmax(a),
                                  jfast.normalize_actions_minmax(a))


def test_hub_processor_matches(tmp_path):
    pytest.importorskip("tokenizers")
    rng = np.random.default_rng(3)
    corpus = np.clip(rng.standard_normal((64, 5, 3)) * 0.3, -1, 1)
    jp = jfast.HubFastProcessor.train(corpus, vocab_size=300)
    tp = tfast.HubFastProcessor.train(corpus, vocab_size=300)
    sample = corpus[:4]
    jids, tids = jp(sample), tp(sample)
    assert tids == jids and tp.vocab_size == jp.vocab_size
    np.testing.assert_allclose(tp.decode(tids), jp.decode(jids), atol=1e-6)
    # the saved artifact reloads in the other package
    tp.save_artifact(str(tmp_path / "fast"))
    jre = jfast.HubFastProcessor.from_artifact(str(tmp_path / "fast"))
    assert jre(sample) == tids


def test_token_mapping_state_and_prompts_match():
    jcfg, tcfg = jpi0fast.tiny_pi0fast_config(), pi0fast.tiny_pi0fast_config()
    t = np.arange(10)
    pg = pi0fast.act_tokens_to_paligemma(t, tcfg)
    np.testing.assert_array_equal(pg, jpi0fast.act_tokens_to_paligemma(t, jcfg))
    np.testing.assert_array_equal(pi0fast.paligemma_to_act_tokens(pg, tcfg), t)
    state = np.random.default_rng(4).uniform(-1.2, 1.2, (3, 40))
    state[0, :3] = [0.0, -1.0, 0.999]
    np.testing.assert_array_equal(pi0fast.discretize_state(state),
                                  jpi0fast.discretize_state(state))
    assert pi0fast.discretize_state(state).shape == (3, 32)
    tasks = ["Pick_Up the cube", "  open THE drawer ", "put_carrot_on_plate"]
    got = pi0fast.build_prompts(state, tasks)
    assert got == jpi0fast.build_prompts(state, tasks)
    assert got[0].startswith("Task: pick up the cube, State: 128 0 255 ")


# ---------------------------------------------------------------------------
# device: logits and greedy decode
# ---------------------------------------------------------------------------


def test_pi0fast_from_jax_rejects_foreign_trees(model):
    jcfg, jp, tcfg, _ = model
    tree = jax.tree_util.tree_map(np.asarray, jp)
    del tree["mm_proj"]
    with pytest.raises(KeyError, match="mm_proj"):
        pi0fast_from_jax(tree, tcfg, device="cpu")


def test_lm_logits_match(model):
    jcfg, jp, tcfg, tp = model
    h = np.random.default_rng(5).standard_normal(
        (3, 4, jcfg.paligemma.width)).astype(np.float32)
    ref = np.asarray(jgemma.lm_logits(jp["paligemma"], jcfg.paligemma, h))
    got = gemma.lm_logits(tp["paligemma"], tcfg.paligemma, _t(h))
    assert got.dtype == torch.float32
    assert got.shape == (3, 4, jcfg.paligemma.vocab_size)
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


def _first_mismatch_gap(jp, jcfg, embs, pad, got, ref):
    """Top-2 logit gap of the JAX decode at the first differing step."""
    row, step = np.argwhere(got != ref)[0]
    g = jcfg.paligemma
    # replay the JAX decode up to `step` with the teacher tokens
    if step == 0:
        pos = np.cumsum(pad, axis=1) - 1
        hid, _ = jgemma.prefill(jp["paligemma"], g, embs, pos,
                                pad[:, None, :] & pad[:, :, None],
                                return_hidden=True)
        h = np.asarray(hid)[row, pad[row].sum() - 1]
    else:
        seq = np.concatenate([np.asarray(embs[row:row + 1]), np.asarray(
            jgemma.embed_tokens(jp["paligemma"], ref[row:row + 1, :step])
            * jnp.asarray(g.width ** 0.5, jp["paligemma"]["embed"].dtype),
            np.float32)], axis=1)
        valid = np.concatenate([pad[row:row + 1],
                                np.ones((1, step), bool)], axis=1)
        keep = np.flatnonzero(valid[0])         # drop the padding slots
        seq, valid = seq[:, keep], valid[:, keep]
        pos = np.cumsum(valid, axis=1) - 1
        causal = np.tril(np.ones((seq.shape[1],) * 2, bool))[None]
        n_pre = int(pad[row].sum())
        causal[:, :n_pre, :n_pre] = True
        hid, _ = jgemma.prefill(jp["paligemma"], g, seq, pos, causal,
                                return_hidden=True)
        h = np.asarray(hid)[0, -1]
    logits = np.sort(np.asarray(jgemma.lm_logits(jp["paligemma"], g, h)))
    return row, step, float(logits[-1] - logits[-2])


def test_ar_generate_tokens_equal_jax(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(6)
    images, im, toks, masks = _prompt_inputs(jcfg, rng)
    jembs, jpad = jpi0fast.embed_prefix(jp, jcfg, images, im, toks, masks)
    tembs, tpad = pi0fast.embed_prefix(tp, tcfg, _t(images), _t(im), _t(toks),
                                       _t(masks))
    assert tembs.dtype == torch.bfloat16
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    np.testing.assert_allclose(tembs.float().numpy(),
                               np.asarray(jembs.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    # the same embeddings into both decoders: the tokens must be equal
    embs = np.asarray(jembs.astype(jnp.float32))
    pad = np.asarray(jpad)
    n_new = 12
    ref = np.asarray(jgemma.ar_generate(jp["paligemma"], jcfg.paligemma,
                                        embs, pad, n_new, eos_id=1))
    got = gemma.ar_generate(tp["paligemma"], tcfg.paligemma, _t(embs),
                            _t(pad), n_new, eos_id=1)
    assert got.dtype == torch.int32 and got.shape == (2, n_new)
    if not np.array_equal(got.numpy(), ref):
        row, step, gap = _first_mismatch_gap(jp, jcfg, embs, pad,
                                             got.numpy(), ref)
        pytest.fail(f"greedy tokens differ first at row {row}, step {step} "
                    f"(JAX top-2 logit gap there {gap:.3e}):\n"
                    f"port {got.numpy()}\nJAX  {ref}")
    # and end to end through the vision tower
    ref = np.asarray(jpi0fast.generate_action_tokens(jp, jcfg, images, im,
                                                     toks, masks))
    got = pi0fast.generate_action_tokens(tp, tcfg, _t(images), _t(im),
                                         _t(toks), _t(masks))
    assert got.shape == (2, jcfg.max_decoding_steps)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ar_generate_eos_and_pad_semantics(model):
    """A row whose first token is EOS emits pad throughout; a row that
    meets EOS later emits it once, then pad; the loop's early stop leaves
    the same outputs as the JAX scan."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(7)
    g = jcfg.paligemma
    embs = rng.standard_normal((3, 9, g.width)).astype(np.float32)
    pad = np.ones((3, 9), bool)
    pad[2, 5:] = False
    base = np.asarray(jgemma.ar_generate(jp["paligemma"], g, embs, pad, 6,
                                         eos_id=1))
    for eos in (int(base[0, 0]), int(base[1, 2])):
        ref = np.asarray(jgemma.ar_generate(jp["paligemma"], g, embs, pad, 6,
                                            eos_id=eos, pad_id=0))
        got = gemma.ar_generate(tp["paligemma"], tcfg.paligemma, _t(embs),
                                _t(pad), 6, eos_id=eos, pad_id=0).numpy()
        np.testing.assert_array_equal(got, ref)
        if eos == base[0, 0]:
            assert (got[0] == 0).all()      # EOS first: pad throughout
    # every row done after its first token: the loop stops at once
    rows_eos = base[:, 0]
    if len(set(rows_eos.tolist())) == 1:
        got = gemma.ar_generate(tp["paligemma"], tcfg.paligemma, _t(embs),
                                _t(pad), 6, eos_id=int(rows_eos[0])).numpy()
        assert (got == 0).all()


def test_generation_right_padding_invariant(model):
    _, _, tcfg, tp = model
    rng = np.random.default_rng(8)
    images, im, toks, masks = _prompt_inputs(tcfg, rng)
    out = pi0fast.generate_action_tokens(tp, tcfg, _t(images), _t(im),
                                         _t(toks), _t(masks))
    again = pi0fast.generate_action_tokens(tp, tcfg, _t(images), _t(im),
                                           _t(toks), _t(masks))
    corrupt = toks.copy()
    corrupt[~masks] = 7
    other = pi0fast.generate_action_tokens(tp, tcfg, _t(images), _t(im),
                                           _t(corrupt), _t(masks))
    assert torch.equal(out, again) and torch.equal(out, other)
    # one image row serves every prompt row
    shared = pi0fast.generate_action_tokens(
        tp, tcfg, _t(images[:1]), _t(im[:1]), _t(toks[:1].repeat(2, 0)),
        _t(masks[:1].repeat(2, 0)))
    assert torch.equal(shared[0], shared[1]) and torch.equal(shared[0], out[0])


def _count_generations(monkeypatch):
    calls = []
    orig = pi0fast.generate_action_tokens

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)
    monkeypatch.setattr(pi0fast, "generate_action_tokens", counted)
    return calls


def test_policy_select_action_queue(model, monkeypatch):
    jcfg, jp, tcfg, tp = model
    generations = _count_generations(monkeypatch)
    policy = pi0fast.Pi0FastPolicy(tp, tcfg, device="cpu")
    jpolicy = jpi0fast.Pi0FastPolicy(jp, jcfg)
    rng = np.random.default_rng(9)
    s = tcfg.vision.image_size
    images = rng.uniform(-1, 1, (1, 1, s, s, 3)).astype(np.float32)
    state = rng.uniform(-1, 1, (1, 7)).astype(np.float32)
    a0 = policy.select_action(images, state, ["pick the cube"])
    assert a0.shape == (1, 7) and len(generations) == 1
    np.testing.assert_allclose(
        a0, jpolicy.select_action(images, state, ["pick the cube"]),
        atol=1e-6, rtol=0)
    a1 = policy.select_action(images, state, ["pick the cube"])
    assert a1.shape == (1, 7) and len(generations) == 1
    assert len(policy._queue) == tcfg.n_action_steps - 2
    policy.reset()
    policy.select_action(images, state, ["pick the cube"])
    assert len(generations) == 2
