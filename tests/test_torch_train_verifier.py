"""PyTorch port vs the JAX package: verifier training on the tiny config
with fp32 weights on the CPU — InfoNCE and its retrieval metrics, the
ranking, listwise and regression losses with each member's gradients,
the one-member, ensemble and full steps, validation metrics, the
retrieval harness, the training-side model functions, the Bridge-verifier
dataset and the `train_verifier` role.

Both packages start from the JAX package's initial tree, carried across
with `convert/from_jax.verifier_from_jax` (the random draws of the two
initialisers cannot match). Tolerances, as for the π0 training path
(tests/test_torch_training.py): losses atol 1e-5; gradients per leaf
within 1e-4 of the largest gradient element of the member's leaves;
parameters after each step within 1e-4 (10% of the learning rate), and
within 1e-5 (1%) in all but ADAMW_SHARE of the elements, outside the
attention key biases. A softmax is invariant to a key bias, so its
gradient is rounding noise on both sides, and Adam divides each gradient
by its own RMS: such an element moves by a noise-driven fraction of lr,
so the key biases are held to one lr (measured: 77 of the heads' 288
key-bias elements beyond 1e-5 after 3 ensemble steps, the largest 1.4e-4;
3 of the other 41,814 elements beyond 1e-5).
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.configs import tiny_verifier_config as j_tiny
from cover_vla_tpu.data import bridge_verifier_dataset as jbridge
from cover_vla_tpu.data.tokenizer import make_verifier_tokenizer as j_tok
from cover_vla_tpu.eval import verifier_retrieval as jretrieval
from cover_vla_tpu.models import verifier as jverifier
from cover_vla_tpu.training import optim as joptim
from cover_vla_tpu.training import train_verifier as jtv

from cover_vla_tpu_torch import run
from cover_vla_tpu_torch.configs import (
    fast_verifier_config, tiny_verifier_config)
from cover_vla_tpu_torch.convert import blob, checkpoints
from cover_vla_tpu_torch.convert.from_jax import verifier_from_jax
from cover_vla_tpu_torch.convert.verifier_from_torch import (
    convert_merged_checkpoint)
from cover_vla_tpu_torch.data import bridge_verifier_dataset as bridge
from cover_vla_tpu_torch.data.tokenizer import make_verifier_tokenizer
from cover_vla_tpu_torch.eval import verifier_retrieval as retrieval
from cover_vla_tpu_torch.models import verifier
from cover_vla_tpu_torch.training import optim, train_verifier as tv
from cover_vla_tpu_torch.utils.tree import flatten

JCFG, TCFG = j_tiny(), tiny_verifier_config()
M, B = 3, 4
LR = 1e-3
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 1e-5
ADAMW_SHARE = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    p = jverifier.init_verifier(jax.random.PRNGKey(0), JCFG, num_members=M)
    return _np_tree(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), p))


def _port(np_params):
    return verifier_from_jax(np_params, TCFG, device="cpu")


def _histories(rng, n, h=10, lengths=None):
    hist = rng.uniform(-1, 1, (n, h, 7)).astype(np.float32)
    for i, length in enumerate(lengths or []):
        hist[i, :h - length] = -5.0            # top padding
    return hist


def _batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    s, t = JCFG.vision.image_size, JCFG.text.context_length
    return {
        "images": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "text_tokens": rng.integers(1, JCFG.text.vocab_size,
                                    (b, t)).astype(np.int32),
        "action_histories": _histories(rng, b, lengths=[4, 7]),
    }


def _cand_batch(seed=0, n=5):
    rng = np.random.default_rng(seed)
    b = _batch(seed)
    del b["action_histories"]
    b["pos_traj"] = _histories(rng, B)
    b["neg_trajs"] = rng.uniform(-1, 1, (B, n - 1, 10, 7)).astype(np.float32)
    b["cand_trajs"] = rng.uniform(-1, 1, (B, n, 10, 7)).astype(np.float32)
    b["qualities"] = rng.uniform(0, 1, (B, n)).astype(np.float32)
    return b


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jflat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jfeats(jp, batch):
    return jverifier.extract_features(jp, JCFG, jnp.asarray(batch["images"]),
                                      jnp.asarray(batch["text_tokens"]))


def _tfeats(tp, batch):
    with torch.no_grad():
        return verifier.extract_features(
            tp, TCFG, torch.from_numpy(batch["images"]),
            torch.from_numpy(batch["text_tokens"]))


def _assert_member_grads_close(got: dict, want: dict):
    """Per leaf and per member: within GRAD_REL of that member's largest
    gradient element."""
    assert set(got) == set(want)
    for m in range(M):
        scale = max(np.abs(v[m]).max() for v in want.values())
        for k, ref in want.items():
            np.testing.assert_allclose(got[k][m], ref[m], rtol=GRAD_REL,
                                       atol=GRAD_REL * scale,
                                       err_msg=f"member {m} {k}")


def _assert_params_close(tparams, jtree):
    """All within 1e-4 (10% of lr); outside the key biases, all but
    ADAMW_SHARE within PARAM_ATOL."""
    want = _jflat(jtree)
    got = flatten(tparams)
    assert set(got) == set(want)
    diff = {k: np.abs(got[k].detach().numpy() - want[k]).ravel()
            for k in want}
    key_bias = [k for k in diff if k.endswith("attn.k.bias")]
    assert max(diff[k].max() for k in key_bias) <= LR
    d = np.concatenate([v for k, v in diff.items() if k not in key_bias])
    assert d.max() <= 1e-4, d.max()
    assert (d > PARAM_ATOL).mean() <= ADAMW_SHARE, (d > PARAM_ATOL).mean()


# ---------------------------------------------------------------------------
# model-side functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [[10, 10], [3, 12, 1], [0]],
                         ids=["full", "ragged", "empty_row"])
def test_pad_action_histories_equal(lengths):
    rng = np.random.default_rng(len(lengths))
    hists = [rng.uniform(-1, 1, (n, 7)) for n in lengths]
    if lengths == [0]:
        hists = [np.zeros((0, 7))]
    want = jverifier.pad_action_histories(hists, 10)
    got = verifier.pad_action_histories(hists, 10)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_contrastive_logits_and_image_text_embed_match(jparams):
    tp, b = _port(jparams), _batch(1)
    jl, jlt = jverifier.contrastive_logits(
        jparams, JCFG, jnp.asarray(b["images"]), jnp.asarray(b["text_tokens"]),
        jnp.asarray(b["action_histories"]), member_idx=2)
    tb = _tbatch(b)
    with torch.no_grad():
        tl, tlt = verifier.contrastive_logits(
            tp, TCFG, tb["images"], tb["text_tokens"],
            tb["action_histories"], member_idx=2)
        temb = verifier.image_text_embed(tp, TCFG, tb["images"],
                                         tb["text_tokens"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOSS_ATOL)
    np.testing.assert_allclose(tlt.numpy(), np.asarray(jlt), atol=LOSS_ATOL)
    jemb = jverifier.image_text_embed(jparams, JCFG,
                                      jnp.asarray(b["images"]),
                                      jnp.asarray(b["text_tokens"]))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=1e-6)


def test_init_member_shapes_match_the_reference():
    shapes = jax.eval_shape(lambda k: jverifier.init_member(k, JCFG),
                            jax.random.PRNGKey(0))
    want = {".".join(str(p.key) for p in path): v for path, v in
            jax.tree_util.tree_leaves_with_path(shapes)}
    got = flatten(verifier.init_member(0, TCFG, num_members=2, device="cpu"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == (2, *v.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------


def test_info_nce_loss_and_metrics_match(jparams):
    tp, b = _port(jparams), _batch(2)
    jf, tf = _jfeats(jparams, b), _tfeats(tp, b)
    jl, jm = jax.vmap(lambda m: jtv.info_nce_loss(
        m, JCFG, jf, jnp.asarray(b["action_histories"])))(jparams["members"])
    with torch.no_grad():
        tl, tm = tv.info_nce_loss(tp["members"], TCFG, tf,
                                  torch.from_numpy(b["action_histories"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOSS_ATOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=LOSS_ATOL, err_msg=k)


def test_retrieval_metrics_count_ties_as_the_reference():
    rng = np.random.default_rng(3)
    logits = rng.integers(0, 3, (5, 5)).astype(np.float32)   # many ties
    want = jtv.retrieval_metrics(jnp.asarray(logits))
    got = tv.retrieval_metrics(torch.from_numpy(logits))
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == float(want[k]), k


_RANKERS = {
    "ranking": (jtv.ranking_loss, tv.ranking_loss,
                ("pos_traj", "neg_trajs"), {}),
    "listwise": (jtv.listwise_ranking_loss, tv.listwise_ranking_loss,
                 ("cand_trajs", "qualities"), {"tau": 0.5}),
    "regression": (jtv.quality_regression_loss, tv.quality_regression_loss,
                   ("cand_trajs", "qualities"), {"q_scale": 5.0}),
}


@pytest.mark.parametrize("name", list(_RANKERS))
def test_ranking_losses_and_per_member_gradients_match(jparams, name):
    jfn, tfn, keys, kw = _RANKERS[name]
    tp, b = _port(jparams), _cand_batch(4)
    jf, tf = _jfeats(jparams, b), _tfeats(tp, b)
    jargs = [jnp.asarray(b[k]) for k in keys]
    targs = [torch.from_numpy(b[k]) for k in keys]

    def jobj(members):
        losses, metrics = jax.vmap(
            lambda m: jfn(m, JCFG, jf, *jargs, **kw))(members)
        return losses.mean(), (losses, metrics)

    (_, (jl, jm)), jg = jax.value_and_grad(jobj, has_aux=True)(
        jparams["members"])
    leaves = flatten(tp["members"])
    for v in leaves.values():
        v.requires_grad_(True)
    tl, tm = tfn(tp["members"], TCFG, tf, *targs, **kw)
    tg = torch.autograd.grad(tl.mean(), list(leaves.values()),
                             allow_unused=True)
    got = {k: (torch.zeros_like(leaves[k]) if g is None else g).numpy()
           for k, g in zip(leaves, tg)}
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=LOSS_ATOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]),
                                   atol=LOSS_ATOL, err_msg=k)
    _assert_member_grads_close(got, _jflat(jg))


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _states(jparams, full=False):
    jtx = joptim.make_adamw(joptim.linear_warmup(LR, 0))
    ttx = optim.make_adamw(optim.linear_warmup(LR, 0))
    tp = _port(jparams)
    if full:
        js = jtv.FullVerifierTrainState(jparams, jtx.init(jparams),
                                        jnp.zeros((), jnp.int32))
        leaves = {k: v.requires_grad_(True) for k, v in flatten(tp).items()}
        ts = tv.FullVerifierTrainState(tp, ttx.init(leaves), optim.counter())
        return jtx, ttx, js, ts, tp
    jm = jparams["members"]
    js = jtv.VerifierTrainState(jm, jtx.init(jm), jnp.zeros((), jnp.int32))
    leaves = {k: v.requires_grad_(True)
              for k, v in flatten(tp["members"]).items()}
    ts = tv.VerifierTrainState(tp["members"], ttx.init(leaves),
                               optim.counter())
    return jtx, ttx, js, ts, tp


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("member_idx", [0, 2])
def test_make_train_step_one_member(jparams, member_idx):
    jtx, ttx, js, ts, tp = _states(jparams)
    jstep = jtv.make_train_step(JCFG, jtx, member_idx=member_idx)
    tstep = tv.make_train_step(TCFG, ttx, member_idx=member_idx)
    jbb = jparams["backbone"]
    before = {k: v.detach().clone() for k, v in flatten(ts.members).items()}
    for i in range(2):
        b = _batch(10 + i)
        js, jm = jstep(js, jbb, _jbatch(b))
        ts, tm = tstep(ts, tp["backbone"], _tbatch(b))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, atol=LOSS_ATOL, err_msg=k)
        _assert_params_close(ts.members, js.members)
    assert int(ts.step) == 2
    # the other members get zero gradients: only weight decay moves them
    after = flatten(ts.members)
    other = [m for m in range(M) if m != member_idx][0]
    assert all(torch.allclose(after[k][other], v[other], rtol=1e-6, atol=0)
               for k, v in before.items())
    assert any(not torch.equal(after[k][member_idx], v[member_idx])
               for k, v in before.items())


def test_ensemble_step_over_three_steps(jparams):
    jtx, ttx, js, ts, tp = _states(jparams)
    jstep = jtv.make_ensemble_train_step(JCFG, jtx)
    tstep = tv.make_ensemble_train_step(TCFG, ttx)
    backbone_before = {k: v.clone() for k, v in flatten(tp["backbone"]).items()}
    b = _batch(20)
    for _ in range(3):
        js, jm = jstep(js, jparams["backbone"], _jbatch(b))
        ts, tm = tstep(ts, tp["backbone"], _tbatch(b))
        assert set(tm) == set(jm)
        assert tm["member_loss"].shape == (M,)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, atol=LOSS_ATOL, err_msg=k)
        _assert_params_close(ts.members, js.members)
    assert all(torch.equal(v, backbone_before[k])
               for k, v in flatten(tp["backbone"]).items())
    # mesh= takes the DDP path: a rank's rows of the global batch (the
    # 2-rank step itself: tests/test_torch_sharded_roles.py); a batch of
    # 4 does not divide over 3 ranks
    mesh = SimpleNamespace(shape=(2, 1), mesh_dim_names=("dp", "fsdp"),
                           get_coordinate=lambda: (1, 0),
                           get_group=lambda axis: None)
    rows = tv.shard_verifier_batch({**_tbatch(b), "instructions": ["a"]},
                                   mesh)
    assert rows["instructions"] == ["a"]
    assert all(torch.equal(rows[k], _tbatch(b)[k][2:]) for k in b)
    odd = SimpleNamespace(shape=(3, 1), mesh_dim_names=("dp", "fsdp"),
                          get_coordinate=lambda: (0, 0),
                          get_group=lambda axis: None)
    with pytest.raises(ValueError, match="does not divide"):
        tv.make_ensemble_train_step(TCFG, ttx, mesh=odd)(
            ts, tp["backbone"], _tbatch(b))


def test_ensemble_gradient_is_each_member_loss_over_m(jparams):
    """The ensemble objective's gradient of member m is 1/M of the
    gradient of m's own loss, in both packages."""
    tp, b = _port(jparams), _batch(21)
    tf = _tfeats(tp, b)
    leaves = flatten(tp["members"])
    for v in leaves.values():
        v.requires_grad_(True)
    ah = torch.from_numpy(b["action_histories"])
    losses, _ = tv.info_nce_loss(tp["members"], TCFG, tf, ah)
    g_mean = torch.autograd.grad(losses.mean(), list(leaves.values()))
    jf = _jfeats(jparams, b)
    jg = _jflat(jax.grad(lambda ms: jax.vmap(lambda m: jtv.info_nce_loss(
        m, JCFG, jf, jnp.asarray(b["action_histories"]))[0])(ms).mean())(
            jparams["members"]))
    _assert_member_grads_close(
        {k: g.numpy() for k, g in zip(leaves, g_mean)}, jg)
    for m in range(M):
        losses, _ = tv.info_nce_loss(tp["members"], TCFG, tf, ah)
        g_own = torch.autograd.grad(losses[m], list(leaves.values()))
        scale = max(g[m].abs().max().item() for g in g_own) / M
        for gm, go in zip(g_mean, g_own):
            torch.testing.assert_close(gm[m], go[m] / M, rtol=1e-5,
                                       atol=1e-6 * scale)


def test_full_step_over_two_steps(jparams):
    jtx, ttx, js, ts, _ = _states(jparams, full=True)
    jstep = jtv.make_full_train_step(JCFG, jtx)
    tstep = tv.make_full_train_step(TCFG, ttx)
    b = _batch(30)
    for _ in range(2):
        js, jm = jstep(js, _jbatch(b))
        ts, tm = tstep(ts, _tbatch(b))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, atol=LOSS_ATOL, err_msg=k)
        _assert_params_close(ts.params, js.params)


@pytest.mark.parametrize("name", list(_RANKERS))
@pytest.mark.parametrize("train_backbone", [False, True])
def test_ranking_steps_match(jparams, name, train_backbone):
    makers = {"ranking": (jtv.make_ranking_train_step,
                          tv.make_ranking_train_step, {}),
              "listwise": (jtv.make_listwise_train_step,
                           tv.make_listwise_train_step, {"tau": 0.5}),
              "regression": (jtv.make_regression_train_step,
                             tv.make_regression_train_step, {"q_scale": 4.0})}
    jmake, tmake, kw = makers[name]
    jtx, ttx, js, ts, _ = _states(jparams, full=True)
    jstep = jmake(JCFG, jtx, train_backbone=train_backbone, **kw)
    tstep = tmake(TCFG, ttx, train_backbone=train_backbone, **kw)
    b = _cand_batch(31)
    js, jm = jstep(js, _jbatch(b))
    ts, tm = tstep(ts, _tbatch(b))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=LOSS_ATOL, err_msg=k)
    _assert_params_close(ts.params, js.params)


def test_kernel_config_steps(jparams):
    """Under the kernel config the frozen-backbone step runs (the towers'
    K2 under no_grad: its plain twin on the CPU) and leaves the backbone
    as it was; a step that differentiates the backbone raises through the
    kernel wrapper's autograd refusal, on the CPU as on the card."""
    kcfg = fast_verifier_config(TCFG)
    _, ttx, _, ts, tp = _states(jparams)
    bb = {k: v.clone() for k, v in flatten(tp["backbone"]).items()}
    ts, tm = tv.make_ensemble_train_step(kcfg, ttx)(ts, tp["backbone"],
                                                    _tbatch(_batch(40)))
    assert np.isfinite(tm["loss"].item())
    assert all(torch.equal(v, bb[k]) for k, v in flatten(tp["backbone"]).items())
    _, ttx, _, fs, _ = _states(jparams, full=True)
    batch = {**_tbatch(_batch(41)), **_tbatch(_cand_batch(41))}
    for step in (tv.make_full_train_step(kcfg, ttx),
                 tv.make_ranking_train_step(kcfg, ttx, train_backbone=True)):
        with pytest.raises(RuntimeError, match="no backward pass"):
            step(fs, batch)
    fs2, m = tv.make_ranking_train_step(kcfg, ttx, train_backbone=False)(
        fs, _tbatch(_cand_batch(41)))
    assert np.isfinite(m["loss"].item())


def test_ensemble_eval_metrics_match(jparams):
    tp, b = _port(jparams), _batch(50)
    want = jtv.ensemble_eval_metrics(jparams["members"], JCFG,
                                     jparams["backbone"], _jbatch(b))
    got = tv.ensemble_eval_metrics(tp["members"], TCFG, tp["backbone"],
                                   _tbatch(b))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=LOSS_ATOL, err_msg=k)


def test_init_train_states(jparams):
    tx = optim.make_adamw(optim.linear_warmup(LR, 10))
    backbone, state = tv.init_train_state(0, TCFG, tx, num_members=2,
                                          device="cpu")
    assert state.members["logit_scale"].shape == (2,)
    assert all(v.requires_grad for v in flatten(state.members).values())
    assert not any(v.requires_grad for v in flatten(backbone).values())
    assert set(state.opt_state["1"]["mu"]) == set(flatten(state.members))
    full = tv.init_full_train_state(0, TCFG, tx, num_members=2, device="cpu")
    assert set(full.opt_state["1"]["mu"]) == set(flatten(full.params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        for init in (tv.init_train_state, tv.init_full_train_state):
            with pytest.raises(RuntimeError, match="CUDA"):
                init(0, TCFG, tx)


# ---------------------------------------------------------------------------
# the retrieval harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", [5, 20])
def test_retrieval_test_results_equal(jparams, pool):
    tp, b = _port(jparams), _batch(60, b=8)
    want = jretrieval.retrieval_test(
        jparams, JCFG, b["images"], b["text_tokens"], b["action_histories"],
        pool_size=pool, seed=3)
    got = retrieval.retrieval_test(
        tp, TCFG, b["images"], b["text_tokens"], b["action_histories"],
        pool_size=pool, seed=3)
    assert got == want
    assert retrieval.display_results(got) == jretrieval.display_results(want)


# ---------------------------------------------------------------------------
# the Bridge-verifier dataset
# ---------------------------------------------------------------------------


def _dataset(tmp_path, n=8, hw=48):
    """As tests/test_verifier_lifecycle.py writes it, .npy images."""
    rng = np.random.default_rng(0)
    samples = []
    for i in range(n):
        np.save(tmp_path / f"img{i}.npy",
                rng.integers(0, 255, (hw, hw, 3)).astype(np.uint8))
        samples.append({
            "image": f"img{i}.npy",
            "instruction": f"put the {['carrot', 'spoon'][i % 2]} on plate",
            "action_history": rng.uniform(-1, 1, (4 + i % 7, 7)),
        })
    path = str(tmp_path / "dataset.json")
    bridge.save_normalized_dataset(path, samples)
    jpath = str(tmp_path / "jax.json")
    jbridge.save_normalized_dataset(jpath, samples)
    return path, jpath


def test_bridge_dataset_files_and_batches_byte_equal(tmp_path):
    path, jpath = _dataset(tmp_path)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    kw = dict(history_length=TCFG.history_length,
              image_size=TCFG.vision.image_size)
    ds, jds = bridge.BridgeVerifierDataset(path, **kw), \
        jbridge.BridgeVerifierDataset(path, **kw)
    tok, jtok = make_verifier_tokenizer(TCFG.text.vocab_size), \
        j_tok(JCFG.text.vocab_size)
    got = list(ds.batches(3, tok, TCFG.text.context_length, seed=5))
    want = list(jds.batches(3, jtok, JCFG.text.context_length, seed=5))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["instructions"] == w["instructions"]
        for k in ("images", "text_tokens", "action_histories"):
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k
    for i in (0, 5):
        g, w = ds.get(i, tok, 16), jds.get(i, jtok, 16)
        assert g["instruction"] == w["instruction"]
        assert all(np.array_equal(g[k], w[k]) for k in
                   ("image", "action_history", "text_tokens"))


@pytest.mark.parametrize("shape,size", [((256, 256), 384), ((48, 64), 64),
                                        ((400, 300), 224), ((384, 384), 384)])
def test_bridge_resize_byte_equal(shape, size):
    from cover_vla_tpu.eval.simpler_utils import _resize_np as j_resize
    from cover_vla_tpu.ops.image import _bicubic_matrix as j_bicubic
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, (*shape, 3)).astype(np.uint8)
    got = bridge._default_preprocess(img, size)
    want = jbridge._default_preprocess(img, size)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert bridge._resize_np(img, size, size, bridge._bicubic_matrix
                             ).tobytes() == j_resize(img, size, size,
                                                     j_bicubic).tobytes()


def test_bridge_streaming_load_and_split(tmp_path):
    path, _ = _dataset(tmp_path)
    full = bridge.BridgeVerifierDataset(path)
    stream = bridge.BridgeVerifierDataset(path, streaming=True)
    assert stream.samples == full.samples
    assert stream.instructions == full.instructions
    assert stream.action_histories == full.action_histories
    # a small read buffer: tokens straddle the chunk boundaries
    for key in ("samples", "action_histories"):
        small = list(bridge._stream_json_field(path, key, chunk_size=7))
        assert small == list(jbridge._stream_json_field(path, key,
                                                        chunk_size=7))
    tr1, va1 = full.split(0.25, seed=3)
    tr2, va2 = full.split(0.25, seed=3)
    jtr, jva = jbridge.BridgeVerifierDataset(path).split(0.25, seed=3)
    assert va1.samples == va2.samples == jva.samples
    assert tr1.samples == tr2.samples == jtr.samples
    assert len(va1) == 2 and len(tr1) == 6


# ---------------------------------------------------------------------------
# the train_verifier role
# ---------------------------------------------------------------------------


def _role_args(path, ck, steps, *extra):
    return ["--role", "train_verifier", "--train.tiny", "true",
            "--train.dataset_dir", path, "--train.num_members", "2",
            "--train.batch_size", "3", "--train.val_every", "2",
            "--train.val_fraction", "0.25", "--train.checkpoint_dir", ck,
            "--train.save_every", "1000", "--train.keep_last", "2",
            "--train.num_steps", str(steps), *extra]


def test_role_train_verifier_lifecycle(tmp_path):
    """train 2 members -> best/ + merged export -> restore -> resume, as
    tests/test_verifier_lifecycle.py::test_cli_verifier_lifecycle runs
    the JAX role."""
    path, _ = _dataset(tmp_path)
    ck = str(tmp_path / "ck")
    run.main(_role_args(os.path.dirname(path), ck, 3), device="cpu")
    kept = [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)]
    assert kept == ["step_00000002", "step_00000003"]
    assert os.path.isfile(os.path.join(ck, "best", checkpoints.BLOB_NAME))
    saved = blob.load_tree(os.path.join(ck, kept[-1], checkpoints.BLOB_NAME))
    assert set(saved) == {"members", "opt_state", "backbone"}
    assert int(saved["opt_state"]["1"]["count"]) == 3
    # the merged export reads back with members bit-equal to the saved ones
    back = convert_merged_checkpoint(os.path.join(ck, "merged_ensemble.pt"),
                                     TCFG, device="cpu")
    got = flatten(back["members"])
    want = flatten(saved["members"])
    assert set(got) == set(want)
    assert all(torch.equal(got[k].float(), want[k].float()) for k in want)
    recs = [json.loads(line) for line in open(os.path.join(ck,
                                                           "metrics.jsonl"))]
    assert recs[0]["_step"] == 0 and "member_loss" not in recs[0]
    assert {"loss", "grad_norm", "top1_i2a", "top5_a2i",
            "logit_scale"} <= set(recs[0])
    assert [r["_step"] for r in recs if "val/top1_i2a" in r] == [2]

    # a fresh state restored from the latest checkpoint, bit for bit
    tx = optim.make_adamw(optim.linear_warmup(5e-5, 100))
    backbone, state = tv.init_train_state(7, TCFG, tx, num_members=2,
                                          device="cpu")
    target = tv.VerifierCheckpoint(state.members, state.opt_state, backbone)
    restored, at = checkpoints.restore_train_state(ck, target)
    assert at == 3
    got, want = flatten(restored._asdict()), flatten(saved)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    run.main(_role_args(os.path.dirname(path), ck, 5, "--train.resume",
                        "true"), device="cpu")
    latest = checkpoints.latest_checkpoint(ck)
    assert latest.endswith("step_00000005")
    final = blob.load_tree(os.path.join(latest, checkpoints.BLOB_NAME))
    assert int(final["opt_state"]["1"]["count"]) == 5
    assert torch.equal(final["backbone"]["vision"]["blocks"]["attn"]["q"]
                       ["kernel"], saved["backbone"]["vision"]["blocks"]
                       ["attn"]["q"]["kernel"])


def test_role_train_verifier_refusals(tmp_path, monkeypatch):
    path, _ = _dataset(tmp_path, n=4)
    with pytest.raises(ValueError, match="no batch"):
        run.main(_role_args(path, str(tmp_path / "ck"), 1,
                            "--train.batch_size", "4"), device="cpu")
    # a world size without an address is a half-configured launch
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        run.main(_role_args(path, str(tmp_path / "ck"), 1), device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(_role_args(path, str(tmp_path / "ck"), 1))
