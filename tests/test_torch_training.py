"""PyTorch port vs the JAX package: the π0 training path on tiny configs
with fp32 weights on the CPU — the flow-matching loss and its gradients,
the fused forward, the schedules, AdamW and 8-bit AdamW, the train steps
(full and partitioned, accumulation, freezing), train-state checkpoints
and validation.

JAX PRNG streams cannot be reproduced in torch: the flow noise and times
are injected on both sides (the JAX package's `sample_noise` and
`sample_flow_time` are patched in its pi0 module for the test; its jitted
step calls them only while tracing, so every step gets the same arrays).

Tolerances: losses atol 1e-5; gradients per leaf within 1e-4 of the
largest gradient element of the tree (a key bias gets ~1e-10 noise on
both sides); parameters after each step atol 1e-5, 1% of the learning
rate, in all but a stated share of elements (Adam divides each gradient
by its own RMS, so an element whose gradient is rounding noise, such as a
key bias, which cannot move the softmax, moves by a noise-driven
fraction of lr on both sides; see ADAMW_8BIT_SHARE for the int8 grids);
optimizer updates given the same gradients bit-equal to the JAX
transforms run op by op (jit's fusion moves them by ulps); schedules
within 1e-6 of the peak rate.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cover_vla_tpu.configs import (
    tiny_pi0_config as j_tiny_pi0, replace as j_replace)
from cover_vla_tpu.models import gemma as jgemma
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.ops import image as jimage
from cover_vla_tpu.ops import masks as jmasks
from cover_vla_tpu.ops import sampling as jsampling
from cover_vla_tpu.training import optim as joptim
from cover_vla_tpu.training import quantized_optim as jq
from cover_vla_tpu.training import train_pi0 as jtrain
from cover_vla_tpu.training import validation as jval

from cover_vla_tpu_torch.configs import tiny_pi0_config, replace
from cover_vla_tpu_torch.convert import checkpoints
from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax
from cover_vla_tpu_torch.models import gemma, pi0
from cover_vla_tpu_torch.ops import image, masks, sampling
from cover_vla_tpu_torch.training import optim, quantized_optim, train_pi0
from cover_vla_tpu_torch.training import validation
from cover_vla_tpu_torch.utils.tree import flatten

JCFG = j_replace(j_tiny_pi0(), compute_dtype="float32")
TCFG = replace(tiny_pi0_config(), compute_dtype="float32")
B = 3
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 1e-5
# through the train steps: AdamW's parameters all within 1e-4 (10% of lr)
# and all but 1e-4 of them within PARAM_ATOL; after each teacher-forced
# 8-bit AdamW step all but 1% (measured: at most 0.013% expert-only,
# 0.027% for the whole tree). Its int8 grids round gradients that differ
# by ~1e-7, and a block whose gradients are rounding noise on both sides
# (a gradient that is zero mathematically) quantises to unrelated values;
# an element whose second moment rounds to 0 while its first keeps a
# quantum then steps by many times lr. The grids given the same gradients
# are bit-equal (test_adamw_8bit_bit_equal_to_jax); after each step at
# most 1% of their entries differ (measured at most 0.002% expert-only,
# 0.016% for the whole tree). Over untouched steps those differences
# compound by an amount that depends on the host, so the 8-bit steps are
# compared one at a time.
ADAMW_SHARE, ADAMW_8BIT_SHARE, GRID_SHARE = 1e-4, 1e-2, 1e-2
SCHEDULE_REL = 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    p = jpi0.init_pi0(jax.random.PRNGKey(0), JCFG)
    return _np_tree(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), p))


def _port(np_params):
    return pi0_from_jax(np_params, TCFG, device="cpu")


def _batch(seed=0, pad=True):
    rng = np.random.default_rng(seed)
    s, t = JCFG.vision.image_size, JCFG.tokenizer_max_length
    b = {
        "images": rng.uniform(-1, 1, (B, 1, s, s, 3)).astype(np.float32),
        "img_masks": np.ones((B, 1), bool),
        "lang_tokens": rng.integers(0, JCFG.paligemma.vocab_size,
                                    (B, t)).astype(np.int32),
        "lang_masks": np.ones((B, t), bool),
        "state": rng.standard_normal((B, 32)).astype(np.float32),
        "actions": rng.standard_normal((B, JCFG.chunk_size, 32)
                                       ).astype(np.float32),
    }
    b["lang_masks"][1, t - 3:] = False
    if pad:
        is_pad = np.zeros((B, JCFG.chunk_size), bool)
        is_pad[0, -2:] = True
        b["actions_is_pad"] = is_pad
    return b


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _draws(seed=0):
    rng = np.random.default_rng(100 + seed)
    noise = rng.standard_normal((B, JCFG.chunk_size, 32)).astype(np.float32)
    time = rng.uniform(0.001, 1.0, (B,)).astype(np.float32)
    return noise, time


@pytest.fixture
def inject(monkeypatch):
    """Make the JAX package's pi0 use the given noise and flow times."""
    def set_draws(noise, time):
        monkeypatch.setattr(jpi0, "sample_noise",
                            lambda key, shape, std=1.0: jnp.asarray(noise))
        monkeypatch.setattr(jpi0, "sample_flow_time",
                            lambda key, b: jnp.asarray(time))
    return set_draws


def _jflat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k, ref in want.items():
        np.testing.assert_allclose(got[k], ref, rtol=GRAD_REL,
                                   atol=GRAD_REL * scale, err_msg=k)


def _mismatch_share(tparams, jtree) -> tuple:
    """(share of elements beyond PARAM_ATOL, largest difference)."""
    want = _jflat(jtree)
    d = np.concatenate([np.abs(v.detach().numpy() - want[k]).ravel()
                        for k, v in flatten(tparams).items()])
    return float((d > PARAM_ATOL).mean()), float(d.max())


def _grid_mismatch_share(tstate, jopt) -> float:
    """Share of the int8 moment entries that differ. A partitioned JAX
    state holds its moments as a list in the trainable leaves' order."""
    n = bad = 0
    for mom in ("mu", "nu"):
        names = sorted(tstate[mom])
        for path, v in jax.tree_util.tree_leaves_with_path(
                getattr(jopt, mom)):
            if getattr(path[-1], "name", None) != "values":
                continue
            k = (names[path[0].idx] if hasattr(path[0], "idx")
                 else ".".join(str(p.key) for p in path[:-1]))
            d = tstate[mom][k]["values"].numpy() != np.asarray(v)
            n, bad = n + d.size, bad + int(d.sum())
    return bad / n


def _assert_params_close(tparams, jtree, atol=PARAM_ATOL, key_bias=None):
    """Every leaf within atol of JAX's; with key_bias, the attention key
    biases within that instead (a softmax is invariant to a key bias, so
    its gradient is zero in exact arithmetic and Adam moves it by a
    noise-driven fraction of lr on both sides)."""
    want = _jflat(jtree)
    for k, v in flatten(tparams).items():
        tol = key_bias if key_bias is not None and k.endswith(
            "attn.k.bias") else atol
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0,
                                   atol=tol, err_msg=k)


def _teacher_force(ts, js) -> None:
    """Set the port's state to the JAX state's values in place: the
    parameters, the 8-bit moments' grids and scales and the count, so the
    next step is a one-step comparison. A partitioned JAX state holds its
    moments as a list in the trainable leaves' order."""
    want = _jflat(js.params)
    with torch.no_grad():
        for k, v in flatten(ts.params).items():
            v.copy_(torch.from_numpy(np.array(want[k])))
    tstate, jopt = ts.opt_state["1"], js.opt_state[1]
    for mom in ("mu", "nu"):
        names = sorted(tstate[mom])
        for path, v in jax.tree_util.tree_leaves_with_path(
                getattr(jopt, mom)):
            k = (names[path[0].idx] if hasattr(path[0], "idx")
                 else ".".join(str(p.key) for p in path[:-1]))
            tstate[mom][k][path[-1].name].copy_(
                torch.from_numpy(np.array(v)))
    tstate["count"].copy_(torch.tensor(int(jopt.count)))


# ---------------------------------------------------------------------------
# model-side pieces
# ---------------------------------------------------------------------------


def test_sample_beta_two_uniform_construction():
    gen = torch.Generator().manual_seed(3)
    got = sampling.sample_beta(1.5, 1.0, 1000, generator=gen, device="cpu")
    gen = torch.Generator().manual_seed(3)
    u1, u2 = torch.rand(1000, generator=gen), torch.rand(1000, generator=gen)
    g1, g2 = u1 ** (1 / 1.5), u2 ** 1.0
    assert torch.equal(got, g1 / (g1 + g2))
    t = sampling.sample_flow_time(20000, generator=torch.Generator()
                                  .manual_seed(0), device="cpu").numpy()
    assert 0.001 <= t.min() and t.max() <= 1.0
    tj = np.asarray(jsampling.sample_flow_time(jax.random.PRNGKey(0), 20000))
    # the same distribution: means and quartiles within sampling noise
    np.testing.assert_allclose(t.mean(), tj.mean(), atol=0.01)
    np.testing.assert_allclose(np.percentile(t, [25, 50, 75]),
                               np.percentile(tj, [25, 50, 75]), atol=0.015)


def test_prefix_masks_and_training_image_ops():
    assert np.array_equal(masks.prefix_att_masks(2, 5, 3).numpy(),
                          np.asarray(jmasks.prefix_att_masks(2, 5, 3)))
    rng = np.random.default_rng(0)
    for src, dst in (((37, 53), (56, 56)), ((240, 320), (224, 224)),
                     ((56, 56), (28, 70))):
        x = rng.uniform(-1, 1, (2, *src, 3)).astype(np.float32)
        np.testing.assert_allclose(
            image.resize_bilinear_torch(torch.from_numpy(x), *dst).numpy(),
            np.asarray(jimage.resize_bilinear_torch(x, *dst)),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            image.resize_with_pad(torch.from_numpy(x), 224, 224,
                                  pad_value=-1.0).numpy(),
            np.asarray(jimage.resize_with_pad(x, 224, 224, pad_value=-1.0)),
            rtol=0, atol=1e-6)
    u8 = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    assert np.array_equal(image.to_siglip_range(torch.from_numpy(u8)).numpy(),
                          np.asarray(jimage.to_siglip_range(u8)))


@pytest.mark.parametrize("pad", [False, True])
def test_flow_matching_loss_and_grads_match(jparams, inject, pad):
    batch = _batch(pad=pad)
    noise, time = _draws()
    inject(noise, time)

    def jloss(p):
        loss, _ = jtrain.loss_fn(p, JCFG, jax.random.PRNGKey(0), batch)
        return loss
    jl, jg = jax.value_and_grad(jloss)(jax.tree_util.tree_map(
        jnp.asarray, jparams))

    tp = _port(jparams)
    leaves = {k: v.requires_grad_(True) for k, v in flatten(tp).items()}
    tl, _ = train_pi0.loss_fn(tp, TCFG, None, _tbatch(batch),
                              noise=torch.from_numpy(noise),
                              time=torch.from_numpy(time))
    grads = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True)
    np.testing.assert_allclose(tl.item(), float(jl), atol=LOSS_ATOL, rtol=0)
    _assert_grads_close(
        {k: np.zeros(leaves[k].shape, np.float32) if g is None
         else g.numpy() for k, g in zip(leaves, grads)}, _jflat(jg))

    # the per-element losses as well
    keys = ("images", "img_masks", "lang_tokens", "lang_masks", "state",
            "actions")
    want = jpi0.flow_matching_loss(jparams, JCFG, jax.random.PRNGKey(0),
                                   *[batch[k] for k in keys])
    with torch.no_grad():
        got = pi0.flow_matching_loss(
            tp, TCFG, *[_tbatch(batch)[k] for k in keys],
            noise=torch.from_numpy(noise), time=torch.from_numpy(time))
    assert got.shape == (B, JCFG.chunk_size, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOSS_ATOL)


def test_fused_forward_matches_and_remat_changes_nothing(jparams):
    rng = np.random.default_rng(1)
    p_len, s_len = 12, 5
    pre = rng.standard_normal((2, p_len, 64)).astype(np.float32)
    suf = rng.standard_normal((2, s_len, 32)).astype(np.float32)
    pad = np.ones((2, p_len + s_len), bool)
    pad[1, p_len - 3:p_len] = False
    att = np.concatenate([np.zeros((2, p_len), np.int32),
                          np.asarray(jmasks.suffix_att_masks(2, s_len - 1))], 1)
    mask = np.asarray(jmasks.make_att_2d_masks(pad, att))
    pos = np.cumsum(pad.astype(np.int32), axis=1) - 1
    want = jgemma.fused_forward(jparams["paligemma"], jparams["expert"],
                                JCFG.paligemma, JCFG.expert, pre, suf, pos,
                                mask)
    outs, grads = [], []
    for remat in (False, True):
        tp = _port(jparams)
        ex = {k: v.requires_grad_(True)
              for k, v in flatten(tp["expert"]).items()}
        hp, hs = gemma.fused_forward(
            tp["paligemma"], tp["expert"], TCFG.paligemma, TCFG.expert,
            torch.from_numpy(pre), torch.from_numpy(suf),
            torch.from_numpy(pos), torch.from_numpy(mask), remat=remat)
        g = torch.autograd.grad(hs.square().sum(), list(ex.values()))
        outs.append((hp.detach(), hs.detach()))
        grads.append(g)
        for got, ref in zip((hp, hs), want):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                       rtol=0, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    assert all(torch.equal(a, b) for a, b in zip(grads[0], grads[1]))


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lr,warmup,total", [
    (5e-5, 100, 300), (1e-3, 10, 5), (1e-3, 0, 20), (2e-4, 1, 1)])
def test_warmup_cosine_matches_optax(lr, warmup, total):
    mine = optim.warmup_cosine(lr, warmup, total)
    ref = joptim.warmup_cosine(lr, warmup, total)
    got = np.array([mine(i) for i in range(total + 6)])
    want = np.array([float(ref(i)) for i in range(total + 6)])
    np.testing.assert_allclose(got, want, rtol=0, atol=SCHEDULE_REL * lr)
    assert got[0] == want[0]


def test_linear_warmup_matches_optax():
    mine, ref = optim.linear_warmup(1e-4, 5), joptim.linear_warmup(1e-4, 5)
    got = np.array([mine(i) for i in range(12)])
    want = np.array([float(ref(i)) for i in range(12)])
    np.testing.assert_allclose(got, want, rtol=0, atol=SCHEDULE_REL * 1e-4)


def _grad_sets(shapes, n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-4, 1)
                 ).astype(dtype) for k, s in shapes.items()}
            for _ in range(n)]


def _t(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _jnp(tree):
    """JAX arrays (the update runs op by op, outside jit)."""
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _bits(x):
    """The elements as comparable bit patterns (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_adamw_8bit_bit_equal_to_jax():
    shapes = {"a": (300,), "b": (17, 33), "c": (4, 256), "d": (5, 7)}
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    params["d"] = np.asarray(jnp.asarray(params["d"], jnp.bfloat16))
    grads = _grad_sets(shapes, 3)
    jt = jq.adamw_8bit(joptim.warmup_cosine(1e-3, 2, 10))
    tt = quantized_optim.adamw_8bit(optim.warmup_cosine(1e-3, 2, 10))
    tparams = {k: _t(v) for k, v in params.items()}
    jstate, tstate = jt.init(params), tt.init(tparams)
    for i in range(3):
        ju, jstate = jt.update(_jnp(grads[i]), jstate, _jnp(params))
        tu, tstate = tt.update({k: _t(v) for k, v in grads[i].items()},
                               tstate, tparams)
        assert int(tstate["count"]) == int(jstate.count) == i + 1
        for k in shapes:
            assert tu[k].dtype == _t(params[k]).dtype
            assert np.array_equal(_bits(tu[k]), _bits(ju[k])), (i, k)
            for mom, jm in (("mu", jstate.mu[k]), ("nu", jstate.nu[k])):
                q = tstate[mom][k]
                assert q["values"].dtype == torch.int8
                assert np.array_equal(q["values"].numpy(),
                                      np.asarray(jm.values)), (i, k, mom)
                assert np.array_equal(q["scales"].numpy(),
                                      np.asarray(jm.scales)), (i, k, mom)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_bit_equal_to_optax(dtype):
    """Clip -> AdamW given the same gradients, op by op: bit-equal
    updates and moments, the moments in the leaf's dtype, and the first
    update zero (the schedule is read at count 0). The gradients' global
    norm stays below the clip: the norm is a sum whose order differs
    between the packages (`test_clip_by_global_norm_matches_optax`)."""
    shapes = {"a": (300,), "b": (17, 33)}
    rng = np.random.default_rng(2)
    params = {k: np.asarray(jnp.asarray(rng.standard_normal(s), dtype))
              for k, s in shapes.items()}
    grads = []
    for g in _grad_sets(shapes, 3, seed=3):
        norm = np.sqrt(sum(np.square(v).sum() for v in g.values()))
        grads.append({k: np.asarray(jnp.asarray(v * (0.5 / norm), dtype))
                      for k, v in g.items()})
    jt = joptim.make_adamw(joptim.warmup_cosine(1e-3, 2, 10))
    tt = optim.make_adamw(optim.warmup_cosine(1e-3, 2, 10))
    tparams = {k: _t(v) for k, v in params.items()}
    jstate, tstate = jt.init(_jnp(params)), tt.init(tparams)
    for i in range(3):
        ju, jstate = jt.update(_jnp(grads[i]), jstate, _jnp(params))
        tu, tstate = tt.update({k: _t(v) for k, v in grads[i].items()},
                               tstate, tparams)
        jadam = jstate[1][0]
        for k in shapes:
            assert tstate["1"]["mu"][k].dtype == tparams[k].dtype
            assert tu[k].dtype == tparams[k].dtype
            assert np.array_equal(_bits(tu[k]), _bits(ju[k])), (i, k)
            assert np.array_equal(_bits(tstate["1"]["mu"][k]),
                                  _bits(jadam.mu[k])), (i, k)
            assert np.array_equal(_bits(tstate["1"]["nu"][k]),
                                  _bits(jadam.nu[k])), (i, k)
            if i == 0:
                assert not tu[k].float().abs().any()


def test_clip_by_global_norm_matches_optax():
    """Above the max norm every gradient is scaled by max_norm / norm (no
    epsilon); below it they pass through unchanged."""
    shapes = {"a": (30,), "b": (4, 5)}
    for scale in (1e-3, 10.0):
        g = {k: (v * scale).astype(np.float32)
             for k, v in _grad_sets(shapes, 1, seed=4)[0].items()}
        ju, _ = optax.clip_by_global_norm(1.0).update(g, None)
        tu, _ = optim.clip_by_global_norm(1.0).update(
            {k: _t(v) for k, v in g.items()}, {})
        for k in shapes:      # the norm's sum order differs: ulps
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=0)
        if scale < 1:
            assert all(np.array_equal(tu[k].numpy(), g[k]) for k in shapes)


# ---------------------------------------------------------------------------
# train steps against the JAX package
# ---------------------------------------------------------------------------


def _jax_state(jparams, tx, partitioned):
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    if partitioned:
        mask = jtrain.freeze_mask(jp, train_expert_only=True)
        return (jtrain.init_partitioned_state(jp, tx, mask),
                jtrain.make_partitioned_train_step(JCFG, tx, mask))
    return (jtrain.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32)),
            jtrain.make_train_step(JCFG, tx))


def _port_state(jparams, tx, partitioned):
    tp = _port(jparams)
    if partitioned:
        mask = train_pi0.freeze_mask(tp, train_expert_only=True)
        return (train_pi0.init_partitioned_state(tp, tx, mask),
                train_pi0.make_partitioned_train_step(TCFG, tx, mask))
    leaves = {k: v.requires_grad_(True) for k, v in flatten(tp).items()}
    return (train_pi0.TrainState(tp, tx.init(leaves), optim.counter()),
            train_pi0.make_train_step(TCFG, tx))


@pytest.mark.parametrize("partitioned", [True, False],
                         ids=["partitioned", "full"])
@pytest.mark.parametrize("opt", ["adamw", "adamw_8bit"])
def test_train_steps_match_jax(jparams, inject, opt, partitioned):
    """Three steps of each optimizer through the train steps, parameters
    compared after each (optax AdamW's first update is zero, so one step
    would prove nothing). AdamW runs one untouched trajectory. 8-bit AdamW
    is teacher-forced: each port step starts from the JAX step's
    parameters and optimizer state of the step before and is held to the
    one-step bounds, so the int8 grids cannot compound the host's 1e-7
    gradient differences over the steps."""
    noise, time = _draws()
    inject(noise, time)
    batch = _batch()
    js, jstep = _jax_state(jparams, jtrain.make_optimizer(
        joptim.warmup_cosine(1e-3, 1, 20), optimizer=opt), partitioned)
    ts, tstep = _port_state(jparams, train_pi0.make_optimizer(
        optim.warmup_cosine(1e-3, 1, 20), optimizer=opt), partitioned)
    moved = []
    for i in range(3):
        if opt == "adamw_8bit" and i > 0:
            _teacher_force(ts, js)
        before = {k: v.detach().clone() for k, v in flatten(ts.params).items()}
        js, jm = jstep(js, jax.random.PRNGKey(i), batch)
        ts, tm = tstep(ts, None, _tbatch(batch), noise=torch.from_numpy(noise),
                       time=torch.from_numpy(time))
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=0, atol=LOSS_ATOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        share, worst = _mismatch_share(ts.params, js.params)
        if opt == "adamw":
            assert share <= ADAMW_SHARE and worst <= 1e-4, (i, share, worst)
        else:
            assert share <= ADAMW_8BIT_SHARE, (i, share, worst)
            assert _grid_mismatch_share(ts.opt_state["1"],
                                        js.opt_state[1]) <= GRID_SHARE
        moved.append(any(not torch.equal(before[k], v)
                         for k, v in flatten(ts.params).items()))
    # optax AdamW reads the schedule at count 0 (zero); adamw_8bit at 1
    assert moved == ([False, True, True] if opt == "adamw" else [True] * 3)


def test_grad_accum_matches_multisteps(jparams, inject):
    """grad_accum 2: the running mean of two micro-batches' gradients is
    applied on every second call; parameters do not move in between."""
    noise, time = _draws()
    inject(noise, time)
    batches = [_batch(seed=0), _batch(seed=1)] * 2
    js, jstep = _jax_state(jparams, jtrain.make_optimizer(
        joptim.warmup_cosine(1e-3, 0, 20), accumulate_steps=2), False)
    ts, tstep = _port_state(jparams, train_pi0.make_optimizer(
        optim.warmup_cosine(1e-3, 0, 20), accumulate_steps=2), False)
    start = {k: v.detach().clone() for k, v in flatten(ts.params).items()}
    for i, batch in enumerate(batches):
        js, jm = jstep(js, jax.random.PRNGKey(i), batch)
        ts, tm = tstep(ts, None, _tbatch(batch), noise=torch.from_numpy(noise),
                       time=torch.from_numpy(time))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=0, atol=LOSS_ATOL)
        _assert_params_close(ts.params, js.params, key_bias=1e-3)   # lr
        assert int(ts.opt_state["mini_step"]) == int(js.opt_state.mini_step)
        assert int(ts.opt_state["gradient_step"]) == \
            int(js.opt_state.gradient_step) == (i + 1) // 2
        if i == 0:
            assert all(torch.equal(start[k], v)
                       for k, v in flatten(ts.params).items())
    assert int(ts.opt_state["inner"]["1"]["count"]) == 2


def test_freeze_semantics(jparams, inject):
    """make_optimizer(mask=) zeroes frozen updates (frozen leaves stay
    bit-equal) and trains the rest as the partitioned step does; the
    partitioned state holds moments for the trainable leaves only."""
    noise, time = _draws()
    inject(noise, time)
    tp = _port(jparams)
    mask = train_pi0.freeze_mask(tp, train_expert_only=True)
    jmask = jtrain.freeze_mask(jparams, train_expert_only=True)
    assert flatten(mask) == _jflat(jmask)
    trainable = {k for k, m in flatten(mask).items() if m}
    assert trainable and all(k.split(".")[0] not in
                             ("vision", "paligemma", "mm_proj")
                             for k in trainable)

    sched = optim.warmup_cosine(1e-2, 0, 50)
    full, full_step = _port_state(jparams, train_pi0.make_optimizer(
        sched, mask=mask), False)
    part, part_step = _port_state(jparams, train_pi0.make_optimizer(sched),
                                  True)
    assert set(part.opt_state["1"]["mu"]) == trainable
    init = {k: v.detach().clone() for k, v in flatten(full.params).items()}
    for i in range(2):
        kw = dict(noise=torch.from_numpy(noise), time=torch.from_numpy(time))
        full, _ = full_step(full, None, _tbatch(_batch()), **kw)
        part, _ = part_step(part, None, _tbatch(_batch()), **kw)
    fl, pl = flatten(full.params), flatten(part.params)
    for k, v in init.items():
        if k in trainable:
            assert not torch.equal(v, fl[k]) or not v.any(), k
            np.testing.assert_allclose(fl[k].detach().numpy(),
                                       pl[k].detach().numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
        else:
            assert torch.equal(v, fl[k]) and torch.equal(v, pl[k]), k
            assert pl[k].grad is None and not pl[k].requires_grad


@pytest.mark.parametrize("opt", ["adamw", "adamw_8bit"])
def test_train_state_save_restore_continues_bit_identically(
        tmp_path, jparams, opt):
    """Save after 3 calls of grad_accum 2 (a mini-step pending), restore
    into a state built from other weights, and run 2 more calls: every
    parameter, moment, grid, scale, counter and the accumulation buffer
    equal bit for bit those of the run that was never saved."""
    def fresh(seed):
        tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 1, 10),
                                      optimizer=opt, accumulate_steps=2)
        state, mask = train_pi0.init_partitioned_train_state(
            seed, TCFG, tx, device="cpu")
        return state, train_pi0.make_partitioned_train_step(TCFG, tx, mask)

    def run(state, step, calls):
        for i in calls:
            state, _ = step(state, torch.Generator().manual_seed(i),
                            _tbatch(_batch(seed=i)))
        return state

    state, step = fresh(0)
    state = run(state, step, range(3))
    checkpoints.save_train_state(str(tmp_path), 3, state, keep_last=1)
    want = flatten(run(state, step, range(3, 5))._asdict())

    other, other_step = fresh(1)
    restored, at = checkpoints.restore_train_state(str(tmp_path), other)
    assert at == 3 and int(restored.step) == 3
    assert int(restored.opt_state["mini_step"]) == 1
    got = flatten(run(restored, other_step, range(3, 5))._asdict())
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_restore_refuses_a_mismatched_state(tmp_path):
    tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 1, 10))
    state, _ = train_pi0.init_partitioned_train_state(0, TCFG, tx,
                                                      device="cpu")
    checkpoints.save_train_state(str(tmp_path), 1, state)
    tx8 = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 1, 10),
                                   optimizer="adamw_8bit")
    other, _ = train_pi0.init_partitioned_train_state(0, TCFG, tx8,
                                                      device="cpu")
    with pytest.raises(KeyError):
        checkpoints.restore_train_state(str(tmp_path), other)


def test_bf16_tree_moments_and_first_update():
    """On the default (bf16 transformer) tree: AdamW's moments take each
    leaf's dtype and its first update is zero; 8-bit AdamW's moments are
    int8 grids and its first step moves the trainable leaves."""
    cfg = tiny_pi0_config()
    batch = _tbatch(_batch())
    for opt in ("adamw", "adamw_8bit"):
        tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 10, 100),
                                      optimizer=opt)
        state, mask = train_pi0.init_partitioned_train_state(
            0, cfg, tx, device="cpu")
        step = train_pi0.make_partitioned_train_step(cfg, tx, mask)
        leaves = flatten(state.params)
        before = {k: v.detach().clone() for k, v in leaves.items()}
        for k, mu in state.opt_state["1"]["mu"].items():
            if opt == "adamw":
                assert mu.dtype == leaves[k].dtype
            else:
                assert mu["values"].dtype == torch.int8
        assert leaves["expert.layers.q"].dtype == torch.bfloat16
        state, metrics = step(state, torch.Generator().manual_seed(0), batch)
        assert np.isfinite(metrics["loss"].item())
        moved = [k for k, v in flatten(state.params).items()
                 if not torch.equal(before[k], v)]
        assert moved == ([] if opt == "adamw" else
                         [k for k, m in flatten(mask).items() if m])


def test_validate_pi0_matches_jax(jparams):
    """Zero-noise rollouts against the ground truth: the same accuracy
    dictionary (mae within 1e-5; no error lies within 1e-5 of a
    threshold here)."""
    batch = _batch()
    want = jval.validate_pi0(jparams, JCFG, batch)
    tp = _port(jparams)
    for leaf in flatten(tp).values():
        leaf.requires_grad_(True)       # as during training
    got = validation.validate_pi0(tp, TCFG, _tbatch(batch))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["mae"], want["mae"], rtol=0, atol=1e-5)
    assert {k: v for k, v in got.items() if k != "mae"} == \
        {k: v for k, v in want.items() if k != "mae"}


def test_sharded_training_raises():
    """The mesh= paths as far as they go without a process group: the
    sharded states hold this rank's flat, block-aligned ranges of the
    seed's leaves (the moments of the trainable ones only), shard_batch
    takes the rank's rows, and a batch that does not divide over the
    ranks is refused. The steps themselves run in gloo processes:
    tests/test_torch_sharded_training.py."""
    from types import SimpleNamespace
    from cover_vla_tpu_torch.parallel.mesh import FlatShard, shard_tensor
    mesh = SimpleNamespace(shape=(1, 2), mesh_dim_names=("dp", "fsdp"),
                           get_coordinate=lambda: (0, 1),
                           get_group=lambda axis: None)
    tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 1, 10))
    whole = flatten(pi0.init_pi0(0, TCFG, device="cpu"))
    state = train_pi0.init_train_state(0, TCFG, tx, mesh=mesh, device="cpu")
    part, mask = train_pi0.init_partitioned_train_state(
        0, TCFG, tx, mesh=mesh, device="cpu")
    for s in (state, part):
        plan = s.params.shard_plan
        assert {k for k, v in plan.items() if isinstance(v, FlatShard)} == \
            {k for k, v in whole.items() if v.numel() >= 2 ** 14}
        for k, v in flatten(s.params).items():
            want = (shard_tensor(whole[k], plan[k])
                    if isinstance(plan[k], FlatShard) else whole[k])
            assert torch.equal(v, want), k
    assert set(part.opt_state["1"]["mu"]) == {
        k for k, m in flatten(mask).items() if m}
    assert set(state.opt_state["1"]["mu"]) == set(whole)
    assert train_pi0.shard_batch({"x": torch.arange(4)}, mesh)["x"].tolist() \
        == [2, 3]
    batch = _tbatch(_batch())                       # B = 3
    for step, s in ((train_pi0.make_train_step(TCFG, tx, mesh=mesh), state),
                    (train_pi0.make_partitioned_train_step(
                        TCFG, tx, mask, mesh=mesh), part)):
        with pytest.raises(ValueError, match="does not divide"):
            step(s, torch.Generator().manual_seed(0), batch)
