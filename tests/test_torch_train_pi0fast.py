"""PyTorch port vs the JAX package: π0-FAST training on the tiny config
with fp32 weights on the CPU — `make_fast_batch` byte for byte,
`token_ce_loss` and its gradients, the train step over three steps with
AdamW and with 8-bit AdamW, the unbind of stacked layers under autograd
(bit-equal to the per-layer select), and the `train_pi0fast` role on npz
trajectories.

Both packages start from the JAX package's initial tree, carried across
with `convert/from_jax.pi0fast_from_jax`. Tolerances as for the π0
training path (tests/test_torch_training.py): losses atol 1e-5 (after an
8-bit step, rtol 1e-3: its outlier elements move the loss); gradients
per leaf within 1e-4 of the tree's largest gradient element; parameters
after each AdamW step within 1e-4 everywhere and within 1e-5 in all but
ADAMW_SHARE of the elements outside the SigLIP tower's attention key
biases (a softmax is invariant to a key bias, so its gradient is rounding
noise that Adam scales to a fraction of lr on both sides; they are held
to one lr); after each 8-bit AdamW step in all but ADAMW_8BIT_SHARE, the
int8 grids differing in at most GRID_SHARE of their entries. 8-bit AdamW
rounds ~1e-7 gradient differences into different grid entries, and an
element whose second moment rounds to 0 while its first keeps a quantum
steps by many times lr; over untouched steps those elements move every
later gradient far beyond 1e-7 (by an amount that depends on the host).
So the 8-bit steps are teacher-forced: each port step starts from the
JAX step's parameters and optimizer state of the step before, and is
held to the one-step bounds.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cover_vla_tpu.data.tokenizer import HashTokenizer as JHash
from cover_vla_tpu.models import pi0fast as jpi0fast
from cover_vla_tpu.training import optim as joptim
from cover_vla_tpu.training import train_pi0 as jtrain_pi0
from cover_vla_tpu.training import train_pi0fast as jtrain

from cover_vla_tpu_torch import run
from cover_vla_tpu_torch.configs import SiglipTextConfig, VitConfig
from cover_vla_tpu_torch.convert import blob, checkpoints
from cover_vla_tpu_torch.convert.from_jax import pi0fast_from_jax
from cover_vla_tpu_torch.data.fast_tokenizer import FastActionTokenizer
from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
from cover_vla_tpu_torch.models import gemma, pi0fast, siglip
from cover_vla_tpu_torch.models.params import Init, ParamTree
from cover_vla_tpu_torch.training import optim, train_pi0, train_pi0fast
from cover_vla_tpu_torch.utils.tree import flatten

JCFG, TCFG = jpi0fast.tiny_pi0fast_config(), pi0fast.tiny_pi0fast_config()
B = 3
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 1e-5
ADAMW_SHARE, ADAMW_8BIT_SHARE, GRID_SHARE = 1e-4, 1e-2, 1e-2


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@pytest.fixture(scope="module")
def jparams():
    p = _f32(jpi0fast.init_pi0fast(jax.random.PRNGKey(0), JCFG))
    return jax.tree_util.tree_map(np.asarray, p)


def _port(np_params):
    return pi0fast_from_jax(np_params, TCFG, device="cpu")


def _frames(seed=0, b=B, hw=None, task="put the carrot on the plate"):
    rng = np.random.default_rng(seed)
    hw = hw or JCFG.vision.image_size
    return {
        "image": rng.integers(0, 255, (b, hw, hw, 3), dtype=np.uint8),
        "state": rng.uniform(-1, 1, (b, 7)).astype(np.float32),
        "actions": rng.uniform(-0.5, 0.5, (b, JCFG.chunk_size, 7)
                               ).astype(np.float32),
        "task": [task] * b,
    }


def _batch(seed=0):
    batch = train_pi0fast.make_fast_batch(
        _frames(seed), HashTokenizer(TCFG.paligemma.vocab_size), TCFG)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jflat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _fake_mesh(dp, fsdp, coord=(0, 0)):
    """A mesh's shape and this rank's coordinate, without a process group:
    enough for the shard plan and the batch rule."""
    return SimpleNamespace(shape=(dp, fsdp), mesh_dim_names=("dp", "fsdp"),
                           get_coordinate=lambda: coord,
                           get_group=lambda axis: None)


def _loss_args(batch):
    return [batch[k] for k in ("images", "img_masks", "tokens", "pad_mask",
                               "suffix_mask")]


# ---------------------------------------------------------------------------
# host batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["one_camera", "two_cameras", "truncated",
                                  "given_fast_tokenizer"])
def test_make_fast_batch_byte_equal(case):
    frames = _frames(1, task=("pick " * 40 if case == "truncated"
                              else "put the carrot on the plate"))
    if case == "two_cameras":
        frames["image"] = np.stack([frames["image"]] * 2, axis=1)
    kw, jkw = {}, {}
    if case == "given_fast_tokenizer":
        from cover_vla_tpu.data.fast_tokenizer import (
            FastActionTokenizer as JFast)
        kw = {"fast_tokenizer": FastActionTokenizer(
            time_horizon=TCFG.chunk_size, action_dim=7, scale=30.0)}
        jkw = {"fast_tokenizer": JFast(time_horizon=JCFG.chunk_size,
                                       action_dim=7, scale=30.0)}
    got = train_pi0fast.make_fast_batch(
        frames, HashTokenizer(TCFG.paligemma.vocab_size), TCFG, **kw)
    want = jtrain.make_fast_batch(
        frames, JHash(JCFG.paligemma.vocab_size), JCFG, **jkw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    if case == "truncated":
        assert want["pad_mask"].all()         # the sequence fills the row
    assert (got["suffix_mask"] <= got["pad_mask"]).all()


# ---------------------------------------------------------------------------
# loss, gradients, steps
# ---------------------------------------------------------------------------


def test_token_ce_loss_and_gradients_match(jparams):
    tp, batch = _port(jparams), _batch(2)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jpi0fast.token_ce_loss(
            p, JCFG, *[jnp.asarray(x) for x in _loss_args(batch)]))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    leaves = {k: v.requires_grad_(True) for k, v in flatten(tp).items()}
    loss = pi0fast.token_ce_loss(tp, TCFG, *_loss_args(_tbatch(batch)))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0,
                               atol=LOSS_ATOL)
    want = _jflat(jgrads)
    got = {k: (torch.zeros_like(leaves[k]) if g is None else g).numpy()
           for k, g in zip(leaves, grads)}
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k, ref in want.items():
        np.testing.assert_allclose(got[k], ref, rtol=GRAD_REL,
                                   atol=GRAD_REL * scale, err_msg=k)
    norm = optim.global_norm({k: torch.from_numpy(v) for k, v in got.items()})
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(jgrads)),
                               rtol=1e-5)


def _mismatch(tparams, jtree):
    """(share beyond PARAM_ATOL outside the key biases, largest difference
    outside them, largest key-bias difference)."""
    want = _jflat(jtree)
    diff = {k: np.abs(v.detach().numpy() - want[k]).ravel()
            for k, v in flatten(tparams).items()}
    kb = [k for k in diff if k.endswith("attn.k.bias")]
    d = np.concatenate([v for k, v in diff.items() if k not in kb])
    return (float((d > PARAM_ATOL).mean()), float(d.max()),
            max(float(diff[k].max()) for k in kb))


def _grid_share(tstate, jopt) -> float:
    n = bad = 0
    for mom in ("mu", "nu"):
        for path, v in jax.tree_util.tree_leaves_with_path(
                getattr(jopt, mom)):
            if getattr(path[-1], "name", None) != "values":
                continue
            k = ".".join(str(p.key) for p in path[:-1])
            d = tstate[mom][k]["values"].numpy() != np.asarray(v)
            n, bad = n + d.size, bad + int(d.sum())
    return bad / n


def _teacher_force(ts, js) -> None:
    """Set the port's state to the JAX state's values in place: the
    parameters, the 8-bit moments' grids and scales and the count."""
    want = _jflat(js.params)
    with torch.no_grad():
        for k, v in flatten(ts.params).items():
            v.copy_(torch.from_numpy(np.array(want[k])))
    tstate, jopt = ts.opt_state["1"], js.opt_state[1]
    for mom in ("mu", "nu"):
        for path, v in jax.tree_util.tree_leaves_with_path(
                getattr(jopt, mom)):
            k = ".".join(str(p.key) for p in path[:-1])
            tstate[mom][k][path[-1].name].copy_(
                torch.from_numpy(np.array(v)))
    tstate["count"].copy_(torch.tensor(int(jopt.count)))


@pytest.mark.parametrize("opt", ["adamw", "adamw_8bit"])
def test_train_step_over_three_steps(jparams, opt):
    lr = 1e-3
    jtx = jtrain_pi0.make_optimizer(joptim.warmup_cosine(lr, 1, 20),
                                    optimizer=opt)
    ttx = train_pi0.make_optimizer(optim.warmup_cosine(lr, 1, 20),
                                   optimizer=opt)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    js = jtrain.FastTrainState(jp, jtx.init(jp), jnp.zeros((), jnp.int32))
    tp = _port(jparams)
    leaves = {k: v.requires_grad_(True) for k, v in flatten(tp).items()}
    ts = train_pi0fast.FastTrainState(tp, ttx.init(leaves), optim.counter())
    jstep = jtrain.make_train_step(JCFG, jtx)
    tstep = train_pi0fast.make_train_step(TCFG, ttx)
    batch = _batch(3)
    for i in range(3):
        if opt == "adamw_8bit" and i > 0:
            _teacher_force(ts, js)      # the one-step comparison
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, _tbatch(batch))
        assert set(tm) == set(jm) == {"loss"}
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=0, atol=LOSS_ATOL)
        share, worst, key_bias = _mismatch(ts.params, js.params)
        if opt == "adamw":
            assert share <= ADAMW_SHARE and worst <= 1e-4, (i, share, worst)
            assert key_bias <= lr, (i, key_bias)
        else:
            assert share <= ADAMW_8BIT_SHARE, (i, share, worst)
            assert _grid_share(ts.opt_state["1"], js.opt_state[1]) \
                <= GRID_SHARE
    # mesh= takes the FSDP path; its batch of 3 does not divide over 2
    # ranks (the 2-rank step itself: tests/test_torch_sharded_roles.py)
    with pytest.raises(ValueError, match="does not divide"):
        train_pi0fast.make_train_step(TCFG, ttx, mesh=_fake_mesh(1, 2))(
            ts, _tbatch(batch))


def test_init_train_state_trains_the_whole_tree():
    tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 1, 20))
    state = train_pi0fast.init_train_state(0, TCFG, tx, device="cpu")
    leaves = flatten(state.params)
    assert all(v.requires_grad for v in leaves.values())
    assert set(state.opt_state["1"]["mu"]) == set(leaves)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            train_pi0fast.init_train_state(0, TCFG, tx)


# ---------------------------------------------------------------------------
# one unbind per stacked leaf under autograd
# ---------------------------------------------------------------------------


def _tower_and_lm():
    init = Init(5, torch.device("cpu"))
    vcfg = VitConfig(width=32, depth=3, mlp_dim=64, num_heads=4,
                     patch_size=8, image_size=16)
    tcfg = SiglipTextConfig(width=32, depth=3, mlp_dim=64, num_heads=4,
                            vocab_size=64, context_length=8, embed_dim=16)
    gcfg = TCFG.paligemma
    trees = {"vit": ParamTree(siglip.init_vit(init, vcfg, torch.float32)),
             "text": ParamTree(siglip.init_text_tower(init, tcfg,
                                                      torch.float32)),
             "lm": ParamTree(gemma.init_gemma(init, gcfg, torch.float32))}
    gen = torch.Generator().manual_seed(0)
    x = {"vit": torch.rand((2, 16, 16, 3), generator=gen) * 2 - 1,
         "text": torch.randint(0, 64, (2, 8), generator=gen),
         "lm": torch.randn((2, 6, gcfg.width), generator=gen)}
    pos = torch.arange(6)[None].expand(2, 6)
    mask = torch.ones((2, 6, 6), dtype=torch.bool).tril()
    fwd = {"vit": lambda p: siglip.vit_forward(p, vcfg, x["vit"]).tokens,
           "text": lambda p: siglip.text_forward(p, tcfg, x["text"])
           .seq_features,
           "lm": lambda p: gemma.prefill(p, gcfg, x["lm"], pos, mask,
                                         return_hidden=True)[0]}
    return trees, fwd


@pytest.mark.parametrize("name", ["vit", "text", "lm"])
def test_unbind_under_autograd_is_bit_equal_to_select(name, monkeypatch):
    """Gradients of every stacked leaf, and the forward, through the
    unbound layers equal those through a `select` per layer, bit for
    bit."""
    from cover_vla_tpu_torch.models import params as params_mod
    trees, fwd = _tower_and_lm()
    tree = trees[name]
    leaves = {k: v.requires_grad_(True) for k, v in flatten(tree).items()}

    def run_once():
        out = fwd[name](tree)
        loss = (out.float() ** 2).sum()
        return out.detach(), torch.autograd.grad(loss, list(leaves.values()),
                                                 allow_unused=True)

    out_u, g_u = run_once()
    calls = []
    original = params_mod.unstack_layers

    def via_select(tree_, axis=0):
        calls.append(1)
        depth = next(iter(flatten(tree_).values())).shape[axis]
        return [params_mod.take_layer(tree_, i, axis) for i in range(depth)]

    monkeypatch.setattr(params_mod, "unstack_layers", via_select)
    out_s, g_s = run_once()
    monkeypatch.setattr(params_mod, "unstack_layers", original)
    assert calls, "the forward did not fetch its layers through the helper"
    assert torch.equal(out_u, out_s)
    for k, a, b in zip(leaves, g_u, g_s):
        assert (a is None) == (b is None), k
        if a is not None:
            assert torch.equal(a, b), k
    if name == "lm":
        # the cache holds detached copies: the graph keeps no cache writes
        _, cache = gemma.prefill(tree, TCFG.paligemma, torch.zeros(
            (1, 2, TCFG.paligemma.width)), torch.arange(2)[None],
            torch.ones((1, 2, 2), dtype=torch.bool))
        assert not cache["k"].requires_grad
    with torch.no_grad():
        assert torch.equal(fwd[name](tree), out_u)


# ---------------------------------------------------------------------------
# the train_pi0fast role on npz trajectories
# ---------------------------------------------------------------------------


def _npz_dataset(path, hw=64, frames=6):
    rng = np.random.default_rng(0)
    os.makedirs(path)
    for i in range(2):
        np.savez(path / f"traj{i}.npz",
                 images=rng.integers(0, 255, (frames, hw, hw, 3)
                                     ).astype(np.uint8),
                 states=rng.standard_normal((frames, 7)).astype(np.float32),
                 actions=rng.uniform(-1, 1, (frames, 7)).astype(np.float32),
                 task="pick up the cube")
    return str(path)


def test_role_train_pi0fast_npz_and_resume(tmp_path):
    ds, ck = _npz_dataset(tmp_path / "ds"), str(tmp_path / "ck")
    args = ["--role", "train_pi0fast", "--train.tiny", "true",
            "--train.dataset_dir", ds, "--train.batch_size", "2",
            "--train.checkpoint_dir", ck, "--train.save_every", "1000",
            "--train.keep_last", "2"]
    run.main(args + ["--train.num_steps", "2"], device="cpu")
    assert checkpoints.latest_checkpoint(ck).endswith("step_00000002")
    saved = blob.load_tree(os.path.join(checkpoints.latest_checkpoint(ck),
                                        checkpoints.BLOB_NAME))
    assert set(saved) == {"params", "opt_state", "step"}
    assert "vision.blocks.mlp.fc1.kernel" in saved["opt_state"]["1"]["mu"]

    # a fresh state restored from it, bit for bit
    tx = train_pi0.make_optimizer(optim.warmup_cosine(5e-5, 100, 2))
    target = train_pi0fast.init_train_state(9, TCFG, tx, device="cpu")
    restored, at = checkpoints.restore_train_state(ck, target)
    assert at == 2
    got, want = flatten(restored._asdict()), flatten(saved)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    run.main(args + ["--train.num_steps", "4", "--train.resume", "true"],
             device="cpu")
    kept = [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)]
    assert kept == ["step_00000002", "step_00000004"]
    final = blob.load_tree(os.path.join(ck, kept[-1], checkpoints.BLOB_NAME))
    assert int(final["step"]) == 4
    assert not torch.equal(final["params"]["paligemma"]["layers"]["q"],
                           saved["params"]["paligemma"]["layers"]["q"])
    recs = [json.loads(line) for line in open(os.path.join(ck,
                                                           "metrics.jsonl"))]
    assert set(recs[0]) == {"_time", "_step", "loss"}


def test_role_train_pi0fast_refusals(tmp_path, monkeypatch):
    ds = _npz_dataset(tmp_path / "ds")
    args = ["--role", "train_pi0fast", "--train.tiny", "true",
            "--train.dataset_dir", ds, "--train.num_steps", "1",
            "--train.batch_size", "2",
            "--train.checkpoint_dir", str(tmp_path / "ck")]
    # a world size without an address is a half-configured launch
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        run.main(args, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(args)
