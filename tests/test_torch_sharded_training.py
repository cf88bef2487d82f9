"""PyTorch port vs the JAX package: π0 FSDP training steps in two gloo
processes on the CPU (tests/torch_dist_worker.py), on the tiny config with
fp32 weights: partitioned and whole tree, AdamW and 8-bit AdamW, at dp=1 x
fsdp=2 and dp=2 x fsdp=1 (the trainable leaves sharded too), against the
port's unsharded step and against the JAX package's step on a
`make_mesh(dp, fsdp, devices[:2])` mesh, with the same flow noise and
times injected on every side. The bounds are tests/test_torch_training.py's;
a 2-rank step sums its gradients in another order than a 1-rank step, so
it is held to them too. After the third 8-bit AdamW step the shares are
tests/test_torch_train_pi0fast.py's LATE_8BIT_SHARE: 8-bit AdamW turns
~1e-7 gradient differences into elements that step by many times lr,
which move every gradient of the next step. On this batch the JAX
package's own 2-device whole-tree step differs from its 1-device step in
1.2% of the elements after step 3, and the port's 1-process step from the
JAX package's in 3.0% (measured; after steps 1-2 in at most 0.03%).
Tests of the other sharded trainers, checkpoints and launches:
tests/test_torch_sharded_roles.py.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.configs import (
    tiny_pi0_config as j_tiny_pi0, replace as j_replace)
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.parallel.mesh import (
    fsdp_sharding as j_fsdp_sharding, make_mesh as j_make_mesh)
from cover_vla_tpu.training import optim as joptim
from cover_vla_tpu.training import train_pi0 as jtrain

from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax
from cover_vla_tpu_torch.training import optim, train_pi0
from cover_vla_tpu_torch.utils.tree import flatten

from torch_dist_worker import _pi0_cfg, _tree, run_ranks

JCFG = j_replace(j_tiny_pi0(), compute_dtype="float32")
TCFG = _pi0_cfg()
B = 4
LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-5
# tests/test_torch_training.py's shares (see there)
ADAMW_SHARE, ADAMW_8BIT_SHARE, GRID_SHARE = 1e-4, 1e-2, 1e-2
LATE_8BIT_SHARE = 5e-2      # tests/test_torch_train_pi0fast.py's
MESHES = [(1, 2), (2, 1)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jflat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _pi0_batch(seed=0):
    rng = np.random.default_rng(seed)
    s, t = JCFG.vision.image_size, JCFG.tokenizer_max_length
    b = {"images": rng.uniform(-1, 1, (B, 1, s, s, 3)).astype(np.float32),
         "img_masks": np.ones((B, 1), bool),
         "lang_tokens": rng.integers(0, JCFG.paligemma.vocab_size,
                                     (B, t)).astype(np.int32),
         "lang_masks": np.ones((B, t), bool),
         "state": rng.standard_normal((B, 32)).astype(np.float32),
         "actions": rng.standard_normal((B, JCFG.chunk_size, 32)
                                        ).astype(np.float32)}
    b["lang_masks"][1, t - 3:] = False
    b["actions_is_pad"] = np.zeros((B, JCFG.chunk_size), bool)
    b["actions_is_pad"][0, -2:] = True
    rng = np.random.default_rng(100)
    noise = rng.standard_normal((B, JCFG.chunk_size, 32)).astype(np.float32)
    time = rng.uniform(0.001, 1.0, (B,)).astype(np.float32)
    return b, noise, time


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX initial tree, the batch and its draws, and every rank's
    results of the π0 case (one launch of two ranks)."""
    jparams = _np(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32),
        jpi0.init_pi0(jax.random.PRNGKey(0), JCFG)))
    batch, noise, time = _pi0_batch()
    tp = pi0_from_jax(jparams, TCFG, device="cpu")
    d = tmp_path_factory.mktemp("sharded_training")
    torch.save({"pi0": flatten(tp), "batch": _t(batch),
                "noise": torch.from_numpy(noise),
                "time": torch.from_numpy(time)}, d / "in.pt")
    run_ranks("pi0", d)
    outs = [torch.load(d / f"out{r}.pt", weights_only=False)
            for r in range(2)]
    return {"jparams": jparams, "tp": tp, "batch": batch, "noise": noise,
            "time": time, "outs": outs}


# ---------------------------------------------------------------------------
# π0
# ---------------------------------------------------------------------------


def _mismatch_share(got: dict, want: dict) -> tuple:
    """(share of elements beyond PARAM_ATOL, largest difference)."""
    assert set(got) == set(want)
    d = np.concatenate([np.abs(np.asarray(got[k]) - want[k]).ravel()
                        for k in want])
    return float((d > PARAM_ATOL).mean()), float(d.max())


def _grid_share(got: dict, want: dict) -> float:
    """Share of differing int8 moment entries of two port (whole-layout)
    8-bit AdamW states."""
    n = bad = 0
    for mom in ("mu", "nu"):
        for k in want[mom]:
            d = got[mom][k]["values"] != want[mom][k]["values"]
            n, bad = n + d.numel(), bad + int(d.sum())
    return bad / n


def _jax_grids(jopt, names) -> dict:
    """A JAX 8-bit AdamW state's grids keyed as the port keys them (a
    partitioned state holds them as lists in the trainable leaves'
    order)."""
    out = {}
    for mom in ("mu", "nu"):
        out[mom] = {}
        for path, v in jax.tree_util.tree_leaves_with_path(
                getattr(jopt, mom)):
            if getattr(path[-1], "name", None) != "values":
                continue
            k = (names[path[0].idx] if hasattr(path[0], "idx")
                 else ".".join(str(p.key) for p in path[:-1]))
            out[mom][k] = {"values": torch.from_numpy(np.asarray(v))}
    return out


def _jax_mesh_steps(jparams, opt, partitioned, dp, fsdp, batch):
    """Three steps of the JAX package's train step on a dp x fsdp mesh of
    two CPU devices: (loss, grad_norm, params, grids or None) each."""
    mesh = j_make_mesh(dp, fsdp, jax.devices()[:2])
    tx = jtrain.make_optimizer(joptim.warmup_cosine(1e-3, 1, 20),
                               optimizer=opt)
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, jparams),
                            j_fsdp_sharding(jparams, mesh))
    if partitioned:
        mask = jtrain.freeze_mask(params, train_expert_only=True)
        state = jtrain.init_partitioned_state(params, tx, mask)
        step = jtrain.make_partitioned_train_step(JCFG, tx, mask)
        names = sorted(k for k, m in _jflat(mask).items() if m)
    else:
        state = jtrain.TrainState(params, tx.init(params),
                                  jnp.zeros((), jnp.int32))
        step = jtrain.make_train_step(JCFG, tx, mesh=mesh)
        names = None
    out = []
    with mesh:
        sharded = jtrain.shard_batch(batch, mesh)
        for i in range(3):
            state, m = step(state, jax.random.PRNGKey(i), sharded)
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        _jflat(state.params),
                        _jax_grids(state.opt_state[1], names)
                        if opt == "adamw_8bit" else None))
    return out


def _port_steps(tp, opt, partitioned, batch, noise, time):
    tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 1, 20),
                                  optimizer=opt)
    tp = _tree(flatten(tp))
    if partitioned:
        mask = train_pi0.freeze_mask(tp, train_expert_only=True)
        state = train_pi0.init_partitioned_state(tp, tx, mask)
        step = train_pi0.make_partitioned_train_step(TCFG, tx, mask)
    else:
        leaves = {k: v.requires_grad_(True) for k, v in flatten(tp).items()}
        state = train_pi0.TrainState(tp, tx.init(leaves), optim.counter())
        step = train_pi0.make_train_step(TCFG, tx)
    out = []
    for _ in range(3):
        state, m = step(state, None, _t(batch), noise=torch.from_numpy(noise),
                        time=torch.from_numpy(time))
        out.append((m["loss"].item(), m["grad_norm"].item(),
                    {k: v.detach().numpy().copy()
                     for k, v in flatten(state.params).items()},
                    state.opt_state["1"] if opt == "adamw_8bit" else None))
    return out


def _hold(got, want, opt):
    """tests/test_torch_training.py's bounds, step by step."""
    for i, ((gl, gn, gp, gg), (wl, wn, wp, wg)) in enumerate(zip(got, want)):
        late_8bit = opt == "adamw_8bit" and i > 0
        np.testing.assert_allclose(
            gl, wl, **(dict(rtol=1e-3) if late_8bit
                       else dict(rtol=0, atol=LOSS_ATOL)))
        np.testing.assert_allclose(gn, wn, rtol=1e-3 if late_8bit else 1e-4)
        share, worst = _mismatch_share(gp, wp)
        if opt == "adamw":
            assert share <= ADAMW_SHARE and worst <= 1e-4, (i, share, worst)
        else:
            late = i == 2
            assert share <= (LATE_8BIT_SHARE if late else ADAMW_8BIT_SHARE), \
                (i, share, worst)
            assert _grid_share(gg, wg) <= (LATE_8BIT_SHARE if late
                                           else GRID_SHARE)


@pytest.mark.parametrize("dp,fsdp", MESHES)
@pytest.mark.parametrize("partitioned", [True, False],
                         ids=["partitioned", "full"])
@pytest.mark.parametrize("opt", ["adamw", "adamw_8bit"])
def test_pi0_fsdp_step_matches_unsharded_and_jax_mesh(
        setup, monkeypatch, opt, partitioned, dp, fsdp):
    batch, noise, time = setup["batch"], setup["noise"], setup["time"]
    monkeypatch.setattr(jpi0, "sample_noise",
                        lambda key, shape, std=1.0: jnp.asarray(noise))
    monkeypatch.setattr(jpi0, "sample_flow_time",
                        lambda key, b: jnp.asarray(time))
    rec = setup["outs"][0]["pi0"][(dp, fsdp, opt, partitioned)]
    got = [(s["loss"], s["grad_norm"],
            {k: v.numpy() for k, v in s["params"].items()},
            s["opt_state"]["1"] if opt == "adamw_8bit" else None)
           for s in rec["steps"]]
    assert rec["step"] == 3
    _hold(got, _port_steps(setup["tp"], opt, partitioned, batch, noise,
                           time), opt)
    jax_run = _jax_mesh_steps(setup["jparams"], opt, partitioned, dp, fsdp,
                              batch)
    _hold(got, jax_run, opt)
    # the ranks hold the same model
    other = setup["outs"][1]["pi0"][(dp, fsdp, opt, partitioned)]
    assert all(torch.equal(v, other["steps"][-1]["params"][k])
               for k, v in rec["steps"][-1]["params"].items())


@pytest.mark.parametrize("dp,fsdp", MESHES)
def test_partitioned_fsdp_freezes_and_holds_moments_of_trainable_only(
        setup, dp, fsdp):
    mask = flatten(train_pi0.freeze_mask(setup["tp"],
                                         train_expert_only=True))
    trainable = sorted(k for k, m in mask.items() if m)
    init = flatten(setup["tp"])
    for opt in ("adamw", "adamw_8bit"):
        for out in setup["outs"]:
            rec = out["pi0"][(dp, fsdp, opt, True)]
            assert rec["moments"] == trainable
            final = rec["steps"][-1]["params"]
            for k, m in mask.items():
                if not m:
                    assert torch.equal(final[k], init[k]), k
            # at rest each rank holds flat shards of the sharded leaves
            shapes = rec["shard_leaves"]
            assert shapes["expert.layers.q"] == (
                -(-init["expert.layers.q"].numel() // (fsdp * 256))
                * 256,)
    default = setup["outs"][0]["pi0"]["default_plan"]
    assert {k for k, v in default.items() if v == "FlatShard"} == {
        k for k, v in init.items() if v.numel() >= 2 ** 14}
    assert setup["outs"][0]["pi0"]["odd_refused"]


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("numel", [5 * 3001, 4096])
def test_adamw_8bit_on_block_aligned_shards_gives_the_unsharded_grids(
        world, numel):
    """8-bit AdamW quantises each leaf flattened in 256-element blocks; a
    rank's flat shard starts on a block (`parallel.mesh`), so the shards'
    updates and int8 grids, laid end to end, are the unsharded leaf's,
    bit for bit, for the same gradients."""
    from types import SimpleNamespace
    from cover_vla_tpu_torch.parallel.mesh import fsdp_sharding, shard_tensor
    from cover_vla_tpu_torch.training.quantized_optim import adamw_8bit
    rng = np.random.default_rng(numel)
    shape = (numel // 7, 7) if numel % 7 == 0 else (numel,)
    leaf = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    grads = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                              * 10.0 ** rng.uniform(-4, 0))
             for _ in range(3)]
    tx = adamw_8bit(optim.warmup_cosine(1e-3, 0, 20))
    whole = {"w": leaf.clone()}
    state = tx.init(whole)
    shards, states = [], []
    for i in range(world):
        mesh = SimpleNamespace(shape=(1, world),
                               mesh_dim_names=("dp", "fsdp"),
                               get_coordinate=lambda i=i: (0, i),
                               get_group=lambda axis: None)
        spec = fsdp_sharding(whole, mesh, min_size=1)["w"]
        shards.append((spec, {"w": shard_tensor(leaf, spec)}))
        states.append(tx.init(shards[-1][1]))
    for g in grads:
        updates, state = tx.update({"w": g}, state, whole)
        optim.apply_updates(whole, updates)
        parts, grids = [], {"mu": [], "nu": []}
        for i, (spec, p) in enumerate(shards):
            u, states[i] = tx.update({"w": shard_tensor(g, spec)}, states[i],
                                     p)
            optim.apply_updates(p, u)
            parts.append(u["w"])
            for mom in grids:
                grids[mom].append(states[i][mom]["w"])
        flat = torch.cat(parts)[:leaf.numel()]
        assert torch.equal(flat.view(shape), updates["w"])
        for mom in grids:
            for key in ("values", "scales"):
                cat = torch.cat([q[key] for q in grids[mom]])
                want = state[mom]["w"][key]
                assert torch.equal(cat[:len(want)], want), (mom, key)
                assert not cat[len(want):].any()
        assert torch.equal(torch.cat([p["w"] for _, p in shards])
                           [:leaf.numel()].view(shape), whole["w"])
