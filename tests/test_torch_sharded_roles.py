"""PyTorch port vs the JAX package: the other sharded trainers, sharded
checkpoints and multi-process launches, in two gloo processes on the CPU
(tests/torch_dist_worker.py), on tiny configs with fp32 weights:

- the π0-FAST FSDP step against the port's unsharded step
  (tests/test_torch_training.py's bounds);
- the verifier's DDP ensemble step (local InfoNCE per rank, gradients and
  metrics averaged) against the JAX package's dp=2 mesh step, bounds as
  tests/test_torch_train_verifier.py's;
- a sharded train state saved at 2 ranks restores at 1 and the reverse,
  bit-equal;
- `run.main --role train` and `--role train_verifier` at 2 ranks: rank 0
  alone writes the metrics and the checkpoints, the logged loss is the
  mean over the ranks.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.configs import tiny_verifier_config as j_tiny_verifier
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.models import pi0fast as jpi0fast
from cover_vla_tpu.models import verifier as jverifier
from cover_vla_tpu.parallel.mesh import make_mesh as j_make_mesh
from cover_vla_tpu.training import optim as joptim
from cover_vla_tpu.training import train_verifier as jtv

from cover_vla_tpu_torch.configs import tiny_verifier_config
from cover_vla_tpu_torch.convert import blob, checkpoints
from cover_vla_tpu_torch.convert.from_jax import (
    pi0_from_jax, pi0fast_from_jax, verifier_from_jax)
from cover_vla_tpu_torch.data import bridge_verifier_dataset as bridge
from cover_vla_tpu_torch.data.tokenizer import (
    HashTokenizer, make_verifier_tokenizer)
from cover_vla_tpu_torch.models import pi0fast
from cover_vla_tpu_torch.training import optim, train_pi0, train_pi0fast
from cover_vla_tpu_torch.training import train_verifier as tv
from cover_vla_tpu_torch.utils.tree import flatten

from test_torch_sharded_training import (
    ADAMW_8BIT_SHARE, ADAMW_SHARE, B, GRID_SHARE, JCFG, LOSS_ATOL,
    PARAM_ATOL, TCFG, _grid_share, _jflat, _mismatch_share, _np, _pi0_batch,
    _t)
from torch_dist_worker import _tree, run_cli, run_ranks

VERIFIER_LR = 1e-3


def _verifier_batch(seed):
    rng = np.random.default_rng(seed)
    jc = j_tiny_verifier()
    s, t = jc.vision.image_size, jc.text.context_length
    hist = rng.uniform(-1, 1, (B, 10, 7)).astype(np.float32)
    hist[0, :6] = -5.0
    return {"images": rng.uniform(-1, 1, (B, s, s, 3)).astype(np.float32),
            "text_tokens": rng.integers(1, jc.text.vocab_size,
                                        (B, t)).astype(np.int32),
            "action_histories": hist}


def _fast_batch():
    rng = np.random.default_rng(3)
    cfg = pi0fast.tiny_pi0fast_config()
    hw = cfg.vision.image_size
    frames = {"image": rng.integers(0, 255, (B, hw, hw, 3), dtype=np.uint8),
              "state": rng.uniform(-1, 1, (B, 7)).astype(np.float32),
              "actions": rng.uniform(-0.5, 0.5, (B, cfg.chunk_size, 7)
                                     ).astype(np.float32),
              "task": ["put the carrot on the plate", "open the drawer",
                       "put the carrot on the plate", "pick up the cube"]}
    return train_pi0fast.make_fast_batch(
        frames, HashTokenizer(cfg.paligemma.vocab_size), cfg)


def _ckpt_tx():
    return train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 0, 20),
                                    optimizer="adamw_8bit",
                                    accumulate_steps=2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX initial trees, a single-process π0 train state saved for the
    ranks to restore, and every rank's results of the π0-FAST, verifier
    and checkpoint cases (one launch of two ranks)."""
    jparams = _np(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32),
        jpi0.init_pi0(jax.random.PRNGKey(0), JCFG)))
    jfast = _np(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x,
        jpi0fast.init_pi0fast(jax.random.PRNGKey(0),
                              jpi0fast.tiny_pi0fast_config())))
    jverif = _np(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32),
        jverifier.init_verifier(jax.random.PRNGKey(0), j_tiny_verifier(),
                                num_members=3)))
    batch, noise, time = _pi0_batch()
    tp = pi0_from_jax(jparams, TCFG, device="cpu")
    d = tmp_path_factory.mktemp("sharded_roles")
    # a single-process state with a pending accumulation step
    tx = _ckpt_tx()
    mask = train_pi0.freeze_mask(tp, train_expert_only=True)
    state = train_pi0.init_partitioned_state(_tree(flatten(tp)), tx, mask)
    step = train_pi0.make_partitioned_train_step(TCFG, tx, mask)
    state, _ = step(state, None, _t(batch), noise=torch.from_numpy(noise),
                    time=torch.from_numpy(time))
    checkpoints.save_train_state(str(d / "ck_w1"), 1, state)
    torch.save({
        "pi0": flatten(tp), "batch": _t(batch),
        "noise": torch.from_numpy(noise), "time": torch.from_numpy(time),
        "fast": flatten(pi0fast_from_jax(
            jfast, pi0fast.tiny_pi0fast_config(), device="cpu")),
        "fast_batch": _t(_fast_batch()),
        "verifier": flatten(verifier_from_jax(jverif, tiny_verifier_config(),
                                              device="cpu")),
        "vbatches": [_t(_verifier_batch(s)) for s in (20, 21)]},
        d / "in.pt")
    run_ranks("pi0fast,verifier,checkpoint", d)
    outs = [torch.load(d / f"out{r}.pt", weights_only=False)
            for r in range(2)]
    return {"jverif": jverif, "tp": tp, "dir": d, "outs": outs,
            "ck_state": state}


@pytest.mark.parametrize("opt", ["adamw", "adamw_8bit"])
def test_pi0fast_fsdp_step_matches_unsharded(setup, opt):
    cfg = pi0fast.tiny_pi0fast_config()
    tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 0, 20),
                                  optimizer=opt)
    inp = torch.load(setup["dir"] / "in.pt", weights_only=False)
    tp = _tree(inp["fast"])
    leaves = {k: v.requires_grad_(True) for k, v in flatten(tp).items()}
    state = train_pi0fast.FastTrainState(tp, tx.init(leaves),
                                         optim.counter())
    state, m = train_pi0fast.make_train_step(cfg, tx)(state,
                                                      inp["fast_batch"])
    for out in setup["outs"]:
        rec = out["pi0fast"][opt]
        np.testing.assert_allclose(rec["loss"], m["loss"].item(), rtol=0,
                                   atol=LOSS_ATOL)
        share, worst = _mismatch_share(
            {k: v.numpy() for k, v in rec["params"].items()},
            {k: v.detach().numpy() for k, v in flatten(state.params).items()})
        assert share <= (ADAMW_SHARE if opt == "adamw" else ADAMW_8BIT_SHARE)
        if opt == "adamw_8bit":
            assert _grid_share(rec["opt_state"]["1"],
                               state.opt_state["1"]) <= GRID_SHARE


def test_verifier_ddp_step_matches_jax_dp_mesh(setup):
    jtx = joptim.make_adamw(joptim.linear_warmup(VERIFIER_LR, 0))
    jm = setup["jverif"]["members"]
    js = jtv.VerifierTrainState(jm, jtx.init(jm), jnp.zeros((), jnp.int32))
    mesh = j_make_mesh(dp=2, fsdp=1, devices=jax.devices()[:2])
    step = jtv.make_ensemble_train_step(j_tiny_verifier(), jtx, mesh=mesh)
    want = []
    with mesh:
        for seed in (20, 21):
            js, m = step(js, setup["jverif"]["backbone"],
                         jtv.shard_verifier_batch(_verifier_batch(seed),
                                                  mesh))
            want.append(({k: np.asarray(v) for k, v in m.items()},
                         _jflat(js.members)))
    outs = [out["verifier"]["steps"] for out in setup["outs"]]
    for i, (wm, wp) in enumerate(want):
        got = outs[0][i]
        assert set(got["metrics"]) == set(wm)
        for k in wm:
            np.testing.assert_allclose(got["metrics"][k].numpy(), wm[k],
                                       rtol=1e-5, atol=LOSS_ATOL, err_msg=k)
        diff = {k: np.abs(got["members"][k].numpy() - wp[k]).ravel()
                for k in wp}
        key_bias = [k for k in diff if k.endswith("attn.k.bias")]
        assert max(diff[k].max() for k in key_bias) <= VERIFIER_LR
        d = np.concatenate([v for k, v in diff.items() if k not in key_bias])
        assert d.max() <= 1e-4 and (d > PARAM_ATOL).mean() <= ADAMW_SHARE
        # replicated members: the ranks hold the same bits
        assert all(torch.equal(v, outs[1][i]["members"][k])
                   for k, v in got["members"].items())
    # DDP is not the one-process step: local negatives
    tx = optim.make_adamw(optim.linear_warmup(VERIFIER_LR, 0))
    tree = verifier_from_jax(setup["jverif"], tiny_verifier_config(),
                             device="cpu")
    leaves = {k: v.requires_grad_(True)
              for k, v in flatten(tree["members"]).items()}
    state = tv.VerifierTrainState(tree["members"], tx.init(leaves),
                                  optim.counter())
    _, m = tv.make_ensemble_train_step(tiny_verifier_config(), tx)(
        state, tree["backbone"], _t(_verifier_batch(20)))
    assert abs(m["loss"].item() - outs[0][0]["metrics"]["loss"].item()) > 1e-3


def test_one_rank_steps_are_the_unsharded_steps(setup):
    """At world size 1 (a 1-rank gloo group) the FSDP π0 steps (both
    optimizers, partitioned and whole tree), the π0-FAST FSDP step and
    the DDP verifier step equal their unsharded steps bit for bit: the
    gathers alias, the reductions are copies, the norm sums the same
    elements in the same order."""
    run_ranks("world_one", setup["dir"], world=1)
    out = torch.load(setup["dir"] / "out0.pt", weights_only=False)
    assert out["world_one"] == {
        **{("pi0", o, p): [] for o in ("adamw", "adamw_8bit")
           for p in (True, False)}, "pi0fast": [], "verifier": []}


def _flat_opt(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            out[prefix + k] = v
        else:
            out.update(_flat_opt(v, f"{prefix}{k}/"))
    return out


def _assert_state_equal(got: dict, state):
    params = flatten(state.params)
    assert set(got["params"]) == set(params)
    assert all(torch.equal(got["params"][k], params[k].detach())
               for k in params)
    g, w = _flat_opt(got["opt_state"]), _flat_opt(state.opt_state)
    assert set(g) == set(w)
    assert all(torch.equal(g[k], w[k]) for k in w), [
        k for k in w if not torch.equal(g[k], w[k])]


def test_sharded_state_restores_across_world_sizes(setup):
    # saved at one process, restored at two: each rank's shards
    for out in setup["outs"]:
        rec = out["checkpoint"]
        assert rec["start"] == 1
        _assert_state_equal(rec["restored"], setup["ck_state"])
    # saved at two (step 3), restored at one
    tx = _ckpt_tx()
    tp = _tree(flatten(setup["tp"]))
    mask = train_pi0.freeze_mask(tp, train_expert_only=True)
    state = train_pi0.init_partitioned_state(tp, tx, mask)
    state, start = checkpoints.restore_train_state(
        str(setup["dir"] / "ck_w2"), state)
    assert start == 3 == setup["outs"][0]["checkpoint"]["step"]
    assert int(state.step) == 3
    _assert_state_equal(setup["outs"][0]["checkpoint"]["gathered"], state)
    # rank 0 wrote one checkpoint
    assert [os.path.basename(p) for p in checkpoints.list_checkpoints(
        str(setup["dir"] / "ck_w2"))] == ["step_00000003"]


# ---------------------------------------------------------------------------
# the entry point at two ranks
# ---------------------------------------------------------------------------


def _npz_dataset(path, frames=16, hw=56):
    rng = np.random.default_rng(0)
    os.makedirs(path)
    np.savez(path / "traj0.npz",
             images=rng.integers(0, 255, (frames, hw, hw, 3)).astype(np.uint8),
             states=rng.standard_normal((frames, 7)).astype(np.float32),
             actions=rng.standard_normal((frames, 7)).astype(np.float32),
             task="pick up the cube")
    return str(path)


def _records(ck):
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_main_train_at_two_ranks(tmp_path):
    from cover_vla_tpu_torch import run
    ds = _npz_dataset(tmp_path / "ds")

    def argv(ck, b=4):
        return ["--role", "train", "--train.tiny", "true",
                "--train.dataset_dir", ds, "--train.num_steps", "2",
                "--train.batch_size", str(b), "--train.checkpoint_dir", ck,
                "--train.val_every", "2", "--train.val_batches", "1",
                "--train.optimizer", "adamw_8bit"]
    ck2, ck1 = str(tmp_path / "ck2"), str(tmp_path / "ck1")
    run_cli(argv(ck2), tmp_path)
    run.main(argv(ck1), device="cpu")
    two, one = _records(ck2), _records(ck1)
    # rank 0 alone logs: the one-process run's records, its keys
    assert [set(r) for r in two] == [set(r) for r in one]
    assert [r["_step"] for r in two] == [r["_step"] for r in one] == [0, 2]
    # the logged loss is the mean over the ranks' rows: the global loss
    np.testing.assert_allclose(two[0]["loss"], one[0]["loss"], rtol=1e-3)
    assert [os.path.basename(p) for p in checkpoints.list_checkpoints(ck2)] \
        == ["step_00000002"]
    a = blob.load_tree(os.path.join(ck2, "step_00000002", "params.blob"))
    b = blob.load_tree(os.path.join(ck1, "step_00000002", "params.blob"))
    # the same layout as a single process writes
    assert flatten(a).keys() == flatten(b).keys()
    assert all(x.shape == flatten(b)[k].shape for k, x in flatten(a).items())
    with pytest.raises(AssertionError, match="does not divide"):
        run_cli(argv(str(tmp_path / "ck3"), b=3), tmp_path)


def test_run_main_train_verifier_at_two_ranks(tmp_path):
    rng = np.random.default_rng(0)
    samples = []
    for i in range(10):
        np.save(tmp_path / f"img{i}.npy",
                rng.integers(0, 255, (48, 48, 3)).astype(np.uint8))
        samples.append({"image": f"img{i}.npy",
                        "instruction": ["put the carrot on plate",
                                        "open the drawer"][i % 2],
                        "action_history": rng.uniform(-1, 1, (4 + i % 7, 7))})
    path = str(tmp_path / "dataset.json")
    bridge.save_normalized_dataset(path, samples)
    ck = str(tmp_path / "ck")
    run_cli(["--role", "train_verifier", "--train.tiny", "true",
             "--train.dataset_dir", path, "--train.num_members", "2",
             "--train.batch_size", "4", "--train.val_every", "2",
             "--train.val_fraction", "0.2", "--train.checkpoint_dir", ck,
             "--train.keep_last", "2", "--train.num_steps", "3"], tmp_path)
    recs = _records(ck)
    assert [r["_step"] for r in recs] == [0, 2]      # rank 0 alone logs
    assert os.path.isfile(os.path.join(ck, "best", "params.blob"))
    assert os.path.isfile(os.path.join(ck, "merged_ensemble.pt"))
    assert [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)] \
        == ["step_00000002", "step_00000003"]
    # the logged step-0 loss is the mean of the ranks' local InfoNCE losses
    vcfg = tiny_verifier_config()
    ds = bridge.BridgeVerifierDataset(path,
                                      history_length=vcfg.history_length,
                                      image_size=vcfg.vision.image_size)
    ds, _ = ds.split(0.2, seed=42)
    batch = next(ds.batches(4, make_verifier_tokenizer(vcfg.text.vocab_size),
                            vcfg.text.context_length, seed=42))
    batch.pop("instructions")
    tx = optim.make_adamw(optim.linear_warmup(5e-5, 100))
    backbone, state = tv.init_train_state(42, vcfg, tx, num_members=2,
                                          device="cpu")
    losses = []
    for rows in (slice(0, 2), slice(2, 4)):
        local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        losses.append(tv.ensemble_eval_metrics(state.members, vcfg, backbone,
                                               local)["loss"].item())
    np.testing.assert_allclose(recs[0]["loss"], np.mean(losses), rtol=1e-5)
