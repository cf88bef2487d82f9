"""Ranks of the port's multi-process tests, and the launchers that run
them.

Every rank is a child process on the CPU: one intra-op thread, no CUDA,
in a gloo process group that meets through a FileStore in the test's
directory (no ports). The test process never makes a process group
itself; it writes the inputs (`in.pt`: numpy-made batches and the port's
trees converted from the JAX package's) and compares what each rank
writes back (`out<rank>.pt`). This module imports no JAX.

    python tests/torch_dist_worker.py <case>[,<case>...] <rank> <world> <dir>
"""

import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
               "PROCESS_ID")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [env.get("PYTHONPATH")] if p]))
    env.update(extra)
    return env


def _wait(procs, what: str, timeout: float) -> list:
    """Every process's output; kills them all when one outlives the
    deadline, and raises when one failed."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(0.1, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{what}: the ranks did not finish within "
                             f"{timeout} s")
    bad = [f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
           for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise AssertionError(f"{what} failed:\n" + "\n".join(bad))
    return outs


def _spawn(args, env, n: int):
    return [subprocess.Popen(args(r), env=env(r), cwd=REPO,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def run_ranks(cases: str, directory, world: int = 2,
              timeout: float = 120) -> list:
    """Run this module's `cases` (comma-separated) as `world` ranks."""
    store = os.path.join(str(directory), f"store_{cases.replace(',', '_')}")
    procs = _spawn(
        lambda r: [sys.executable, os.path.abspath(__file__), cases, str(r),
                   str(world), str(directory), store],
        lambda r: _env(), world)
    return _wait(procs, cases, timeout)


def run_cli(argv, directory, world: int = 2, timeout: float = 120) -> list:
    """`python -m cover_vla_tpu_torch.run <argv> --device cpu` as `world`
    ranks, the process group configured through the environment."""
    store = f"file://{directory}/store_cli_{time.monotonic_ns()}"
    procs = _spawn(
        lambda r: [sys.executable, "-m", "cover_vla_tpu_torch.run", *argv,
                   "--device", "cpu"],
        lambda r: _env(COORDINATOR_ADDRESS=store, NUM_PROCESSES=str(world),
                       PROCESS_ID=str(r)), world)
    return _wait(procs, "run.main " + " ".join(argv), timeout)


# ---------------------------------------------------------------------------
# the cases: case(rank, world, directory, inputs) -> results of this rank
# ---------------------------------------------------------------------------


def _tree(flat):
    from cover_vla_tpu_torch.models.params import ParamTree
    from cover_vla_tpu_torch.utils.tree import unflatten
    return ParamTree(unflatten({k: v.clone() for k, v in flat.items()}))


def _flat_clone(tree):
    from cover_vla_tpu_torch.utils.tree import flatten
    return {k: v.detach().clone() for k, v in flatten(tree).items()}


def case_parallel(rank, world, d, inp):
    from cover_vla_tpu_torch.parallel import distributed as pd
    from cover_vla_tpu_torch.parallel import mesh as pm
    from cover_vla_tpu_torch.training import optim
    from cover_vla_tpu_torch.utils.tree import flatten
    out = {"world": pd.world_size(), "rank": pd.rank(),
           "agg": pd.aggregate_metrics({"loss": 1.5 + rank,
                                        "acc": 0.25 * rank, "n": 3})}
    pd.barrier("test")
    meshes = {"default": pm.make_mesh(), "dp": pm.make_mesh(dp=world),
              "fsdp": pm.make_mesh(fsdp=world)}
    out["shapes"] = {k: tuple(m.shape) for k, m in meshes.items()}
    try:
        pm.make_mesh(dp=world, fsdp=world)
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    params = {"big": torch.arange(3 * 7001, dtype=torch.float32
                                  ).reshape(3, 7001),
              "small": torch.ones(5), "scalar": torch.tensor(2.0)}
    for name, m in meshes.items():
        plan = pm.fsdp_sharding(params, m, min_size=1000)
        sharded = pm.shard_params(params, plan)
        out[f"plan_{name}"] = {k: (type(v).__name__, getattr(v, "padded", 0))
                               for k, v in plan.items()}
        out[f"shard_{name}"] = flatten(sharded)["big"].clone()
        out[f"gathered_{name}"] = _flat_clone(pm.gather_params(sharded))
        rows = pm.batch_sharding(m)(torch.arange(4 * world))
        out[f"rows_{name}"] = rows
        out[f"gather_rows_{name}"] = (pm.gather_rows(rows, m),
                                      pm.gather_rows(rows % 2 == 0, m))
        # the global norm over the shards of a gradient tree
        grads = {"big": flatten(sharded)["big"] * 1e-3,
                 "small": torch.full((5,), 0.5), "scalar": torch.tensor(3.)}
        with optim.sharded_norm(pm.norm_counts(plan, grads),
                                m.get_group("fsdp")):
            out[f"norm_{name}"] = optim.global_norm(grads)
    try:
        pm.batch_sharding(meshes["default"])(torch.arange(3))
        out["odd_rows_refused"] = False
    except ValueError:
        out["odd_rows_refused"] = True
    return out


def case_verified_step(rank, world, d, inp):
    from cover_vla_tpu_torch import configs
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.engine.verified_step import (
        make_verified_step_batched, make_verified_step_sharded)
    from cover_vla_tpu_torch.parallel.mesh import make_mesh
    pcfg, vcfg = configs.tiny_pi0_config(), configs.tiny_verifier_config()
    stats = DatasetStatistics.from_json()
    pp, vp = _tree(inp["policy"]), _tree(inp["verifier"])
    episodes, noise = inp["episodes"], inp["noise"]
    mesh = make_mesh()
    out = {}
    for sel in ("verifier", "random"):
        ccfg = configs.CoVerConfig(n_samples=2, n_rephrases=2, selection=sel)
        sharded = make_verified_step_sharded(pcfg, vcfg, ccfg, stats, mesh,
                                             device="cpu")
        batched = make_verified_step_batched(pcfg, vcfg, ccfg, stats,
                                             device="cpu")
        out[sel] = {
            "injected": sharded(pp, vp, *episodes, noise=noise)._asdict(),
            "drawn": sharded(pp, vp, *episodes, generator=torch.Generator()
                             .manual_seed(5))._asdict(),
            "batched_drawn": batched(pp, vp, *episodes, generator=torch
                                     .Generator().manual_seed(5))._asdict(),
            "batched_injected": batched(pp, vp, *episodes,
                                        noise=noise)._asdict()}
        try:
            sharded(pp, vp, *(x[:3] for x in episodes), noise=noise[:3])
            out[sel]["odd_refused"] = False
        except ValueError:
            out[sel]["odd_refused"] = True
    return out


def _pi0_cfg():
    from cover_vla_tpu_torch.configs import replace, tiny_pi0_config
    return replace(tiny_pi0_config(), compute_dtype="float32")


def _pi0_state(tp, tx, mesh, partitioned, min_size):
    """A sharded π0 state of `tp` and its step; `min_size` small enough
    that the tiny model's trainable leaves are sharded too."""
    from cover_vla_tpu_torch.parallel.mesh import fsdp_sharding, shard_params
    from cover_vla_tpu_torch.training import optim, train_pi0
    from cover_vla_tpu_torch.utils.tree import flatten
    cfg = _pi0_cfg()
    params = shard_params(tp, fsdp_sharding(tp, mesh, min_size=min_size))
    leaves = flatten(params)
    if partitioned:
        mask = train_pi0.freeze_mask(tp, train_expert_only=True)
        m = flatten(mask)
        state = train_pi0.PartitionedTrainState(
            params, tx.init({k: v for k, v in leaves.items() if m[k]}),
            optim.counter())
        return state, train_pi0.make_partitioned_train_step(cfg, tx, mask,
                                                            mesh=mesh)
    return (train_pi0.TrainState(params, tx.init(leaves), optim.counter()),
            train_pi0.make_train_step(cfg, tx, mesh=mesh))


def _gathered_state(state):
    from cover_vla_tpu_torch.parallel.mesh import (
        gather_tensor, map_shards, shard_plan)
    plan = shard_plan(state.params)
    return {"params": _flat_clone(map_shards(state.params, plan,
                                             gather_tensor)),
            "opt_state": map_shards(state.opt_state, plan, gather_tensor)}


def case_pi0(rank, world, d, inp):
    from cover_vla_tpu_torch.parallel.mesh import make_mesh
    from cover_vla_tpu_torch.training import optim, train_pi0
    from cover_vla_tpu_torch.utils.tree import flatten
    out = {}
    for dp, fsdp in ((1, world), (world, 1)):
        mesh = make_mesh(dp=dp, fsdp=fsdp)
        for opt in ("adamw", "adamw_8bit"):
            for part in (True, False):
                tx = train_pi0.make_optimizer(
                    optim.warmup_cosine(1e-3, 1, 20), optimizer=opt)
                state, step = _pi0_state(_tree(inp["pi0"]), tx, mesh, part,
                                         min_size=256)
                steps = []
                for _ in range(3):
                    state, m = step(state, None, inp["batch"],
                                    noise=inp["noise"], time=inp["time"])
                    steps.append({"loss": m["loss"].item(),
                                  "grad_norm": m["grad_norm"].item(),
                                  **_gathered_state(state)})
                out[(dp, fsdp, opt, part)] = {
                    "steps": steps, "step": int(state.step),
                    "moments": sorted(state.opt_state["1"]["mu"]),
                    "shard_leaves": {k: tuple(v.shape) for k, v in
                                     flatten(state.params).items()}}
    # the default plan through init_partitioned_state
    mesh = make_mesh()
    tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 1, 20))
    mask = train_pi0.freeze_mask(_tree(inp["pi0"]), train_expert_only=True)
    state = train_pi0.init_partitioned_state(_tree(inp["pi0"]), tx, mask,
                                             mesh)
    out["default_plan"] = {k: type(v).__name__ for k, v in
                           state.params.shard_plan.items()}
    try:
        train_pi0.shard_batch({"x": torch.zeros(3)}, mesh)
        out["odd_refused"] = False
    except ValueError:
        out["odd_refused"] = True
    return out


def case_pi0fast(rank, world, d, inp):
    from cover_vla_tpu_torch.models.pi0fast import tiny_pi0fast_config
    from cover_vla_tpu_torch.parallel.mesh import (
        fsdp_sharding, make_mesh, shard_params)
    from cover_vla_tpu_torch.training import optim, train_pi0, train_pi0fast
    from cover_vla_tpu_torch.utils.tree import flatten
    cfg = tiny_pi0fast_config()
    out = {}
    for opt in ("adamw", "adamw_8bit"):
        mesh = make_mesh()
        tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 0, 20),
                                      optimizer=opt)
        tp = _tree(inp["fast"])
        params = shard_params(tp, fsdp_sharding(tp, mesh, min_size=256))
        state = train_pi0fast.FastTrainState(
            params, tx.init(flatten(params)), optim.counter())
        step = train_pi0fast.make_train_step(cfg, tx, mesh=mesh)
        state, m = step(state, inp["fast_batch"])
        out[opt] = {"loss": m["loss"].item(), **_gathered_state(state)}
    return out


def case_verifier(rank, world, d, inp):
    from cover_vla_tpu_torch.configs import tiny_verifier_config
    from cover_vla_tpu_torch.parallel.mesh import make_mesh
    from cover_vla_tpu_torch.training import optim
    from cover_vla_tpu_torch.training import train_verifier as tv
    from cover_vla_tpu_torch.utils.tree import flatten
    tree = _tree(inp["verifier"])
    tx = optim.make_adamw(optim.linear_warmup(1e-3, 0))
    members = tree["members"]
    state = tv.VerifierTrainState(members, tx.init(flatten(members)),
                                  optim.counter())
    step = tv.make_ensemble_train_step(tiny_verifier_config(), tx,
                                       mesh=make_mesh(dp=world, fsdp=1))
    steps = []
    for b in inp["vbatches"]:
        state, m = step(state, tree["backbone"], b)
        steps.append({"metrics": {k: v.clone() for k, v in m.items()},
                      "members": _flat_clone(state.members)})
    return {"steps": steps}


def case_checkpoint(rank, world, d, inp):
    """Restore the test's single-process save (ck_w1) into a sharded
    state, take two steps, save it sharded (ck_w2)."""
    from cover_vla_tpu_torch.convert import checkpoints
    from cover_vla_tpu_torch.parallel.mesh import make_mesh
    from cover_vla_tpu_torch.training import optim, train_pi0
    tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 0, 20),
                                  optimizer="adamw_8bit", accumulate_steps=2)
    state, step = _pi0_state(_tree(inp["pi0"]), tx, make_mesh(), True,
                             min_size=256)
    state, start = checkpoints.restore_train_state(
        os.path.join(d, "ck_w1"), state)
    restored = _gathered_state(state)
    for _ in range(2):
        state, _ = step(state, None, inp["batch"], noise=inp["noise"],
                        time=inp["time"])
    checkpoints.save_train_state(os.path.join(d, "ck_w2"), int(state.step),
                                 state)
    return {"start": start, "restored": restored,
            "gathered": _gathered_state(state), "step": int(state.step)}


def _differ(a, b, where="") -> list:
    """The paths at which two trees of tensors differ in any bit."""
    out = []
    for k in b:
        if isinstance(b[k], torch.Tensor):
            if not torch.equal(a[k].detach(), b[k].detach()):
                out.append(f"{where}/{k}")
        else:
            out += _differ(a[k], b[k], f"{where}/{k}")
    return out


def case_world_one(rank, world, d, inp):
    """At one rank a sharded step is its unsharded step: every loss, norm,
    parameter and optimizer entry, bit for bit. Returns the mismatches."""
    from cover_vla_tpu_torch.configs import tiny_verifier_config
    from cover_vla_tpu_torch.models.pi0fast import tiny_pi0fast_config
    from cover_vla_tpu_torch.parallel.mesh import (
        fsdp_sharding, make_mesh, shard_params)
    from cover_vla_tpu_torch.training import (
        optim, train_pi0, train_pi0fast, train_verifier as tv)
    from cover_vla_tpu_torch.utils.tree import flatten
    mesh, out = make_mesh(), {}

    def trainable(tree):
        leaves = flatten(tree)
        for v in leaves.values():
            v.requires_grad_(True)
        return leaves

    for opt in ("adamw", "adamw_8bit"):
        for part in (True, False):
            tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 1, 20),
                                          optimizer=opt)
            sharded, sstep = _pi0_state(_tree(inp["pi0"]), tx, mesh, part,
                                        min_size=256)
            tp = _tree(inp["pi0"])
            if part:
                mask = train_pi0.freeze_mask(tp, train_expert_only=True)
                plain = train_pi0.init_partitioned_state(tp, tx, mask)
                pstep = train_pi0.make_partitioned_train_step(_pi0_cfg(), tx,
                                                              mask)
            else:
                plain = train_pi0.TrainState(tp, tx.init(trainable(tp)),
                                             optim.counter())
                pstep = train_pi0.make_train_step(_pi0_cfg(), tx)
            bad = []
            for i in range(3):
                kw = dict(noise=inp["noise"], time=inp["time"])
                sharded, sm = sstep(sharded, None, inp["batch"], **kw)
                plain, pm_ = pstep(plain, None, inp["batch"], **kw)
                got = _gathered_state(sharded)
                bad += [f"{i}{x}" for x in _differ(sm, pm_)
                        + _differ(got["params"], flatten(plain.params))
                        + _differ(got["opt_state"], plain.opt_state)]
            out[("pi0", opt, part)] = bad
    tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 0, 20))
    tp = _tree(inp["fast"])
    plain = train_pi0fast.FastTrainState(tp, tx.init(trainable(tp)),
                                         optim.counter())
    params = shard_params(_tree(inp["fast"]), fsdp_sharding(
        tp, mesh, min_size=256))
    sharded = train_pi0fast.FastTrainState(params, tx.init(flatten(params)),
                                           optim.counter())
    cfg = tiny_pi0fast_config()
    sharded, sm = train_pi0fast.make_train_step(cfg, tx, mesh=mesh)(
        sharded, inp["fast_batch"])
    plain, pm_ = train_pi0fast.make_train_step(cfg, tx)(plain,
                                                        inp["fast_batch"])
    got = _gathered_state(sharded)
    out["pi0fast"] = (_differ(sm, pm_)
                      + _differ(got["params"], flatten(plain.params))
                      + _differ(got["opt_state"], plain.opt_state))
    tx = optim.make_adamw(optim.linear_warmup(1e-3, 0))
    states = []
    for m in (mesh, None):
        tree = _tree(inp["verifier"])
        state = tv.VerifierTrainState(tree["members"],
                                      tx.init(trainable(tree["members"])),
                                      optim.counter())
        step = tv.make_ensemble_train_step(tiny_verifier_config(), tx,
                                           mesh=m)
        metrics = []
        for b in inp["vbatches"]:
            state, mm = step(state, tree["backbone"], b)
            metrics.append(mm)
        states.append((state, metrics))
    (a, am), (b, bm) = states
    out["verifier"] = (_differ(dict(enumerate(am)), dict(enumerate(bm)))
                       + _differ(a.members, b.members)
                       + _differ(a.opt_state, b.opt_state))
    return out


CASES = {"parallel": case_parallel, "verified_step": case_verified_step,
         "pi0": case_pi0, "pi0fast": case_pi0fast, "verifier": case_verifier,
         "checkpoint": case_checkpoint,
         "world_one": case_world_one}


def main(cases: str, rank: int, world: int, d: str, store: str) -> None:
    torch.set_num_threads(1)
    from cover_vla_tpu_torch.parallel import distributed
    distributed.init_multihost(f"file://{store}", world, rank, device="cpu")
    try:
        path = os.path.join(d, "in.pt")
        inp = torch.load(path, weights_only=False) \
            if os.path.exists(path) else {}
        out = {}
        for case in cases.split(","):
            t0 = time.perf_counter()
            out[case] = CASES[case](rank, world, d, inp)
            print(f"rank {rank}: {case} {time.perf_counter() - t0:.1f} s",
                  flush=True)
        torch.save(out, os.path.join(d, f"out{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
