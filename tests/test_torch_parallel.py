"""The port's `parallel/` package: the multi-process environment rules
(the JAX package's, plus torchrun's names), the single-process helpers,
the mesh's defaults and its refusal, the FSDP shard plan and layout, the
batch rule, and, in two gloo processes on the CPU (tests/
torch_dist_worker.py), the cross-process metric mean, the shards, the
gathers and the global norm over shards."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cover_vla_tpu.parallel.distributed import (
    resolve_multihost_env as j_resolve)

from cover_vla_tpu_torch.parallel import (
    batch_sharding, fsdp_sharding, make_mesh, replicated)
from cover_vla_tpu_torch.parallel import distributed, mesh as pm

from torch_dist_worker import run_ranks

JAX_CASES = [
    {},
    {"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4",
     "PROCESS_ID": "2"},
    {"COORDINATOR_ADDRESS": "a:1"},
]


@pytest.mark.parametrize("env", JAX_CASES)
def test_resolve_multihost_env_keeps_the_jax_rules(env):
    assert distributed.resolve_multihost_env(env=env) == j_resolve(env=env)
    got = distributed.resolve_multihost_env("other:1", num_processes=8,
                                            process_id=0, env=env)
    assert got == j_resolve("other:1", num_processes=8, process_id=0,
                            env=env) == {"coordinator_address": "other:1",
                                         "num_processes": 8, "process_id": 0}


@pytest.mark.parametrize("env", [
    {"NUM_PROCESSES": "4"}, {"PROCESS_ID": "1"}, {"WORLD_SIZE": "2"},
    {"RANK": "1"}, {"WORLD_SIZE": "2", "RANK": "0", "MASTER_PORT": "29500"},
    {"MASTER_ADDR": "h"}])
def test_half_configured_launch_is_refused(env):
    with pytest.raises(ValueError):
        distributed.resolve_multihost_env(env=env)


def test_torchrun_names():
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500",
           "WORLD_SIZE": "8", "RANK": "3", "LOCAL_RANK": "3"}
    assert distributed.resolve_multihost_env(env=env) == {
        "coordinator_address": "127.0.0.1:29500", "num_processes": 8,
        "process_id": 3}
    # a one-process torchrun launch still makes its group
    one = {"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "1",
           "RANK": "0"}
    assert distributed.resolve_multihost_env(env=one)["num_processes"] == 1
    # world size 1 without an address is a single process
    assert distributed.resolve_multihost_env(
        env={"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}) is None
    # the JAX names win over torchrun's
    both = {**env, "COORDINATOR_ADDRESS": "c:2", "NUM_PROCESSES": "2",
            "PROCESS_ID": "1"}
    assert distributed.resolve_multihost_env(env=both) == {
        "coordinator_address": "c:2", "num_processes": 2, "process_id": 1}


def test_single_process_helpers(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_multihost(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.aggregate_metrics(
        {"loss": np.float32(1.5), "acc": 0.5}) == {"loss": 1.5, "acc": 0.5}
    distributed.barrier("test")
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert distributed.local_device() == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.local_device()


def test_make_mesh_defaults_and_refusal():
    assert pm._mesh_dims(None, None, 8) == (1, 8)
    assert pm._mesh_dims(2, None, 8) == (2, 4)
    assert pm._mesh_dims(None, 2, 8) == (4, 2)
    with pytest.raises(ValueError, match="mesh 2x2 != 3"):
        make_mesh(dp=2, fsdp=2, devices=[0, 1, 2])
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh()


def _fake_mesh(dp, fsdp, coord):
    return SimpleNamespace(shape=(dp, fsdp), mesh_dim_names=("dp", "fsdp"),
                           get_coordinate=lambda: coord,
                           get_group=lambda axis: None)


def test_fsdp_plan_and_flat_layout():
    params = {"w": torch.arange(5 * 3001, dtype=torch.float32).reshape(
        5, 3001), "b": torch.ones(7), "s": torch.tensor(1.0),
        "blocks": {"k": torch.zeros(64, 256)}}
    full = {"w": params["w"].reshape(-1)}
    for dp, fsdp in ((1, 2), (2, 1), (1, 3)):
        parts = []
        for i in range(fsdp):
            m = _fake_mesh(dp, fsdp, (0, i))
            plan = fsdp_sharding(params, m, min_size=1000)
            assert isinstance(plan["b"], pm.Replicated)
            assert isinstance(plan["s"], pm.Replicated)
            w = plan["w"]
            assert w.padded % (fsdp * pm.BLOCK) == 0 and w.padded >= 15005
            assert w.padded - 15005 < fsdp * pm.BLOCK
            assert w.chunk % pm.BLOCK == 0 and w.index == i
            assert plan["blocks.k"].shape == (64, 256)
            parts.append(pm.shard_tensor(params["w"], w))
            assert parts[-1].numel() == w.chunk
            # per-block state: [chunk / 256, c] rows of the [n / 256, c]
            # whole-layout grid
            grid = torch.arange(-(-15005 // 256) * 2).reshape(-1, 2)
            got = pm.shard_tensor(grid, w, (w.chunk // 256, 2))
            lo = i * w.chunk // 256
            want = grid[lo:lo + w.chunk // 256]
            assert torch.equal(got[:len(want)], want)
            assert not got[len(want):].any()
        flat = torch.cat(parts)
        assert torch.equal(flat[:15005], full["w"]) and not flat[15005:].any()
    # the default threshold: 2**14 elements and more are sharded
    plan = fsdp_sharding(params, _fake_mesh(1, 2, (0, 1)))
    assert {k for k, v in plan.items() if isinstance(v, pm.FlatShard)} == \
        {"blocks.k"}
    assert replicated("m") == pm.Replicated("m")


def test_shard_and_gather_at_size_one_alias():
    m = _fake_mesh(1, 1, (0, 0))
    leaf = torch.arange(512, dtype=torch.float32).reshape(2, 256)
    spec = fsdp_sharding({"x": leaf}, m, min_size=1)["x"]
    shard = pm.shard_tensor(leaf, spec)
    whole = pm.gather_tensor(shard, spec)
    assert torch.equal(whole, leaf)
    assert whole.data_ptr() == shard.data_ptr()      # a view, no copy


def test_batch_rule():
    rows = batch_sharding(_fake_mesh(2, 2, (1, 0)))   # flat index 2 of 4
    assert rows(np.arange(8)).tolist() == [4, 5]
    assert rows(torch.tensor(3.0)).item() == 3.0
    assert rows(["a", "b"]) == ["a", "b"]
    with pytest.raises(ValueError, match="does not divide"):
        rows(np.arange(6))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    run_ranks("parallel", d)
    return [torch.load(os.path.join(d, f"out{r}.pt"),
                       weights_only=False)["parallel"] for r in range(2)]


def test_two_process_aggregate_metrics_is_the_mean(two_ranks):
    for r, out in enumerate(two_ranks):
        assert (out["world"], out["rank"]) == (2, r)
        assert out["agg"] == {"loss": 2.0, "acc": 0.125, "n": 3.0}


@pytest.mark.parametrize("name", ["default", "dp", "fsdp"])
def test_two_process_mesh_shards_and_gathers(two_ranks, name):
    shapes = {"default": (1, 2), "dp": (2, 1), "fsdp": (1, 2)}
    big = torch.arange(3 * 7001, dtype=torch.float32).reshape(3, 7001)
    unit = shapes[name][1] * pm.BLOCK
    shards = []
    for r, out in enumerate(two_ranks):
        assert out["shapes"] == shapes and out["refused"]
        assert out["odd_rows_refused"]
        assert out[f"plan_{name}"] == {
            "big": ("FlatShard", -(-big.numel() // unit) * unit),
            "small": ("Replicated", 0), "scalar": ("Replicated", 0)}
        shards.append(out[f"shard_{name}"])
        assert torch.equal(out[f"gathered_{name}"]["big"], big)
        assert torch.equal(out[f"gathered_{name}"]["small"], torch.ones(5))
        assert out[f"rows_{name}"].tolist() == list(range(4 * r, 4 * r + 4))
        ints, bools = out[f"gather_rows_{name}"]
        assert ints.tolist() == list(range(8))
        assert bools.dtype == torch.bool and bools.tolist() == [
            i % 2 == 0 for i in range(8)]
        # the global norm over every rank's shards counts each element once
        want = torch.sqrt((big * 1e-3).square().sum() + 5 * 0.25 + 9.0)
        torch.testing.assert_close(out[f"norm_{name}"], want, rtol=1e-6,
                                   atol=0)
    if shapes[name][1] == 2:
        flat = torch.cat(shards)
        assert torch.equal(flat[:big.numel()], big.reshape(-1))
    else:       # dp replicas hold the whole (padded) leaf each
        assert torch.equal(shards[0], shards[1])
