"""The `train` role of the port's run.py at tiny size on the CPU: the npz
trajectory set of the JAX package's own role test, checkpoints under
step_<N>/, metrics.jsonl, a resume that continues from the saved state,
and the launches that still stop (several processes, no device, an rlds
directory without shards)."""

import json
import os

import numpy as np
import pytest
import torch

from cover_vla_tpu_torch import run
from cover_vla_tpu_torch.configs import tiny_pi0_config
from cover_vla_tpu_torch.convert import blob, checkpoints
from cover_vla_tpu_torch.training import optim, train_pi0
from cover_vla_tpu_torch.utils.tree import flatten


def _dataset(path, n_traj=1, frames=6, hw=56):
    """As tests/test_cli_analysis.py::test_run_train_role_tiny writes it."""
    rng = np.random.default_rng(0)
    os.makedirs(path)
    for i in range(n_traj):
        np.savez(path / f"traj{i}.npz",
                 images=rng.integers(0, 255, (frames, hw, hw, 3)
                                     ).astype(np.uint8),
                 states=rng.standard_normal((frames, 7)).astype(np.float32),
                 actions=rng.standard_normal((frames, 7)).astype(np.float32),
                 task="pick up the cube")
    return str(path)


def _argv(ds, ck, steps, *extra):
    return ["--role", "train", "--train.tiny", "true",
            "--train.dataset_dir", ds, "--train.num_steps", str(steps),
            "--train.batch_size", "2", "--train.checkpoint_dir", ck,
            *extra]


def _records(ck):
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_role_train_tiny_and_resume(tmp_path):
    ds, ck = _dataset(tmp_path / "ds"), str(tmp_path / "ck")
    run.main(_argv(ds, ck, 3, "--train.save_every", "1000"), device="cpu")
    assert [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)] \
        == ["step_00000003"]
    recs = _records(ck)
    assert set(recs[0]) == {"_time", "_step", "loss", "grad_norm"}
    assert recs[0]["_step"] == 0 and np.isfinite(recs[0]["loss"])

    saved = blob.load_tree(os.path.join(checkpoints.latest_checkpoint(ck),
                                        checkpoints.BLOB_NAME))
    assert int(saved["step"]) == 3
    assert int(saved["opt_state"]["1"]["count"]) == 3

    # the resumed run starts from the saved state, bit for bit
    tx = train_pi0.make_optimizer(optim.warmup_cosine(5e-5, 100, 5))
    state, _ = train_pi0.init_partitioned_train_state(
        42, tiny_pi0_config(), tx, device="cpu")
    restored, at = checkpoints.restore_train_state(ck, state)
    assert at == 3
    got = flatten(restored._asdict())
    want = flatten(saved)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    run.main(_argv(ds, ck, 5, "--train.resume", "true",
                   "--train.save_every", "1000", "--train.keep_last", "1"),
             device="cpu")
    assert [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)] \
        == ["step_00000005"]
    final = blob.load_tree(os.path.join(checkpoints.latest_checkpoint(ck),
                                        checkpoints.BLOB_NAME))
    assert int(final["step"]) == 5
    assert not torch.equal(final["params"]["expert"]["layers"]["q"],
                           saved["params"]["expert"]["layers"]["q"])
    # frozen weights stay as initialised across the resume
    assert torch.equal(final["params"]["paligemma"]["layers"]["q"],
                       saved["params"]["paligemma"]["layers"]["q"])


@pytest.mark.parametrize("extra", [
    ("--train.optimizer", "adamw_8bit", "--train.val_every", "2",
     "--train.val_batches", "2", "--train.save_every", "2",
     "--train.keep_last", "1"),
    ("--train.grad_accum", "2", "--train.augment", "true",
     "--train.train_expert_only", "false"),
], ids=["adamw_8bit_validation", "accum_augment_full"])
def test_role_train_options(tmp_path, extra):
    ds = _dataset(tmp_path / "ds", n_traj=2, hw=64)
    ck = str(tmp_path / "ck")
    run.main(_argv(ds, ck, 4, *extra), device="cpu")
    recs = _records(ck)
    assert recs[0]["_step"] == 0
    if "--train.val_every" in extra:
        val = [r for r in recs if "val/mae" in r]
        assert [r["_step"] for r in val] == [2, 4]
        assert set(val[0]) == {"_time", "_step", "val/acc@0.01",
                               "val/acc@0.05", "val/acc@0.1", "val/mae"}
    kept = [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)]
    assert kept == ["step_00000004"]
    saved = blob.load_tree(os.path.join(ck, kept[0], checkpoints.BLOB_NAME))
    if "--train.optimizer" in extra:
        assert saved["opt_state"]["1"]["mu"]["expert.layers.q"][
            "values"].dtype == torch.int8
    else:
        # the whole tree trains: vision has moments; two applications
        assert "vision.blocks.mlp.fc1.kernel" in \
            saved["opt_state"]["inner"]["1"]["mu"]
        assert int(saved["opt_state"]["gradient_step"]) == 2


def test_cli_names_the_device(tmp_path):
    """`--device cpu` on the command line runs the role on the CPU."""
    ds, ck = _dataset(tmp_path / "ds"), str(tmp_path / "ck")
    run.main(_argv(ds, ck, 1) + ["--device", "cpu"])
    assert checkpoints.latest_checkpoint(ck).endswith("step_00000001")
    with pytest.raises(SystemExit, match="--device needs a value"):
        run.main(_argv(ds, ck, 1) + ["--device"])


def test_role_train_stops_where_the_port_ends(tmp_path, monkeypatch):
    ds = _dataset(tmp_path / "ds")
    # rlds data is read (tests/test_torch_rlds.py); a directory without
    # shards is refused
    with pytest.raises(FileNotFoundError, match="tfrecord"):
        run.main(_argv(ds, str(tmp_path / "ck"), 1,
                       "--train.data_format", "rlds"), device="cpu")
    # a world size without an address is a half-configured launch
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        run.main(_argv(ds, str(tmp_path / "ck"), 1), device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(_argv(ds, str(tmp_path / "ck"), 1))
    tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 1, 10))
    for init in (train_pi0.init_train_state,
                 train_pi0.init_partitioned_train_state):
        with pytest.raises(RuntimeError, match="CUDA"):
            init(0, tiny_pi0_config(), tx)
