"""PyTorch port vs the JAX package: the LeRobotDataset v2.x reader and
writer (`data/lerobot.py`, a numpy copy in the port). The cases of
tests/test_lerobot_dataset.py run through both packages: the two writers
write byte-equal files from the same episodes into tmp_path (video and
PNG cameras), and both readers return byte-equal items, windows, pad
masks, tasks and trajectories from either directory, down to the π0
batches of the two input pipelines."""

import os

import numpy as np
import pytest

from cover_vla_tpu.configs import tiny_pi0_config as j_tiny_pi0
from cover_vla_tpu.data import lerobot as jlerobot
from cover_vla_tpu.data import pipeline as jpipeline
from cover_vla_tpu.data.tokenizer import HashTokenizer as JHash

from cover_vla_tpu_torch.configs import tiny_pi0_config
from cover_vla_tpu_torch.data import lerobot, pipeline
from cover_vla_tpu_torch.data.tokenizer import HashTokenizer

from test_torch_oxe import assert_same

FEATURES = {
    "observation.images.cam": {"dtype": "video", "shape": [32, 32, 3],
                               "names": ["h", "w", "c"]},
    "observation.state": {"dtype": "float32", "shape": [7], "names": None},
    "action": {"dtype": "float32", "shape": [7], "names": None},
}
DELTAS = {"action": [0.0, 0.1, 0.2, 0.3], "observation.state": [-0.1, 0.0]}


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    shades = rng.integers(30, 220, (n, 3))
    imgs = np.zeros((n, 32, 32, 3), np.uint8) + \
        shades[:, None, None, :].astype(np.uint8)
    return {"observation.images.cam": imgs,
            "observation.state": rng.standard_normal((n, 7)).astype(
                np.float32),
            "action": rng.standard_normal((n, 7)).astype(np.float32)}


def _write(mod, root, use_videos):
    feats = dict(FEATURES)
    if not use_videos:
        feats = {k: ({**v, "dtype": "image"} if v["dtype"] == "video" else v)
                 for k, v in feats.items()}
    w = mod.LeRobotWriter(root=str(root), fps=10.0, features=feats,
                          use_videos=use_videos)
    w.add_episode(_frames(6, 0), task="pick the fork")
    w.add_episode(_frames(4, 1), task="stack the cups")
    w.finalize()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.fixture(scope="module", params=["video", "image"])
def roots(request, tmp_path_factory):
    """(the port's directory, the JAX package's), written from the same
    episodes."""
    use_videos = request.param == "video"
    out = []
    for mod in (lerobot, jlerobot):
        root = tmp_path_factory.mktemp(f"{mod.__name__.split('.')[0]}_"
                                       f"{request.param}")
        _write(mod, root, use_videos)
        out.append(str(root))
    return out


def test_writers_write_the_same_files(roots):
    ours, ref = (_files(r) for r in roots)
    assert set(ours) == set(ref) and "meta/info.json" in ours
    for name in ref:
        assert ours[name] == ref[name], name


@pytest.mark.parametrize("deltas", [None, DELTAS], ids=["flat", "windows"])
def test_items_byte_equal(roots, deltas):
    for root in roots:
        ours = lerobot.LeRobotDataset(root, delta_timestamps=deltas)
        ref = jlerobot.LeRobotDataset(root, delta_timestamps=deltas)
        assert len(ours) == len(ref) == 10
        assert (ours.meta.fps, ours.meta.camera_keys) == \
            (ref.meta.fps, ref.meta.camera_keys)
        for i in range(len(ref)):
            assert_same(ours[i], ref[i], f"/{i}/")
    if deltas:
        item = lerobot.LeRobotDataset(roots[0], delta_timestamps=deltas)[4]
        assert item["action_is_pad"].tolist() == [False, False, True, True]


def test_episode_selection_and_trajectories_byte_equal(roots):
    for root in roots:
        assert_same(list(lerobot.LeRobotDataset(root).trajectories()),
                    list(jlerobot.LeRobotDataset(root).trajectories()))
        ours = lerobot.LeRobotDataset(root, episodes=[1])
        ref = jlerobot.LeRobotDataset(root, episodes=[1])
        assert len(ours) == len(ref) == 4
        assert_same([ours[i] for i in range(4)], [ref[i] for i in range(4)])


def test_delta_timestamp_validation_equal():
    for mod in (lerobot, jlerobot):
        mod.check_delta_timestamps({"action": [0.0, 0.1]}, 10.0, 1e-4)
        with pytest.raises(ValueError):
            mod.check_delta_timestamps({"action": [0.07]}, 10.0, 1e-4)
    assert lerobot.get_delta_indices({"a": [-0.1, 0.0, 0.2]}, 10.0) == \
        jlerobot.get_delta_indices({"a": [-0.1, 0.0, 0.2]}, 10.0) == \
        {"a": [-1, 0, 2]}


def test_trajectory_bridge_into_both_pipelines(roots):
    out = []
    for mod, pipe, hash_tok, cfg in (
            (lerobot, pipeline, HashTokenizer, tiny_pi0_config()),
            (jlerobot, jpipeline, JHash, j_tiny_pi0())):
        stream = pipe.StreamingFrameDataset(
            source=mod.LeRobotDataset(roots[0]), chunk_size=4)
        batch = next(pipe.batcher(stream.frames(seed=0), batch_size=5))
        out.append(pipe.make_pi0_batch(
            batch, hash_tok(cfg.paligemma.vocab_size), cfg))
    assert_same(*out)
    assert out[0]["actions_is_pad"].shape == (5, 4)
