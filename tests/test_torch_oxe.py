"""PyTorch port vs the JAX package: the Open-X-Embodiment registry
(`data/oxe.py`) and the feature normalizer (`data/normalize.py`), numpy
copies in the port. The cases of tests/test_oxe.py and
tests/test_oxe_registry.py run through both packages on the same inputs
(RLDS shards written in tmp_path); every array is byte-equal, every name,
id and weight equal."""

import dataclasses
import os

import numpy as np
import pytest

from cover_vla_tpu.data import normalize as jnormalize
from cover_vla_tpu.data import oxe as joxe
from cover_vla_tpu.data import pipeline as jpipeline
from cover_vla_tpu.data import rlds as jrlds

from cover_vla_tpu_torch.data import normalize, oxe, pipeline, rlds
from cover_vla_tpu_torch.utils import get_class_from_path


def assert_same(got, want, where="/"):
    """Equal structure, names and values; arrays byte-equal with the same
    dtype and shape."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}{k}/")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}{i}/")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want and type(got) is type(want), (where, got, want)


def _traj8(seed=0, t=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((t, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    states = np.concatenate(
        [rng.uniform(-1, 1, (t, 3)), q, rng.uniform(0, 1, (t, 1))], axis=1)
    return {"images": rng.integers(0, 255, (t, 16, 16, 3)).astype(np.uint8),
            "states": states,
            "actions": rng.standard_normal((t, 7)).astype(np.float32),
            "task": "x"}


def _config(c):
    return {f.name: (int(v) if isinstance(v, int) and not isinstance(v, bool)
                     else v)
            for f in dataclasses.fields(c)
            for v in [getattr(c, f.name)] if f.name != "standardize"}


def test_registry_and_mixes_equal():
    assert list(oxe.OXE_DATASET_CONFIGS) == list(joxe.OXE_DATASET_CONFIGS)
    assert len(oxe.OXE_DATASET_CONFIGS) == 65
    for name, c in joxe.OXE_DATASET_CONFIGS.items():
        got = oxe.OXE_DATASET_CONFIGS[name]
        assert _config(got) == _config(c), name
        assert (got.standardize is None) == (c.standardize is None), name
        assert_same(dataclasses.asdict(oxe.rlds_spec_for(name)),
                    dataclasses.asdict(joxe.rlds_spec_for(name)))
    assert oxe.OXE_NAMED_MIXES == joxe.OXE_NAMED_MIXES
    assert [(e.name, int(e)) for e in oxe.ProprioEncoding] == \
        [(e.name, int(e)) for e in joxe.ProprioEncoding]
    assert [(e.name, int(e)) for e in oxe.ActionEncoding] == \
        [(e.name, int(e)) for e in joxe.ActionEncoding]


@pytest.mark.parametrize("fn", ["standardize_bridge", "standardize_fractal"])
@pytest.mark.parametrize("seed", [0, 1])
def test_named_standardizers_byte_equal(fn, seed):
    traj = _traj8(seed)
    assert_same(getattr(oxe, fn)(dict(traj)), getattr(joxe, fn)(dict(traj)))


def _generic_inputs():
    rng = np.random.default_rng(0)
    t = 5
    quat = rng.standard_normal((t, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    yield "kuka", {"images": np.zeros((t, 8, 8, 3), np.uint8),
                   "states": np.concatenate(
                       [rng.standard_normal((t, 3)), quat,
                        rng.uniform(0, 1, (t, 1))], 1).astype(np.float32),
                   "task": "pick"}
    yield "roboturk", {"images": np.zeros((t, 8, 8, 3), np.uint8)}
    for name in ("bridge_dataset", "fractal20220817_data", "taco_play",
                 "aloha_static_dataset", "language_table"):
        yield name, {"images": rng.integers(0, 255, (t, 8, 8, 3)
                                            ).astype(np.uint8),
                     "states": rng.standard_normal((t, 8)),
                     "actions": rng.standard_normal((t, 7)),
                     "task": name}


@pytest.mark.parametrize("case", range(7))
def test_standardize_by_name_byte_equal(case):
    name, traj = list(_generic_inputs())[case]
    assert_same(oxe.standardize(name, dict(traj)),
                joxe.standardize(name, dict(traj)))


@pytest.mark.parametrize("proprio,action,convention", [
    ("POS_EULER", "EEF_POS", "closedness"),
    ("JOINT", "JOINT_POS", "closedness"),
    ("POS_QUAT", "EEF_POS", "openness"),
    ("NONE", "NAV_2D", "openness")])
def test_generic_standardization_byte_equal(proprio, action, convention):
    t = 3
    rng = np.random.default_rng(4)
    base = {"images": np.zeros((t, 8, 8, 3), np.uint8),
            "states": np.concatenate([rng.standard_normal((t, 7)),
                                      rng.uniform(0, 1, (t, 1))], 1),
            "actions": np.tile(np.asarray([[0, 0, 0, 0, 0, 0, 1.0]]),
                               (t, 1))}
    out = []
    for mod in (oxe, joxe):
        cfg = mod.OXEDatasetConfig(
            name="x", image_key="image",
            proprio=getattr(mod.ProprioEncoding, proprio),
            action=getattr(mod.ActionEncoding, action),
            gripper_convention=convention)
        out.append(mod.standardize_generic(dict(base), cfg))
    assert_same(*out)


def test_make_mix_frames_byte_equal():
    runs = []
    for mod, pipe in ((oxe, pipeline), (joxe, jpipeline)):
        trajs = {"bridge_dataset": [mod.standardize_bridge(_traj8(0))],
                 "fractal20220817_data": [mod.standardize_fractal(_traj8(1))]}
        datasets, weights = mod.make_mix("bridge_fractal", trajs,
                                         chunk_size=2)
        assert weights == [0.5, 0.5]
        runs.append([list(d.frames(seed=3)) for d in datasets])
    assert_same(*runs)


def test_streaming_mix_over_shards_byte_equal(tmp_path):
    rng = np.random.default_rng(0)

    def episode(task):
        t = 4
        return {"images": rng.integers(0, 255, (t, 16, 16, 3)
                                       ).astype(np.uint8),
                "states": rng.standard_normal((t, 8)).astype(np.float32),
                "actions": rng.standard_normal((t, 7)).astype(np.float32),
                "task": task}

    dirs = {}
    for name in ("bridge_dataset", "fractal20220817_data"):
        d = tmp_path / name
        os.makedirs(d)
        rlds.write_rlds_shard(str(d / "ep.tfrecord-00000-of-00001"),
                              [episode(f"{name} task")],
                              spec=oxe.rlds_spec_for(name))
        dirs[name] = str(d)
    runs = []
    for mod, pipe in ((oxe, pipeline), (joxe, jpipeline)):
        datasets, weights = mod.make_streaming_mix("bridge_fractal", dirs,
                                                   chunk_size=2)
        runs.append(list(pipe.batcher(pipe.interleave(
            datasets, weights=weights, shuffle_buffer=4, seed=0), 2)))
    assert_same(*runs)
    assert len(runs[0]) == 4 and runs[0][0]["state"].shape == (2, 7)
    # the shards read back through the JAX package's reader too
    assert len(list(jrlds.RldsShardDataset(
        dirs["bridge_dataset"], spec=joxe.rlds_spec_for("bridge_dataset")))) \
        == 1


def test_get_class_from_path():
    from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
    assert get_class_from_path(
        "cover_vla_tpu_torch.eval.adapters.BridgeSimplerAdapter") \
        is BridgeSimplerAdapter


@pytest.mark.parametrize("mode", ["mean_std", "min_max", "identity"])
def test_normalizer_byte_equal(mode):
    rng = np.random.default_rng(2)
    stats = {"state": {"mean": rng.standard_normal(7),
                       "std": rng.uniform(0.1, 2, 7),
                       "min": -rng.uniform(1, 2, 7),
                       "max": rng.uniform(1, 2, 7)}}
    batch = {"state": rng.standard_normal((4, 7)).astype(np.float32),
             "other": rng.standard_normal(3)}
    ours = normalize.Normalizer(stats, {"state": mode})
    ref = jnormalize.Normalizer(stats, {"state": mode})
    assert_same(ours.normalize(batch), ref.normalize(batch))
    assert_same(ours.unnormalize(batch), ref.unnormalize(batch))
    with pytest.raises(ValueError):
        normalize.Normalizer(stats, {"state": "zscore"}).normalize(batch)
