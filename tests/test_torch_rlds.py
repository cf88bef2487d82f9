"""The port's RLDS TFRecord reader and writer against the JAX package's
and TensorFlow's: CRC32C vectors, the Example codec, shards written by
each package read by the other (byte-equal files), TensorFlow-written
shards, raw frames without PIL, and `--train.data_format rlds` through
the `train` and `train_pi0fast` roles at tiny size on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cover_vla_tpu.data import rlds as jrlds

from cover_vla_tpu_torch import run
from cover_vla_tpu_torch.convert import blob, checkpoints
from cover_vla_tpu_torch.data import rlds
from cover_vla_tpu_torch.data.pipeline import (
    StreamingFrameDataset, batcher, interleave)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _episodes(n=3, t=5, hw=24, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.integers(0, 255, (t, hw, hw, 3)).astype(np.uint8),
             "states": rng.standard_normal((t, 7)).astype(np.float32),
             "actions": rng.standard_normal((t, 7)).astype(np.float32),
             "task": f"put the carrot on plate {i}"} for i in range(n)]


def _assert_episodes_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in ("images", "states", "actions"):
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
        assert x["task"] == y["task"]


@pytest.mark.parametrize("data", [b"", b"123456789", bytes(32),
                                  bytes(range(256)) * 3],
                         ids=["empty", "digits", "zeros", "bytes"])
def test_crc32c_vectors(data):
    known = {b"": 0, b"123456789": 0xE3069283, bytes(32): 0x8A9136AA}
    assert rlds.crc32c(data) == jrlds.crc32c(data)
    assert rlds.masked_crc32c(data) == jrlds.masked_crc32c(data)
    if data in known:
        assert rlds.crc32c(data) == known[data]


def test_example_codec_matches():
    feats = {"a/bytes": [b"x", b"", b"\x00\xff"],
             "a/floats": np.linspace(-2, 2, 11, dtype=np.float32),
             "a/ints": np.asarray([0, 1, -1, 2 ** 40, -(2 ** 62)], np.int64),
             "empty": []}
    payload = rlds.encode_example(feats)
    assert payload == jrlds.encode_example(feats)
    got, want = rlds.parse_example(payload), jrlds.parse_example(payload)
    assert set(got) == set(want) == set(feats)
    for k in feats:
        if isinstance(want[k], list):
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("image_format", ["png", "raw"])
def test_shards_cross_read_and_byte_equal(tmp_path, image_format):
    eps = _episodes()
    spec = rlds.RldsSpec(raw_image_hw=(24, 24) if image_format == "raw"
                         else None)
    jspec = jrlds.RldsSpec(raw_image_hw=spec.raw_image_hw)
    ours = str(tmp_path / "port.tfrecord-00000-of-00002")
    theirs = str(tmp_path / "jax.tfrecord-00001-of-00002")
    rlds.write_rlds_shard(ours, eps, spec=spec, image_format=image_format)
    jrlds.write_rlds_shard(theirs, eps, spec=jspec, image_format=image_format)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    _assert_episodes_equal(
        rlds.RldsShardDataset(theirs, spec=spec, verify_crc=True).episodes(),
        eps)
    _assert_episodes_equal(
        jrlds.RldsShardDataset(ours, spec=jspec, verify_crc=True).episodes(),
        eps)
    both = rlds.RldsShardDataset(str(tmp_path), spec=spec)
    assert both.files == sorted([ours, theirs])
    assert len(both.episodes()) == 6 and len(both.episodes(limit=4)) == 4


def test_raw_frames_need_no_pil(tmp_path):
    """A raw-image shard is written and read with PIL unimportable; the
    reader without raw_image_hw takes unencoded square frames as raw."""
    path = str(tmp_path / "raw.tfrecord-00000-of-00001")
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from cover_vla_tpu_torch.data import rlds\n"
        "rng = np.random.default_rng(0)\n"
        "eps = [{'images': rng.integers(0, 255, (4, 16, 16, 3)).astype(np.uint8),\n"
        "        'states': np.zeros((4, 7), np.float32),\n"
        "        'actions': np.ones((4, 7), np.float32), 'task': 'go'}]\n"
        f"rlds.write_rlds_shard({path!r}, eps, image_format='raw')\n"
        f"back = rlds.RldsShardDataset({path!r}).episodes()\n"
        "assert np.array_equal(back[0]['images'], eps[0]['images'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # the JAX reader with the spec reads the same shard
    back = jrlds.RldsShardDataset(
        path, spec=jrlds.RldsSpec(raw_image_hw=(16, 16))).episodes()
    assert back[0]["images"].shape == (4, 16, 16, 3)


def test_corrupt_shards_are_refused(tmp_path):
    path = str(tmp_path / "c.tfrecord-00000-of-00001")
    rlds.write_rlds_shard(path, _episodes(n=1), image_format="raw")
    data = bytearray(open(path, "rb").read())
    for cut, msg in ((5, "truncated record header"),
                     (len(data) - 10, "truncated record payload")):
        with open(path, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(IOError, match=msg):
            list(rlds.read_tfrecords(path))
    bad = bytearray(data)
    bad[20] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bad)
    with pytest.raises(IOError, match="payload CRC"):
        list(rlds.read_tfrecords(path, verify_crc=True))
    bad = bytearray(data)
    bad[0] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bad)
    with pytest.raises(IOError, match="length CRC"):
        list(rlds.read_tfrecords(path))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="tfrecord"):
        rlds.RldsShardDataset(str(tmp_path / "empty"))


def test_tensorflow_written_and_read_shards(tmp_path):
    tf = pytest.importorskip("tensorflow")
    eps = _episodes()
    path = str(tmp_path / "tfds.tfrecord-00000-of-00001")
    spec = rlds.RldsSpec()

    def feature(v):
        if isinstance(v, list):
            return tf.train.Feature(bytes_list=tf.train.BytesList(value=v))
        return tf.train.Feature(float_list=tf.train.FloatList(
            value=np.asarray(v).ravel().tolist()))

    with tf.io.TFRecordWriter(path) as w:
        for ep in eps:
            imgs = [tf.io.encode_png(f).numpy() for f in ep["images"]]
            ex = tf.train.Example(features=tf.train.Features(feature={
                spec.image_key: feature(imgs),
                spec.state_key: feature(ep["states"]),
                spec.action_key: feature(ep["actions"]),
                spec.instruction_key: feature([ep["task"].encode()])}))
            w.write(ex.SerializeToString())
    _assert_episodes_equal(
        rlds.RldsShardDataset(path, verify_crc=True).episodes(), eps)
    # TensorFlow reads the port's shard, payload for payload
    ours = str(tmp_path / "port.tfrecord")
    rlds.write_rlds_shard(ours, eps)
    got = [r.numpy() for r in tf.data.TFRecordDataset(ours)]
    assert got == list(rlds.read_tfrecords(ours))
    ex = tf.train.Example.FromString(got[0])
    np.testing.assert_array_equal(
        np.asarray(ex.features.feature[spec.action_key].float_list.value,
                   np.float32), eps[0]["actions"].ravel())


def test_streaming_into_frame_pipeline(tmp_path):
    rlds.write_rlds_shard(str(tmp_path / "ds.tfrecord-00000-of-00001"),
                          _episodes(n=2, t=6), image_format="raw")
    ds = StreamingFrameDataset(rlds.RldsShardDataset(str(tmp_path)),
                               chunk_size=4)
    batches = list(batcher(interleave([ds], seed=0, shuffle_buffer=8), 4))
    assert len(batches) == 3
    assert batches[0]["image"].shape == (4, 24, 24, 3)
    assert batches[0]["actions"].shape == (4, 4, 7)


def _rlds_dir(tmp_path, hw=32, t=6):
    eps = _episodes(n=2, t=t, hw=hw)
    for ep in eps:
        ep["task"] = "pick up the cube"
    d = tmp_path / "rlds"
    os.makedirs(d)
    rlds.write_rlds_shard(str(d / "fix.tfrecord-00000-of-00001"), eps)
    return str(d)


def test_role_train_on_rlds(tmp_path):
    """`--role train --train.data_format rlds` with augmentation, a
    paraphrase table and validation, as the JAX package's role test runs
    it (tests/test_rlds.py::test_run_train_role_rlds_augment_val)."""
    from cover_vla_tpu_torch.eval.rephrase import save_rephrases
    reph = str(tmp_path / "reph.json")
    save_rephrases({"pick up the cube": ["grab the cube", "lift the cube"]},
                   reph)
    ck = str(tmp_path / "ck")
    run.main(["--role", "train", "--train.tiny", "true",
              "--train.data_format", "rlds",
              "--train.dataset_dir", _rlds_dir(tmp_path),
              "--train.augment", "true", "--train.paraphrase_json", reph,
              "--train.val_every", "2", "--train.num_steps", "3",
              "--train.batch_size", "2", "--train.shuffle_buffer", "4",
              "--train.checkpoint_dir", ck, "--train.save_every", "1000"],
             device="cpu")
    assert checkpoints.latest_checkpoint(ck).endswith("step_00000003")
    recs = [json.loads(line) for line in open(os.path.join(ck,
                                                           "metrics.jsonl"))]
    assert any("loss" in r for r in recs)
    val = [r for r in recs if "val/mae" in r]
    assert val and "val/acc@0.1" in val[0]


def test_role_train_pi0fast_on_rlds_and_resume(tmp_path):
    ck = str(tmp_path / "ck")
    args = ["--role", "train_pi0fast", "--train.tiny", "true",
            "--train.data_format", "rlds",
            "--train.dataset_dir", _rlds_dir(tmp_path, hw=40),
            "--train.batch_size", "2", "--train.shuffle_buffer", "4",
            "--train.checkpoint_dir", ck, "--train.save_every", "2",
            "--train.keep_last", "1", "--train.optimizer", "adamw_8bit"]
    run.main(args + ["--train.num_steps", "2"], device="cpu")
    saved = blob.load_tree(os.path.join(checkpoints.latest_checkpoint(ck),
                                        checkpoints.BLOB_NAME))
    assert int(saved["step"]) == 2
    assert saved["opt_state"]["1"]["mu"]["paligemma.embed"][
        "values"].dtype == torch.int8
    run.main(args + ["--train.num_steps", "3", "--train.resume", "true"],
             device="cpu")
    kept = [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)]
    assert kept == ["step_00000003"]
    final = blob.load_tree(os.path.join(ck, kept[0], checkpoints.BLOB_NAME))
    assert int(final["step"]) == 3
    assert int(final["opt_state"]["1"]["count"]) == 3
