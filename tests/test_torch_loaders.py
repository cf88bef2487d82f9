"""PyTorch port: checkpoint files, the convert-once cache and the loaders
on the CPU, mirroring tests/test_loaders.py.

The cached convert round trip and its invalidation, corrupt and
unwritable caches, the heads-only merged .pt with and without a backbone,
the CVTBLOB1 file read in both directions between the packages (bf16, 0-d,
transposed and nested leaves, equal bytes), checkpoint rotation and
resume, and the port's refusal of the JAX package's orbax directories."""

import os
import time

import numpy as np
import jax
import ml_dtypes
import pytest
import torch

from cover_vla_tpu import configs as jconfigs
from cover_vla_tpu.convert import blob as jblob
from cover_vla_tpu.convert import checkpoints as jcheckpoints
from cover_vla_tpu.convert import loaders as jloaders
from cover_vla_tpu.models import pi0 as jpi0
from cover_vla_tpu.models import verifier as jverifier

from cover_vla_tpu_torch import configs
from cover_vla_tpu_torch.convert import blob, checkpoints, loaders
from cover_vla_tpu_torch.convert.from_jax import pi0_from_jax
from cover_vla_tpu_torch.convert.verifier_to_torch import save_merged_ensemble
from cover_vla_tpu_torch.models import pi0, verifier

from tests.test_convert_parity import make_tiny_pi0_state_dict
from tests.test_torch_convert import assert_trees_equal


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _write_source(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_cached_convert_roundtrip_and_invalidation(tmp_path):
    """The first load converts and writes `<src>.torchcache/`; the second
    comes from it without the converter; a changed source (mtime/size key)
    converts again; cache=False never reads the cache."""
    src = str(tmp_path / "model.safetensors")
    _write_source(src, "v1")
    calls = []

    def convert_fn():
        calls.append(1)
        return {"w": torch.full((3,), float(len(calls))),
                "n": {"b": torch.ones(2, dtype=torch.bfloat16)}}

    out1 = loaders._cached_convert(src, convert_fn, cache=True)
    assert len(calls) == 1 and os.path.isdir(src + ".torchcache")
    out2 = loaders._cached_convert(src, convert_fn, cache=True)
    assert len(calls) == 1, "second load must hit the cache"
    assert_trees_equal(out2, out1)

    _write_source(src, "v2 longer")      # size change -> key mismatch
    out3 = loaders._cached_convert(src, convert_fn, cache=True)
    assert len(calls) == 2, "source change must invalidate the cache"
    assert float(out3["w"][0]) == 2.0
    loaders._cached_convert(src, convert_fn, cache=False)
    assert len(calls) == 3


@pytest.mark.parametrize("damage", ["orbax_dir", "garbage", "truncated",
                                    "bad_meta"])
def test_cached_convert_recovers_from_a_corrupt_cache(tmp_path, damage):
    """A cache that cannot be read (an old orbax-style directory without
    a blob, a file that is not a blob, a cut-off blob, a meta file that is
    not JSON) is converted again and rewritten."""
    src = str(tmp_path / "model.safetensors")
    _write_source(src, "v1")
    calls = []

    def convert_fn():
        calls.append(1)
        return {"w": torch.arange(64, dtype=torch.float32)}

    cache_dir = src + ".torchcache"
    blob_path = os.path.join(cache_dir, "params.blob")
    loaders._cached_convert(src, convert_fn, cache=True)
    if damage == "orbax_dir":
        os.remove(blob_path)
        os.makedirs(os.path.join(cache_dir, "params"))
    elif damage == "garbage":
        _write_source(blob_path, "not a blob at all")
    elif damage == "truncated":
        with open(blob_path, "rb") as f:
            data = f.read()
        with open(blob_path, "wb") as f:
            f.write(data[:-100])
    else:
        _write_source(os.path.join(cache_dir, "meta.json"), "{not json")
    out = loaders._cached_convert(src, convert_fn, cache=True)
    assert len(calls) == 2
    assert torch.equal(out["w"], torch.arange(64, dtype=torch.float32))
    loaders._cached_convert(src, convert_fn, cache=True)
    assert len(calls) == 2, "the rewritten cache serves"


def test_unwritable_cache_location_serves_uncached(tmp_path):
    """Where `<src>.torchcache` cannot be made (here a file stands in its
    place, as a read-only directory would refuse it), every load converts
    and is served."""
    src = str(tmp_path / "model.safetensors")
    _write_source(src, "v1")
    _write_source(src + ".torchcache", "in the way")
    calls = []

    def convert_fn():
        calls.append(1)
        return {"w": torch.ones(2)}

    for i in range(2):
        out = loaders._cached_convert(src, convert_fn, cache=True)
        assert torch.equal(out["w"], torch.ones(2)) and len(calls) == i + 1


def _mixed_tree(rng):
    return {
        "a": {"w": torch.from_numpy(rng.standard_normal((4, 6)).astype(
            np.float32)).t(),
            "scale": torch.tensor(3.25)},
        "b": {"emb": torch.from_numpy(rng.standard_normal((8, 2)).astype(
            np.float32)).to(torch.bfloat16),
            "ids": torch.arange(5, dtype=torch.int32),
            "mask": torch.tensor([True, False, True])},
    }


def test_blob_roundtrip_bf16_nested(tmp_path):
    """save_tree / load_tree in the port: nested dicts, bf16 / fp32 / int /
    bool leaves, 0-d scalars, transposed tensors; bytes exact, with and
    without the memory map."""
    tree = _mixed_tree(np.random.default_rng(0))
    path = blob.save_tree(str(tmp_path / "p.blob"), tree)
    for mmap in (True, False):
        assert_trees_equal(blob.load_tree(path, mmap=mmap), tree)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_blob_across_packages(tmp_path, writer):
    """A blob written by either package reads in the other with the same
    dtypes, shapes and values, and both write the same bytes."""
    rng = np.random.default_rng(1)
    arrays = {"x": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
              "y": np.float32(2.5).reshape(()),
              "n": {"z": np.arange(6, dtype=np.int64).reshape(2, 3).T,
                    "m": np.array([True, False])}}
    tensors = {"x": torch.from_numpy(arrays["x"].view(np.uint16)).view(
        torch.bfloat16), "y": torch.tensor(2.5),
        "n": {"z": torch.arange(6).reshape(2, 3).t(),
              "m": torch.tensor([True, False])}}
    pj, pt = str(tmp_path / "j.blob"), str(tmp_path / "t.blob")
    jblob.save_tree(pj, arrays)
    blob.save_tree(pt, tensors)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    if writer == "jax":
        assert_trees_equal(blob.load_tree(pj), tensors)
    else:
        back = jblob.load_tree(pt)
        for got, want in ((back["x"], arrays["x"]), (back["y"], arrays["y"]),
                          (back["n"]["z"], arrays["n"]["z"]),
                          (back["n"]["m"], arrays["n"]["m"])):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(np.asarray(got), want)


def test_load_policy_params_blob_dir(tmp_path):
    """The port's native checkpoint: save_params / load_policy_params;
    and a blob the JAX package wrote into `<dir>/params.blob`."""
    cfg = configs.tiny_pi0_config()
    p = pi0.init_pi0(0, cfg, device="cpu")
    ck = checkpoints.save_params(str(tmp_path / "ck"), p)
    assert_trees_equal(loaders.load_policy_params(ck, cfg, device="cpu"), p)

    jp = _np_tree(jpi0.init_pi0(jax.random.PRNGKey(0),
                                jconfigs.tiny_pi0_config()))
    jdir = tmp_path / "from_jax"
    jdir.mkdir()
    jblob.save_tree(str(jdir / "params.blob"), jp)
    assert_trees_equal(loaders.load_policy_params(str(jdir), cfg,
                                                  device="cpu"),
                       pi0_from_jax(jp, cfg, device="cpu"))

    with pytest.raises(FileNotFoundError):
        loaders.load_policy_params(str(tmp_path / "weights.npz"), cfg,
                                   device="cpu")
    # a blob of another model is refused before anything is served
    vck = checkpoints.save_params(str(tmp_path / "v"), verifier.init_verifier(
        0, configs.tiny_verifier_config(), device="cpu"))
    with pytest.raises(KeyError):
        loaders.load_policy_params(vck, cfg, device="cpu")


@pytest.mark.parametrize("form", ["safetensors", "hf_dir", "pt"])
def test_load_policy_params_torch_formats(tmp_path, form):
    """A lerobot state dict as a .safetensors file, an HF save_pretrained
    directory or a .pt file: the port's load equals the JAX package's
    load, and the second load comes from `.torchcache`."""
    from safetensors.numpy import save_file
    cfg = configs.tiny_pi0_config()
    sd = make_tiny_pi0_state_dict(cfg)
    if form == "safetensors":
        path = src = str(tmp_path / "model.safetensors")
        save_file(sd, path)
    elif form == "hf_dir":
        path = str(tmp_path / "hf")
        os.makedirs(path)
        src = os.path.join(path, "model.safetensors")
        save_file(sd, src)
    else:
        path = src = str(tmp_path / "policy.pt")
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in sd.items()}}, path)
    want = pi0_from_jax(_np_tree(jloaders.load_policy_params(
        path, jconfigs.tiny_pi0_config(), cache=False)), cfg, device="cpu")
    got = loaders.load_policy_params(path, cfg, device="cpu")
    assert_trees_equal(got, want)
    assert os.path.isfile(os.path.join(src + ".torchcache", "params.blob"))
    assert_trees_equal(loaders.load_policy_params(path, cfg, device="cpu"),
                       want)


def test_load_verifier_merged_pt_caches_and_needs_backbone(tmp_path):
    """Heads-only merged ensembles reuse the supplied backbone as it is;
    without one the load fails loudly. The second load comes from the
    `.torchcache`. A blob directory holds the whole verifier."""
    vcfg = configs.tiny_verifier_config()
    vp = verifier.init_verifier(1, vcfg, num_members=2, device="cpu")
    path = str(tmp_path / "merged.pt")
    save_merged_ensemble(path, vp["members"], vcfg)
    with pytest.raises(ValueError, match="heads-only"):
        loaders.load_verifier_params(path, vcfg, device="cpu")
    out = loaders.load_verifier_params(path, vcfg,
                                       backbone_params=vp["backbone"],
                                       device="cpu")
    assert os.path.isdir(path + ".torchcache")
    assert out["backbone"] is vp["backbone"]
    assert_trees_equal(out, vp)
    out2 = loaders.load_verifier_params(path, vcfg,
                                        backbone_params=vp["backbone"],
                                        device="cpu")
    assert_trees_equal(out2, vp)
    ck = checkpoints.save_params(str(tmp_path / "vck"), vp)
    assert_trees_equal(loaders.load_verifier_params(ck, vcfg, device="cpu"),
                       vp)
    with pytest.raises(FileNotFoundError):
        loaders.load_verifier_params(str(tmp_path / "v.npz"), vcfg,
                                     device="cpu")


def test_checkpoint_rotation_and_resume(tmp_path):
    """save_train_state keeps the last `keep_last` step_%08d directories;
    restore_train_state resumes from the latest, cast to the target's
    dtypes; cleanup_empty_runs removes run directories without any."""
    root = str(tmp_path / "run_a")
    assert checkpoints.restore_train_state(root, {"w": torch.zeros(2)},
                                           device="cpu")[1] == 0
    for step in (10, 20, 30, 40):
        checkpoints.save_train_state(
            root, step, {"w": torch.full((2,), float(step)),
                         "opt": {"mu": torch.full((2,), step / 10)}},
            keep_last=2)
    assert [os.path.basename(p) for p in checkpoints.list_checkpoints(root)] \
        == ["step_00000030", "step_00000040"]
    assert checkpoints.latest_checkpoint(root).endswith("step_00000040")
    target = {"w": torch.zeros(2, dtype=torch.bfloat16),
              "opt": {"mu": torch.zeros(2, dtype=torch.float64)}}
    state, step = checkpoints.restore_train_state(root, target, device="cpu")
    assert step == 40
    assert state["w"].dtype == torch.bfloat16 and float(state["w"][0]) == 40
    assert state["opt"]["mu"].dtype == torch.float64
    with pytest.raises(KeyError, match="missing"):
        checkpoints.restore_train_state(root, {**target, "extra":
                                               torch.zeros(1)}, device="cpu")
    os.makedirs(tmp_path / "run_empty")
    os.makedirs(tmp_path / "run_b" / "notes")
    assert checkpoints.cleanup_empty_runs(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == ["run_a", "run_b"]


def test_orbax_directory_is_refused_with_directions(tmp_path):
    """An orbax directory written by the JAX package: the port raises a
    ValueError that names orbax and the ways across."""
    jcfg = jconfigs.tiny_verifier_config()
    ck = jcheckpoints.save_params(
        str(tmp_path / "orbax"),
        jverifier.init_verifier(jax.random.PRNGKey(0), jcfg))
    for load in (lambda: checkpoints.load_params(ck, device="cpu"),
                 lambda: loaders.load_verifier_params(
                     ck, configs.tiny_verifier_config(), device="cpu")):
        with pytest.raises(ValueError, match="orbax") as e:
            load()
        assert "blob" in str(e.value) and "from_jax" in str(e.value)
    with pytest.raises(FileNotFoundError):
        checkpoints.load_params(str(tmp_path / "nothing"), device="cpu")


def test_chip_smoke_lerobot_writer_round_trips(tmp_path):
    """chip_smoke.py phase 7's inverse of the converter's layout and its
    own .safetensors writer, at tiny size: the `safetensors` package reads
    the file as the port's parser does, and load_policy_params gives the
    written tree back bit for bit (fp32 norms and bf16 weights alike)."""
    import chip_smoke
    cfg = configs.tiny_pi0_config()
    pp = pi0.init_pi0(5, cfg, device="cpu")
    path = str(tmp_path / "model.safetensors")
    named = chip_smoke.lerobot_pi0_tensors(pp, cfg)
    n = chip_smoke.write_safetensors(torch, path, named)
    assert n == os.path.getsize(path)
    safetensors_torch = pytest.importorskip("safetensors.torch")
    want = safetensors_torch.load_file(path)
    from cover_vla_tpu_torch.convert.pi0_from_torch import load_state_dict
    got = load_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(k for k, _ in named)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert_trees_equal(loaders.load_policy_params(path, cfg, device="cpu"), pp)


def test_chip_smoke_page_cache_and_rss_probes(tmp_path):
    """chip_smoke.py phase 7's probes: here `drop_page_cache` leaves none
    of a just-written file in the page cache (by `mincore`) and says a
    read now comes from the disk, reading it brings it back, a file still
    resident is not called a disk reading, the mount is named; the
    resident-set sampler sees a 67 MB allocation."""
    import chip_smoke
    path = str(tmp_path / "blob")
    with open(path, "wb") as f:
        f.write(np.random.default_rng(0).bytes(8 << 20))
    assert chip_smoke.resident_share(path) > 0.99     # dirty, just written
    left = chip_smoke.drop_page_cache(path)
    assert left == 0.0 and chip_smoke.resident_share(path) == 0.0
    assert chip_smoke.read_from(left).startswith("the disk")
    assert chip_smoke.read_from(1.0).endswith("not a disk reading")
    with open(path, "rb") as f:
        f.read()
    assert chip_smoke.resident_share(path) > 0.99
    assert " at /" in chip_smoke.mount_of(path)
    with chip_smoke.RssPeak() as rss:
        base = rss.last
        x = np.ones(64 << 20, np.uint8)
        time.sleep(0.1)
        del x
    assert rss.peak >= base + 0.06
