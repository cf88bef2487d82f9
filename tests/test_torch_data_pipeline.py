"""PyTorch port vs the JAX package: the trajectory data pipeline (the
port's own numpy copy; batches byte-equal) and the training image
augmentation (torch on the device; JAX's draws replayed from the same key
splits and injected into the port's apply, float outputs within 1e-5)."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.configs import tiny_pi0_config as j_tiny_pi0
from cover_vla_tpu.data import augment as jaug
from cover_vla_tpu.data import pipeline as jpipe
from cover_vla_tpu.data.stats import DatasetStatistics as JStats
from cover_vla_tpu.data.tokenizer import HashTokenizer as JHash

from cover_vla_tpu_torch.configs import tiny_pi0_config
from cover_vla_tpu_torch.data import augment, pipeline
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.data.tokenizer import HashTokenizer

AUG_ATOL = 1e-5


def _traj(t=6, task="pick it up", seed=0, hw=32):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 255, (t, hw, hw, 3)).astype(np.uint8),
        "states": rng.standard_normal((t, 7)).astype(np.float32),
        "actions": rng.standard_normal((t, 7)).astype(np.float32),
        "task": task,
    }


def _trajs():
    return [_traj(t=5 + i, task=("pick it up", "open the drawer", "")[i % 3],
                  seed=i) for i in range(5)]


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k


TABLE = {"pick it up": ["grab it", "lift it", "take it"],
         "open the drawer": ["pull the drawer open"]}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(paraphrase=True),
    dict(subsample_length=3, skip_unlabeled=True),
])
def test_frame_batches_byte_equal(kw):
    def build(mod):
        extra = dict(kw)
        if extra.pop("paraphrase", False):
            extra["paraphrase"] = mod.ParaphraseAugment(TABLE, prob=0.5)
        ds = mod.FrameDataset(_trajs(), chunk_size=4, **extra)
        stream = mod.StreamingFrameDataset(_trajs(), chunk_size=4, **extra)
        return list(mod.batcher(mod.interleave(
            [ds, stream], weights=[0.7, 0.3], shuffle_buffer=5, seed=3), 3))
    got, want = build(pipeline), build(jpipe)
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_chunk_subsample_and_statistics_equal(tmp_path):
    traj = _traj(t=5)
    _assert_batches_equal(
        {k: v for k, v in pipeline.chunk_trajectory(traj, 4).items()
         if k != "task"},
        {k: v for k, v in jpipe.chunk_trajectory(traj, 4).items()
         if k != "task"})
    frames = pipeline.chunk_trajectory(_traj(t=9), 4)
    a = pipeline.subsample(frames, 4, np.random.default_rng(1))
    b = jpipe.subsample(jpipe.chunk_trajectory(_traj(t=9), 4), 4,
                        np.random.default_rng(1))
    _assert_batches_equal({k: v for k, v in a.items() if k != "task"},
                          {k: v for k, v in b.items() if k != "task"})
    stats = pipeline.compute_statistics(_trajs())
    assert stats == jpipe.compute_statistics(_trajs())
    pipeline.save_statistics(stats, str(tmp_path / "port.json"))
    jpipe.save_statistics(stats, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("norm", [None, "bound", "gaussian"])
def test_make_pi0_batch_byte_equal(norm):
    frames = next(pipeline.batcher(
        pipeline.FrameDataset(_trajs(), chunk_size=4).frames(seed=0), 4))
    cfg, jcfg = tiny_pi0_config(), j_tiny_pi0()
    kw, jkw = {}, {}
    if norm:
        kw = dict(stats=DatasetStatistics.from_json(), state_norm=norm)
        jkw = dict(stats=JStats.from_json(), state_norm=norm)
    got = pipeline.make_pi0_batch(
        frames, HashTokenizer(cfg.paligemma.vocab_size), cfg, **kw)
    want = jpipe.make_pi0_batch(
        frames, JHash(jcfg.paligemma.vocab_size), jcfg, **jkw)
    _assert_batches_equal(got, want)


def test_prefetch_order_and_errors():
    assert list(pipeline.prefetch(iter(range(20)), depth=3)) == list(range(20))

    def broken():
        yield 1
        raise ValueError("bad shard")
    it = pipeline.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad shard"):
        next(it)


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------


def _jax_draws(keys, h, w):
    """JAX's draws for each frame's key, replayed from the same splits as
    `augment_frame`: (crop, jitter) as the port's draw tuples."""
    crop, jit = [], []
    for key in keys:
        kc, kj = jax.random.split(key)
        k1, k2, k3, k4 = jax.random.split(kc, 4)
        scale = jax.random.uniform(k1, (), minval=0.8, maxval=1.0)
        log_ratio = jax.random.uniform(k2, (), minval=jnp.log(0.9),
                                       maxval=jnp.log(1.1))
        area = h * w * scale
        r = jnp.exp(log_ratio)
        crop_w = jnp.clip(jnp.sqrt(area * r), 8, w).astype(jnp.int32)
        crop_h = jnp.clip(jnp.sqrt(area / r), 8, h).astype(jnp.int32)
        y0 = jax.random.randint(k3, (), 0, h - crop_h + 1)
        x0 = jax.random.randint(k4, (), 0, w - crop_w + 1)
        crop.append((scale, log_ratio, y0, x0, crop_h, crop_w))
        j1, j2, j3, j4 = jax.random.split(kj, 4)
        jit.append((jax.random.uniform(j1, (), minval=-0.1, maxval=0.1),
                    jax.random.uniform(j2, (), minval=0.9, maxval=1.1),
                    jax.random.uniform(j3, (), minval=0.9, maxval=1.1),
                    jax.random.uniform(j4, (), minval=-0.025, maxval=0.025)))

    def col(rows, i, dtype):
        return torch.tensor(np.array([np.asarray(r[i]) for r in rows]),
                            dtype=dtype)
    f32, i32 = torch.float32, torch.int32
    return (augment.CropDraw(col(crop, 0, f32), col(crop, 1, f32),
                             col(crop, 2, i32), col(crop, 3, i32)),
            augment.JitterDraw(*(col(jit, i, f32) for i in range(4))),
            col(crop, 4, i32), col(crop, 5, i32))


@pytest.mark.parametrize("src,out", [((64, 80), (56, 56)),
                                     ((224, 224), (224, 224))])
def test_augment_matches_jax_with_injected_draws(src, out):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, *src, 3)).astype(np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(5), imgs.shape[0])
    want = np.asarray(jax.vmap(
        lambda k, im: jaug.augment_frame(k, im, out))(keys, imgs))
    crop, jit, crop_h, crop_w = _jax_draws(keys, *src)
    got_h, got_w = augment.crop_size(*src, crop.area_scale, crop.log_ratio)
    assert torch.equal(got_h, crop_h) and torch.equal(got_w, crop_w)
    got = augment.augment_frames(torch.from_numpy(imgs), out, crop, jit)
    assert got.shape == (imgs.shape[0], *out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_ATOL)
    # the parts on their own
    x = torch.from_numpy(imgs).float() / 255.0
    np.testing.assert_allclose(
        augment.apply_crop(x, crop, out).numpy(),
        np.asarray(jax.vmap(lambda k, im: jaug.random_resized_crop(
            jax.random.split(k)[0], im, out))(keys, imgs / 255.0)),
        rtol=0, atol=AUG_ATOL)


def test_augment_draws_deterministic_and_in_range():
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (16, 60, 50, 3)).astype(np.uint8))
    a = augment.augment_frame(torch.Generator().manual_seed(3), imgs, (56, 56))
    b = augment.augment_frame(torch.Generator().manual_seed(3), imgs, (56, 56))
    assert torch.equal(a, b)
    assert a.min() >= -1.0 and a.max() <= 1.0 and a.shape == (16, 56, 56, 3)
    crop = augment.draw_crop(torch.Generator().manual_seed(4), 1000, 60, 50)
    h, w = augment.crop_size(60, 50, crop.area_scale, crop.log_ratio)
    assert (crop.area_scale >= 0.8).all() and (crop.area_scale <= 1.0).all()
    assert (crop.y0 >= 0).all() and (crop.y0 + h <= 60).all()
    assert (crop.x0 >= 0).all() and (crop.x0 + w <= 50).all()
    jit = augment.draw_jitter(torch.Generator().manual_seed(5), 1000)
    assert jit.brightness.abs().max() <= 0.1 and jit.hue.abs().max() <= 0.025
    # each transform is its draw, then its apply
    x = torch.rand((3, 40, 30, 3), generator=torch.Generator().manual_seed(7))
    assert torch.equal(
        augment.random_resized_crop(torch.Generator().manual_seed(8), x,
                                    (20, 20)),
        augment.apply_crop(x, augment.draw_crop(
            torch.Generator().manual_seed(8), 3, 40, 30), (20, 20)))
    assert torch.equal(
        augment.color_jitter(torch.Generator().manual_seed(9), x),
        augment.apply_jitter(x, augment.draw_jitter(
            torch.Generator().manual_seed(9), 3)))
    # the identity draw leaves a frame in [0, 1] as it is
    x = torch.rand((2, 8, 8, 3), generator=torch.Generator().manual_seed(6))
    ident = augment.JitterDraw(torch.zeros(2), torch.ones(2), torch.ones(2),
                               torch.zeros(2))
    torch.testing.assert_close(augment.apply_jitter(x, ident), x, atol=2e-3,
                               rtol=0)
