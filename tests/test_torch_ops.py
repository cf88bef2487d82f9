"""PyTorch port vs the JAX package: small ops on the same numpy inputs
(CPU, fp32), and the image resizes at the engine's shapes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.ops import image as jimage
from cover_vla_tpu.ops import masks as jmasks
from cover_vla_tpu.ops import norms as jnorms
from cover_vla_tpu.ops import rope as jrope
from cover_vla_tpu.ops import sampling as jsampling
from cover_vla_tpu.utils import geometry as jgeom

from cover_vla_tpu_torch.ops import image, masks, norms, rope, sampling
from cover_vla_tpu_torch.utils import geometry

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32) * 0.1
    b = rng.standard_normal(48).astype(np.float32) * 0.1
    _close(norms.rms_norm(_t(x), _t(w)), jnorms.rms_norm(x, w))
    _close(norms.layer_norm(_t(x), _t(w), _t(b)),
           jnorms.layer_norm(x, w, b))
    _close(norms.layer_norm(_t(x), _t(w), _t(b), 1e-5),
           jnorms.layer_norm(x, w, b, 1e-5))


def test_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 400, (2, 7)).astype(np.int32)
    _close(rope.apply_rope(_t(x), _t(pos)), jrope.apply_rope(x, pos),
           atol=1e-4)   # |x| ~ 4 and angles up to 400 rad: fp32 sin/cos


def test_masks_match():
    pad = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    att = np.array([[0, 0, 1, 1, 0], [1, 0, 1, 0, 0]], np.int32)
    np.testing.assert_array_equal(
        masks.make_att_2d_masks(_t(pad), _t(att)).numpy(),
        np.asarray(jmasks.make_att_2d_masks(pad, att)))
    np.testing.assert_array_equal(masks.suffix_att_masks(3, 4).numpy(),
                                  np.asarray(jmasks.suffix_att_masks(3, 4)))


def test_time_embedding_and_noise():
    t = np.array([1.0, 0.9, 0.35, 0.1], np.float32)
    _close(sampling.sinusoidal_time_embedding(_t(t), 64),
           jsampling.sinusoidal_time_embedding(jnp.asarray(t), 64))
    g = torch.Generator().manual_seed(0)
    n = sampling.sample_noise((2, 3, 4), 0.5, generator=g, device="cpu")
    assert n.shape == (2, 3, 4) and n.dtype == torch.float32
    g2 = torch.Generator().manual_seed(0)
    torch.testing.assert_close(
        n, sampling.sample_noise((2, 3, 4), 0.5, generator=g2, device="cpu"))


def test_euler_to_rotvec_matches():
    rng = np.random.default_rng(2)
    rpy = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    rpy[:4] = 0.0                                  # zero rotation branch
    _close(geometry.euler_to_rotvec(_t(rpy)), jgeom.euler_to_rotvec(rpy))


@pytest.mark.parametrize("shape,size", [((256, 256), 224),
                                        ((480, 640), 224),
                                        ((224, 224), 224)])
def test_lanczos4_uint8_bit_exact(shape, size):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    img[:8] = 255                                  # saturating overshoot
    img[8:16] = 0
    ref = np.asarray(jimage.resize_lanczos4_uint8_device(jnp.asarray(img),
                                                         size, size))
    got = image.resize_lanczos4_uint8_device(_t(img)[None], size, size)[0]
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape,out", [((64, 64), (128, 128)),
                                       ((256, 256), (224, 224)),
                                       ((480, 640), (224, 200)),
                                       ((37, 53), (96, 112))])
def test_lanczos4_float_matches(shape, out):
    """The float LANCZOS4 (no overshoot clipping): the tap matrices equal
    the JAX package's bit for bit, the resize within 1e-3 at the 0-255
    scale (fp32 sums of 8 taps per pass in another order)."""
    np.testing.assert_array_equal(image._lanczos4_matrix(shape[1], out[1]),
                                  jimage._lanczos4_matrix(shape[1], out[1]))
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 255, (2, *shape, 3)).astype(np.float32)
    ref = np.asarray(jimage.resize_lanczos4(jnp.asarray(img), *out))
    got = image.resize_lanczos4(_t(img), *out)
    assert got.shape == (2, *out, 3) and got.dtype == torch.float32
    assert ref.min() < 0 or ref.max() > 255        # overshoot kept
    _close(got.numpy(), ref, atol=1e-3)


def _assert_rounding_flips_only(got, ref):
    """Rounding between the two passes may flip a value sitting on .5: at
    most 1 off, on at most 0.1% of the pixels."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("shape,size", [((256, 256), 384),
                                        ((480, 640), 256)])
def test_bicubic_pil_matches(shape, size):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, *shape, 3)).astype(np.float32)
    ref = jimage.resize_bicubic_pil(jnp.asarray(img), size, size)
    got = image.resize_bicubic_pil(_t(img), size, size)
    _assert_rounding_flips_only(got.numpy(), ref)


@pytest.mark.parametrize("shape,size", [((480, 640), 256),
                                        ((256, 256), 384)])
def test_tf_antialias_matches(shape, size):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (2, *shape, 3)).astype(np.float32)
    ref = np.asarray(jimage.resize_bilinear_tf_antialias(
        jnp.asarray(img), size, size))
    got = image.resize_bilinear_tf_antialias(_t(img), size, size).numpy()
    _close(got, ref, atol=1e-3)                    # fp32 sums at 255 scale
    # the engine's truncating uint8 cast after the resize
    _assert_rounding_flips_only(np.clip(np.floor(got), 0, 255),
                                np.clip(np.floor(ref), 0, 255))


def test_fast_math_switch_reads_as_in_jax():
    """`set_fast_math` / `score_precision` read as the JAX package's do
    (by the precision's name); the port's eager scores stay full fp32, so
    the attention output does not move."""
    from cover_vla_tpu.ops import attention as jatt
    from cover_vla_tpu_torch.ops import attention as att
    rng = np.random.default_rng(9)
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 2, 8), (1, 4, 1, 8), (1, 4, 1, 8)))
    m = torch.ones((1, 4, 4), dtype=torch.bool)
    exact = att.gqa_attention(q, k, v, m)
    try:
        for on in (True, False):
            att.set_fast_math(on)
            jatt.set_fast_math(on)
            assert att.score_precision() == jatt.score_precision().name.lower()
            assert torch.equal(att.gqa_attention(q, k, v, m), exact)
    finally:
        att.set_fast_math(False)
        jatt.set_fast_math(False)


def test_patchify_matches():
    rng = np.random.default_rng(6)
    img = rng.standard_normal((2, 28, 42, 3)).astype(np.float32)
    np.testing.assert_array_equal(image.patchify(_t(img), 14).numpy(),
                                  np.asarray(jimage.patchify(img, 14)))
