"""PyTorch port vs the JAX package: eager attention, and the plain twins of
the CUDA kernels against the Pallas kernels in interpret mode (CPU).
Kernel-on-card tests carry the `cuda` marker and skip without a GPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.models import gemma as jgemma
from cover_vla_tpu.ops import attention as jatt
from cover_vla_tpu.ops.masks import make_att_2d_masks, suffix_att_masks
from cover_vla_tpu.ops.pallas_attention import (
    pallas_mha_dense, pallas_prefix_gqa, pallas_shared_prefix_gqa)

from cover_vla_tpu_torch.models import gemma
from cover_vla_tpu_torch.ops import attention, cuda_attention

DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x, dtype):
    """One numpy array as (jax array, torch tensor) of the same dtype."""
    _, jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(torch.as_tensor(x).float()) if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32)


def _suffix_inputs(rng, b, n, s, hq, hkv, d, p):
    q = rng.standard_normal((b, n, s, hq, d)).astype(np.float32)
    ks = rng.standard_normal((b, n, s, hkv, d)).astype(np.float32)
    vs = rng.standard_normal((b, n, s, hkv, d)).astype(np.float32)
    kp = rng.standard_normal((b, p, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((b, p, hkv, d)).astype(np.float32)
    prefix_pad = np.ones((b, p), bool)
    prefix_pad[-1, p * 2 // 3:] = False
    smask = np.array(make_att_2d_masks(
        np.ones((b, s), bool), np.asarray(suffix_att_masks(b, s - 1))))
    return q, ks, vs, kp, vp, prefix_pad, smask


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gqa_and_mha_eager_match(dtype):
    atol = DTYPES[dtype][3]
    rng = np.random.default_rng(0)
    b, s, hq, hkv, d = 2, 19, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pad = np.ones((b, s), bool)
    pad[1, 13:] = False
    mask = pad[:, None, :] & pad[:, :, None]
    mask[:, :, 0] = True                       # no fully-masked rows
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    ref = jatt.gqa_attention(jq, jk, jv, jnp.asarray(mask))
    np.testing.assert_allclose(_np(attention.gqa_attention(tq, tk, tv, tmask)),
                               _np(ref), atol=atol, rtol=0)

    kh = np.concatenate([k, k], axis=2)
    vh = np.concatenate([v, v], axis=2)
    (jkh, tkh), (jvh, tvh) = _pair(kh, dtype), _pair(vh, dtype)
    bias = rng.standard_normal((b, s, s)).astype(np.float32)
    for kw_j, kw_t in [({}, {}),
                       ({"mask": jnp.asarray(mask)}, {"mask": tmask}),
                       ({"bias": jnp.asarray(bias)},
                        {"bias": torch.from_numpy(bias)})]:
        ref = jatt.mha_attention(jq, jkh, jvh, **kw_j)
        got = attention.mha_attention(tq, tkh, tvh, **kw_t)
        np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=0)
    with pytest.raises(ValueError):
        attention.mha_attention(tq, tkh, tvh, backend="xla")


def _k1_inputs(rng, b, n, s, g, hkv, d, p, n_valid=None, empty_rows=False):
    """K1's inputs with G query heads per kv head: the prefix of batch row
    i real up to n_valid[i % len] (all of it by default), the action
    expert's suffix mask (the state token attends itself, the actions the
    state and each other). `empty_rows`: in the last batch row no prefix
    key is real and the state token attends nothing, so its G*N rows have
    no attended key at all."""
    hq = g * hkv
    q = rng.standard_normal((b, n, s, hq, d)).astype(np.float32)
    ks, vs = (rng.standard_normal((b, n, s, hkv, d)).astype(np.float32)
              for _ in range(2))
    kp, vp = (rng.standard_normal((b, p, hkv, d)).astype(np.float32)
              for _ in range(2))
    pad = np.ones((b, p), bool)
    for i in range(b):
        pad[i, (n_valid or [p])[i % len(n_valid or [p])]:] = False
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    smask = np.broadcast_to((j == 0) | ((i >= 1) & (j >= 1)), (b, s, s)).copy()
    if empty_rows:
        pad[-1] = False
        smask[-1, 0] = False
    return q, ks, vs, kp, vp, pad, smask


@pytest.mark.parametrize("dtype,empty_rows", [("fp32", False), ("bf16", False),
                                              ("fp32", True), ("bf16", True)])
def test_shared_prefix_eager_matches(dtype, empty_rows):
    """Port vs JAX eager; with `empty_rows` some query rows attend no key
    and are the uniform softmax over their own P + S keys, which the
    kernel's plain twin must give as well."""
    atol = DTYPES[dtype][3]
    rng = np.random.default_rng(1)
    if empty_rows:
        inputs = _k1_inputs(rng, 2, 3, 5, 4, 1, 16, 11, empty_rows=True)
        assert not (inputs[5][-1].any() or inputs[6][-1, 0].any())
    else:
        inputs = _suffix_inputs(rng, 2, 3, 5, 4, 1, 16, 11)
    jx = [_pair(x, dtype) for x in inputs[:5]]
    masks = inputs[5:]
    ref = jgemma._shared_prefix_gqa(*(j for j, _ in jx),
                                    *(jnp.asarray(m) for m in masks))
    got = gemma._shared_prefix_gqa(*(t for _, t in jx),
                                   *(torch.from_numpy(m) for m in masks))
    np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=0)
    if empty_rows:
        twin = cuda_attention.shared_prefix_gqa_plain(
            *(t for _, t in jx), *(torch.from_numpy(m) for m in masks))
        np.testing.assert_allclose(_np(twin), _np(ref), atol=2e-2, rtol=0)


@pytest.mark.parametrize("b,n,s,hq,hkv,d,p", [(2, 3, 5, 4, 1, 16, 11),
                                              (1, 2, 5, 4, 2, 72, 40)])
def test_shared_prefix_twin_matches_pallas(b, n, s, hq, hkv, d, p):
    rng = np.random.default_rng(2)
    inputs = _suffix_inputs(rng, b, n, s, hq, hkv, d, p)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in inputs[:5]]
    tx = [torch.from_numpy(x).to(torch.bfloat16) for x in inputs[:5]]
    masks = inputs[5:]
    ref = pallas_shared_prefix_gqa(*jx, *(jnp.asarray(m) for m in masks),
                                   interpret=True)
    cuda_attention.reset_launch_counts()
    twin = cuda_attention.shared_prefix_gqa_plain(
        *tx, *(torch.from_numpy(m) for m in masks))
    # the wrapper routes CPU tensors to the twin and counts no launch
    routed = gemma._shared_prefix_gqa(*tx, *(torch.from_numpy(m) for m in masks),
                                      attn_impl="cuda")
    assert cuda_attention.launch_counts["shared_prefix_gqa"] == 0
    torch.testing.assert_close(routed, twin, atol=0, rtol=0)
    assert twin.shape == (b, n, s, hq * d) and twin.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(twin), _np(ref), atol=2e-2, rtol=0)


# then one under and over the CUDA kernel's 64-key tile, and one over its
# 128-row block, at so400m's head dim
@pytest.mark.parametrize("b,s,h,d", [(2, 37, 4, 16), (1, 300, 2, 32),
                                     (2, 40, 2, 72), (1, 63, 2, 72),
                                     (1, 65, 2, 72), (1, 129, 2, 72)])
def test_mha_dense_twin_matches_pallas(b, s, h, d):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    ref = pallas_mha_dense(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                           interpret=True)
    tx = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    cuda_attention.reset_launch_counts()
    twin = cuda_attention.mha_dense_plain(*tx)
    routed = attention.mha_attention(*tx, backend="cuda")
    assert cuda_attention.launch_counts["mha_dense"] == 0
    torch.testing.assert_close(routed, twin, atol=0, rtol=0)
    np.testing.assert_allclose(_np(twin), _np(ref), atol=2e-2, rtol=0)
    # fp32 inputs are rounded to bf16 inside, as in the Pallas kernel, and
    # the result comes back in the value dtype
    t32 = cuda_attention.mha_dense_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    assert t32.dtype == torch.float32
    np.testing.assert_allclose(_np(t32), _np(twin), atol=1e-2, rtol=0)


def _prefix_inputs(rng, b, sq, skv, hq, hkv, d, n_pad, windows=None):
    """Trailing padding of `n_pad` keys in the last batch row; or, with
    `windows`, real keys lo <= j < hi per batch row under a causal mask
    (the last query on the last key), so that whole blocks of masked keys
    come before a row's first real key."""
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    pad = np.ones((b, skv), bool)
    if windows is None:
        pad[-1, skv - n_pad:] = False
    else:
        pad[:] = False
        for i, (lo, hi) in enumerate(windows):
            pad[i, lo:hi] = True
    qpad = pad if sq == skv else np.ones((b, sq), bool)
    mask = pad[:, None, :] & qpad[:, :, None]
    if windows is not None:
        pos = np.arange(skv)
        mask = mask & (pos[None, :] <= pos[-sq:, None])
    return q, k, v, mask, qpad


# the JAX test's shapes (tests/test_pallas_attention.py), then Sq != Skv
# and the tiny config's head dim
# and the tiny config's head dim; then one over the CUDA kernel's 64-key
# tile and 128-row block with the padding starting inside a 16-position
# block (positions 60.. and 100.. of a block at 48 and 96), so real and
# all-masked rows share a block, and Sq one over a tile against Skv two
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,n_pad", [
    (1, 130, 130, 8, 1, 128, 37), (2, 200, 200, 8, 2, 128, 37),
    (2, 3, 50, 8, 2, 32, 11), (2, 40, 40, 4, 1, 16, 7),
    (1, 65, 65, 8, 1, 32, 5), (2, 129, 129, 8, 1, 16, 29),
    (2, 65, 129, 8, 1, 16, 20)])
def test_prefix_gqa_twin_matches_pallas(b, sq, skv, hq, hkv, d, n_pad):
    rng = np.random.default_rng(5)
    _check_prefix_twin(*_prefix_inputs(rng, b, sq, skv, hq, hkv, d, n_pad))


# whole key blocks masked ahead of the first real key, for the Pallas
# kernel's 128-key blocks and the CUDA kernel's 64-key tiles alike: the
# p = 1 such a block collects must be wiped when a real score arrives
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,windows", [
    (2, 300, 300, 8, 2, 32, [(140, 263), (40, 300)]),
    (2, 5, 300, 4, 1, 16, [(130, 268), (33, 300)])])
def test_prefix_gqa_twin_matches_pallas_leading_masked(b, sq, skv, hq, hkv, d,
                                                       windows):
    rng = np.random.default_rng(6)
    q, k, v, mask, qpad = _prefix_inputs(rng, b, sq, skv, hq, hkv, d, 0,
                                         windows=windows)
    first_real = mask.argmax(-1)[qpad & mask.any(-1)]
    assert first_real.max() >= 128          # a whole Pallas block, 2 tiles
    _check_prefix_twin(q, k, v, mask, qpad)


def _check_prefix_twin(q, k, v, mask, qpad):
    b, sq, hq, d = q.shape
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    cuda_attention.reset_launch_counts()
    twin = cuda_attention.prefix_gqa_plain(tq, tk, tv, tmask)
    routed = cuda_attention.prefix_gqa(tq, tk, tv, tmask)
    assert cuda_attention.launch_counts["prefix_gqa"] == 0
    torch.testing.assert_close(routed, twin, atol=0, rtol=0)
    assert twin.shape == (b, sq, hq * d) and twin.dtype == torch.float32
    # fp32 v: both sides round q/k/v to bf16 and keep p in fp32, so valid
    # rows agree to fp32 summation order (atol 1e-4)
    ref = pallas_prefix_gqa(*(jnp.asarray(x) for x in (q, k, v, mask)),
                            interpret=True)
    valid = np.repeat(qpad[:, :, None], hq * d, axis=2)
    assert np.abs(_np(twin) - _np(ref))[valid].max() <= 1e-4
    # padding rows are a uniform softmax over the real keys, as in the
    # eager path: ALL rows agree with gqa_attention on bf16 inputs within
    # the JAX test's bound (bf16 rounding of p and of the result there)
    eager = jatt.gqa_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(mask))
    np.testing.assert_allclose(_np(twin), _np(eager), atol=1.5e-2, rtol=0)
    # bf16 operands give a bf16 result unless fp32 is asked for
    tb = [x.to(torch.bfloat16) for x in (tq, tk, tv)]
    assert cuda_attention.prefix_gqa(*tb, tmask).dtype == torch.bfloat16
    out32 = cuda_attention.prefix_gqa(*tb, tmask, out_dtype=torch.float32)
    torch.testing.assert_close(out32, twin, atol=0, rtol=0)


def _autograd_cases():
    """Each wrapper with small CPU inputs (bf16, as the kernels take)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    b, n, s, hq, hkv, d, p = 1, 2, 3, 4, 1, 16, 5
    k1 = dict(q=r(b, n, s, hq, d), k_suf=r(b, n, s, hkv, d),
              v_suf=r(b, n, s, hkv, d), k_pre=r(b, p, hkv, d),
              v_pre=r(b, p, hkv, d),
              prefix_pad=torch.ones((b, p), dtype=torch.bool),
              suffix_mask=torch.ones((b, s, s), dtype=torch.bool))
    k2 = dict(q=r(2, 7, 2, 16), k=r(2, 7, 2, 16), v=r(2, 7, 2, 16))
    k3 = dict(q=r(2, 6, 4, 16), k=r(2, 6, 1, 16), v=r(2, 6, 1, 16),
              mask=torch.ones((2, 6, 6), dtype=torch.bool))
    return {"shared_prefix_gqa": k1, "mha_dense": k2, "prefix_gqa": k3}


@pytest.mark.parametrize("name", ["shared_prefix_gqa", "mha_dense",
                                  "prefix_gqa"])
def test_kernel_wrappers_refuse_autograd(name):
    """No kernel has a backward pass: with grad enabled and an input that
    requires grad the wrapper raises (on the CPU route too) instead of
    returning a silently detached output; under no_grad, or with no input
    requiring grad, it runs."""
    fn = getattr(cuda_attention, name)
    args = _autograd_cases()[name]
    plain = fn(**args)
    args["q"] = args["q"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        fn(**args)
    with torch.no_grad():
        assert torch.equal(fn(**args), plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 72, 256])
def test_kernels_match_twins_on_card(cuda_device, d):
    rng = np.random.default_rng(4)
    inputs = _suffix_inputs(rng, 2, 3, 5, 8, 1, d, 70)
    tx = [torch.from_numpy(x).to(cuda_device, torch.bfloat16)
          for x in inputs[:5]]
    masks = [torch.from_numpy(m).to(cuda_device) for m in inputs[5:]]
    got = cuda_attention.shared_prefix_gqa(*tx, *masks)
    ref = cuda_attention.shared_prefix_gqa_plain(*tx, *masks)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 77, 4, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(3))
    got = cuda_attention.mha_dense(q, k, v)
    ref = cuda_attention.mha_dense_plain(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    pq, pk, pv, pmask, _ = _prefix_inputs(rng, 2, 77, 77, 8, 1, d, 20)
    pq, pk, pv = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
                  for x in (pq, pk, pv))
    pmask = torch.from_numpy(pmask).to(cuda_device)
    got = cuda_attention.prefix_gqa(pq, pk, pv, pmask, out_dtype=torch.float32)
    ref = cuda_attention.prefix_gqa_plain(pq, pk, pv, pmask,
                                          out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4
    # whole 64-key tiles masked ahead of the first real key
    pq, pk, pv, pmask, _ = _prefix_inputs(
        rng, 3, 150, 150, 8, 1, d, 0,
        windows=[(40, 120), (100, 150), (0, 150)])
    pq, pk, pv = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
                  for x in (pq, pk, pv))
    pmask = torch.from_numpy(pmask).to(cuda_device)
    got = cuda_attention.prefix_gqa(pq, pk, pv, pmask, out_dtype=torch.float32)
    ref = cuda_attention.prefix_gqa_plain(pq, pk, pv, pmask,
                                          out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_mha_dense_fp32_inputs_on_card(cuda_device):
    """An fp32 tower (the verification-scaling experiment's verifier) runs
    K2 in bf16 and gets an fp32 result, as from the twin and the JAX
    kernel; the kernel's bf16 result adds one rounding."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((16, 256, 4, 16)).astype(
        np.float32)).to(cuda_device) for _ in range(3))
    got = cuda_attention.mha_dense(q, k, v)
    ref = cuda_attention.mha_dense_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 2e-2


# the edges of the warpgroup kernels' tiles: 64 keys, 64 rows a warpgroup,
# 128 rows a block (16 positions of 8 heads in K3)
@pytest.mark.cuda
@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 577])
@pytest.mark.parametrize("d", [64, 72])
def test_mha_dense_tile_edges_on_card(cuda_device, s, d):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, 3, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(3))
    got = cuda_attention.mha_dense(q, k, v)
    ref = cuda_attention.mha_dense_plain(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


# (Sq, Skv, trailing padding): the padding starts inside a 16-position
# block, so all-masked rows share a block, and a warpgroup, with real ones
@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,n_pad", [(63, 63, 5), (65, 65, 5),
                                          (129, 129, 69), (129, 129, 1),
                                          (65, 129, 20), (17, 130, 64)])
@pytest.mark.parametrize("d", [72, 256])
def test_prefix_gqa_tile_edges_on_card(cuda_device, sq, skv, n_pad, d):
    rng = np.random.default_rng(8)
    pq, pk, pv, pmask, _ = _prefix_inputs(rng, 2, sq, skv, 8, 1, d, n_pad)
    pq, pk, pv = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
                  for x in (pq, pk, pv))
    pmask = torch.from_numpy(pmask).to(cuda_device)
    got = cuda_attention.prefix_gqa(pq, pk, pv, pmask, out_dtype=torch.float32)
    ref = cuda_attention.prefix_gqa_plain(pq, pk, pv, pmask,
                                          out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4       # every row
    got16 = cuda_attention.prefix_gqa(pq, pk, pv, pmask)
    torch.cuda.synchronize()
    assert (got16.float() - ref).abs().max().item() <= 2e-2


# K1 at the edges of its design: rows one under, at and one over the
# 64-row warpgroup and the 128-row block (S = G = 1, one row a candidate,
# so a warpgroup spans 64 candidates); P one under, at and one over the
# 64-key tile and the split boundaries (one batch row splits 383-385 keys
# into 3 or 4 parts, 1500 into 6, 2000 into 8), and P under one tile;
# S = 1 and 32; a warpgroup spanning 3 or 4 candidates (S G = 24); G = 1
# with Hkv = 2; the padded head dims; rows with no attended key.
K1_EDGES = {
    "rows63": (2, 63, 1, 1, 1, 256, 70), "rows64": (2, 64, 1, 1, 1, 256, 70),
    "rows65": (2, 65, 1, 1, 1, 256, 70), "rows127": (2, 127, 1, 1, 1, 256, 70),
    "rows128": (2, 128, 1, 1, 1, 256, 70), "rows129": (2, 129, 1, 1, 1, 256, 70),
    "p40": (2, 3, 5, 8, 1, 256, 40), "p63": (2, 3, 5, 8, 1, 256, 63),
    "p64": (2, 3, 5, 8, 1, 256, 64), "p65": (2, 3, 5, 8, 1, 256, 65),
    "p127": (2, 3, 5, 8, 1, 256, 127), "p128": (2, 3, 5, 8, 1, 256, 128),
    "p129": (2, 3, 5, 8, 1, 256, 129), "p383": (1, 5, 5, 8, 1, 256, 383),
    "p384": (1, 5, 5, 8, 1, 256, 384), "p385": (1, 5, 5, 8, 1, 256, 385),
    "p1500": (1, 5, 5, 8, 1, 256, 1500), "p2000": (1, 5, 5, 8, 1, 256, 2000),
    "s1": (2, 9, 1, 8, 1, 256, 100), "s32": (2, 3, 32, 2, 1, 256, 100),
    "three_cands": (2, 7, 3, 8, 1, 256, 150),
    "g1_hkv2": (2, 6, 5, 1, 2, 256, 90),
    "d64": (2, 4, 5, 8, 1, 64, 130), "d72": (2, 4, 5, 8, 1, 72, 130),
    "d128": (2, 4, 5, 8, 1, 128, 130), "d256": (2, 4, 5, 8, 1, 256, 130),
}


@pytest.mark.cuda
@pytest.mark.parametrize("empty_rows", [False, True])
@pytest.mark.parametrize("case", sorted(K1_EDGES))
def test_shared_prefix_gqa_edges_on_card(cuda_device, case, empty_rows):
    b, n, s, g, hkv, d, p = K1_EDGES[case]
    rng = np.random.default_rng(9)
    inputs = _k1_inputs(rng, b, n, s, g, hkv, d, p, n_valid=[p, p * 2 // 3],
                        empty_rows=empty_rows)
    tx = [torch.from_numpy(x).to(cuda_device, torch.bfloat16)
          for x in inputs[:5]]
    masks = [torch.from_numpy(m).to(cuda_device) for m in inputs[5:]]
    got = cuda_attention.shared_prefix_gqa(*tx, *masks)
    ref = cuda_attention.shared_prefix_gqa_plain(*tx, *masks)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
