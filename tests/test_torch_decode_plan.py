"""K1's key split on the CPU: the plan the wrapper hands to the kernel
(`cuda_attention.decode_plan`), and a plain model of the kernel's
split-and-combine arithmetic held against the Pallas kernel (interpret
mode) and the plain twin."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cover_vla_tpu.ops.pallas_attention import pallas_shared_prefix_gqa

from cover_vla_tpu_torch.ops import cuda_attention as ca
from cover_vla_tpu_torch.ops.attention import BIG_NEG

from test_torch_attention import _k1_inputs

# (batch x kv heads, query rows per pair, prefix keys) -> (split, blocks):
# the E=16 x N=16 step (160 row tiles of 64), the 5x8 protocol (32, the
# last of each pair 8 of its 200 rows) and the episode path's cohort (128)
MAIN = {"bench": ((16, 16 * 5 * 8, 328), (1, 80)),
        "protocol": ((8, 5 * 5 * 8, 328), (3, 48)),
        "cohort": ((32, 5 * 5 * 8, 328), (2, 128))}


@pytest.mark.parametrize("tag", sorted(MAIN))
def test_main_shapes_get_the_documented_split(tag):
    (bh, rows, p), (split, blocks) = MAIN[tag]
    plan = ca.decode_plan(bh, rows, p)
    assert (plan.split, plan.blocks) == (split, blocks)
    assert plan.row_blocks == math.ceil(rows / 128)
    assert plan.waves == pytest.approx(blocks / 132)
    assert plan.waves <= 1.0          # one wave at every main shape


@pytest.mark.parametrize("bh", [1, 2, 8, 16, 64])
@pytest.mark.parametrize("rows", [1, 40, 128, 200, 640])
@pytest.mark.parametrize("p", [1, 40, 64, 65, 328, 1000])
def test_parts_cover_every_key_tile_once(bh, rows, p):
    plan = ca.decode_plan(bh, rows, p)
    parts = plan.parts(p)
    assert 1 <= plan.split <= ca.DECODE_MAX_SPLIT
    assert len(parts) == plan.split                 # no empty part
    tiles = [t for lo, hi, _ in parts
             for t in range(lo // 64, math.ceil(hi / 64))]
    assert tiles == list(range(math.ceil(p / 64)))  # each tile exactly once
    assert all(lo % 64 == 0 and lo < hi for lo, hi, _ in parts)
    assert parts[-1][1] == p
    # the suffix phase falls to exactly one part, the last
    assert [suf for *_, suf in parts] == [False] * (plan.split - 1) + [True]
    # the split is chosen among the card's waves
    assert plan.blocks == bh * plan.row_blocks * plan.split


def split_model(q, ks, vs, kp, vp, pad, smask, plan):
    """The kernel's arithmetic in plain PyTorch: per part, a running
    maximum over its keys 32 at a time (the last part then its suffix keys),
    raised only past 2^8, p = bf16(exp(s - m)), sums of the rounded p and
    of p V; the combine rescales each part by exp(m_part - m)."""
    bf = torch.bfloat16
    b, n, s, hq, d = q.shape
    hkv = ks.shape[3]
    q32 = q.to(bf).float().reshape(b, n, s, hkv, hq // hkv, d) * d ** -0.5
    sp = torch.einsum("bnshgd,bphd->bnhgsp", q32, kp.to(bf).float())
    sp = torch.where(pad[:, None, None, None, None, :], sp, BIG_NEG)
    ss = torch.einsum("bnshgd,bnthd->bnhgst", q32, ks.to(bf).float())
    ss = torch.where(smask[:, None, None, None], ss, BIG_NEG)
    vp32 = vp.to(bf).float()
    vs32 = vs.to(bf).float()
    raise_by = 8 * math.log(2.0)
    parts = []
    for lo, hi, with_suffix in plan.parts(kp.shape[1]):
        tiles = [(sp[..., j:min(j + 32, hi)],
                  lambda pr, j=j: torch.einsum(
                      "bnhgsp,bphd->bnhgsd", pr, vp32[:, j:min(j + 32, hi)]))
                 for j in range(lo, hi, 32)]
        if with_suffix:
            tiles.append((ss, lambda pr: torch.einsum(
                "bnhgst,bnthd->bnhgsd", pr, vs32)))
        m = torch.full(sp.shape[:-1], BIG_NEG)
        l = torch.zeros(sp.shape[:-1])
        o = torch.zeros((*sp.shape[:-1], d))
        for x, pv in tiles:
            mx = x.amax(-1)
            up = mx > m + raise_by
            alpha = torch.where(up, torch.exp(m - mx), torch.ones_like(m))
            m = torch.where(up, mx, m)
            pr = torch.exp(x - m[..., None]).to(bf).float()
            l = l * alpha + pr.sum(-1)
            o = o * alpha[..., None] + pv(pr)
        parts.append((m, l, o))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - m_all) for m, _, _ in parts]
    l_all = sum(wk * l for wk, (_, l, _) in zip(w, parts))
    o_all = sum(wk[..., None] * o for wk, (_, _, o) in zip(w, parts))
    out = (o_all / l_all.clamp_min(1e-37)[..., None]).permute(0, 1, 4, 2, 3, 5)
    return out.reshape(b, n, s, hq * d).to(bf)


@pytest.mark.parametrize("empty_rows", [False, True])
@pytest.mark.parametrize("split", [1, 2, 3])
def test_split_model_matches_pallas_and_twin(split, empty_rows):
    rng = np.random.default_rng(11)
    b, n, s, g, hkv, d, p = 2, 3, 5, 4, 2, 32, 150   # 3 key tiles
    inputs = _k1_inputs(rng, b, n, s, g, hkv, d, p, n_valid=[p, 97],
                        empty_rows=empty_rows)
    per = math.ceil(math.ceil(p / 64) / split)
    plan = ca.DecodePlan(split=split, tiles_per_part=per, row_blocks=1,
                         blocks=b * hkv * split, waves=0.0)
    assert len(plan.parts(p)) == split
    tx = [torch.from_numpy(x).to(torch.bfloat16) for x in inputs[:5]]
    masks = [torch.from_numpy(m) for m in inputs[5:]]
    got = split_model(*tx, *masks, plan)
    twin = ca.shared_prefix_gqa_plain(*tx, *masks)
    np.testing.assert_allclose(got.float().numpy(), twin.float().numpy(),
                               atol=2e-2, rtol=0)
    ref = np.asarray(pallas_shared_prefix_gqa(
        *(jnp.asarray(x, jnp.bfloat16) for x in inputs[:5]),
        *(jnp.asarray(m) for m in inputs[5:]), interpret=True), np.float32)
    # the Pallas kernel gives a row with no attended key the mean over its
    # padded blocks, not over the row's own keys: compare the other rows
    rows = np.ones((b, n, s), bool)
    if empty_rows:
        rows[-1, :, 0] = False
    np.testing.assert_allclose(got.float().numpy()[rows], ref[rows],
                               atol=2e-2, rtol=0)
