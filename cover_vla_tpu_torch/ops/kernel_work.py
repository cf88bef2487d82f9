"""The work of one launch of each hand kernel: the bytes it must move
(each input read once, the bf16 result written once) and the operations
of the (query, key) pairs its inputs attend. `chip_smoke.py` divides them
into the card's peaks for each kernel's bound, and `scripts/torch_roofline.py`
into a trace's kernel time for its achieved rates.

Each function takes the tuple of tensors the kernel was launched on, in
the order of its wrapper in `ops/cuda_attention.py` (K2's q/k/v after the
cast to bf16). K1 and K3 count the keys this run's masks attend, so they
read their masks back from the card.
"""

from __future__ import annotations


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_work(args):
    """K1 `shared_prefix_gqa`: every candidate's suffix rows over the row's
    valid prefix keys and its own suffix."""
    q, ks, vs, kp, vp, pad, smask = args
    b, n, s, hq, d = q.shape
    valid_keys = pad.sum(dim=1).float() + s            # per batch row
    flops = float(4 * n * s * hq * d * valid_keys.sum().item())
    return nbytes(*args) + nbytes(q), flops


def k2_work(args):
    """K2 `mha_dense`: every query over every key."""
    q, k, v = args
    b, s, h, d = q.shape
    return nbytes(q, k, v) + nbytes(q), float(4 * b * h * s * k.shape[1] * d)


def k3_work(args):
    """K3 `prefix_gqa`: bytes once (bf16 result) and the operations of the
    attended (query, key) pairs of this run's mask."""
    q, k, v, mask = args
    hq, d = q.shape[2], q.shape[3]
    return nbytes(*args) + nbytes(q), float(4 * hq * d * mask.sum().item())


# by the wrappers' names in `ops/cuda_attention.launch_counts`
WORK = {"shared_prefix_gqa": k1_work, "mha_dense": k2_work,
        "prefix_gqa": k3_work}
