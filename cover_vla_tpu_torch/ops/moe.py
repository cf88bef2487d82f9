"""Sigmoid-routed mixture of experts (DeepSeek-V3's `noaux_tc` routing,
arXiv 2412.19437) on the device, with no host synchronisation and no
dropped token.

  route    fp32 router logits, sigmoid scores; the top k experts chosen on
           score + correction bias (the bias only chooses), weighted by
           their scores normalised to sum 1 and times the routed scaling
  dispatch the (token, choice) rows sorted by expert (a stable sort), the
           groups' ends found by a binary search of the sorted ids, the
           tokens gathered in that order
  experts  the SwiGLU experts as two grouped products
           (`torch._grouped_mm`, the group ends on the device) over the
           sorted rows: [gate | up], then down
  combine  the rows put back in (token, choice) order and summed in fp32
           with their weights, then cast to the stream's dtype

No step reads a count on the host: how many rows an expert gets is known
only on the device, and the grouped product takes its groups from there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          k: int, scaling: float):
    """x: [T, W]; router: [W, E]; bias: [E] correction bias.
    -> (expert ids int64 [T, k], fp32 weights [T, k])."""
    scores = torch.sigmoid(x.float() @ router.float())
    idx = torch.topk(scores + bias.float(), k, dim=-1).indices
    w = scores.gather(-1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * scaling


def swiglu(x: torch.Tensor, gate_up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)); gate_up: [W, 2M] = [gate | up]."""
    gu = x @ gate_up
    m = gu.shape[-1] // 2
    return (F.silu(gu[..., :m]) * gu[..., m:]) @ down


def routed_experts(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                   gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The routed experts' weighted sum for every token.

    x: [T, W]; idx, w: [T, k] from `route`; gate_up: [E, W, 2M] ([gate |
    up] per expert); down: [E, M, W]. Returns [T, W] in x's dtype."""
    t, k = idx.shape
    e = gate_up.shape[0]
    ids, order = torch.sort(idx.reshape(-1), stable=True)
    ends = torch.searchsorted(
        ids, torch.arange(e, device=ids.device, dtype=ids.dtype),
        right=True).to(torch.int32)
    rows = x.index_select(0, order // k)                  # [T*k, W]
    gu = torch._grouped_mm(rows, gate_up, offs=ends)      # [T*k, 2M]
    m = gu.shape[-1] // 2
    act = F.silu(gu[:, :m]) * gu[:, m:]
    out = torch._grouped_mm(act, down, offs=ends)         # [T*k, W]
    back = torch.empty_like(out).index_copy_(0, order, out)
    # bf16 rows times fp32 weights promote to fp32 in one pass
    y = (back.view(t, k, -1) * w[..., None]).sum(dim=1)
    return y.to(x.dtype)
