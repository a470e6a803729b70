"""Token sampling filters: top-k / top-p.

Counterpart of fourm_tpu/ops/sampling.py (reference generate.py:332-404), with
the same sort-and-threshold formulation so both packages filter identically.
"""

from __future__ import annotations

from typing import Union

import torch

NEG_INF = torch.finfo(torch.float32).min


def top_k_top_p_filtering(logits: torch.Tensor, top_k: Union[int, float] = 0.0,
                          top_p: float = 0.0) -> torch.Tensor:
    """Set logits outside the top-k / nucleus top-p set to NEG_INF. `top_k` is
    an absolute count, or a vocab fraction when a float below 1."""
    logits = logits.float()
    V = logits.shape[-1]
    if top_k and top_k > 0.0:
        k = min(int(top_k * V) if isinstance(top_k, float) and top_k < 1.0 else int(top_k), V)
        k = max(k, 1)
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    if top_p and top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        exceeded = cum_probs > top_p
        # shift right so the first token crossing the threshold is kept
        exceeded = torch.cat([torch.zeros_like(exceeded[..., :1]), exceeded[..., :-1]], dim=-1)
        min_kept = torch.where(exceeded, torch.full_like(sorted_logits, float("inf")),
                               sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < min_kept, torch.full_like(logits, NEG_INF), logits)
    return logits


def top_k_top_p_filtering_dynamic(logits: torch.Tensor, top_k: float,
                                  top_p: float) -> torch.Tensor:
    """Filter with top_k/top_p as run-time scalars (0 = off): one sort serves
    both filters, top-p acting on the top-k-filtered distribution."""
    logits = logits.float()
    V = logits.shape[-1]
    top_k = float(top_k)
    top_p = float(top_p)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    kf = V if top_k <= 0 else (top_k * V if top_k < 1.0 else top_k)
    k = min(max(int(kf), 1), V)
    neg = torch.full_like(logits, NEG_INF)
    if top_k > 0:
        kth = sorted_logits[..., k - 1:k]
        logits = torch.where(logits < kth, neg, logits)
    ranks = torch.arange(V, device=logits.device)
    sorted_k = torch.where(ranks < k, sorted_logits, neg)
    if top_p > 0:
        cum_probs = torch.cumsum(torch.softmax(sorted_k, dim=-1), dim=-1)
        exceeded = cum_probs > top_p
        exceeded = torch.cat([torch.zeros_like(exceeded[..., :1]), exceeded[..., :-1]], dim=-1)
        min_kept = torch.where(exceeded, torch.full_like(sorted_k, float("inf")),
                               sorted_k).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < min_kept, neg, logits)
    return logits
