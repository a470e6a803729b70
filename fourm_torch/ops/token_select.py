"""Fixed-shape token-subset selection and decoder attention-mask construction.

Counterpart of fourm_tpu/ops/token_select.py (reference fm.py:338-475): of the
O tokens concatenated across all modalities, K enter the encoder / decoder,
selected as [all unmasked tokens in original order, then masked tokens].
"""

from __future__ import annotations

from typing import Optional

import torch


def select_tokens(mask: torch.Tensor, num_keep: int) -> torch.Tensor:
    """Indices (B, num_keep) of the selected tokens per row: unmasked tokens in
    original order first, then masked tokens in original order.

    The key is the exact integer mask * O + position (as in the JAX package),
    so a stable ascending sort gives the same order bit for bit. A budget
    larger than the stream clamps to O, like the reference's slice."""
    O = mask.shape[-1]
    num_keep = min(num_keep, O)
    positions = torch.arange(O, dtype=torch.int64, device=mask.device)
    key = mask.to(torch.int64) * O + positions
    idx = torch.argsort(key, dim=-1, stable=True)[..., :num_keep]
    return idx


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along dim 1 with batched indices. x: (B, O, ...), idx: (B, K)."""
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def compact_position_ids(mask: torch.Tensor,
                         max_length: Optional[int] = None) -> torch.Tensor:
    """Positions counted over unmasked tokens only, 0 for masked ones
    (reference encoder_embeddings.py:112-115 / decoder_embeddings.py:127-131)."""
    pos = torch.cumsum((~mask).to(torch.int64), dim=-1) - 1
    pos = torch.where(mask, torch.zeros_like(pos), pos)
    if max_length is not None:
        pos = torch.where(pos >= max_length, torch.zeros_like(pos), pos)
    return pos.clamp_min(0)


def adapt_decoder_attention_mask(
    compressed: torch.Tensor,
    mod_mask: Optional[torch.Tensor],
    causal: bool = False,
    sep_mask: bool = True,
) -> torch.Tensor:
    """Expand the compressed per-token attention mask to a full (B, M, M) bool
    mask, True = attention not allowed (reference fm.py:440-475)."""
    B, M = compressed.shape
    dev = compressed.device
    if causal:
        att = torch.triu(torch.ones((M, M), dtype=torch.bool, device=dev), diagonal=1)
        att = att.expand(B, M, M)
    else:
        arange = torch.arange(M, dtype=torch.int64, device=dev)
        cums = torch.cumsum(compressed.to(torch.int64), dim=-1)  # (B, M)
        att = arange[None, None, :] >= cums[:, :, None]
    if sep_mask and mod_mask is not None:
        att = att | (mod_mask[:, :, None] != mod_mask[:, None, :])
    return att
