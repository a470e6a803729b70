"""Memcodes: the attention-based Gumbel quantizer, PyTorch port.

Counterpart of fourm_tpu/vq/memcodes.py (reference
fourm/vq/quantizers/quantize_memcodes.py:25-120, from lucidrains' NWT):
channel-last (B, N, dim) like VectorQuantize; per-head learned codes whose
keys and values are the codes times `to_k` / `to_v`; each query attends to
one code, the argmax of its logits, or in training the argmax of a Gumbel
softmax with the hard one-hot passed straight through. The gumbel
uniforms are an argument (`uniform`), drawn from a torch.Generator when
not given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Memcodes(nn.Module):
    def __init__(self, dim: int, codebook_size: int, heads: int = 1, temperature: float = 1.0):
        super().__init__()
        if dim % heads != 0:
            raise ValueError("dim must be divisible by heads")
        cdim = dim // heads
        self.dim, self.codebook_size, self.heads, self.temperature = (dim, codebook_size, heads,
                                                                      temperature)
        self.codes = nn.Parameter(torch.randn(heads, codebook_size, cdim))
        self.to_k = nn.Parameter(torch.randn(heads, cdim, cdim) * cdim ** -0.5)
        self.to_v = nn.Parameter(torch.randn(heads, cdim, cdim) * cdim ** -0.5)

    def _kv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        k = torch.einsum("hnd,hdc->hnc", self.codes, self.to_k)
        v = torch.einsum("hnd,hdc->hnc", self.codes, self.to_v)
        return k, v

    def indices_to_embedding(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, N) or (B, N, heads) -> (B, N, dim)."""
        _, v = self._kv()
        if self.heads == 1:
            return v[0][indices].reshape(indices.shape + (self.dim,))
        gathered = torch.stack([v[h][indices[..., h]] for h in range(self.heads)], dim=-2)
        return gathered.reshape(indices.shape[:-1] + (self.dim,))

    def forward(self, x: torch.Tensor, train: bool = False,
                uniform: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """-> (out (B, N, dim) in x's dtype, indices, loss 0). uniform:
        (B, heads, N, K) draws in [1e-20, 1) for the training Gumbel noise."""
        B, N, C = x.shape
        cdim = C // self.heads
        q = x.reshape(B, N, self.heads, cdim).transpose(1, 2) * cdim ** -0.5
        k, v = self._kv()
        logits = torch.einsum("bhid,hjd->bhij", q.float(), k)
        if train:
            if uniform is None:
                uniform = torch.rand(logits.shape, generator=generator, device=x.device)
                uniform = uniform * (1.0 - 1e-20) + 1e-20
            g = -torch.log(-torch.log(uniform))
            soft = F.softmax((logits + g) / self.temperature, dim=-1)
            ind = soft.argmax(-1)
            hard = F.one_hot(ind, self.codebook_size).to(soft.dtype)
            attn = hard + soft - soft.detach()  # straight-through
        else:
            ind = logits.argmax(-1)
            attn = F.one_hot(ind, self.codebook_size).float()
        out = torch.einsum("bhij,hjd->bhid", attn, v)
        out = out.transpose(1, 2).reshape(B, N, C).to(x.dtype)
        ind = ind[:, 0] if self.heads == 1 else ind.transpose(1, 2)
        return out, ind, torch.zeros((), dtype=torch.float32, device=x.device)
