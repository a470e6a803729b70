"""Vector quantization of the VQ tokenizers, inference.

Counterpart of the eval path of fourm_tpu/vq/quantizer.py:VectorQuantize
(reference quantize_lucid.py:432-560): Euclidean or cosine codebook,
multi-head codebooks, `project_in` / `project_out`, `norm_latents`, and
`indices_to_embedding`. The nearest-code search goes through the
`nearest_code` / `nearest_code_cosine` kernels (their plain twins on the
CPU), which equal the JAX package's fp32 argmax up to summation order. EMA
updates, k-means init and dead-code expiry belong to training and are not
ported yet.

Channel-last: latents (B, N, dim) -> (quantize (B, N, dim), indices
(B, N[, heads]), loss 0).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.vq_codebook import nearest_code, nearest_code_cosine
from ..ops.transformer import _dense


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(p=2, dim=-1) (clamped norm), as the JAX package's l2norm."""
    return t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True), eps)


class Codebook(nn.Module):
    """Holds the (K, codebook_dim) fp32 codebook as the buffer `embed`, the
    reference's `quantize._codebook.embed`."""

    def __init__(self, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.register_buffer("embed", torch.zeros(codebook_size, codebook_dim))


class VectorQuantize(nn.Module):
    def __init__(self, dim: int, codebook_size: int, codebook_dim: Optional[int] = None,
                 heads: int = 1, use_cosine_sim: bool = False, norm_latents: bool = False):
        super().__init__()
        cdim = codebook_dim or dim
        self.heads, self.use_cosine_sim, self.norm_latents = heads, use_cosine_sim, norm_latents
        self.requires_projection = cdim * heads != dim
        if self.requires_projection:
            self.project_in = nn.Linear(dim, cdim * heads)
            self.project_out = nn.Linear(cdim * heads, dim)
        self._codebook = Codebook(codebook_size, cdim)

    @property
    def codebook(self) -> torch.Tensor:
        return self._codebook.embed

    def _project(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """nn.Dense without a dtype: computed in the input's and the
        parameters' promoted dtype, as flax does."""
        return _dense(x, lin, torch.promote_types(x.dtype, lin.weight.dtype))

    def search_inputs(self, x: torch.Tensor):
        """The fp32 (B*heads*N, cdim) rows and (K, cdim) codebook the search
        compares (l2-normalised for cosine), and the shape of x after the
        head split."""
        B = x.shape[0]
        if self.requires_projection:
            x = self._project(self.project_in, x)
        if self.heads > 1:
            x = x.reshape(B, x.shape[1], self.heads, -1).transpose(1, 2)
            x = x.reshape(B * self.heads, x.shape[2], -1)
        if self.norm_latents:
            x = l2norm(x)
        flatten = x.float().reshape(-1, x.shape[-1])
        embed = self.codebook
        if self.use_cosine_sim:
            return l2norm(flatten), l2norm(embed), x.shape
        return flatten, embed, x.shape

    def forward(self, x: torch.Tensor):
        B = x.shape[0]
        orig_dtype = x.dtype
        flatten, embed, shape = self.search_inputs(x)
        search = nearest_code_cosine if self.use_cosine_sim else nearest_code
        ind = search(flatten.contiguous(), embed.contiguous())
        quantize = self.codebook[ind].reshape(shape[:-1] + (-1,))
        ind = ind.reshape(shape[:-1])
        if self.heads > 1:
            quantize = quantize.reshape(B, self.heads, -1, quantize.shape[-1]).transpose(1, 2)
            quantize = quantize.reshape(B, quantize.shape[1], -1)
            ind = ind.reshape(B, self.heads, -1).transpose(1, 2)
        quantize = quantize.to(orig_dtype)
        if self.requires_projection:
            quantize = self._project(self.project_out, quantize)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        return quantize, ind, loss

    def indices_to_embedding(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook lookup + output projection, channel-last:
        (B, ...) -> (B, ..., dim)."""
        emb = self.codebook[indices]
        if self.heads > 1:
            emb = emb.reshape(emb.shape[:-2] + (-1,))
        if self.requires_projection:
            emb = self._project(self.project_out, emb)
        return emb
