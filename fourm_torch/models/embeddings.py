"""Per-modality encoder/decoder embeddings of the PyTorch port.

Counterparts of fourm_tpu/models/embeddings.py (reference
fourm/models/encoder_embeddings.py, decoder_embeddings.py). As there:
  * embeddings return (x, pos) with pos NOT including the modality embedding;
    FourM adds it. Each module owns its `mod_emb` parameter (1, 1, D) under
    the reference name; FourM ties encoder and decoder ones when shared;
  * raw images are NHWC, patchified in (ph, pw, c) order, so imported
    projection weights are identical;
  * sin-cos tables are non-persistent buffers, computed, never loaded.
Boolean masks use True = masked out / padding.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.posemb import build_1d_sincos_posemb, build_2d_sincos_posemb
from ..ops.token_select import compact_position_ids


def _embed(emb: nn.Embedding, ids: torch.Tensor, dtype) -> torch.Tensor:
    return F.embedding(ids.long(), emb.weight).to(dtype)


class _ModEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.mod_emb = nn.Parameter(torch.zeros(1, 1, dim))


class _SeqPos(_ModEmb):
    """1-D positional table: sin-cos buffer, or a learned `pos_emb` (1, L, D)."""

    def _init_pos(self, max_length, dim, sincos, max_sincos):
        if sincos:
            if max_length > max_sincos:
                raise ValueError(f"max_length {max_length} > {max_sincos}")
            self.register_buffer("sincos_table",
                                 build_1d_sincos_posemb(max_sincos, dim)[:max_length],
                                 persistent=False)
        else:
            self.pos_emb = nn.Parameter(torch.zeros(1, max_length, dim))

    def _table(self):
        return self.sincos_table if hasattr(self, "sincos_table") else self.pos_emb[0]


class _GridPos(_ModEmb):
    """2-D positional table: sin-cos buffer, or a learned `pos_emb` (1, N, D)."""

    def _init_pos(self, grid_h, grid_w, dim, sincos):
        if sincos:
            self.register_buffer("pos_table", build_2d_sincos_posemb(grid_h, grid_w, dim),
                                 persistent=False)
        else:
            self.pos_emb = nn.Parameter(torch.zeros(1, grid_h * grid_w, dim))

    def _grid_pos(self, B: int, dtype) -> torch.Tensor:
        table = self.pos_table if hasattr(self, "pos_table") else self.pos_emb[0]
        return table[None].to(dtype).expand(B, -1, -1)


class SequenceEncoderEmbedding(_SeqPos):
    """Discrete token sequences (reference encoder_embeddings.py:22-121);
    positions are compacted over unmasked tokens."""

    def __init__(self, vocab_size: int, max_length: int, dim: int,
                 sincos_pos_emb: bool = True, max_sincos_pos_emb: int = 512,
                 padding_idx: int = 0, dtype=torch.float32):
        super().__init__(dim)
        self.max_length, self.padding_idx, self.dtype = max_length, padding_idx, dtype
        self.token_emb = nn.Embedding(vocab_size, dim)
        self._init_pos(max_length, dim, sincos_pos_emb, max_sincos_pos_emb)

    def forward(self, tensor, input_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _embed(self.token_emb, tensor, self.dtype)
        x = x.masked_fill((tensor == self.padding_idx)[..., None], 0.0)
        pos_id = compact_position_ids(input_mask).clamp_max(self.max_length - 1)
        pos = self._table()[pos_id]
        pos = pos.masked_fill(input_mask[..., None], 0.0).to(self.dtype)
        return x, pos


class ImageTokenEncoderEmbedding(_GridPos):
    """Tokenized image modalities on a fixed grid (reference
    encoder_embeddings.py:123-211); `tensor` is (B, H*W) int tokens."""

    def __init__(self, vocab_size: int, grid_h: int, grid_w: int, dim: int,
                 sincos_pos_emb: bool = True, dtype=torch.float32):
        super().__init__(dim)
        self.dtype = dtype
        self.token_emb = nn.Embedding(vocab_size, dim)
        self._init_pos(grid_h, grid_w, dim, sincos_pos_emb)

    def forward(self, tensor, input_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        B = tensor.shape[0]
        x = _embed(self.token_emb, tensor.reshape(B, -1), self.dtype)
        return x, self._grid_pos(B, self.dtype)


class ImageEncoderEmbedding(_GridPos):
    """Patchify and project raw NHWC images (reference encoder_embeddings.py:
    214-309); the projection has no bias."""

    def __init__(self, num_channels: int, patch_size: int, grid_h: int, grid_w: int,
                 dim: int, sincos_pos_emb: bool = True, dtype=torch.float32):
        super().__init__(dim)
        self.patch_size, self.dtype = patch_size, dtype
        self.proj = nn.Linear(patch_size * patch_size * num_channels, dim, bias=False)
        self._init_pos(grid_h, grid_w, dim, sincos_pos_emb)

    def forward(self, tensor, input_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        B, H, W, C = tensor.shape
        ph = pw = self.patch_size
        nh, nw = H // ph, W // pw
        # (B, nh, ph, nw, pw, C) -> (B, nh*nw, ph*pw*C): reference rearrange
        # 'b d (nh ph) (nw pw) -> b (nh nw) (ph pw d)'
        x = tensor.reshape(B, nh, ph, nw, pw, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, nh * nw, ph * pw * C).to(self.dtype)
        x = F.linear(x, self.proj.weight.to(self.dtype))
        return x, self._grid_pos(B, self.dtype)


class SequenceEmbEncoderEmbedding(_SeqPos):
    """Pre-computed embedding sequences, e.g. T5-XXL captions (reference
    encoder_embeddings.py:312-421)."""

    def __init__(self, max_length: int, dim: int, orig_emb_dim: int = 4096,
                 sincos_pos_emb: bool = True, max_sincos_pos_emb: int = 512,
                 dtype=torch.float32):
        super().__init__(dim)
        self.max_length, self.dtype = max_length, dtype
        self.emb_proj = nn.Linear(orig_emb_dim, dim)
        self._init_pos(max_length, dim, sincos_pos_emb, max_sincos_pos_emb)

    def forward(self, tensor, input_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.linear(tensor.to(self.dtype), self.emb_proj.weight.to(self.dtype),
                     self.emb_proj.bias.to(self.dtype))
        pos_id = compact_position_ids(input_mask).clamp_max(self.max_length - 1)
        pos = self._table()[pos_id]
        pos = pos.masked_fill(input_mask[..., None], 0.0).to(self.dtype)
        return x, pos


class _TokenLogits(nn.Module):
    def _init_logits(self, vocab_size: int, dim: int, share_embedding: bool):
        self.share_embedding = share_embedding
        if not share_embedding:
            self.to_logits = nn.Linear(dim, vocab_size, bias=False)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        w = self.token_emb.weight if self.share_embedding else self.to_logits.weight
        return F.linear(x.to(self.dtype), w.to(self.dtype))


class SequenceDecoderEmbedding(_SeqPos, _TokenLogits):
    """Decoder-side sequence embedding with a (tied) output projection
    (reference decoder_embeddings.py:24-160; fourm_tpu/models/embeddings.py:
    229-263). `embed` returns (x, pos, ids); `token_embed` and `pos_table`
    serve KV-cached autoregressive decoding."""

    def __init__(self, vocab_size: int, max_length: int, dim: int,
                 sincos_pos_emb: bool = True, max_sincos_pos_emb: int = 512,
                 padding_idx: int = 0, share_embedding: bool = True, dtype=torch.float32):
        super().__init__(dim)
        self.max_length, self.padding_idx, self.dtype = max_length, padding_idx, dtype
        self.token_emb = nn.Embedding(vocab_size, dim)
        self._init_logits(vocab_size, dim, share_embedding)
        self._init_pos(max_length, dim, sincos_pos_emb, max_sincos_pos_emb)

    def embed(self, tensor, target_mask):
        ids = tensor
        x = self.token_embed(ids)
        # positions at or past max_length take position-embedding 0
        # (reference decoder_embeddings.py:129-131)
        pos_id = compact_position_ids(target_mask, max_length=self.max_length)
        pos = self._table()[pos_id]
        pos = pos.masked_fill(target_mask[..., None], 0.0).to(self.dtype)
        return x, pos, ids

    def token_embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embedding lookup, padding zeroed, for AR decoding."""
        x = _embed(self.token_emb, ids, self.dtype)
        return x.masked_fill((ids == self.padding_idx)[..., None], 0.0)

    def pos_table(self, max_len: int) -> torch.Tensor:
        """Positional table (max_len, D) for compacted AR positions; rows at
        or past max_length repeat position-embedding 0."""
        table = self._table()
        n = min(max_len, self.max_length)
        out = table[:n]
        if max_len > n:
            out = torch.cat([out, table[:1].expand(max_len - n, -1)])
        return out


class ImageTokenDecoderEmbedding(_GridPos, _TokenLogits):
    """Decoder-side image-token embedding with a (tied) output projection
    (reference decoder_embeddings.py:163-284)."""

    def __init__(self, vocab_size: int, grid_h: int, grid_w: int, dim: int,
                 sincos_pos_emb: bool = True, share_embedding: bool = True,
                 dtype=torch.float32):
        super().__init__(dim)
        self.dtype = dtype
        self.token_emb = nn.Embedding(vocab_size, dim)
        self._init_logits(vocab_size, dim, share_embedding)
        self._init_pos(grid_h, grid_w, dim, sincos_pos_emb)

    def embed(self, tensor, target_mask):
        B = tensor.shape[0]
        ids = tensor.reshape(B, -1)
        x = _embed(self.token_emb, ids, self.dtype)
        return x, self._grid_pos(B, self.dtype), ids
