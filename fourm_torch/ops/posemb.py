"""Sin-cos positional embeddings (MoCo-v3 style).

Numerically identical to fourm_tpu/ops/posemb.py and the reference builders
(fourm/models/fm_utils.py:32-63): built in numpy fp32, returned as an (N, D)
fp32 tensor on the CPU. Callers register them as non-persistent buffers.
"""

from __future__ import annotations

import numpy as np
import torch


def build_1d_sincos_posemb(max_len: int, embed_dim: int,
                           temperature: float = 10000.0) -> torch.Tensor:
    """1D sin-cos positional embedding, shape (max_len, embed_dim); layout
    [sin(out) | cos(out)] over the feature dim."""
    if embed_dim % 2 != 0:
        raise ValueError("embed_dim must be divisible by 2 for 1D sin-cos posemb")
    pos_dim = embed_dim // 2
    arange = np.arange(max_len, dtype=np.float32)
    omega = np.arange(pos_dim, dtype=np.float32) / pos_dim
    omega = 1.0 / (temperature**omega)
    out = np.einsum("n,d->nd", arange, omega)
    pos_emb = np.concatenate([np.sin(out), np.cos(out)], axis=1)
    return torch.from_numpy(pos_emb.astype(np.float32))


def build_2d_sincos_posemb(h: int, w: int, embed_dim: int,
                           temperature: float = 10000.0) -> torch.Tensor:
    """2D sin-cos positional embedding, shape (h*w, embed_dim); layout
    [sin_w | cos_w | sin_h | cos_h] with the w grid varying slowest."""
    if embed_dim % 4 != 0:
        raise ValueError("embed_dim must be divisible by 4 for 2D sin-cos posemb")
    pos_dim = embed_dim // 4
    grid_w, grid_h = np.meshgrid(
        np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32), indexing="ij"
    )
    omega = np.arange(pos_dim, dtype=np.float32) / pos_dim
    omega = 1.0 / (temperature**omega)
    out_w = np.einsum("n,d->nd", grid_w.reshape(-1), omega)
    out_h = np.einsum("n,d->nd", grid_h.reshape(-1), omega)
    pos_emb = np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1
    )
    return torch.from_numpy(pos_emb.astype(np.float32))
