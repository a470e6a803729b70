"""ViT encoder and decoder of the VQ tokenizers, channel-last, inference.

Counterpart of fourm_tpu/vq/vit_models.py (reference
fourm/vq/models/vit_models.py:298-661). The encoder: patch projection (or a
1x1 projection of a feature map), 2D sin-cos positions, pre-LN blocks, and
the optional fp32 tanh post-MLP. The decoder: sin-cos positions, pre-LN
blocks, the optional tanh post-MLP (in the compute dtype, as the JAX
decoder's), an output projection depatchified channel-major, and optional
ConvNeXt output blocks. The blocks are fourm_torch.ops.transformer's, so
their halves run as `attn_block` and `ln_mlp`. A token grid other than the
training resolution's gets its positions resized bicubically
(`interp_posemb`), as jax.image.resize does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.posemb import build_2d_sincos_posemb
from ..ops.transformer import Block, LayerNorm, Mlp, _dense
from .layers import Conv2d, nchw, nhwc

# Size presets (reference vit_models.py:664-861; vit_t is the JAX package's
# test size)
VIT_SIZES = {
    "vit_t": dict(dim_tokens=64, depth=2, num_heads=2),
    "vit_s": dict(dim_tokens=512, depth=8, num_heads=8),
    "vit_b": dict(dim_tokens=768, depth=12, num_heads=12),
    "vit_l": dict(dim_tokens=1024, depth=24, num_heads=16),
}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (jax.image's; torch's
    bicubic uses a = -0.75), at distances x >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) fp64 weights of a 1-D bicubic resize from n_in to n_out
    samples, as jax.image.resize(..., "bicubic") builds them
    (jax/_src/image/scale.py:compute_weight_mat): half-pixel centres; when
    downsizing, antialiased (the kernel widened by n_in / n_out); each
    output's weights normalised to sum 1."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def interp_posemb(pos: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Bicubic resize of a (H0, W0, D) positional grid to (nh, nw, D): the
    counterpart of fourm_tpu vit_models.py:_interp_posemb
    (jax.image.resize(pos, (nh, nw, D), "bicubic")). Two separable 1-D
    weight matrices, built on the host in fp64, applied with one einsum in
    fp64; returned in pos.dtype."""
    H0, W0 = pos.shape[:2]
    if (H0, W0) == (nh, nw):
        return pos
    wh = torch.from_numpy(resize_weights(H0, nh)).to(pos.device)
    ww = torch.from_numpy(resize_weights(W0, nw)).to(pos.device)
    return torch.einsum("hwd,hi,wj->ijd", pos.double(), wh, ww).to(pos.dtype)


class PatchProj(nn.Module):
    """Patch embedding as space-to-depth plus one F.linear, numerically the
    stride-p convolution it stands for. The weight keeps the convolution's
    layout (out, in, p, p), as the reference's `proj` and the JAX package's
    (p, p, in, out) kernel transposed; p = 1 is a 1x1 projection of a
    feature map. Input (B, H, W, C) -> (B, H/p, W/p, out)."""

    def __init__(self, in_channels: int, features: int, patch_size: int, bias: bool = True):
        super().__init__()
        self.p = patch_size
        self.weight = nn.Parameter(torch.zeros(features, in_channels, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        p = self.p
        B, H, W, C = x.shape
        nh, nw = H // p, W // p
        if p > 1:  # (B, nh, nw, C, p, p): the weight's (in, p, p) order
            x = x.reshape(B, nh, p, nw, p, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, nh, nw, C * p * p).to(dtype)
        w = self.weight.reshape(self.weight.shape[0], -1).to(dtype)
        return F.linear(x, w, None if self.bias is None else self.bias.to(dtype))


class ViTEncoder(nn.Module):
    """Images / feature maps -> latent grid. Input (B, H, W, C) with
    patch_proj, else a (B, N_H, N_W, C) feature map; output
    (B, N_H, N_W, dim_tokens) in the compute dtype."""

    def __init__(self, in_channels: int = 3, patch_size: int = 16, resolution: int = 256,
                 dim_tokens: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, patch_proj: bool = True,
                 post_mlp: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size, self.resolution, self.dim_tokens = patch_size, resolution, dim_tokens
        self.patch_proj, self.dtype = patch_proj, dtype
        self.proj = PatchProj(in_channels, dim_tokens, patch_size if patch_proj else 1)
        self.blocks = nn.ModuleList(
            Block(dim_tokens, num_heads, mlp_ratio, qkv_bias=qkv_bias, dtype=dtype)
            for _ in range(depth))
        if post_mlp:  # fp32, tanh (ViT-VQGAN; reference :495-497)
            self.norm_mlp = LayerNorm(dim_tokens)
            self.post_mlp = Mlp(dim_tokens, int(mlp_ratio * dim_tokens), act="tanh")
        else:
            self.norm_mlp = self.post_mlp = None
        self._pos = {}  # (nh, nw, device) -> (1, nh*nw, dim) sin-cos table

    def pos_table(self, nh: int, nw: int, device) -> torch.Tensor:
        """The sin-cos positions of the training grid (resolution /
        patch_size; a feature map's own grid without patch_proj), resized
        bicubically to (nh, nw) when the grid differs."""
        key = (nh, nw, str(device))
        if key not in self._pos:
            n0h, n0w = ((self.resolution // self.patch_size,) * 2 if self.patch_proj
                        else (nh, nw))
            pos = build_2d_sincos_posemb(n0h, n0w, self.dim_tokens).reshape(n0h, n0w, -1)
            pos = interp_posemb(pos, nh, nw).reshape(1, nh * nw, self.dim_tokens)
            self._pos[key] = pos.to(device)
        return self._pos[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x = self.proj(x, self.dtype)
        nh, nw = x.shape[1:3]
        pos = self.pos_table(nh, nw, x.device)
        x = x.reshape(B, nh * nw, self.dim_tokens) + pos.to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        if self.post_mlp is not None:
            x32 = x.float()
            x = (x32 + self.post_mlp(self.norm_mlp(x32))).to(self.dtype)
        return x.reshape(B, nh, nw, self.dim_tokens)


class ConvNeXtBlock(nn.Module):
    """ConvNeXt block (reference vit_models.py:298-336), channel-last:
    depthwise 7x7 convolution, LayerNorm (eps 1e-6), pointwise MLP with the
    exact GELU, fp32 layer scale `gamma`, residual. As in the JAX block, the
    fp32 layer scale promotes the branch and the residual sum to fp32."""

    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(nhwc(self.dwconv(nchw(x))))
        h = F.gelu(_dense(h, self.pwconv1, self.dtype), approximate="none")
        h = _dense(h, self.pwconv2, self.dtype)
        if self.gamma is not None:
            h = h * self.gamma
        return x + h


class ViTDecoder(nn.Module):
    """Latent grid -> images / feature maps (reference vit_models.py:504-661).
    Input (B, N_H, N_W, dim_tokens) in the compute dtype; output
    (B, H, W, out_channels) with patch_proj, else (B, N_H, N_W,
    out_channels)."""

    def __init__(self, out_channels: int = 3, patch_size: int = 16, resolution: int = 256,
                 dim_tokens: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, patch_proj: bool = True,
                 post_mlp: bool = False, out_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_channels, self.dim_tokens, self.dtype = out_channels, dim_tokens, dtype
        self.n0 = resolution // patch_size
        self.ph = patch_size if patch_proj else 1
        self.blocks = nn.ModuleList(
            Block(dim_tokens, num_heads, mlp_ratio, qkv_bias=qkv_bias, dtype=dtype)
            for _ in range(depth))
        if post_mlp:
            self.norm_mlp = LayerNorm(dim_tokens, dtype=dtype)
            self.post_mlp = Mlp(dim_tokens, int(mlp_ratio * dim_tokens), dtype=dtype, act="tanh")
        else:
            self.norm_mlp = self.post_mlp = None
        self.out_proj = nn.Linear(dim_tokens, out_channels * self.ph ** 2)
        self.out_conv = (nn.ModuleList(ConvNeXtBlock(out_channels, dtype=dtype)
                                       for _ in range(2)) if out_conv else None)
        self._pos = {}  # (nh, nw, device) -> (1, nh*nw, dim) sin-cos table

    def pos_table(self, nh: int, nw: int, device) -> torch.Tensor:
        """The sin-cos positions of the training grid (resolution /
        patch_size, with or without patch_proj), resized bicubically to
        (nh, nw) when the grid differs."""
        key = (nh, nw, str(device))
        if key not in self._pos:
            n0 = self.n0
            pos = build_2d_sincos_posemb(n0, n0, self.dim_tokens).reshape(n0, n0, -1)
            pos = interp_posemb(pos, nh, nw).reshape(1, nh * nw, self.dim_tokens)
            self._pos[key] = pos.to(device)
        return self._pos[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, nh, nw, D = x.shape
        x = x.reshape(B, nh * nw, D) + self.pos_table(nh, nw, x.device).to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        if self.post_mlp is not None:
            x = x + self.post_mlp(self.norm_mlp(x))
        x = _dense(x, self.out_proj, self.dtype)
        # (B, nh*nw, c*ph*pw) -> (B, nh*ph, nw*pw, c): the reference's
        # channel-major rearrange '... (c ph pw)' (vit_models.py:648-652)
        ph, c = self.ph, self.out_channels
        x = x.reshape(B, nh, nw, c, ph, ph).permute(0, 1, 4, 2, 5, 3)
        x = x.reshape(B, nh * ph, nw * ph, c)
        if self.out_conv is not None:
            for blk in self.out_conv:
                x = blk(x)
        return x
