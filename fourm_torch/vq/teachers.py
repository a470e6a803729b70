"""Teacher feature extractors for dataset pre-tokenization, inference.

Counterpart of fourm_tpu/vq/teachers.py: one configurable ViT covering the
OpenAI CLIP visual tower and DINOv2, channel-last, so that the CLIP and
DINOv2 tokenizers get the feature maps they tokenize:
  * CLIP-B16:          ln_post(tokens)[no cls] @ proj -> (B, 14, 14, 512)
  * DINOv2-B14:        x_norm_patchtokens -> (B, 16, 16, 768)
  * DINOv2-B14-global: x_norm_clstoken -> (B, 1, 1, 768)
Each block's attention is fourm_torch.ops.transformer.Attention, which takes
the `mha_short` kernel for these short, unmasked sequences; the MLP is two
plain F.linear, as in the JAX package. Weights cross from the JAX package
through fourm_torch.utils.checkpoint.from_jax_teacher_params.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.transformer import Attention, LayerNorm, _dense, gelu_exact
from .vit_models import PatchProj
from .vqvae import _DTYPES, cast_matrices


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class _TeacherBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, act, layer_scale: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.act, self.dtype = act, dtype
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        if layer_scale:  # fp32: the residual stream is promoted to fp32, as in JAX
            self.gamma_1 = nn.Parameter(torch.full((dim,), 1e-5))
            self.gamma_2 = nn.Parameter(torch.full((dim,), 1e-5))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.norm1(x))
        if self.gamma_1 is not None:
            h = h * self.gamma_1
        x = x + h
        h = _dense(self.act(_dense(self.norm2(x), self.fc1, self.dtype)), self.fc2, self.dtype)
        if self.gamma_2 is not None:
            h = h * self.gamma_2
        return x + h


class ViTTeacher(nn.Module):
    """CLIP-visual / DINOv2-style ViT producing patch-token feature maps.
    Input (B, H, W, 3) images; `device` defaults to the card."""

    def __init__(self, patch_size: int = 16, width: int = 768, depth: int = 12,
                 num_heads: int = 12, image_size: int = 224, act_name: str = "gelu",
                 pre_norm: bool = False, layer_scale: bool = False, patch_bias: bool = True,
                 output_dim: int = 0, dtype: str = "float32", device: Optional[str] = None):
        super().__init__()
        from ..api import resolve_device

        dt = _DTYPES[dtype]
        self.dtype, self.width, self.output_dim = dt, width, output_dim
        self.n = image_size // patch_size
        act = quick_gelu if act_name == "quick_gelu" else gelu_exact
        self.patch_embed = PatchProj(3, width, patch_size, bias=patch_bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(self.n * self.n + 1, width))
        self.ln_pre = LayerNorm(width, dtype=dt) if pre_norm else None
        self.blocks = nn.ModuleList(_TeacherBlock(width, num_heads, 4.0, act, layer_scale, dt)
                                    for _ in range(depth))
        self.ln_post = LayerNorm(width, dtype=dt)
        self.proj = nn.Parameter(torch.zeros(width, output_dim)) if output_dim else None
        cast_matrices(self, dt)
        self.to(resolve_device(device))
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def forward(self, x: torch.Tensor, return_global: bool = False) -> torch.Tensor:
        B, n, dt = x.shape[0], self.n, self.dtype
        h = self.patch_embed(x, dt).reshape(B, n * n, self.width)
        h = torch.cat([self.cls_token.to(dt).expand(B, 1, self.width), h], dim=1)
        h = h + self.pos_embed[None].to(dt)
        if self.ln_pre is not None:
            h = self.ln_pre(h)
        for blk in self.blocks:
            h = blk(h)
        h = self.ln_post(h)
        dim = self.width
        if self.proj is not None:  # CLIP: ln_post(tokens) @ proj
            h = h @ self.proj.to(h.dtype)
            dim = self.output_dim
        if return_global:
            return h[:, 0].reshape(B, 1, 1, dim)
        return h[:, 1:].reshape(B, n, n, dim)


TEACHER_PRESETS: Dict[str, Dict] = {
    # OpenAI CLIP ViT-B/16 visual tower
    "CLIP-B16": dict(patch_size=16, width=768, depth=12, num_heads=12,
                     act_name="quick_gelu", pre_norm=True, patch_bias=False, output_dim=512),
    # DINOv2 ViT-B/14
    "DINOv2-B14": dict(patch_size=14, width=768, depth=12, num_heads=12,
                       act_name="gelu", layer_scale=True),
    "DINOv2-B14-global": dict(patch_size=14, width=768, depth=12, num_heads=12,
                              act_name="gelu", layer_scale=True),
}


def init_teacher_weights(teacher: ViTTeacher, seed: int, std: float = 0.02) -> ViTTeacher:
    """Random weights from a seeded torch.Generator on the model's device,
    after the JAX package's initialisers: matrices lecun-normal, the class
    token and positions normal(0.02), the output projection normal(
    width^-0.5), LayerNorm scales one, biases zero, layer scales 1e-5."""
    gen = torch.Generator(device=teacher.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in teacher.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("gamma_"):
                p.fill_(1e-5)
            elif p.ndim == 1:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            else:
                scale = {"cls_token": std, "pos_embed": std, "proj": p.shape[0] ** -0.5}.get(
                    leaf, p[0].numel() ** -0.5)
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * scale)
    return teacher
