"""FourMViT: the 4M encoder as an RGB-only ViT for transfer learning, PyTorch
port (fourm_tpu/models/fm_vit.py; reference fourm/models/fm_vit.py:49-484).

Patch embedding, the encoder blocks, an optional final norm and an optional
mean-pooled linear head, built from the port's `ImageEncoderEmbedding`,
`Block` and `LayerNorm`. So a bf16 FourMViT runs the FourM encoder's kernel
route: each block's attention half is one `attn_block` where the block has
no QK-norm and the card holds the sequence (`attn_block_takes`), else
`ln_matmul` + `mha_short` (no QK-norm) or `ln_matmul` + `flash_mha`
(QK-norm), and its MLP half one `ln_mlp`. `forward(x, train=True)` is the
training path (`attention_train` on the card, the rest plain autograd ops).

Parameter names are those of FourM's encoder (`encoder_embeddings.rgb@224.
proj.weight`, `encoder.{i}....`, `encoder_norm.weight`) plus `head`, so
`params_from_fourm(fourm.state_dict())` is the encoder's entries of a
trained FourM, which `load_state_dict(..., strict=False)` takes (the head
stays as initialised).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.transformer import Block, LayerNorm, _dense
from .embeddings import ImageEncoderEmbedding
from .fourm import _DTYPES, MODEL_REGISTRY


@dataclass(frozen=True)
class FourMViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    dim: int = 768
    encoder_depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    proj_bias: bool = True
    mlp_bias: bool = True
    norm_bias: bool = True
    act: str = "gelu"
    gated_mlp: bool = False
    qk_norm: bool = False
    drop_path_rate: float = 0.0
    encoder_norm: bool = True
    num_classes: Optional[int] = None  # adds a mean-pool linear head
    dtype: str = "float32"  # compute dtype

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class FourMViT(nn.Module):
    """RGB-only ViT sharing the FourM encoder architecture (fm_vit.py:49-233).
    Input: (B, H, W, C) NHWC images."""

    def __init__(self, config: FourMViTConfig):
        super().__init__()
        cfg = self.config = config
        dtype = cfg.compute_dtype
        n = cfg.img_size // cfg.patch_size
        self.rgb_key = f"rgb@{cfg.img_size}"
        self.encoder_embeddings = nn.ModuleDict({self.rgb_key: ImageEncoderEmbedding(
            cfg.in_chans, cfg.patch_size, n, n, cfg.dim, True, dtype)})
        dpr = [cfg.drop_path_rate * i / max(cfg.encoder_depth - 1, 1)
               for i in range(cfg.encoder_depth)]
        self.encoder = nn.ModuleList([
            Block(cfg.dim, cfg.num_heads, cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                  proj_bias=cfg.proj_bias, mlp_bias=cfg.mlp_bias, act=cfg.act,
                  gated_mlp=cfg.gated_mlp, qk_norm=cfg.qk_norm, norm_bias=cfg.norm_bias,
                  dtype=dtype, drop_path_rate=r)
            for r in dpr])
        if cfg.encoder_norm:
            self.encoder_norm = LayerNorm(cfg.dim, use_bias=cfg.norm_bias, dtype=dtype)
        if cfg.num_classes is not None:
            self.head = nn.Linear(cfg.dim, cfg.num_classes)

    def forward_features(self, x: torch.Tensor, train: bool = False,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C) image -> (B, N, D) encoder features (fm_vit.py:182-199)."""
        emb = self.encoder_embeddings[self.rgb_key]
        tokens, pos = emb(x, None)
        x = tokens + pos + emb.mod_emb.to(tokens.dtype)
        for blk in self.encoder:
            x = blk(x, None, train=train, generator=generator)
        if self.config.encoder_norm:
            x = self.encoder_norm(x)
        return x

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits (B, num_classes) of the mean-pooled features, or the
        features (B, N, D) without a head."""
        feats = self.forward_features(x, train, generator)
        if self.config.num_classes is None:
            return feats
        return _dense(feats.mean(1), self.head, self.config.compute_dtype)


def vit_config_from_registry(model_name: str, **overrides) -> FourMViTConfig:
    """A FourMViTConfig from one of the 13 registered size variants
    (reference fm_vit.py:273-484)."""
    if model_name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {model_name}")
    kw = dict(MODEL_REGISTRY[model_name])
    kw.pop("decoder_depth", None)
    return FourMViTConfig(**{**kw, **overrides})


def params_from_fourm(state_dict: Dict[str, torch.Tensor],
                      img_size: int = 224) -> Dict[str, torch.Tensor]:
    """The encoder entries of a FourM state dict, which a FourMViT of the
    same width and depth loads with strict=False (the transfer-learning warm
    start; its head is not among them)."""
    emb = f"encoder_embeddings.rgb@{img_size}."
    return {k: v for k, v in state_dict.items()
            if k.startswith(("encoder.", "encoder_norm.", emb))}
