"""VQ: the encoder and quantizer of every 4M-21 image tokenizer, inference.

Counterpart of fourm_tpu/vq/vqvae.py:VQ (reference vqvae.py:39-393),
channel-last: `prepare_input` (ImageNet standardisation undone to [-1, 1],
class maps embedded), `latents`, `encode`, `tokenize`,
`tokens_to_embedding`. It is the encoder side of the VQ-VAE and DiVAE
tokenizers too (what save_vq_tokens builds). MLP encoders, the decoders
and training are not ported yet.

Usage:
    vq = VQ(image_size=224, patch_size=16, enc_type="vit_b_enc",
            codebook_size=16384, latent_dim=32, dtype="bfloat16")  # on "cuda"
    vq.load_state_dict(from_jax_vq_variables(variables))  # or init_vq_weights(vq, seed)
    tokens = vq.tokenize(images_nhwc)                    # (B, 14, 14) int64
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..data.modality_info import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from ..ops.transformer import _dense
from .quantizer import VectorQuantize, l2norm
from .vit_models import VIT_SIZES, ViTEncoder

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast_matrices(module: nn.Module, dtype: torch.dtype) -> None:
    """Weight matrices (and tables) to the compute dtype; vectors (LayerNorm
    scales and shifts, biases, layer scales) stay fp32. The JAX modules hold
    every parameter in fp32 and cast matrices to the compute dtype for each
    product while the kernels read vectors in fp32: the same numbers, with
    no cast kernel per call."""
    for p in module.parameters():
        if p.ndim >= 2:
            p.data = p.data.to(dtype)


class VQ(nn.Module):
    """Encoder + quantizer. Inputs are NHWC images (B, H, W, C), (B, H, W)
    int class maps when n_labels is set, or (B, N_H, N_W, C) feature maps
    when patch_proj is False. `device` defaults to the card (`api.resolve_
    device`)."""

    def __init__(self, image_size: int = 224, image_size_enc: Optional[int] = None,
                 n_channels: int = 3, n_labels: Optional[int] = None,
                 enc_type: str = "vit_b_enc", patch_proj: bool = True, post_mlp: bool = False,
                 patch_size: int = 16, codebook_size: int = 16384, num_codebooks: int = 1,
                 latent_dim: int = 32, norm_codes: bool = True, norm_latents: bool = False,
                 undo_std: bool = False, dtype: str = "float32", device: Optional[str] = None):
        super().__init__()
        from ..api import resolve_device

        if "vit" not in enc_type:
            raise NotImplementedError(f"enc_type {enc_type!r}: the port has the ViT encoders "
                                      "(the MLP ones, fourm_tpu vq/mlp_models.py, are not ported)")
        self.image_size, self.n_labels, self.undo_std = image_size, n_labels, undo_std
        self.num_codebooks = num_codebooks
        self.compute_dtype = _DTYPES[dtype]
        if n_labels is not None:
            self.cls_emb = nn.Embedding(n_labels, n_channels)
        size = VIT_SIZES[enc_type.replace("_enc", "")]
        self.encoder = ViTEncoder(in_channels=n_channels, patch_size=patch_size,
                                  resolution=image_size_enc or image_size, patch_proj=patch_proj,
                                  post_mlp=post_mlp, dtype=self.compute_dtype, **size)
        self.quant_proj = nn.Linear(size["dim_tokens"], latent_dim)
        self.quantize = VectorQuantize(latent_dim, codebook_size, codebook_dim=latent_dim,
                                       heads=num_codebooks, use_cosine_sim=norm_codes,
                                       norm_latents=norm_latents)
        for m in (self.encoder.proj, self.encoder.blocks, self.quant_proj,
                  getattr(self, "cls_emb", None)):
            if m is not None:
                cast_matrices(m, self.compute_dtype)
        self.to(resolve_device(device))
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.quant_proj.weight.device

    def prepare_input(self, x: torch.Tensor) -> torch.Tensor:
        """Undo ImageNet standardisation to [-1, 1] and embed class maps
        (reference vqvae.py:269-285)."""
        if self.undo_std:
            mean = torch.tensor(IMAGENET_DEFAULT_MEAN, dtype=torch.float32, device=x.device)
            std = torch.tensor(IMAGENET_DEFAULT_STD, dtype=torch.float32, device=x.device)
            x = 2.0 * (x * std + mean) - 1.0
        if self.n_labels is not None:
            x = self.cls_emb(x.long())
        return x.to(self.compute_dtype)

    def latents(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's output projected to the latent dim, before the
        quantizer: (B, Hq, Wq, latent_dim) in the compute dtype."""
        return _dense(self.encoder(self.prepare_input(x)), self.quant_proj, self.compute_dtype)

    def encode(self, x: torch.Tensor):
        """-> (quant (B, Hq, Wq, latent_dim), code_loss, tokens (B, Hq, Wq)
        or (B, Hq, Wq, num_codebooks))."""
        h = self.latents(x)
        B, Hq, Wq, D = h.shape
        quant, tokens, loss = self.quantize(h.reshape(B, Hq * Wq, D))
        shape = (B, Hq, Wq) if self.num_codebooks == 1 else (B, Hq, Wq, self.num_codebooks)
        return quant.reshape(B, Hq, Wq, -1), loss, tokens.reshape(shape)

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x)[2]

    def tokens_to_embedding(self, tokens: torch.Tensor) -> torch.Tensor:
        """Codebook lookup: (B, Hq, Wq) -> (B, Hq, Wq, latent_dim)."""
        return self.quantize.indices_to_embedding(tokens)


def init_vq_weights(vq: VQ, seed: int) -> VQ:
    """Random weights from a seeded torch.Generator on the model's device,
    after the JAX package's initialisers: matrices lecun-normal (std
    1/sqrt(fan_in)), embeddings normal(1), LayerNorm scales one, biases
    zero; the codebook kaiming-uniform (bound sqrt(6 / dim)), l2-normalised
    for a cosine codebook, as at init (quantizer.py:143-149)."""
    gen = torch.Generator(device=vq.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in vq.named_parameters():
            if p.ndim == 1:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                fan_in = 1 if name.startswith("cls_emb") else int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * fan_in ** -0.5)
        e = vq.quantize.codebook
        bound = (6.0 / e.shape[1]) ** 0.5
        e.copy_((torch.rand(e.shape, generator=gen, device=e.device) * 2 - 1) * bound)
        if vq.quantize.use_cosine_sim:
            e.copy_(l2norm(e))
    return vq
