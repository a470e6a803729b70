"""VQ tokenizers of the PyTorch port: the encoders and quantizer of the
4M-21 tokenizers (`VQ`), their decoders (`VQVAE`: ViT or MLP; `DiVAE`: the
patched ADM UNet or the UViT, sampled by `divae_decode_tokens`), and the
CLIP / DINOv2 teachers whose feature maps those tokenizers tokenize
(`ViTTeacher`)."""

from .mlp_models import build_mlp
from .quantizer import VectorQuantize, l2norm
from .scheduling import DiffusionScheduler, diffusion_sample, pndm_sample
from .teachers import TEACHER_PRESETS, ViTTeacher, init_teacher_weights, quick_gelu
from .unet import PatchedUNetCondCat, unet_patched
from .uvit import UVIT_PRESETS, UViT
from .vit_models import VIT_SIZES, PatchProj, ViTDecoder, ViTEncoder
from .vqvae import (VQ, VQVAE, DiVAE, divae_decode_quant, divae_decode_tokens,
                    init_vq_weights)

__all__ = ["VQ", "VQVAE", "DiVAE", "DiffusionScheduler", "PatchedUNetCondCat", "UViT",
           "UVIT_PRESETS", "VIT_SIZES", "PatchProj", "TEACHER_PRESETS", "VectorQuantize",
           "ViTDecoder", "ViTEncoder", "ViTTeacher", "build_mlp", "diffusion_sample",
           "divae_decode_quant", "divae_decode_tokens", "init_teacher_weights",
           "init_vq_weights", "l2norm", "pndm_sample", "quick_gelu", "unet_patched"]
