"""VQ tokenization of the PyTorch port: the ViT encoder and quantizer of the
4M-21 image tokenizers (`VQ`) and the CLIP / DINOv2 teachers whose feature
maps those tokenizers tokenize (`ViTTeacher`)."""

from .quantizer import VectorQuantize, l2norm
from .teachers import TEACHER_PRESETS, ViTTeacher, init_teacher_weights, quick_gelu
from .vit_models import VIT_SIZES, PatchProj, ViTEncoder
from .vqvae import VQ, init_vq_weights

__all__ = ["VQ", "VIT_SIZES", "PatchProj", "TEACHER_PRESETS", "VectorQuantize", "ViTEncoder",
           "ViTTeacher", "init_teacher_weights", "init_vq_weights", "l2norm", "quick_gelu"]
