"""VQ tokenizers of the PyTorch port: the encoders and quantizer of the
4M-21 tokenizers (`VQ`), their decoders (`VQVAE`: ViT or MLP; `DiVAE`: the
patched ADM UNet or the UViT, sampled by `divae_decode_tokens`;
`VQControlNet`: an SD-1.5-scale ControlNet over a KL-VAE latent space,
sampled by `controlnet_decode_tokens`), their training forwards
(`train=True`; the quantizer's EMA, `Memcodes`; LPIPS and InceptionV3 in
`percept_losses` / `inception`), and the CLIP / DINOv2 teachers whose
feature maps those tokenizers tokenize (`ViTTeacher`);
`get_image_tokenizer` loads a tokenizer checkpoint."""

from .controlnet import (AutoencoderKL, ControlNetCond, Token2VAE, controlnet_params_from_unet,
                         vqcontrolnet_trainable_mask)
from .loader import get_image_tokenizer
from .memcodes import Memcodes
from .mlp_models import build_mlp
from .quantizer import VectorQuantize, l2norm
from .scheduling import (DDIMScheduler, DDPMScheduler, DiffusionScheduler, PNDMScheduler,
                         diffusion_sample, pndm_sample)
from .teachers import TEACHER_PRESETS, ViTTeacher, init_teacher_weights, quick_gelu
from .unet import PatchedUNetCondCat, unet_patched
from .uvit import UVIT_PRESETS, UViT
from .vit_models import (VIT_SIZES, PatchProj, ViTDecoder, ViTEncoder, build_vit_decoder,
                         build_vit_encoder)
from .vqvae import (VQ, VQVAE, DiVAE, VQControlNet, controlnet_decode_quant,
                    controlnet_decode_tokens, divae_decode_quant, divae_decode_tokens,
                    init_vq_weights)

__all__ = ["VQ", "VQVAE", "AutoencoderKL", "ControlNetCond", "DiVAE", "DiffusionScheduler",
           "Memcodes", "PatchedUNetCondCat", "Token2VAE", "UViT", "UVIT_PRESETS", "VIT_SIZES",
           "PatchProj", "TEACHER_PRESETS", "VQControlNet", "VectorQuantize", "ViTDecoder",
           "ViTEncoder", "ViTTeacher", "build_mlp", "controlnet_decode_quant",
           "controlnet_decode_tokens", "controlnet_params_from_unet", "diffusion_sample",
           "divae_decode_quant", "divae_decode_tokens", "get_image_tokenizer",
           "init_teacher_weights", "init_vq_weights", "l2norm", "pndm_sample", "quick_gelu",
           "unet_patched", "vqcontrolnet_trainable_mask"]
