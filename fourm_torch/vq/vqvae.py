"""VQ tokenizers of the port, inference: `VQ` (encoder + quantizer),
`VQVAE` (+ ViT or MLP decoder) and `DiVAE` (+ UNet or UViT diffusion
decoder).

Counterpart of fourm_tpu/vq/vqvae.py:VQ, VQVAE and DiVAE (reference
vqvae.py:39-763), channel-last. `VQ`: `prepare_input` (ImageNet
standardisation undone to [-1, 1], class maps embedded), `latents`,
`encode`, `tokenize`, `tokens_to_embedding`; the encoder of every 4M-21
tokenizer (ViT, or the BottleneckMLP of the global-embedding and pose
tokenizers). `VQVAE`: `decode_quant`, `decode_tokens`, `autoencode`.
`DiVAE`: `noise_scheduler`, `denoise_step`, and diffusion decoding by
`divae_decode_quant` / `divae_decode_tokens` (an eager loop over the
timesteps). Training (the quantizer's EMA, the DiVAE's training forward
and condition dropout) is not ported yet; nor is VQControlNet.

Usage:
    vq = VQ(image_size=224, patch_size=16, enc_type="vit_b_enc",
            codebook_size=16384, latent_dim=32, dtype="bfloat16")  # on "cuda"
    vq.load_state_dict(from_jax_vq_variables(variables))  # or init_vq_weights(vq, seed)
    tokens = vq.tokenize(images_nhwc)                    # (B, 14, 14) int64
    divae = DiVAE(dec_type="unet_patched", prediction_type="sample", ...)
    images = divae_decode_tokens(divae, tokens, generator, timesteps=25)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..data.modality_info import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from ..ops.transformer import _dense
from .mlp_models import build_mlp
from .quantizer import VectorQuantize, l2norm
from .scheduling import DiffusionScheduler, diffusion_sample
from .unet import unet_patched
from .uvit import UVIT_PRESETS, UViT
from .vit_models import VIT_SIZES, ViTDecoder, ViTEncoder

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
        self.image_size, self.n_labels, self.undo_std = image_size, n_labels, undo_std
        self.n_channels, self.patch_size, self.latent_dim = n_channels, patch_size, latent_dim
        self.patch_proj, self.post_mlp = patch_proj, post_mlp
        self.num_codebooks = num_codebooks
        self.compute_dtype = _DTYPES[dtype]
        if n_labels is not None:
            self.cls_emb = nn.Embedding(n_labels, n_channels)
        if "vit" in enc_type:
            size = VIT_SIZES[enc_type.replace("_enc", "")]
            self.encoder = ViTEncoder(in_channels=n_channels, patch_size=patch_size,
                                      resolution=image_size_enc or image_size,
                                      patch_proj=patch_proj, post_mlp=post_mlp,
                                      dtype=self.compute_dtype, **size)
            enc_dim = size["dim_tokens"]
            # the ViT encoder's post-MLP stays fp32
            low = [self.encoder.proj, self.encoder.blocks]
        elif "MLP" in enc_type:
            self.encoder, enc_dim = build_mlp(enc_type, n_channels, dtype=self.compute_dtype)
            low = [self.encoder]
        else:
            raise NotImplementedError(f"enc_type {enc_type} not implemented")
        self.quant_proj = nn.Linear(enc_dim, latent_dim)
        self.quantize = VectorQuantize(latent_dim, codebook_size, codebook_dim=latent_dim,
                                       heads=num_codebooks, use_cosine_sim=norm_codes,
                                       norm_latents=norm_latents)
        for m in low + [self.quant_proj, getattr(self, "cls_emb", None)]:
            if m is not None:
                cast_matrices(m, self.compute_dtype)
        self._place(device)

    def _place(self, device: Optional[str]) -> None:
        """Onto the entry point's device (`api.resolve_device`), frozen, in
        eval mode; each constructor ends with it."""
        from ..api import resolve_device

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


class VQVAE(VQ):
    """VQ-VAE: encoder, quantizer and a feed-forward decoder (ViT or MLP;
    reference vqvae.py:396-495)."""

    def __init__(self, dec_type: str = "vit_b_dec", out_conv: bool = False,
                 image_size_dec: Optional[int] = None, patch_size_dec: Optional[int] = None,
                 device: Optional[str] = None, **kw):
        super().__init__(device="cpu", **kw)
        dt = self.compute_dtype
        out_channels = self.n_channels if self.n_labels is None else self.n_labels
        if "vit" in dec_type:
            size = VIT_SIZES[dec_type.replace("_dec", "")]
            self.decoder = ViTDecoder(out_channels=out_channels,
                                      patch_size=patch_size_dec or self.patch_size,
                                      resolution=image_size_dec or self.image_size,
                                      patch_proj=self.patch_proj, post_mlp=self.post_mlp,
                                      out_conv=out_conv, dtype=dt, **size)
            dec_dim = size["dim_tokens"]
        elif "MLP" in dec_type:
            self.decoder, dec_dim = build_mlp(dec_type, dim_out=out_channels, dtype=dt)
        else:
            raise NotImplementedError(f"{dec_type} not implemented")
        self.post_quant_proj = nn.Linear(self.latent_dim, dec_dim)
        cast_matrices(self.decoder, dt)
        cast_matrices(self.post_quant_proj, dt)
        self._place(device)

    def decode_quant(self, quant: torch.Tensor) -> torch.Tensor:
        return self.decoder(_dense(quant, self.post_quant_proj, self.compute_dtype))

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.decode_quant(self.tokens_to_embedding(tokens))

    def autoencode(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode_quant(self.encode(x)[0])


class DiVAE(VQ):
    """Diffusion VQ-VAE: encoder, quantizer and a diffusion decoder, UViT
    (`uvit_*` presets) or the patched ADM UNet (`unet_patched`) (reference
    vqvae.py:498-763, inspired by arXiv:2206.00386). Inference only."""

    def __init__(self, dec_type: str = "uvit_b_p4_f16", num_train_timesteps: int = 1000,
                 scheduler: str = "ddpm", beta_schedule: str = "squaredcos_cap_v2",
                 prediction_type: str = "v_prediction", clip_sample: bool = False,
                 thresholding: bool = True, conditioning: str = "concat",
                 zero_terminal_snr: bool = True, image_size_dec: Optional[int] = None,
                 device: Optional[str] = None, **kw):
        super().__init__(device="cpu", **kw)
        dt = self.compute_dtype
        self.scheduler_kw = dict(kind=scheduler, num_train_timesteps=num_train_timesteps,
                                 beta_schedule=beta_schedule, prediction_type=prediction_type,
                                 clip_sample=clip_sample, thresholding=thresholding,
                                 zero_terminal_snr=zero_terminal_snr)
        if "uvit_" in dec_type:
            self.decoder = UViT(sample_size=image_size_dec or self.image_size,
                                in_channels=self.n_channels, out_channels=self.n_channels,
                                cond_dim=self.latent_dim, cond_type=conditioning, dtype=dt,
                                **UVIT_PRESETS[dec_type])
        elif "unet_" in dec_type:
            self.decoder = unet_patched(in_channels=self.n_channels,
                                        out_channels=self.n_channels, cond_dim=self.latent_dim,
                                        dtype=dt)
        else:
            raise NotImplementedError(f"dec_type {dec_type} not implemented")
        cast_matrices(self.decoder, dt)
        self._place(device)

    def noise_scheduler(self) -> DiffusionScheduler:
        return DiffusionScheduler(**self.scheduler_kw)

    def denoise_step(self, noised, timesteps, quant, cond_mask=None, orig_res=None,
                     unconditional: bool = False) -> torch.Tensor:
        """One decoder evaluation, the model's prediction."""
        return self.decoder(noised, timesteps, quant, cond_mask=cond_mask, orig_res=orig_res,
                            unconditional=unconditional)


def divae_decode_quant(model: DiVAE, quant: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       timesteps: Optional[int] = None, image_size: Optional[int] = None,
                       guidance_scale: float = 0.0, guidance_rescale: float = 0.0,
                       scheduler: Optional[DiffusionScheduler] = None,
                       scheduler_timesteps_mode: str = "trailing", orig_res=None,
                       noise: Optional[torch.Tensor] = None,
                       step_noise=None) -> torch.Tensor:
    """Diffusion decoding of quantized latents (B, Hq, Wq, latent_dim) to
    (B, S, S, n_channels) fp32 images (reference decode_quant +
    PipelineCond, vqvae.py:657-694): `diffusion_sample` over the model's
    denoise_step, the unconditional branch of CFG with the whole condition
    masked. Noise: `noise` / `step_noise`, else draws from `generator` (on
    the model's device)."""
    sched = scheduler or model.noise_scheduler()
    size = image_size or model.image_size
    shape = (quant.shape[0], size, size, model.n_channels)

    def model_fn(noisy, t, cond):
        return model.denoise_step(noisy, t, cond, orig_res=orig_res)

    def model_fn_uncond(noisy, t, cond):
        return model.denoise_step(noisy, t, cond, orig_res=orig_res, unconditional=True)

    return diffusion_sample(model_fn, sched, quant, shape, generator, timesteps,
                            guidance_scale, guidance_rescale, scheduler_timesteps_mode,
                            model_fn_uncond, noise, step_noise)


def divae_decode_tokens(model: DiVAE, tokens: torch.Tensor,
                        generator: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
    return divae_decode_quant(model, model.tokens_to_embedding(tokens), generator, **kw)


def init_vq_weights(vq: VQ, seed: int, spread: float = 0.0) -> VQ:
    """Random weights from a seeded torch.Generator on the model's device,
    after the JAX package's initialisers: matrices and convolution kernels
    lecun-normal (std 1/sqrt(fan_in)), embeddings normal(1), LayerNorm and
    GroupNorm scales one, other vectors zero; the codebook kaiming-uniform
    (bound sqrt(6 / dim)), l2-normalised for a cosine codebook, as at init
    (quantizer.py:143-149). Layers the JAX modules initialise to zero (the
    decoders' output convolutions, adaLN-Zero gates) are drawn like the
    others, so a decoder's output is not zero. With `spread` > 0 the vectors
    are drawn too: scales 1 + spread * N(0, 1), the others spread * N(0, 1)
    (a check of the decoders then exercises every bias, mask token and
    layer scale)."""
    gen = torch.Generator(device=vq.device).manual_seed(seed)

    def randn(p):
        return torch.randn(p.shape, generator=gen, device=p.device)

    with torch.no_grad():
        for name, p in vq.named_parameters():
            if p.ndim == 1:
                scale = name.endswith("weight")
                p.copy_(float(scale) + spread * randn(p) if spread else
                        torch.full_like(p, float(scale)))
            else:
                fan_in = 1 if name.startswith("cls_emb") else int(np.prod(p.shape[1:]))
                if isinstance(_owner(vq, name), nn.ConvTranspose2d):
                    fan_in = p.shape[0] * int(np.prod(p.shape[2:]))
                p.copy_(randn(p) * fan_in ** -0.5)
        e = vq.quantize.codebook
        bound = (6.0 / e.shape[1]) ** 0.5
        e.copy_((torch.rand(e.shape, generator=gen, device=e.device) * 2 - 1) * bound)
        if vq.quantize.use_cosine_sim:
            e.copy_(l2norm(e))
    return vq


def _owner(module: nn.Module, param_name: str) -> nn.Module:
    return module.get_submodule(param_name.rsplit(".", 1)[0])
