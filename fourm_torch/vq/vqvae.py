"""VQ tokenizers of the port: `VQ` (encoder + quantizer), `VQVAE` (+ ViT or
MLP decoder), `DiVAE` (+ UNet or UViT diffusion decoder) and
`VQControlNet` (+ ControlNet decoder over a KL-VAE latent space), for
inference and training.

Counterpart of fourm_tpu/vq/vqvae.py:VQ, VQVAE, DiVAE and VQControlNet
(reference vqvae.py:39-1047), channel-last. `VQ`: `prepare_input` (ImageNet
standardisation undone to [-1, 1], class maps embedded), `latents`,
`encode`, `tokenize`, `tokens_to_embedding`; the encoder of every 4M-21
tokenizer (ViT, or the BottleneckMLP of the global-embedding and pose
tokenizers). `VQVAE`: `decode_quant`, `decode_tokens`, `autoencode`.
`DiVAE`: `noise_scheduler`, `denoise_step`, and diffusion decoding by
`divae_decode_quant` / `divae_decode_tokens` (an eager loop over the
timesteps). Training (fourm_tpu/vq/vqvae.py:105-116, :176-179, :229-261):
`VQ.encode(x, train=True)` (the blocks' differentiable path through
`attention_train`, the quantizer's straight-through estimator, commitment
loss and codebook EMA; `freeze_enc` stops the gradient at the encoder's
output), `VQVAE.forward` -> (reconstruction, code loss), `DiVAE.forward`
(clean input encoded, noised input denoised) with `sample_cond_mask`, and
`init_codebook_kmeans`. `VQControlNet` (vq/controlnet.py): `vae_encode`,
`vae_decode`, `denoise_step`, the training forward, and decoding by
`controlnet_decode_quant` / `controlnet_decode_tokens` in the VAE's latent
space. Built with `fp32_params=True` a model keeps every parameter in fp32
(the train CLIs' masters; each product casts them to the compute dtype).

Usage:
    vq = VQ(image_size=224, patch_size=16, enc_type="vit_b_enc",
            codebook_size=16384, latent_dim=32, dtype="bfloat16")  # on "cuda"
    vq.load_state_dict(from_jax_vq_variables(variables))  # or init_vq_weights(vq, seed)
    tokens = vq.tokenize(images_nhwc)                    # (B, 14, 14) int64
    vqvae = VQVAE(..., fp32_params=True).requires_grad_(True)
    rec, code_loss = vqvae(images_nhwc, train=True)      # a training forward
    divae = DiVAE(dec_type="unet_patched", prediction_type="sample", ...)
    images = divae_decode_tokens(divae, tokens, generator, timesteps=25)
    cn = VQControlNet(image_size=448, codebook_size=1024, dtype="bfloat16")
    images = controlnet_decode_tokens(init_vq_weights(cn, 0), tokens, generator)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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
                 ema_decay: float = 0.99, threshold_ema_dead_code: float = 0.25,
                 code_replacement_policy: str = "batch_random", commitment_weight: float = 1.0,
                 kmeans_init: bool = False, undo_std: bool = False, freeze_enc: bool = False,
                 dtype: str = "float32", fp32_params: bool = False,
                 device: Optional[str] = None):
        super().__init__()
        self.image_size, self.n_labels, self.undo_std = image_size, n_labels, undo_std
        self.freeze_enc, self.fp32_params = freeze_enc, fp32_params
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
                                       norm_latents=norm_latents, decay=ema_decay,
                                       threshold_ema_dead_code=threshold_ema_dead_code,
                                       code_replacement_policy=code_replacement_policy,
                                       commitment_weight=commitment_weight,
                                       kmeans_init=kmeans_init)
        for m in low + [self.quant_proj, getattr(self, "cls_emb", None)]:
            if m is not None:
                self._cast(m)
        self._place(device)

    def _cast(self, module: nn.Module) -> None:
        if not self.fp32_params:
            cast_matrices(module, self.compute_dtype)

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

    def latents(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The encoder's output projected to the latent dim, before the
        quantizer: (B, Hq, Wq, latent_dim) in the compute dtype. In training
        with freeze_enc the gradient stops at the encoder's output
        (vqvae.py:107-108)."""
        h = self.encoder(self.prepare_input(x), train=train)
        if train and self.freeze_enc:
            h = h.detach()
        return _dense(h, self.quant_proj, self.compute_dtype)

    def encode(self, x: torch.Tensor, train: bool = False,
               draws: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None):
        """-> (quant (B, Hq, Wq, latent_dim), code_loss, tokens (B, Hq, Wq)
        or (B, Hq, Wq, num_codebooks)). train=True: the training forward,
        the codebook's EMA state updated in place (`draws` / `generator`:
        the quantizer's random draws, VectorQuantize.forward)."""
        h = self.latents(x, train)
        B, Hq, Wq, D = h.shape
        quant, tokens, loss = self.quantize(h.reshape(B, Hq * Wq, D), train=train, draws=draws,
                                            generator=generator)
        shape = (B, Hq, Wq) if self.num_codebooks == 1 else (B, Hq, Wq, self.num_codebooks)
        return quant.reshape(B, Hq, Wq, -1), loss, tokens.reshape(shape)

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x)[2]

    def tokens_to_embedding(self, tokens: torch.Tensor) -> torch.Tensor:
        """Codebook lookup: (B, Hq, Wq) -> (B, Hq, Wq, latent_dim)."""
        return self.quantize.indices_to_embedding(tokens)

    def init_codebook_kmeans(self, x: torch.Tensor, init_idx: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None) -> None:
        """k-means codebook init from a batch (vqvae.py:127-130)."""
        with torch.no_grad():
            self.quantize.init_codebook_kmeans(self.latents(x), init_idx, generator)

    def forward(self, x: torch.Tensor, train: bool = False, **kw):
        """-> (quant, code_loss) (vqvae.py:132-134)."""
        quant, code_loss, _ = self.encode(x, train=train, **kw)
        return quant, code_loss


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
        self._cast(self.decoder)
        self._cast(self.post_quant_proj)
        self._place(device)

    def decode_quant(self, quant: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder(_dense(quant, self.post_quant_proj, self.compute_dtype), train=train)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.decode_quant(self.tokens_to_embedding(tokens))

    def autoencode(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode_quant(self.encode(x)[0])

    def forward(self, x: torch.Tensor, train: bool = False, **kw):
        """-> (reconstruction, code_loss) (vqvae.py:176-179)."""
        quant, code_loss, _ = self.encode(x, train=train, **kw)
        return self.decode_quant(quant, train), code_loss


class DiVAE(VQ):
    """Diffusion VQ-VAE: encoder, quantizer and a diffusion decoder, UViT
    (`uvit_*` presets) or the patched ADM UNet (`unet_patched`) (reference
    vqvae.py:498-763, inspired by arXiv:2206.00386)."""

    def __init__(self, dec_type: str = "uvit_b_p4_f16", num_train_timesteps: int = 1000,
                 cls_free_guidance_dropout: float = 0.0, masked_cfg: bool = False,
                 masked_cfg_low: int = 0, masked_cfg_high: Optional[int] = None,
                 scheduler: str = "ddpm", beta_schedule: str = "squaredcos_cap_v2",
                 prediction_type: str = "v_prediction", clip_sample: bool = False,
                 thresholding: bool = True, conditioning: str = "concat",
                 zero_terminal_snr: bool = True, image_size_dec: Optional[int] = None,
                 device: Optional[str] = None, **kw):
        super().__init__(device="cpu", **kw)
        dt = self.compute_dtype
        self.cls_free_guidance_dropout, self.masked_cfg = cls_free_guidance_dropout, masked_cfg
        self.masked_cfg_low, self.masked_cfg_high = masked_cfg_low, masked_cfg_high
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
        self._cast(self.decoder)
        self._place(device)

    def noise_scheduler(self) -> DiffusionScheduler:
        return DiffusionScheduler(**self.scheduler_kw)

    def sample_cond_mask(self, B: int, Hq: int, Wq: int, drop: Optional[torch.Tensor] = None,
                         k: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training-time condition dropout of classifier-free guidance
        (vqvae.py:229-244; reference vqvae.py:618-640): a sample's whole
        condition is dropped with probability cls_free_guidance_dropout
        (`drop` (B,) bool); with masked_cfg, of a dropped sample only the
        tokens whose rank in `noise` ((B, Hq*Wq) uniforms) is at least `k`
        ((B,) ints in [masked_cfg_low, masked_cfg_high]). Draws not given
        come from `generator`."""
        dev = self.device
        if drop is None:
            drop = torch.rand(B, generator=generator, device=dev) < self.cls_free_guidance_dropout
        cond_mask = drop.to(dev)[:, None, None].expand(B, Hq, Wq)
        if self.masked_cfg:
            n = Hq * Wq
            high = self.masked_cfg_high if self.masked_cfg_high is not None else n
            if k is None:
                k = torch.randint(self.masked_cfg_low, high + 1, (B,), generator=generator,
                                  device=dev)
            if noise is None:
                noise = torch.rand(B, n, generator=generator, device=dev)
            ranks = torch.argsort(torch.argsort(noise.to(dev), dim=1, stable=True), dim=1,
                                  stable=True)
            cond_mask = (ranks >= k.to(dev)[:, None]).reshape(B, Hq, Wq) & cond_mask
        return cond_mask

    def forward(self, input_clean: torch.Tensor, input_noised: torch.Tensor, timesteps,
                cond_mask: Optional[torch.Tensor] = None, orig_res=None, train: bool = False,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """Training forward (vqvae.py:252-261; reference vqvae.py:727-763):
        encode the clean input, denoise the noised one conditioned on the
        quantized latents -> (the decoder's prediction, code_loss). In
        training with cls_free_guidance_dropout > 0 and no cond_mask, the
        mask comes from sample_cond_mask (its draws `draws["cond_drop"]`,
        `draws["cond_k"]`, `draws["cond_noise"]` when given)."""
        draws = draws or {}
        quant, code_loss, _ = self.encode(input_clean, train=train, draws=draws,
                                          generator=generator)
        if cond_mask is None and self.cls_free_guidance_dropout > 0.0 and train:
            B, Hq, Wq, _ = quant.shape
            cond_mask = self.sample_cond_mask(B, Hq, Wq, draws.get("cond_drop"),
                                              draws.get("cond_k"), draws.get("cond_noise"),
                                              generator)
        dec = self.decoder(input_noised, timesteps, quant, cond_mask=cond_mask,
                           orig_res=orig_res, train=train)
        return dec, code_loss

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


class VQControlNet(VQ):
    """VQ encoder + ControlNet diffusion decoder over a frozen KL-VAE latent
    space (fourm_tpu/vq/vqvae.py:306-405; reference vqvae.py:766-1047): the
    SD-1.5-scale UNet, its ControlNet branch and the VAE of vq/controlnet.py,
    random unless a checkpoint is loaded. The scheduler is DDIM over
    scaled-linear betas from 0.00085 to 0.012 (the JAX code's; its docstring
    says PNDM), epsilon prediction by default. The latent side,
    (image_size_sd or image_size) / 2^(len(vae_ch_mult) - 1), must be a
    multiple of 2^(len(channel_mult) - 1) (a ValueError here; the JAX
    package's concatenation raises at the first call). Built on `device`
    directly (the card unless "cpu" is asked): SD-1.5 scale is 1.08 B
    parameters."""

    def __init__(self, image_size_sd: Optional[int] = None,
                 cls_free_guidance_dropout: float = 0.0, masked_cfg: bool = False,
                 masked_cfg_low: int = 0, masked_cfg_high: Optional[int] = None,
                 num_train_timesteps: int = 1000, prediction_type: str = "epsilon",
                 beta_schedule: str = "scaled_linear", beta_start: float = 0.00085,
                 beta_end: float = 0.012, model_channels: int = 320, num_res_blocks: int = 2,
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 attention_levels: Sequence[int] = (0, 1, 2), num_heads: int = 8,
                 context_len: int = 77, context_dim: int = 768, vae_base_channels: int = 128,
                 vae_ch_mult: Sequence[int] = (1, 2, 4, 4), latent_channels: int = 4,
                 device: Optional[str] = None, **kw):
        from ..api import resolve_device
        from .controlnet import AutoencoderKL, ControlNetCond

        dev = resolve_device(device)
        with torch.device(dev):
            super().__init__(device=dev, **kw)
            dt = self.compute_dtype
            self.image_size_sd = image_size_sd
            self.cls_free_guidance_dropout, self.masked_cfg = cls_free_guidance_dropout, masked_cfg
            self.masked_cfg_low, self.masked_cfg_high = masked_cfg_low, masked_cfg_high
            self.prediction_type, self.latent_channels = prediction_type, latent_channels
            self.scheduler_kw = dict(kind="ddim", num_train_timesteps=num_train_timesteps,
                                     beta_schedule=beta_schedule, beta_start=beta_start,
                                     beta_end=beta_end, prediction_type=prediction_type,
                                     clip_sample=False, thresholding=False,
                                     zero_terminal_snr=False)
            self.latent_size = (image_size_sd or self.image_size) // 2 ** (len(vae_ch_mult) - 1)
            self.decoder = ControlNetCond(
                in_channels=latent_channels, cond_channels=self.latent_dim,
                sample_size=self.latent_size, model_channels=model_channels,
                num_res_blocks=num_res_blocks, channel_mult=tuple(channel_mult),
                attention_levels=tuple(attention_levels), num_heads=num_heads,
                context_len=context_len, context_dim=context_dim, dtype=dt)
            self.vae = AutoencoderKL(vae_base_channels, tuple(vae_ch_mult), latent_channels,
                                     in_channels=self.n_channels, dtype=dt)
            # the prompt encoding stays fp32, as the JAX parameter
            self._cast(self.decoder.unet)
            self._cast(self.decoder.controlnet)
            self._cast(self.vae)
        self._place(dev)

    def noise_scheduler(self) -> DiffusionScheduler:
        return DiffusionScheduler(**self.scheduler_kw)

    # conditioning dropout: DiVAE's (reference sample_mask, vqvae.py:856-887)
    sample_cond_mask = DiVAE.sample_cond_mask

    def latents(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The encoder's inference path whatever `train`, without a graph:
        nothing upstream of the quantizer trains here
        (vqcontrolnet_trainable_mask), so the training forward's encoder is
        the tokenizer's (the JAX training forward runs the same encoder and
        masks its gradients)."""
        with torch.no_grad():
            return super().latents(x, train=False)

    def vae_encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Image -> the frozen VAE's scaled latent, without a graph
        (vqvae.py:367-369): the mean, or a sample (`noise` / `generator`,
        the JAX method's rng)."""
        with torch.no_grad():
            return self.vae.encode(self.prepare_input(x), noise, generator)

    def vae_decode(self, z: torch.Tensor, clip: bool = True) -> torch.Tensor:
        x = self.vae.decode(z)
        return x.clamp(-1.0, 1.0) if clip else x

    def denoise_step(self, noised, timesteps, quant, cond_mask=None, orig_res=None,
                     unconditional: bool = False, cond_scale: float = 1.0,
                     prompt_emb=None) -> torch.Tensor:
        return self.decoder(noised, timesteps, quant, cond_mask=cond_mask,
                            unconditional=unconditional, cond_scale=cond_scale,
                            prompt_emb=prompt_emb)

    def forward(self, input_clean: torch.Tensor, input_noised: torch.Tensor, timesteps,
                cond_mask: Optional[torch.Tensor] = None, prompt_emb=None, orig_res=None,
                train: bool = False, draws: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """Training forward (vqvae.py:390-405): the clean image quantized
        (train=True: the codebook's EMA and dead codes, `draws` /
        `generator` as VQ.encode), the noised VAE latent (B, Hl, Wl,
        latent_channels) denoised under the token condition, dropped by
        sample_cond_mask in training (DiVAE.forward's draws) -> (prediction,
        code_loss)."""
        draws = draws or {}
        quant, code_loss, _ = self.encode(input_clean, train=train, draws=draws,
                                          generator=generator)
        if cond_mask is None and self.cls_free_guidance_dropout > 0.0 and train:
            B, Hq, Wq, _ = quant.shape
            cond_mask = self.sample_cond_mask(B, Hq, Wq, draws.get("cond_drop"),
                                              draws.get("cond_k"), draws.get("cond_noise"),
                                              generator)
        dec = self.decoder(input_noised, timesteps, quant, cond_mask=cond_mask,
                           prompt_emb=prompt_emb)
        return dec, code_loss


def controlnet_decode_quant(model: VQControlNet, quant: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            timesteps: Optional[int] = None, guidance_scale: float = 0.0,
                            cond_scale: float = 1.0, scheduler_timesteps_mode: str = "leading",
                            vae_decode: bool = True, prompt_emb=None,
                            noise: Optional[torch.Tensor] = None,
                            step_noise=None) -> torch.Tensor:
    """ControlNet diffusion decoding in the VAE's latent space
    (vqvae.py:407-442; reference decode_quant + PipelineCond, vqvae.py:
    884-921): `diffusion_sample` over denoise_step (the condition scaled by
    cond_scale; the unconditional branch of CFG without the branch and with
    the empty prompt), then the VAE's decoder, clipped to [-1, 1] -> (B, S,
    S, n_channels); with vae_decode=False the latent. Timesteps "leading"
    by default (DiVAE's are "trailing"). Noise: `noise` / `step_noise`,
    else draws from `generator` (on the model's device)."""
    sched = model.noise_scheduler()
    shape = (quant.shape[0], model.latent_size, model.latent_size, model.latent_channels)

    def model_fn(noisy, t, cond):
        return model.denoise_step(noisy, t, cond, cond_scale=cond_scale, prompt_emb=prompt_emb)

    def model_fn_uncond(noisy, t, cond):
        return model.denoise_step(noisy, t, cond, unconditional=True)

    z = diffusion_sample(model_fn, sched, quant, shape, generator, timesteps, guidance_scale,
                         0.0, scheduler_timesteps_mode, model_fn_uncond, noise, step_noise)
    return model.vae_decode(z) if vae_decode else z


def controlnet_decode_tokens(model: VQControlNet, tokens: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             **kw) -> torch.Tensor:
    return controlnet_decode_quant(model, model.tokens_to_embedding(tokens), generator, **kw)


def init_vq_weights(vq: VQ, seed: int, spread: float = 0.0) -> VQ:
    """Random weights from a seeded torch.Generator on the model's device,
    after the JAX package's initialisers: matrices and convolution kernels
    lecun-normal (std 1/sqrt(fan_in)), embeddings normal(1), LayerNorm and
    GroupNorm scales one, other vectors zero; the codebook kaiming-uniform
    (bound sqrt(6 / dim)), l2-normalised for a cosine codebook, as at init
    (quantizer.py:143-149); a ControlNet's prompt encoding normal(0.02), as
    its JAX initialiser. Layers the JAX modules initialise to zero (the
    decoders' output convolutions, adaLN-Zero gates, the ControlNet's
    residual taps and conditioning output) are drawn like the others, so a
    decoder's output, and a ControlNet branch's share of it, is not zero.
    With `spread` > 0 the vectors are drawn too: scales 1 + spread *
    N(0, 1), the others spread * N(0, 1) (a check of the decoders then
    exercises every bias, mask token and layer scale)."""
    gen = torch.Generator(device=vq.device).manual_seed(seed)

    def randn(p):
        return torch.randn(p.shape, generator=gen, device=p.device)

    with torch.no_grad():
        for name, p in vq.named_parameters():
            if p.ndim == 1:
                scale = name.endswith("weight")
                p.copy_(float(scale) + spread * randn(p) if spread else
                        torch.full_like(p, float(scale)))
            elif name.endswith("empty_str_encoding"):
                p.copy_(randn(p) * 0.02)
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
