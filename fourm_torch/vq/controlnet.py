"""ControlNet diffusion decoder and SD-style KL VAE of the VQControlNet
tokenizer, PyTorch port.

Counterpart of fourm_tpu/vq/controlnet.py (reference
fourm/vq/models/controlnet.py:102-255 `ControlnetCond` and
fourm/vq/vqvae.py:766-1047): a frozen SD-1.5-style cross-attention UNet
over VAE latents (`CondUNet`), a trainable copy of its down and mid path
(`ControlNetBranch`) conditioned on the quantized token map through a conv
embedding and tapped by 1x1 residual convolutions, a stand-in for the
frozen CLIP empty-prompt encoding (`ControlNetCond.empty_str_encoding`,
fp32), the KL VAE whose latent space the decoder denoises
(`AutoencoderKL`), and the `Token2VAE` adapter. Weights are random unless a
checkpoint is loaded, as in the JAX package.

Numerics are those of the flax modules (vq/layers.py: convolutions in the
compute dtype, GroupNorm with flax's epsilon 1e-6 and fp32 statistics,
jax.image.resize's nearest). The attentions are plain matmul + fp32
softmax, as the JAX module's XLA einsums (no Pallas kernel computes them),
in query-row chunks with the backward recomputing them
(`spatial_attention`).

Interfaces are channel-last, as the JAX module's; activations are NCHW
inside, and the branch hands its residuals to the UNet in NCHW. Submodule
names are those of the JAX tree as fourm_tpu/utils/checkpoint.py:
_vq_torch_name maps them (`down_blocks.0.downsamplers.0`,
`up_blocks.1.upsamplers.0`, `cond_embedding.block.3`, `zero_conv_4`, ...),
so the weight bridge's state dict loads with strict=True.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.transformer import _dense
from .layers import Conv2d, GroupNorm, nchw, nhwc, resize_nearest
from .unet import GN_EPS, ADMResBlock, _stages, adm_timestep_embedding

# the fp32 logits of one chunk of query rows (a level-0 attention of SD 1.5
# at latent 56 and B = 32 has 10 GB of them)
_CHUNK_BYTES = 1 << 30


def _row_chunks(q: torch.Tensor, k: torch.Tensor):
    B, H, N, _ = q.shape
    rows = max(1, _CHUNK_BYTES // (B * H * k.shape[2] * 4))
    return [slice(s, min(s + rows, N)) for s in range(0, N, rows)]


def _probs(q: torch.Tensor, k: torch.Tensor, root: float) -> torch.Tensor:
    """softmax(q k^T / root) in fp32: the products of the dtype values
    summed in fp32 (preferred_element_type=float32), then divided."""
    return torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) / root, dim=-1)


class _Attention(torch.autograd.Function):
    """Attention over (B, H, N, d) heads, chunked over the query rows; the
    backward recomputes each chunk's probabilities from q and k (nothing of
    size N x M is kept between the passes)."""

    @staticmethod
    def forward(ctx, q, k, v, root):
        out = torch.empty(q.shape[:3] + (v.shape[3],), dtype=v.dtype, device=v.device)
        for rows in _row_chunks(q, k):
            out[:, :, rows] = torch.matmul(_probs(q[:, :, rows], k, root).to(v.dtype), v)
        ctx.save_for_backward(q, k, v)
        ctx.root = root
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for rows in _row_chunks(q, k):
            p = _probs(q[:, :, rows], k, ctx.root)
            do = dout[:, :, rows].to(v.dtype)
            dv += torch.matmul(p.to(v.dtype).transpose(-1, -2), do).float()
            dp = torch.matmul(do, v.transpose(-1, -2)).float()
            # the softmax's backward (the cast to v's dtype passes the gradient on)
            ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) / ctx.root).to(q.dtype)
            dq[:, :, rows] = torch.matmul(ds, k)
            dk += torch.matmul(ds.transpose(-1, -2), q[:, :, rows]).float()
        return dq, dk.to(k.dtype), dv.to(v.dtype), None


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """Multi-head attention of controlnet.py:51-62: q (B, N, C), k and v
    (B, M, C) in the compute dtype -> (B, N, C). The logits are fp32,
    divided by sqrt(head dim) after the product, the softmax fp32, and the
    probabilities are cast to v's dtype for the product with v."""
    B, N, C = q.shape
    hd = C // num_heads

    def split(t):
        return t.reshape(B, t.shape[1], num_heads, hd).transpose(1, 2)

    out = _Attention.apply(split(q), split(k), split(v), math.sqrt(hd))
    return out.transpose(1, 2).reshape(B, N, C)


class SpatialSelfAttention(nn.Module):
    """Self-attention over a feature map, pre-norm, residual (:35-61).
    NCHW."""

    def __init__(self, channels: int, num_heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.norm = GroupNorm(32, channels, GN_EPS, dtype)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        dt = self.dtype
        out = spatial_attention(_dense(h, self.q, dt), _dense(h, self.k, dt),
                                _dense(h, self.v, dt), self.num_heads)
        out = _dense(out, self.proj_out, dt)
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class SpatialCrossAttention(nn.Module):
    """Cross-attention from a feature map into a (B, L, context_dim)
    context, the SD UNet's prompt path (:64-91). NCHW."""

    def __init__(self, channels: int, context_dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.norm = GroupNorm(32, channels, GN_EPS, dtype)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(context_dim, channels)
        self.v = nn.Linear(context_dim, channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).flatten(2).transpose(1, 2)
        dt = self.dtype
        out = spatial_attention(_dense(h, self.q, dt), _dense(context, self.k, dt),
                                _dense(context, self.v, dt), self.num_heads)
        out = _dense(out, self.proj_out, dt)
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class ControlNetConditioningEmbedding(nn.Module):
    """Conv stack embedding the conditioning map (:94-120). NCHW."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int] = (16, 32, 96, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1, dtype=dtype)
        blocks = []
        for i in range(len(ch) - 1):
            blocks += [Conv2d(ch[i], ch[i], 3, padding=1, dtype=dtype),
                       Conv2d(ch[i], ch[i + 1], 3, padding=1, dtype=dtype)]
        self.block = nn.ModuleList(blocks)
        self.conv_out = Conv2d(ch[-1], out_channels, 3, padding=1, dtype=dtype)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(cond))
        for conv in self.block:
            h = F.silu(conv(h))
        return self.conv_out(h)


class TimestepEmbed(nn.Module):
    """Sinusoidal embedding + two dense layers (:164-173)."""

    def __init__(self, model_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model_channels, self.dtype = model_channels, dtype
        self.fc1 = nn.Linear(model_channels, 4 * model_channels)
        self.fc2 = nn.Linear(4 * model_channels, 4 * model_channels)

    def forward(self, timesteps, batch: int, device) -> torch.Tensor:
        t = torch.as_tensor(timesteps, device=device).reshape(-1).expand(batch)
        emb = _dense(adm_timestep_embedding(t, self.model_channels), self.fc1, self.dtype)
        return _dense(F.silu(emb), self.fc2, self.dtype)


def _add_attention(module: nn.Module, prefix: str, i: int, ch: int, num_heads: int,
                   context_dim: int, dtype) -> str:
    """`{prefix}_attn_{i}` (self) and `{prefix}_xattn_{i}` (cross) added to
    module; returns their names with `{}` for attn / xattn."""
    module.add_module(f"{prefix}_attn_{i}", SpatialSelfAttention(ch, num_heads, dtype))
    module.add_module(f"{prefix}_xattn_{i}",
                      SpatialCrossAttention(ch, context_dim, num_heads, dtype))
    return f"{prefix}_{{}}_{i}"


class UNetEncoderPath(nn.Module):
    """conv_in, the down blocks and the mid block (:123-161), the part of
    the UNet the ControlNet branch copies. forward -> (h, skips), NCHW."""

    def __init__(self, in_channels: int, model_channels: int, num_res_blocks: int,
                 channel_mult: Sequence[int], attention_levels: Sequence[int], num_heads: int,
                 context_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        mc, time_dim = model_channels, 4 * model_channels
        ch = int(channel_mult[0] * mc)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, dtype=dtype)
        self.skip_channels = [ch]
        self.plan: List[Tuple[str, str]] = []  # ("res" | "attn" | "down", name), ("push", "")
        down = {}
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                name = f"down_{level}_res_{i}"
                self.add_module(name, ADMResBlock(ch, int(mult * mc), time_dim, dtype=dtype))
                ch = int(mult * mc)
                self.plan.append(("res", name))
                if level in attention_levels:
                    self.plan.append(("attn", _add_attention(self, f"down_{level}", i, ch,
                                                             num_heads, context_dim, dtype)))
                self.plan.append(("push", ""))
                self.skip_channels.append(ch)
            if level != len(channel_mult) - 1:
                down[level] = Conv2d(ch, ch, 3, stride=2, padding=1, dtype=dtype)
                self.plan += [("down", str(level)), ("push", "")]
                self.skip_channels.append(ch)
        self.down_blocks = _stages("downsamplers", down)
        self.mid_res_0 = ADMResBlock(ch, ch, time_dim, dtype=dtype)
        self.mid_attn = SpatialSelfAttention(ch, num_heads, dtype)
        self.mid_xattn = SpatialCrossAttention(ch, context_dim, num_heads, dtype)
        self.mid_res_1 = ADMResBlock(ch, ch, time_dim, dtype=dtype)
        self.out_channels = ch

    def forward(self, x: torch.Tensor, emb: torch.Tensor, context: torch.Tensor,
                cond_embedding: Optional[torch.Tensor] = None):
        h = self.conv_in(x)
        if cond_embedding is not None:
            h = h + cond_embedding
        hs = [h]
        for op, name in self.plan:
            if op == "res":
                h = getattr(self, name)(h, emb)
            elif op == "attn":
                h = getattr(self, name.format("attn"))(h)
                h = getattr(self, name.format("xattn"))(h, context)
            elif op == "down":
                h = self.down_blocks[name]["downsamplers"][0](h)
            else:
                hs.append(h)
        h = self.mid_res_0(h, emb)
        h = self.mid_xattn(self.mid_attn(h), context)
        return self.mid_res_1(h, emb), hs


class CondUNet(nn.Module):
    """SD-style cross-attention UNet over latents with the ControlNet's
    residuals added to its skips and mid block (:176-228). forward(sample
    (B, H, W, C), timesteps, context (B, L, D), down_residuals (NCHW list),
    mid_residual (NCHW)) -> (B, H, W, out_channels)."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4, model_channels: int = 320,
                 num_res_blocks: int = 2, channel_mult: Sequence[int] = (1, 2, 4, 4),
                 attention_levels: Sequence[int] = (0, 1, 2), num_heads: int = 8,
                 context_dim: int = 768, dtype: torch.dtype = torch.float32):
        super().__init__()
        mc, self.dtype = model_channels, dtype
        self.time_embed = TimestepEmbed(mc, dtype)
        self.encoder = UNetEncoderPath(in_channels, mc, num_res_blocks, channel_mult,
                                       attention_levels, num_heads, context_dim, dtype)
        skips = list(self.encoder.skip_channels)
        ch = self.encoder.out_channels
        self.plan: List[Tuple[str, str]] = []  # ("res" | "attn" | "up", name)
        up = {}
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                name = f"up_{level}_res_{i}"
                self.add_module(name, ADMResBlock(ch + skips.pop(), int(mult * mc), 4 * mc,
                                                  dtype=dtype))
                ch = int(mult * mc)
                self.plan.append(("res", name))
                if level in attention_levels:
                    self.plan.append(("attn", _add_attention(self, f"up_{level}", i, ch,
                                                             num_heads, context_dim, dtype)))
                if level and i == num_res_blocks:
                    up[level] = Conv2d(ch, ch, 3, padding=1, dtype=dtype)
                    self.plan.append(("up", str(level)))
        self.up_blocks = _stages("upsamplers", up)
        self.out_norm = GroupNorm(32, ch, GN_EPS, dtype)
        # normally initialised (not zero), as diffusers' UNet2DConditionModel
        self.conv_out = Conv2d(ch, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, sample: torch.Tensor, timesteps, context: torch.Tensor,
                down_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.time_embed(timesteps, sample.shape[0], sample.device)
        h, hs = self.encoder(nchw(sample), emb, context)
        if mid_residual is not None:
            h = h + mid_residual
        if down_residuals is not None:
            hs = [s + r for s, r in zip(hs, down_residuals)]
        for op, name in self.plan:
            if op == "res":
                h = getattr(self, name)(torch.cat([h, hs.pop()], dim=1), emb)
            elif op == "attn":
                h = getattr(self, name.format("attn"))(h)
                h = getattr(self, name.format("xattn"))(h, context)
            else:  # up: nearest x2, then a 3x3 convolution
                h = resize_nearest(h, (2 * h.shape[2], 2 * h.shape[3]), (2, 3))
                h = self.up_blocks[name]["upsamplers"][0](h)
        return nhwc(self.conv_out(F.silu(self.out_norm(h))))


class ControlNetBranch(nn.Module):
    """Trainable copy of the UNet's encoder path with the conditioning
    embedding and the 1x1 residual taps (:231-271). forward(sample (B, H,
    W, C), timesteps, context, cond (B, H, W, cond_channels)) ->
    (down residuals, mid residual), NCHW."""

    def __init__(self, in_channels: int = 4, cond_channels: int = 32, model_channels: int = 320,
                 num_res_blocks: int = 2, channel_mult: Sequence[int] = (1, 2, 4, 4),
                 attention_levels: Sequence[int] = (0, 1, 2), num_heads: int = 8,
                 context_dim: int = 768,
                 cond_embedding_channels: Sequence[int] = (16, 32, 96, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mc = model_channels
        self.time_embed = TimestepEmbed(mc, dtype)
        self.cond_embedding = ControlNetConditioningEmbedding(
            cond_channels, int(channel_mult[0] * mc), cond_embedding_channels, dtype)
        self.encoder = UNetEncoderPath(in_channels, mc, num_res_blocks, channel_mult,
                                       attention_levels, num_heads, context_dim, dtype)
        self.n_taps = len(self.encoder.skip_channels)
        for i, c in enumerate(self.encoder.skip_channels):
            self.add_module(f"zero_conv_{i}", Conv2d(c, c, 1, dtype=dtype))
        c = self.encoder.out_channels
        self.mid_zero_conv = Conv2d(c, c, 1, dtype=dtype)

    def forward(self, sample: torch.Tensor, timesteps, context: torch.Tensor,
                cond: torch.Tensor):
        emb = self.time_embed(timesteps, sample.shape[0], sample.device)
        cond_emb = self.cond_embedding(nchw(cond))
        h, hs = self.encoder(nchw(sample), emb, context, cond_embedding=cond_emb)
        down = [getattr(self, f"zero_conv_{i}")(s) for i, s in enumerate(hs)]
        return down, self.mid_zero_conv(h)


def check_latent_size(sample_size: int, channel_mult: Sequence[int]) -> None:
    """The UNet halves the latent len(channel_mult) - 1 times and doubles it
    back, concatenating each skip: a side the divisor does not divide comes
    back one larger than its skip (the 224 config's 28 -> 14 -> 7 -> 4 -> 8
    against 7, where the JAX package's concatenation raises)."""
    div = 2 ** (len(channel_mult) - 1)
    if sample_size % div:
        raise ValueError(f"latent size {sample_size} is not a multiple of {div} = "
                         f"2^(len(channel_mult) - 1) for channel_mult {tuple(channel_mult)}: "
                         "the UNet's upsampled path would not match its skips")


class ControlNetCond(nn.Module):
    """Frozen base UNet + trainable ControlNet branch conditioned on the
    quantized-token map (:274-346). forward(sample (B, Hl, Wl, C), timestep,
    condition (B, Hq, Wq, cond_channels), cond_mask (B, Hq, Wq) bool,
    orig_res (unused), unconditional, cond_scale, prompt_emb) -> the UNet's
    prediction (B, Hl, Wl, C). The unconditional pass of classifier-free
    guidance takes the empty-prompt encoding and no residuals: the JAX
    module computes the branch and zeroes its outputs, so the port skips
    it (the sums are the same, exactly)."""

    def __init__(self, in_channels: int = 4, cond_channels: int = 32, sample_size: int = 28,
                 model_channels: int = 320, num_res_blocks: int = 2,
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 attention_levels: Sequence[int] = (0, 1, 2), num_heads: int = 8,
                 context_len: int = 77, context_dim: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_latent_size(sample_size, channel_mult)
        self.sample_size, self.dtype = sample_size, dtype
        kw = dict(model_channels=model_channels, num_res_blocks=num_res_blocks,
                  channel_mult=channel_mult, attention_levels=attention_levels,
                  num_heads=num_heads, context_dim=context_dim, dtype=dtype)
        self.unet = CondUNet(in_channels, in_channels, **kw)
        self.controlnet = ControlNetBranch(in_channels, cond_channels, **kw)
        # the frozen CLIP empty-prompt encoding's stand-in, fp32 (normal(0.02)
        # as the JAX initialiser)
        self.empty_str_encoding = nn.Parameter(torch.randn(context_len, context_dim) * 0.02)

    def forward(self, sample: torch.Tensor, timestep, condition: torch.Tensor,
                cond_mask: Optional[torch.Tensor] = None, orig_res=None,
                unconditional: bool = False, cond_scale: float = 1.0,
                prompt_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = sample.shape[0]
        if prompt_emb is None or unconditional:
            context = self.empty_str_encoding.to(self.dtype)[None].expand(B, -1, -1)
        else:
            context = prompt_emb
        if unconditional:
            return self.unet(sample, timestep, context)
        if cond_mask is not None:
            condition = torch.where(cond_mask[..., None], 0.0, condition)
        cond = resize_nearest(condition, (self.sample_size, self.sample_size), (1, 2))
        down, mid = self.controlnet(sample, timestep, context, cond)
        if cond_scale != 1.0:
            down, mid = [r * cond_scale for r in down], mid * cond_scale
        return self.unet(sample, timestep, context, down_residuals=down, mid_residual=mid)


# ------------------------------------------------------------------ KL VAE


class VAEResBlock(nn.Module):
    """GroupNorm-SiLU-Conv twice, 1x1 skip on a width change (:349-364).
    NCHW."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, GN_EPS, dtype)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm(32, out_channels, GN_EPS, dtype)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.skip = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.skip is None else self.skip(x)) + h


class _VAEEncoder(nn.Module):
    def __init__(self, in_channels: int, base_channels: int, ch_mult: Sequence[int],
                 latent_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        bc, ch = base_channels, base_channels
        self.conv_in = Conv2d(in_channels, bc, 3, padding=1, dtype=dtype)
        self.levels = len(ch_mult)
        for level, mult in enumerate(ch_mult):
            self.add_module(f"enc_{level}_res", VAEResBlock(ch, bc * mult, dtype))
            ch = bc * mult
            if level != len(ch_mult) - 1:
                self.add_module(f"enc_{level}_down",
                                Conv2d(ch, ch, 3, stride=2, padding=1, dtype=dtype))
        self.enc_norm = GroupNorm(32, ch, GN_EPS, dtype)
        self.enc_out = Conv2d(ch, 2 * latent_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in range(self.levels):
            h = getattr(self, f"enc_{level}_res")(h)
            if level != self.levels - 1:
                h = getattr(self, f"enc_{level}_down")(h)
        return self.enc_out(F.silu(self.enc_norm(h)))


class _VAEDecoder(nn.Module):
    def __init__(self, base_channels: int, ch_mult: Sequence[int], latent_channels: int,
                 out_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        bc = base_channels
        ch = bc * ch_mult[-1]
        self.dec_in = Conv2d(latent_channels, ch, 3, padding=1, dtype=dtype)
        self.levels = len(ch_mult)
        for level, mult in reversed(list(enumerate(ch_mult))):
            self.add_module(f"dec_{level}_res", VAEResBlock(ch, bc * mult, dtype))
            ch = bc * mult
            if level:
                self.add_module(f"dec_{level}_up", Conv2d(ch, ch, 3, padding=1, dtype=dtype))
        self.dec_norm = GroupNorm(32, ch, GN_EPS, dtype)
        self.dec_out = Conv2d(ch, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.dec_in(z)
        for level in reversed(range(self.levels)):
            h = getattr(self, f"dec_{level}_res")(h)
            if level:
                h = resize_nearest(h, (2 * h.shape[2], 2 * h.shape[3]), (2, 3))
                h = getattr(self, f"dec_{level}_up")(h)
        return self.dec_out(F.silu(self.dec_norm(h)))


def _normal(shape, noise: Optional[torch.Tensor], generator: Optional[torch.Generator],
            like: torch.Tensor):
    """`noise` (a draw given by the caller, e.g. the JAX package's), else a
    standard normal draw from `generator` in like's dtype, else None."""
    if noise is None and generator is not None:
        noise = torch.randn(shape, generator=generator, device=like.device)
    return None if noise is None else noise.to(like.dtype)


class AutoencoderKL(nn.Module):
    """SD-style KL VAE (:377-446): 2^(len(ch_mult) - 1) x downscale,
    diagonal-Gaussian latents scaled by scaling_factor. Channel-last."""

    def __init__(self, base_channels: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 latent_channels: int = 4, scaling_factor: float = 0.18215,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.encoder = _VAEEncoder(in_channels, base_channels, ch_mult, latent_channels, dtype)
        self.decoder = _VAEDecoder(base_channels, ch_mult, latent_channels, in_channels, dtype)

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Image (B, H, W, C) -> scaled latent: the mean, or a sample with
        `noise` (a standard normal draw of the latent's shape) or a draw from
        `generator` (the JAX method's `rng`)."""
        mean, logvar = nhwc(self.encoder(nchw(x))).chunk(2, dim=-1)
        eps = _normal(mean.shape, noise, generator, mean)
        if eps is None:
            z = mean
        else:
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps
        return z * self.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return nhwc(self.decoder(nchw(z / self.scaling_factor)))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode(x, noise, generator))


# ------------------------------------------------------------------ helpers


def controlnet_params_from_unet(model: nn.Module) -> nn.Module:
    """The ControlNet branch as a copy of the base UNet's time embedding and
    encoder path (:450-467; diffusers ControlNetModel.from_unet), in place,
    for a VQControlNet or a ControlNetCond. Returns the model."""
    cond = getattr(model, "decoder", model)
    with torch.no_grad():
        for key in ("time_embed", "encoder"):
            dst = getattr(cond.controlnet, key).state_dict()
            for name, t in getattr(cond.unet, key).state_dict().items():
                dst[name].copy_(t)
    return model


def vqcontrolnet_trainable_mask(model: nn.Module) -> set:
    """The names of the parameters that train (:470-484): those under a
    `controlnet` module only; the base UNet, the VAE, the encoder, the
    quantizer's projection and the prompt encoding stay frozen."""
    return {n for n, _ in model.named_parameters() if "controlnet" in n.split(".")}


class Token2VAE(nn.Module):
    """Adapter from quantized token latents to SD-VAE latent statistics or
    samples (:487-531; reference lm_models.py:30-160): conv_in, a mid block
    with single-head attention, upsampling ResBlock stages, 8 channels (mean,
    std) or 4 (a sample). Channel-last."""

    def __init__(self, in_channels: int = 32, output_type: str = "stats",
                 block_out_channels: Sequence[int] = (256, 512), layers_per_block: int = 2,
                 latent_channels: int = 4, scaling_factor: float = 0.18215,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_channels, self.layers_per_block = latent_channels, layers_per_block
        out_ch = latent_channels if output_type == "sample" else 2 * latent_channels
        ch = list(reversed(block_out_channels))
        self.stages = len(ch)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1, dtype=dtype)
        self.mid_res_0 = VAEResBlock(ch[0], ch[0], dtype)
        self.mid_attn = SpatialSelfAttention(ch[0], num_heads=1, dtype=dtype)
        self.mid_res_1 = VAEResBlock(ch[0], ch[0], dtype)
        cur, up = ch[0], {}
        for i, c in enumerate(ch):
            for j in range(layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", VAEResBlock(cur, c, dtype))
                cur = c
            if i != len(ch) - 1:
                up[i] = Conv2d(cur, cur, 3, padding=1, dtype=dtype)
        self.up_blocks = _stages("upsamplers", up)
        self.conv_norm_out = GroupNorm(32, cur, GN_EPS, dtype)
        self.conv_out = Conv2d(cur, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, quant: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(nchw(quant))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for i in range(self.stages):
            for j in range(self.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i != self.stages - 1:
                h = resize_nearest(h, (2 * h.shape[2], 2 * h.shape[3]), (2, 3))
                h = self.up_blocks[str(i)]["upsamplers"][0](h)
        return nhwc(self.conv_out(F.silu(self.conv_norm_out(h))))

    def sample(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Statistics (mean, std) -> a latent sample (:525-531): mean + std *
        noise (`noise`, else a draw from `generator`, else 0); a 4-channel
        input passes through."""
        if x.shape[-1] == self.latent_channels:
            return x
        mean, std = x.chunk(2, dim=-1)
        eps = _normal(std.shape, noise, generator, std)
        return mean + std * (0.0 if eps is None else eps)
