"""UViT diffusion decoder, PyTorch port: a conditional UNet with a
Transformer bottleneck.

Counterpart of fourm_tpu/vq/uvit.py (reference fourm/vq/models/uvit.py:45-1104
and the diffusers pieces it borrows: ResnetBlock2D, Down-/Upsample2D,
Timesteps, TimestepEmbedding):
  * patched input (arXiv:2207.04316) and small convolutional down/up stacks;
  * Transformer mid blocks with adaLN modulation and adaLN-Zero gates
    (arXiv:2212.09748), optional U-ViT long skips (arXiv:2209.12152);
  * conditioning by latent concat (TransformerConcatCond) or by
    cross-attention (TransformerXattnCond), with a learned mask token for
    the condition dropout of classifier-free guidance;
  * the SDXL-style original-resolution embedding (arXiv:2307.01952).
The mid blocks' attention cores go through `dot_product_attention`, so at
head dim 64 in bf16 on the card each is one launch of the `attention`
kernel, and in the training forward (`train=True`) one `attention_train`
forward (and its backward), which, unlike `attention`, has a backward. The adaLN modulation sits between each LayerNorm and its product,
so the fused LN kernels do not apply: the products are `_dense`, the
LayerNorms fp32 (flax nn.LayerNorm, eps 1e-6), the GELU exact. The
ResNet GroupNorms take the UViT's norm_eps (1e-5).

Interfaces are channel-last; activations are NCHW inside. Submodule names
are those of the JAX tree as fourm_tpu/utils/checkpoint.py:_vq_torch_name
maps them (`down_blocks.0.resnets.1`, `mid_block.mid_block.3.mlp.fc1`,
`up_blocks.0.upsamplers.0.conv`, ...).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.posemb import build_2d_sincos_posemb
from ..ops.transformer import LayerNorm, Mlp, _dense, dot_product_attention, mask_to_bias
from .layers import Conv2d, ConvTranspose2d, GroupNorm, nchw, nhwc, resize_nearest
from .vit_models import interp_posemb


def modulate(x, shift, scale):
    """AdaLN modulation (reference uvit.py:45-46)."""
    return x * (1 + scale) + shift


def get_timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers Timesteps), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over the sinusoidal embedding (diffusers)."""

    def __init__(self, in_dim: int, time_embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return _dense(F.silu(_dense(sample, self.linear_1, self.dtype)), self.linear_2, self.dtype)


class ResnetBlock2D(nn.Module):
    """GroupNorm-SiLU-Conv twice with the time embedding added between
    (diffusers ResnetBlock2D). NCHW."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, groups: int = 32,
                 eps: float = 1e-5, output_scale_factor: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_scale_factor, self.dtype = output_scale_factor, dtype
        self.norm1 = GroupNorm(groups, in_channels, eps, dtype)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps, dtype)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + _dense(F.silu(temb), self.time_emb_proj, self.dtype)[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return (x + h) / self.output_scale_factor


class Downsample2D(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest resize (x2, or to `out_size`), then a 3x3 convolution."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, out_size=None) -> torch.Tensor:
        size = out_size or (2 * x.shape[2], 2 * x.shape[3])
        return self.conv(resize_nearest(x, size, (2, 3)))


class AdaLNAttention(nn.Module):
    """Multi-head self-attention of the UViT blocks (reference
    uvit.py:129-173); mask True = not attended."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        B, N, C = x.shape
        qkv = _dense(x, self.qkv, self.dtype).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = dot_product_attention(q, k, v, mask_to_bias(mask, N), train=train)
        return _dense(out.transpose(1, 2).reshape(B, N, C), self.proj, self.dtype)


class AdaLNBlock(nn.Module):
    """Transformer block with adaLN modulation, adaLN-Zero gates and an
    optional long-skip input (reference uvit.py:226-254)."""

    def __init__(self, dim: int, num_heads: int, temb_dim: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, skip: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.adaLN_modulation = nn.Linear(temb_dim, 4 * dim)
        self.adaLN_gate = nn.Linear(temb_dim, 2 * dim)
        self.skip_linear = nn.Linear(2 * dim, dim) if skip else None
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = AdaLNAttention(dim, num_heads, qkv_bias, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, temb, mask=None, skip_connection=None, train: bool = False):
        st = F.silu(temb)
        mod = _dense(st, self.adaLN_modulation, self.dtype)[:, None, :]
        shift_msa, scale_msa, shift_mlp, scale_mlp = mod.chunk(4, dim=-1)
        gate_msa, gate_mlp = _dense(st, self.adaLN_gate, self.dtype)[:, None, :].chunk(2, dim=-1)
        if self.skip_linear is not None:
            x = _dense(torch.cat([x, skip_connection], dim=-1), self.skip_linear, self.dtype)
        x = x + gate_msa * self.attn(modulate(self.norm1(x), shift_msa, scale_msa), mask, train)
        h = modulate(self.norm2(x), shift_mlp, scale_mlp)
        return x + gate_mlp * self.mlp(h)


class _CrossAttn(nn.Module):
    """The cross-attention products of AdaLNDecoderBlock (`xattn_q`,
    `xattn_kv`, `xattn_proj`, the reference's cross_attn.q / kv / proj)."""

    def __init__(self, dim: int, dim_context: int, qkv_bias: bool):
        super().__init__()
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim_context, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class AdaLNDecoderBlock(nn.Module):
    """adaLN transformer block with cross-attention to a conditioning
    sequence (reference uvit.py:256-289)."""

    def __init__(self, dim: int, num_heads: int, dim_context: int, temb_dim: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, skip: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.adaLN_modulation = nn.Linear(temb_dim, 6 * dim)
        self.adaLN_gate = nn.Linear(temb_dim, 3 * dim)
        self.skip_linear = nn.Linear(2 * dim, dim) if skip else None
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.self_attn = AdaLNAttention(dim, num_heads, qkv_bias, dtype)
        self.query_norm = LayerNorm(dim, dtype=dtype)
        self.context_norm = LayerNorm(dim_context, dtype=dtype)
        self.cross_attn = _CrossAttn(dim, dim_context, qkv_bias)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, context, temb, xa_mask=None, skip_connection=None,
                train: bool = False):
        dt = self.dtype
        st = F.silu(temb)
        (shift_msa, scale_msa, shift_mxa, scale_mxa, shift_mlp,
         scale_mlp) = _dense(st, self.adaLN_modulation, dt)[:, None, :].chunk(6, dim=-1)
        gate_msa, gate_mxa, gate_mlp = _dense(st, self.adaLN_gate, dt)[:, None, :].chunk(3, -1)
        if self.skip_linear is not None:
            x = _dense(torch.cat([x, skip_connection], dim=-1), self.skip_linear, dt)
        x = x + gate_msa * self.self_attn(modulate(self.norm1(x), shift_msa, scale_msa),
                                          train=train)
        B, N, D = x.shape
        M, H = context.shape[1], self.num_heads
        hq = modulate(self.query_norm(x), shift_mxa, scale_mxa)
        xa = self.cross_attn
        q = _dense(hq, xa.q, dt).reshape(B, N, H, D // H).transpose(1, 2)
        kv = _dense(self.context_norm(context), xa.kv, dt).reshape(B, M, 2, H, D // H)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        out = dot_product_attention(q, k, v, mask_to_bias(xa_mask, N), train=train)
        x = x + gate_mxa * _dense(out.transpose(1, 2).reshape(B, N, D), xa.proj, dt)
        h = modulate(self.norm2(x), shift_mlp, scale_mlp)
        return x + gate_mlp * self.mlp(h)


def _run_blocks(blocks, x, args, use_long_skip: bool, train: bool = False):
    """The mid blocks in order; with long skips the second half's blocks take
    the first half's outputs, last in first out (U-ViT)."""
    if not use_long_skip:
        for blk in blocks:
            x = blk(x, *args, train=train)
        return x
    n = len(blocks) // 2
    skips = []
    for blk in blocks[:n]:
        x = blk(x, *args, train=train)
        skips.append(x)
    x = blocks[n](x, *args, train=train)
    for blk in blocks[n + 1:]:
        x = blk(x, *args, skip_connection=skips.pop(), train=train)
    return x


class TransformerConcatCond(nn.Module):
    """UViT bottleneck with latent-concat conditioning (reference
    uvit.py:291-412)."""

    def __init__(self, unet_dim: int, cond_dim: int, mid_layers: int = 12,
                 mid_num_heads: int = 12, mid_dim: int = 768, mid_mlp_ratio: float = 4.0,
                 mid_qkv_bias: bool = True, time_embed_dim: int = 512, hw_posemb: int = 16,
                 use_long_skip: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mid_dim, self.hw_posemb, self.dtype = mid_dim, hw_posemb, dtype
        self.use_long_skip = use_long_skip
        self.mid_proj_in = nn.Linear(unet_dim, mid_dim)
        self.mid_cond_proj = nn.Linear(cond_dim, mid_dim)
        self.mask_token = nn.Parameter(torch.zeros(mid_dim))
        self.mid_block = nn.ModuleList(
            AdaLNBlock(mid_dim, mid_num_heads, time_embed_dim, mid_mlp_ratio, mid_qkv_bias,
                       skip=(i > mid_layers // 2 and use_long_skip), dtype=dtype)
            for i in range(mid_layers))
        self.mid_proj_out = nn.Linear(mid_dim, unet_dim)
        self._pos = {}  # (H, W, device) -> (1, H*W, mid_dim)

    def pos_table(self, H: int, W: int, device) -> torch.Tensor:
        """The sin-cos grid of hw_posemb, resized bicubically to (H, W) as
        jax.image.resize does (reference uvit.py:389)."""
        key = (H, W, str(device))
        if key not in self._pos:
            n = self.hw_posemb
            pos = build_2d_sincos_posemb(n, n, self.mid_dim).reshape(n, n, -1)
            self._pos[key] = interp_posemb(pos, H, W).reshape(1, H * W, -1).to(device)
        return self._pos[key]

    def forward(self, x, temb, cond, cond_mask=None, train: bool = False):
        B, _, H, W = x.shape
        dt = self.dtype
        x = _dense(x.flatten(2).transpose(1, 2), self.mid_proj_in, dt)
        # the condition as tokens at the mid resolution (nearest, uvit.py:377)
        cond = resize_nearest(cond, (H, W), (1, 2)).reshape(B, H * W, -1)
        cond = _dense(cond, self.mid_cond_proj, dt)
        if cond_mask is not None:
            # condition dropout: masked positions take the learned mask token
            cm = resize_nearest(cond_mask.float()[..., None], (H, W), (1, 2))
            cond = torch.where(cm.reshape(B, H * W, 1) > 0.5, self.mask_token.to(cond.dtype),
                               cond)
        x = x + cond
        x = x + self.pos_table(H, W, x.device).to(x.dtype)
        x = _run_blocks(self.mid_block, x, (temb,), self.use_long_skip, train)
        x = _dense(x, self.mid_proj_out, dt)
        return x.transpose(1, 2).reshape(B, -1, H, W)


class TransformerXattnCond(nn.Module):
    """UViT bottleneck with cross-attention conditioning (reference
    uvit.py:413-527)."""

    def __init__(self, unet_dim: int, cond_dim: int, mid_layers: int = 12,
                 mid_num_heads: int = 12, mid_dim: int = 768, mid_mlp_ratio: float = 4.0,
                 mid_qkv_bias: bool = True, time_embed_dim: int = 512, hw_posemb: int = 16,
                 use_long_skip: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mid_dim, self.hw_posemb, self.dtype = mid_dim, hw_posemb, dtype
        self.use_long_skip = use_long_skip
        self.mid_proj_in = nn.Linear(unet_dim, mid_dim)
        self.mid_block = nn.ModuleList(
            AdaLNDecoderBlock(mid_dim, mid_num_heads, cond_dim, time_embed_dim, mid_mlp_ratio,
                              mid_qkv_bias, skip=(i > mid_layers // 2 and use_long_skip),
                              dtype=dtype)
            for i in range(mid_layers))
        self.mid_proj_out = nn.Linear(mid_dim, unet_dim)

    def forward(self, x, temb, cond, cond_mask=None, train: bool = False):
        B, _, H, W = x.shape
        dt = self.dtype
        x = _dense(x.flatten(2).transpose(1, 2), self.mid_proj_in, dt)
        n = self.hw_posemb
        pos = build_2d_sincos_posemb(n, n, self.mid_dim).reshape(n, n, -1)
        pos = resize_nearest(pos, (H, W), (0, 1)).reshape(1, H * W, -1)
        x = x + pos.to(device=x.device, dtype=x.dtype)
        ctx = cond.reshape(B, cond.shape[1] * cond.shape[2], cond.shape[-1])
        xa_mask = None if cond_mask is None else cond_mask.reshape(B, 1, -1)  # True = masked
        x = _run_blocks(self.mid_block, x, (ctx, temb, xa_mask), self.use_long_skip, train)
        x = _dense(x, self.mid_proj_out, dt)
        return x.transpose(1, 2).reshape(B, -1, H, W)


class _Stage(nn.Module):
    """One down or up stage: its ResNet blocks and an optional resampler,
    under the reference's names (resnets.<j>, down-/upsamplers.0)."""

    def __init__(self, resnets, sampler_kind: str, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.sampler_kind = sampler_kind
        if sampler is not None:
            self.add_module(sampler_kind, nn.ModuleList([sampler]))

    @property
    def sampler(self):
        samplers = self._modules.get(self.sampler_kind)
        return None if samplers is None else samplers[0]


class UViT(nn.Module):
    """Conditional UViT diffusion model (reference uvit.py:528-974).

    forward(sample (B, H, W, C), timestep (B,) or a scalar, condition
    (B, Hc, Wc, Dc), cond_mask (B, Hc, Wc) bool, orig_res (B, 2),
    unconditional, train) -> (B, H, W, out_channels), channel-last."""

    def __init__(self, sample_size: Optional[int] = None, in_channels: int = 3,
                 out_channels: int = 3, patch_size: int = 4,
                 block_out_channels: Sequence[int] = (128, 256, 512), layers_per_block: int = 2,
                 downsample_before_mid: bool = False, mid_layers: int = 12,
                 mid_num_heads: int = 12, mid_dim: int = 768, mid_mlp_ratio: float = 4.0,
                 mid_qkv_bias: bool = True, mid_hw_posemb: int = 32,
                 mid_use_long_skip: bool = False, cond_dim: int = 32, cond_type: str = "concat",
                 norm_num_groups: int = 32, norm_eps: float = 1e-5,
                 resnet_out_scale_factor: float = 1.0, flip_sin_to_cos: bool = True,
                 freq_shift: float = 0.0, res_embedding: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch0 = block_out_channels[0]
        temb = ch0 * 4
        self.ch0, self.dtype = ch0, dtype
        self.flip_sin_to_cos, self.freq_shift = flip_sin_to_cos, freq_shift
        self.downsample_before_mid = downsample_before_mid
        self.time_embedding = TimestepEmbedding(ch0, temb, dtype)
        if res_embedding:
            self.height_embedding = TimestepEmbedding(ch0, temb, dtype)
            self.width_embedding = TimestepEmbedding(ch0, temb, dtype)
        self.res_embedding = res_embedding
        self.conv_in = Conv2d(in_channels, ch0, patch_size, stride=patch_size, dtype=dtype)

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, temb, norm_num_groups, norm_eps,
                                 resnet_out_scale_factor, dtype)

        n_blocks = len(block_out_channels)
        res_ch, ch, downs = [ch0], ch0, []
        for i, out_ch in enumerate(block_out_channels):
            resnets = []
            for _ in range(layers_per_block):
                resnets.append(resnet(ch, out_ch))
                ch = out_ch
                res_ch.append(ch)
            sampler = Downsample2D(out_ch, dtype) if i < n_blocks - 1 else None
            if sampler is not None:
                res_ch.append(ch)
            downs.append(_Stage(resnets, "downsamplers", sampler))
        self.down_blocks = nn.ModuleList(downs)
        if downsample_before_mid:
            self.downsample_mid = Downsample2D(block_out_channels[-1], dtype)
        mid_cls = TransformerConcatCond if cond_type == "concat" else TransformerXattnCond
        self.mid_block = mid_cls(block_out_channels[-1], cond_dim, mid_layers, mid_num_heads,
                                 mid_dim, mid_mlp_ratio, mid_qkv_bias, temb, mid_hw_posemb,
                                 mid_use_long_skip, dtype)
        if downsample_before_mid:
            self.upsample_mid = Upsample2D(block_out_channels[-1], dtype)
        ups = []
        for i, out_ch in enumerate(reversed(block_out_channels)):
            resnets = []
            for _ in range(layers_per_block + 1):
                resnets.append(resnet(ch + res_ch.pop(), out_ch))
                ch = out_ch
            ups.append(_Stage(resnets, "upsamplers",
                              Upsample2D(out_ch, dtype) if i < n_blocks - 1 else None))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(norm_num_groups, ch, norm_eps, dtype)
        # torch ConvTranspose2d semantics: flax's transpose_kernel=True
        self.conv_out = ConvTranspose2d(ch, out_channels, patch_size, patch_size, dtype)

    def _embed(self, values, B: int, device) -> torch.Tensor:
        v = torch.as_tensor(values, dtype=torch.float32, device=device).reshape(-1).expand(B)
        return get_timestep_embedding(v, self.ch0, self.flip_sin_to_cos,
                                      self.freq_shift).to(self.dtype)

    def forward(self, sample: torch.Tensor, timestep, condition: torch.Tensor,
                cond_mask: Optional[torch.Tensor] = None, orig_res=None,
                unconditional: bool = False, train: bool = False) -> torch.Tensor:
        B, dev = sample.shape[0], sample.device
        emb = self.time_embedding(self._embed(timestep, B, dev))
        if self.res_embedding and orig_res is not None:
            orig_res = torch.as_tensor(orig_res, device=dev)
            emb = emb + self.height_embedding(self._embed(orig_res[..., 0], B, dev))
            emb = emb + self.width_embedding(self._embed(orig_res[..., 1], B, dev))
        # the unconditional pass of CFG masks the whole condition
        if unconditional:
            cond_mask = torch.ones(condition.shape[:3], dtype=torch.bool, device=dev)
        x = self.conv_in(nchw(sample))
        res_stack = [x]
        for stage in self.down_blocks:
            for blk in stage.resnets:
                x = blk(x, emb)
                res_stack.append(x)
            if stage.sampler is not None:
                x = stage.sampler(x)
                res_stack.append(x)
        if self.downsample_before_mid:
            x = self.downsample_mid(x)
        x = self.mid_block(x, emb, condition.to(self.dtype), cond_mask, train)
        if self.downsample_before_mid:
            x = self.upsample_mid(x)
        for stage in self.up_blocks:
            for blk in stage.resnets:
                x = blk(torch.cat([x, res_stack.pop()], dim=1), emb)
            if stage.sampler is not None:
                x = stage.sampler(x, res_stack[-1].shape[2:])
        x = F.silu(self.conv_norm_out(x))
        return nhwc(self.conv_out(x))


# Presets (reference uvit.py:976-1104; uvit_t_p4_f16 is the JAX package's
# test size)
UVIT_PRESETS = {
    "uvit_t_p4_f16": dict(patch_size=4, block_out_channels=(32, 64), layers_per_block=1,
                          downsample_before_mid=True, mid_layers=2, mid_num_heads=2, mid_dim=64),
    "uvit_b_p4_f16": dict(patch_size=4, block_out_channels=(128, 256), layers_per_block=2,
                          downsample_before_mid=True, mid_layers=12, mid_num_heads=12,
                          mid_dim=768),
    "uvit_l_p4_f16": dict(patch_size=4, block_out_channels=(128, 256), layers_per_block=2,
                          downsample_before_mid=True, mid_layers=24, mid_num_heads=16,
                          mid_dim=1024),
    "uvit_h_p4_f16": dict(patch_size=4, block_out_channels=(128, 256), layers_per_block=2,
                          downsample_before_mid=True, mid_layers=32, mid_num_heads=16,
                          mid_dim=1280),
    "uvit_b_p4_f16_longskip": dict(patch_size=4, block_out_channels=(128, 256),
                                   layers_per_block=2, downsample_before_mid=True,
                                   mid_layers=13, mid_num_heads=12, mid_dim=768,
                                   mid_use_long_skip=True),
    "uvit_l_p4_f16_longskip": dict(patch_size=4, block_out_channels=(128, 256),
                                   layers_per_block=2, downsample_before_mid=True,
                                   mid_layers=25, mid_num_heads=16, mid_dim=1024,
                                   mid_use_long_skip=True),
    "uvit_b_p4_f8": dict(patch_size=4, block_out_channels=(128, 256), layers_per_block=2,
                         downsample_before_mid=False, mid_layers=12, mid_num_heads=12,
                         mid_dim=768),
    "uvit_l_p4_f8": dict(patch_size=4, block_out_channels=(128, 256), layers_per_block=2,
                         downsample_before_mid=False, mid_layers=24, mid_num_heads=16,
                         mid_dim=1024),
    "uvit_b_p4_f16_extraconv": dict(patch_size=4, block_out_channels=(128, 256, 512),
                                    layers_per_block=2, downsample_before_mid=False,
                                    mid_layers=12, mid_num_heads=12, mid_dim=768),
    "uvit_l_p4_f16_extraconv": dict(patch_size=4, block_out_channels=(128, 256, 512),
                                    layers_per_block=2, downsample_before_mid=False,
                                    mid_layers=24, mid_num_heads=16, mid_dim=1024),
}


def build_uvit(preset: str, **kwargs) -> UViT:
    return UViT(**{**UVIT_PRESETS[preset], **kwargs})
