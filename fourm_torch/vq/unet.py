"""ADM-style UNet diffusion decoder ("unet_patched"), PyTorch port: the
decoder of the released 4M-21 RGB, depth, normal and edge DiVAE tokenizers.

Counterpart of fourm_tpu/vq/unet.py (reference
fourm/vq/models/unet/unet.py:103-752): guided-diffusion ResBlocks
(GroupNorm-SiLU-Conv with timestep injection, optional scale-shift norm),
single-head spatial self-attention with the legacy double-sqrt scaling at
the chosen downsampling ratios, zero-initialised output convolutions, and
the PatchedUNetCondCat wrapper that patchifies the input and concatenates
the nearest-upsampled conditioning (arXiv:2207.04316). Every GroupNorm has
flax's default epsilon, 1e-6. The attention is plain matmul + softmax, as
the JAX module's XLA einsums (no Pallas kernel computes it).

Interfaces are channel-last, as the JAX module's; activations are NCHW
inside. Submodule names are those of the JAX tree as
fourm_tpu/utils/checkpoint.py:_vq_torch_name maps them (`down_0_res_1`,
`down_blocks.0.downsamplers.0`, `up_blocks.3.upsamplers.0`, ...), so the
weight bridge's state dict loads with strict=True.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.transformer import _dense
from .layers import Conv2d, GroupNorm, nchw, nhwc, resize_nearest

GN_EPS = 1e-6  # flax nn.GroupNorm's default epsilon


def adm_timestep_embedding(timesteps: torch.Tensor, dim: int,
                           max_period: float = 10000.0) -> torch.Tensor:
    """Guided-diffusion sinusoidal embedding: cat([cos, sin]), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class ADMResBlock(nn.Module):
    """Reference unet.py:163-275 (no up/down variant: 4M resamples with
    convolutions). NCHW."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 use_scale_shift_norm: bool = False, groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_scale_shift_norm, self.dtype = use_scale_shift_norm, dtype
        self.in_norm = GroupNorm(groups, in_channels, GN_EPS, dtype)
        self.in_conv = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.emb_proj = nn.Linear(time_dim, 2 * out_channels if use_scale_shift_norm
                                  else out_channels)
        self.out_norm = GroupNorm(groups, out_channels, GN_EPS, dtype)
        self.out_conv = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.skip = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(F.silu(self.in_norm(x)))
        e = _dense(F.silu(emb), self.emb_proj, self.dtype)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = self.out_norm(h) * (1 + scale) + shift
        else:
            h = self.out_norm(h + e)
        h = self.out_conv(F.silu(h))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class ADMAttentionBlock(nn.Module):
    """Spatial self-attention (reference unet.py:277-375, the legacy qkv
    order: per head, q, k and v of hd channels each). NCHW."""

    def __init__(self, channels: int, num_heads: int = 1, groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.norm = GroupNorm(groups, channels, GN_EPS, dtype)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        hd = C // self.num_heads
        h = self.norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        qkv = _dense(h, self.qkv, self.dtype).reshape(B, H * W, self.num_heads, 3, hd)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))  # (B, nh, N, hd)
        scale = 1.0 / math.sqrt(math.sqrt(hd))  # legacy double-sqrt scaling
        # the products of dtype values summed in fp32 (preferred_element_type)
        logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, H * W, C)
        out = _dense(out, self.proj_out, self.dtype)
        return x + out.transpose(1, 2).reshape(B, C, H, W)


def _stages(kind: str, convs: dict) -> nn.ModuleDict:
    """The resampling convolutions under the reference's names
    (`down_blocks.<level>.downsamplers.0`, `up_blocks.<level>.upsamplers.0`)."""
    return nn.ModuleDict({str(level): nn.ModuleDict({kind: nn.ModuleList([conv])})
                          for level, conv in convs.items()})


class UNetModel(nn.Module):
    """ADM UNet (reference unet.py:411-692). Input (B, H, W, in_channels),
    output (B, H, W, out_channels), channel-last."""

    def __init__(self, in_channels: int = 3, model_channels: int = 256, out_channels: int = 3,
                 num_res_blocks: int = 3, attention_resolutions: Sequence[int] = (8, 16),
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_heads: int = 1,
                 use_scale_shift_norm: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        mc, self.dtype = model_channels, dtype
        self.model_channels = mc
        time_dim = mc * 4
        self.time_embed_0 = nn.Linear(mc, time_dim)
        self.time_embed_2 = nn.Linear(time_dim, time_dim)
        ch = int(channel_mult[0] * mc)
        self.input_conv = Conv2d(in_channels, ch, 3, padding=1, dtype=dtype)

        def res(name, cin, cout):
            self.add_module(name, ADMResBlock(cin, cout, time_dim, use_scale_shift_norm,
                                              dtype=dtype))

        def attn(name, c):
            self.add_module(name, ADMAttentionBlock(c, num_heads, dtype=dtype))

        # the forward's steps in order: ("res" | "attn", module name), ("down"
        # | "up", level), ("push" | "pop", None) for the skip stack
        self.plan = []
        hs_ch, ds, down, up = [ch], 1, {}, {}
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                res(f"down_{level}_res_{i}", ch, int(mult * mc))
                ch = int(mult * mc)
                self.plan.append(("res", f"down_{level}_res_{i}"))
                if ds in attention_resolutions:
                    attn(f"down_{level}_attn_{i}", ch)
                    self.plan.append(("attn", f"down_{level}_attn_{i}"))
                self.plan.append(("push", None))
                hs_ch.append(ch)
            if level != len(channel_mult) - 1:
                down[level] = Conv2d(ch, ch, 3, stride=2, padding=1, dtype=dtype)
                self.plan += [("down", level), ("push", None)]
                hs_ch.append(ch)
                ds *= 2
        res("mid_res_0", ch, ch)
        attn("mid_attn", ch)
        res("mid_res_1", ch, ch)
        self.plan += [("res", "mid_res_0"), ("attn", "mid_attn"), ("res", "mid_res_1")]
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                res(f"up_{level}_res_{i}", ch + hs_ch.pop(), int(mult * mc))
                ch = int(mult * mc)
                self.plan += [("pop", None), ("res", f"up_{level}_res_{i}")]
                if ds in attention_resolutions:
                    attn(f"up_{level}_attn_{i}", ch)
                    self.plan.append(("attn", f"up_{level}_attn_{i}"))
                if level and i == num_res_blocks:
                    up[level] = Conv2d(ch, ch, 3, padding=1, dtype=dtype)
                    self.plan.append(("up", level))
                    ds //= 2
        self.down_blocks = _stages("downsamplers", down)
        self.up_blocks = _stages("upsamplers", up)
        self.out_norm = GroupNorm(32, ch, GN_EPS, dtype)
        self.out_conv = Conv2d(ch, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, timesteps) -> torch.Tensor:
        B = x.shape[0]
        t = torch.as_tensor(timesteps, device=x.device).reshape(-1).expand(B)
        emb = adm_timestep_embedding(t, self.model_channels)
        emb = _dense(emb, self.time_embed_0, self.dtype)
        emb = _dense(F.silu(emb), self.time_embed_2, self.dtype)
        h = self.input_conv(nchw(x))
        hs = [h]
        for op, arg in self.plan:
            if op == "res":
                h = getattr(self, arg)(h, emb)
            elif op == "attn":
                h = getattr(self, arg)(h)
            elif op == "push":
                hs.append(h)
            elif op == "pop":
                h = torch.cat([h, hs.pop()], dim=1)
            elif op == "down":
                h = self.down_blocks[str(arg)]["downsamplers"][0](h)
            else:  # up: nearest x2, then a 3x3 convolution
                h = resize_nearest(h, (2 * h.shape[2], 2 * h.shape[3]), (2, 3))
                h = self.up_blocks[str(arg)]["upsamplers"][0](h)
        h = self.out_conv(F.silu(self.out_norm(h)))
        return nhwc(h)


class PatchedUNetCondCat(nn.Module):
    """Patched UNet with the conditioning concatenated to the patchified
    input (reference unet.py:693-747). Interface of UViT: forward(sample
    (B, H, W, C), timestep, condition (B, Hc, Wc, Dc), cond_mask (B, Hc, Wc)
    bool, orig_res (unused), unconditional)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, cond_dim: int = 32,
                 patch_size: int = 4, model_channels: int = 256, num_res_blocks: int = 3,
                 attention_resolutions: Sequence[int] = (4, 8),
                 channel_mult: Sequence[int] = (1, 2, 2, 2), use_scale_shift_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        P = patch_size
        self.patch_size, self.out_channels, self.dtype = P, out_channels, dtype
        self.unet = UNetModel(in_channels * P * P + cond_dim, model_channels,
                              out_channels * P * P, num_res_blocks, attention_resolutions,
                              channel_mult, use_scale_shift_norm=use_scale_shift_norm,
                              dtype=dtype)

    def forward(self, sample: torch.Tensor, timestep, condition: torch.Tensor,
                cond_mask: Optional[torch.Tensor] = None, orig_res=None,
                unconditional: bool = False, train: bool = False) -> torch.Tensor:
        """`train` changes nothing: the UNet has no kernel and no dropout,
        its forward is differentiable as it is."""
        B, H, W, C = sample.shape
        P = self.patch_size
        nh, nw = H // P, W // P
        # patchify, channel-major: 'b c (nh ph) (nw pw) -> b (c ph pw) nh nw'
        x = sample.reshape(B, nh, P, nw, P, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, nh, nw, C * P * P)
        if unconditional:
            cond_mask = torch.ones(condition.shape[:3], dtype=torch.bool, device=sample.device)
        if cond_mask is not None:
            condition = torch.where(cond_mask[..., None], 0.0, condition)
        cond_up = resize_nearest(condition, (nh, nw), (1, 2))
        x = torch.cat([x.to(self.dtype), cond_up.to(self.dtype)], dim=-1)
        out = self.unet(x, timestep)
        out = out.reshape(B, nh, nw, self.out_channels, P, P).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(B, H, W, self.out_channels)


def unet_patched(in_channels: int = 3, out_channels: int = 3, cond_dim: int = 32,
                 dtype: torch.dtype = torch.float32, **kw) -> PatchedUNetCondCat:
    """Reference preset unet.py:748-757."""
    return PatchedUNetCondCat(in_channels=in_channels, out_channels=out_channels,
                              cond_dim=cond_dim, patch_size=4, model_channels=256,
                              num_res_blocks=3, attention_resolutions=(4, 8),
                              channel_mult=(1, 2, 2, 2), dtype=dtype, **kw)
