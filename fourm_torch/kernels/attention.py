"""Attention: `flash_mha` on heads-concatenated (B, N, C) q/k/v with in-kernel
QK-norm, `mha_short` on a fused (B, N, 3C) QKV output, `attention` on
(B, H, N, Dh) with an fp32 additive bias, and `attn_block`, the whole
pre-norm attention half of a block in one call.

Counterparts of fourm_tpu/kernels/attention.py: `flash_mha` is
pallas_flash_mha, `mha_short` is pallas_mha_short, `attention` is
pallas_attention and, having no size split, also its blocked form
flash_attention; those three wrappers launch one CUDA kernel body
(csrc/attention.cu). `attn_block` is pallas_attn_block (csrc/attn_block.cu).
Both sources are TMA-fed wgmma kernels built on one attention core
(csrc/attn_sm90.cuh); a wrapper counts one launch per call, whatever number
of CUDA kernels it runs (a QK-norm pre-pass; attn_block's LN rows, heads and
projection kernels).
Each wrapper counts its launches in `<wrapper>.launches`, raises on a CUDA
call its predicate (`attention_takes`, `flash_mha_takes`, `mha_short_takes`,
`attn_block_takes`) refuses, and computes its plain PyTorch twin for CPU
tensors.

Masked logits carry the finite bias finfo(f32).min, so a row whose keys are
all masked gets uniform weights, never NaN. The twins are the XLA path of
the JAX package (fourm_tpu/ops/transformer.py:dot_product_attention):
logits in fp32, scale then bias, softmax (or softmax1) in fp32,
probabilities cast to v's dtype, products summed in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._checks import aligned, all_bf16, f32, ptr, require, require_cuda, require_takes, stream
from .fused_mlp import _mm, layer_norm_fp32


def softmax1(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax with an implicit extra zero logit (reference fm_utils.py:28-30)."""
    m = torch.clamp_min(logits.amax(dim=dim, keepdim=True), 0.0)
    e = torch.exp(logits - m)
    return e / (e.sum(dim=dim, keepdim=True) + torch.exp(-m))


def attention_plain(q, k, v, bias=None, allow_zero_attn: bool = False) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = softmax1(logits) if allow_zero_attn else torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _strides_ok(t: torch.Tensor) -> bool:
    return t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1]) and aligned(t, 16)


def attention_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether csrc/attention.cu takes attention(q, k, v), from dtypes and
    shapes alone: bf16, head dim 64, rows read through strides that are
    multiples of 8 with a contiguous last dim, 16-byte aligned."""
    return (all_bf16(q, k, v) and q.shape[-1] == 64 and all(_strides_ok(t) for t in (q, k, v))
            and max(t.numel() for t in (q, k, v)) < 2**31)


def _launch(name, q, k, v, o, qs, ks, vs, os_, bias, bs, norms, B, H, N, M, Dh, eps,
            allow_zero_attn, dev, stats=None):
    """One call of csrc/attention.cu's entry; `stats`, fp32 (B, H, N, 2)
    contiguous or None, gets each row's statistics (attention_train_fwd)."""
    from . import _build

    # QK-norm: the kernel's pre-pass writes LN(k) (B, M, H, 64) here once,
    # and the attention kernel reads it back (it normalises its q tiles)
    scratch = None
    if norms[0] is not None:
        scratch = torch.empty((B * M * H, Dh), dtype=q.dtype, device=dev)
    code = _build.entry("attention")(
        ptr(q), ptr(k), ptr(v), ptr(o), *qs, *ks, *vs, *os_, ptr(bias), *bs,
        *[ptr(t) for t in norms], ptr(scratch), B, H, N, M, float(Dh) ** -0.5, float(eps),
        int(allow_zero_attn), ptr(stats), stream(dev))
    _build.check(name, code)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              allow_zero_attn: bool = False) -> torch.Tensor:
    """softmax(q k^T * Dh^-0.5 + bias) v. q: (B, H, N, Dh); k, v: (B, H, M, Dh);
    bias: fp32, broadcastable as (B, 1|H, N|1, M). Returns (B, H, N, Dh) in
    q.dtype; on CUDA it is a (B, N, H, Dh) buffer seen through a permute, so
    moving heads back next to channels is free."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, allow_zero_attn)
    name = "attention"
    dev = require_cuda(name, q, k, v, bias)
    B, H, N, Dh = q.shape
    M = k.shape[2]
    require(tuple(k.shape) == (B, H, M, Dh) and tuple(v.shape) == (B, H, M, Dh),
            f"{name}: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q")
    bs = (0, 0, 0, 0)
    if bias is not None:
        require(bias.dtype == torch.float32, f"{name}: bias must be fp32")
        require(bias.ndim == 4 and bias.shape[-1] == M
                and all(bias.shape[i] in (1, (B, H, N)[i]) for i in range(3)),
                f"{name}: bias {tuple(bias.shape)} not broadcastable to ({B}, {H}, {N}, {M})")
    require_takes(name, attention_takes(q, k, v), q, k, v)
    if bias is not None:
        # stride 0 on broadcast axes: (B, 1, 1, M) is never materialised
        bs = tuple(0 if bias.shape[i] == 1 else bias.stride(i) for i in range(4))
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=dev)
    _launch(name, q, k, v, out, q.stride()[:3], k.stride()[:3], v.stride()[:3],
            (out.stride(0), out.stride(2), out.stride(1)), bias, bs,
            (None, None, None, None), B, H, N, M, Dh, 1e-6, allow_zero_attn, dev)
    attention.launches += 1
    return out.permute(0, 2, 1, 3)


attention.launches = 0


def flash_mha_plain(q, k, v, num_heads: int, bias=None, qn_gamma=None, qn_beta=None,
                    kn_gamma=None, kn_beta=None, eps: float = 1e-6,
                    allow_zero_attn: bool = False) -> torch.Tensor:
    B, N, C = q.shape
    M = k.shape[1]
    Dh = C // num_heads
    qh = q.reshape(B, N, num_heads, Dh).transpose(1, 2)
    kh = k.reshape(B, M, num_heads, Dh).transpose(1, 2)
    vh = v.reshape(B, M, num_heads, Dh).transpose(1, 2)
    if qn_gamma is not None:
        qh = layer_norm_fp32(qh.float(), qn_gamma, qn_beta, eps).to(q.dtype)
        kh = layer_norm_fp32(kh.float(), kn_gamma, kn_beta, eps).to(k.dtype)
    b4 = None if bias is None else bias.float()[:, None, None, :]
    out = attention_plain(qh, kh, vh, b4, allow_zero_attn)
    return out.transpose(1, 2).reshape(B, N, C)


def flash_mha_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> bool:
    """Whether csrc/attention.cu takes heads-concatenated (B, N, C) q and
    (B, M, C) k, v, from dtypes and shapes alone: bf16, C = 64 x num_heads,
    strides that are multiples of 8 with a contiguous last dim, 16-byte
    aligned."""
    return (all_bf16(q, k, v) and q.shape[-1] == 64 * num_heads
            and all(_strides_ok(t) for t in (q, k, v))
            and max(t.storage_offset() + t.stride(0) * t.shape[0] for t in (q, k, v)) < 2**31)


def _heads_checks(name, q, k, v, num_heads, bias, norms):
    """Checks of the attention.cu kernel on heads-concatenated (B, N, C) q
    and (B, M, C) k, v: flash_mha_takes, matching shapes, an fp32 (B, M)
    bias, QK-norm with both gammas."""
    require_cuda(name, q, k, v, bias, *norms)
    require_takes(name, flash_mha_takes(q, k, v, num_heads), q, k, v)
    B, N, C = q.shape
    M = k.shape[1]
    require(tuple(k.shape) == (B, M, C) and tuple(v.shape) == (B, M, C),
            f"{name}: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q")
    require(norms[0] is None or norms[2] is not None, f"{name}: QK-norm needs both gammas")
    if bias is not None:
        require(bias.dtype == torch.float32 and tuple(bias.shape) == (B, M),
                f"{name}: bias must be fp32 ({B}, {M}), got {bias.dtype} {tuple(bias.shape)}")


def _heads_launch(name, q, k, v, num_heads, bias, norms, eps, allow_zero_attn):
    """Launch of the attention.cu kernel on heads-concatenated (B, N, C) q and
    (B, M, C) k, v read through their strides (checked by _heads_checks)."""
    dev = q.device
    B, N, C = q.shape
    M = k.shape[1]
    Dh = C // num_heads
    bs = (0, 0, 0, 0)
    if bias is not None:
        bs = (bias.stride(0), 0, 0, bias.stride(1))
    out = torch.empty((B, N, C), dtype=q.dtype, device=dev)
    # fp32 LN parameters on 16-byte boundaries: the kernels read them as float4
    norms = tuple(None if t is None else t if aligned(t, 16) else t.clone()
                  for t in (f32(u) for u in norms))
    _launch(name, q, k, v, out, (q.stride(0), Dh, q.stride(1)), (k.stride(0), Dh, k.stride(1)),
            (v.stride(0), Dh, v.stride(1)), (out.stride(0), Dh, out.stride(1)), bias, bs,
            norms, B, num_heads, N, M, Dh, eps, allow_zero_attn, dev)
    return out


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              bias: Optional[torch.Tensor] = None, qn_gamma=None, qn_beta=None,
              kn_gamma=None, kn_beta=None, eps: float = 1e-6,
              allow_zero_attn: bool = False) -> torch.Tensor:
    """Multi-head attention on (B, N, C) heads-concatenated q and (B, M, C)
    k, v (e.g. column slices of a fused QKV output, read through their
    strides), with optional per-head QK-norm (fp32 LN over Dh, cast to the
    compute dtype) and an fp32 (B, M) additive key bias. Returns (B, N, C)."""
    norms = (qn_gamma, qn_beta, kn_gamma, kn_beta)
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, num_heads, bias, *norms, eps, allow_zero_attn)
    _heads_checks("flash_mha", q, k, v, num_heads, bias, norms)
    out = _heads_launch("flash_mha", q, k, v, num_heads, bias, norms, eps, allow_zero_attn)
    flash_mha.launches += 1
    return out


flash_mha.launches = 0


def _split3(qkv: torch.Tensor):
    C = qkv.shape[-1] // 3
    return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]


def mha_short_takes(qkv: torch.Tensor, num_heads: int) -> bool:
    """flash_mha_takes on the three column slices of a fused QKV output."""
    return flash_mha_takes(*_split3(qkv), num_heads)


def mha_short_plain(qkv, num_heads: int, bias=None, allow_zero_attn: bool = False):
    return flash_mha_plain(*_split3(qkv), num_heads, bias, allow_zero_attn=allow_zero_attn)


def mha_short(qkv: torch.Tensor, num_heads: int, bias: Optional[torch.Tensor] = None,
              allow_zero_attn: bool = False) -> torch.Tensor:
    """Multi-head self-attention straight from a fused (B, N, 3C) QKV
    projection output, heads on the channel axis, no QK-norm, an fp32 (B, N)
    additive key bias. Returns (B, N, C). On CUDA it passes the three column
    slices of `qkv` to the attention.cu kernel, as flash_mha does."""
    if qkv.device.type == "cpu":
        return mha_short_plain(qkv, num_heads, bias, allow_zero_attn)
    _heads_checks("mha_short", *_split3(qkv), num_heads, bias, (None,) * 4)
    out = _heads_launch("mha_short", *_split3(qkv), num_heads, bias, (None,) * 4, 1e-6,
                        allow_zero_attn)
    mha_short.launches += 1
    return out


mha_short.launches = 0


def attn_block_takes(N: int, C: int, device: torch.device,
                     num_heads: Optional[int] = None) -> bool:
    """Whether attn_block holds a sequence of N tokens of width C on
    `device`: the port's counterpart of the JAX package's VMEM estimate for
    pallas_attn_block (ops/transformer.py:474-482). On CUDA the kernel takes
    C in 512 / 768 / 1024 over heads of 64 (num_heads, when given), and its
    own library answers for N (csrc/attn_block.cu keeps q, k and v of one
    image and head in shared memory, which bounds N: 448 at each width). The
    plain twin takes any N and C."""
    if torch.device(device).type == "cpu":
        return True
    if C not in (512, 768, 1024) or (num_heads is not None and C != 64 * num_heads):
        return False
    from . import _build

    return bool(_build.entry("attn_block_fits")(N, C))


def attn_block_plain(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj, num_heads: int,
                     bias=None, eps: float = 1e-6, allow_zero_attn: bool = False):
    dt = w_qkv.dtype
    h = layer_norm_fp32(x.float(), gamma, beta, eps).to(dt)
    qkv = _mm(h, w_qkv, b_qkv).to(dt)
    attn = mha_short_plain(qkv, num_heads, bias, allow_zero_attn)
    return x + _mm(attn, w_proj, b_proj).to(x.dtype)


def attn_block(x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
               w_qkv: torch.Tensor, b_qkv: Optional[torch.Tensor], w_proj: torch.Tensor,
               b_proj: Optional[torch.Tensor], num_heads: int,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6,
               allow_zero_attn: bool = False) -> torch.Tensor:
    """x + proj(MHA(LN(x) @ w_qkv.T + b_qkv)) + b_proj over (B, N, C) tokens:
    LN statistics in fp32, q/k/v rounded to the compute dtype (w_qkv's),
    softmax in fp32, each head's output and the projected branch rounded
    before the residual add. w_qkv (3C, C), w_proj (C, C): nn.Linear layout;
    bias: fp32 (B, N) additive key bias. Returns (B, N, C) in x.dtype."""
    if x.device.type == "cpu":
        return attn_block_plain(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj, num_heads,
                                bias, eps, allow_zero_attn)
    name = "attn_block"
    dev = require_cuda(name, x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj, bias)
    require(x.ndim == 3, f"{name}: x must be (B, N, C), got {tuple(x.shape)}")
    B, N, C = x.shape
    require(tuple(w_qkv.shape) == (3 * C, C) and tuple(w_proj.shape) == (C, C),
            f"{name}: w_qkv must be ({3 * C}, {C}) and w_proj ({C}, {C})")
    if bias is not None:
        require(bias.dtype == torch.float32 and tuple(bias.shape) == (B, N)
                and bias.is_contiguous(),
                f"{name}: bias must be contiguous fp32 ({B}, {N}), got {bias.dtype} "
                f"{tuple(bias.shape)}")
    require_takes(name, all_bf16(x, w_qkv, w_proj)
                  and all(t.is_contiguous() for t in (x, w_qkv, w_proj))
                  and aligned(x, 16) and aligned(w_qkv, 32) and aligned(w_proj, 32)
                  and x.numel() < 2**31 and attn_block_takes(N, C, dev, num_heads),
                  x, w_qkv, w_proj)
    # fp32 copies stay referenced until the launch is queued
    g32, be32, bq32, bp32 = f32(gamma), f32(beta), f32(b_qkv), f32(b_proj)
    h_ln = torch.empty_like(x)  # LN(x), read by the heads kernel
    heads = torch.empty_like(x)  # the heads' outputs, read by the projection
    out = torch.empty_like(x)
    from . import _build

    code = _build.entry(name)(
        ptr(x), ptr(g32), ptr(be32), ptr(w_qkv), ptr(bq32), ptr(w_proj), ptr(bp32), ptr(bias),
        ptr(h_ln), ptr(heads), ptr(out), B, N, C, num_heads, float(eps), float(64) ** -0.5,
        int(allow_zero_attn), stream(dev))
    _build.check(name, code)
    attn_block.launches += 1
    return out


attn_block.launches = 0
