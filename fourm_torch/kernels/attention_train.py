"""Differentiable attention for the training step: `attention_train`, a
torch.autograd.Function whose forward and backward are CUDA kernels: the
forward is csrc/attention.cu's kernel with its row-statistics output, the
backward csrc/attention_train.cu.

Counterpart of fourm_tpu/kernels/attention_bwd.py: the forward is
_train_fwd_call, the backward _train_bwd_call, the Function their
custom_vjp `attention_train`, and `attention_train_takes` the gate
fused_train_attention_eligible, by dtype and shape. The bias is a constant
mask (fp32, none, key-only (B, 1, 1, M) or full (B, 1, N, M)); its gradient
is None.

The plain twins follow the TPU kernels' arithmetic (attention_bwd.py:67-139):
logits q k^T in fp32, scale then bias, softmax (or softmax1) in fp32,
probabilities cast to v's dtype for the products; the backward with the
explicit formulas, p cast to the compute dtype for dv, D = rowsum(do * o)
in fp32 from the compute-dtype o, ds = p (dp - D) cast before dq and dk,
the scale applied after the products. On CPU tensors the Function runs the
twins, so the CPU tests go through the backward formulas too. Each wrapper
counts its launches: `attention_train_fwd.launches`,
`attention_train_bwd.launches` (one per backward: the backward kernel, and
past 128 keys the pass that sums its dq partials).

The forward kernel leaves the backward a residual: each row's statistics in
log2 units (`attention_train_stats_plain` computes them as it does), from
which the backward recomputes the probabilities
(`attention_train_bwd_stats_plain`, the kernel's formulation, the reference
of that contract). The twins never see the statistics.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._checks import aligned, all_bf16, ptr, require, require_cuda, require_takes, stream
from .attention import _launch, softmax1

HEAD_DIM = 64  # the only head dim the kernels take
LOG2E = 1.4426950408889634
BIAS_FLOOR = -1e30  # csrc/attn_sm90.cuh: the bias is clamped here before the log2 fold
KEYS_PER_CTA = 128  # csrc/attention_train.cu: BW_KEYS, the keys of one backward CTA


def _probs(q, k, bias, allow_zero_attn):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias.float()
    return softmax1(s) if allow_zero_attn else torch.softmax(s, dim=-1)


def attention_train_fwd_plain(q, k, v, bias=None, allow_zero_attn: bool = False):
    """softmax(q k^T * Dh^-0.5 + bias) v: the twin of _train_fwd_call."""
    p = _probs(q, k, bias, allow_zero_attn)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_train_bwd_plain(q, k, v, bias, o, do, allow_zero_attn: bool = False):
    """dq, dk, dv by the explicit formulas of _train_bwd_call."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    p = _probs(q, k, bias, allow_zero_attn)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    D = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - D)).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _logits2(q, k, bias):
    """The logits in log2 units, as the kernels form them: q k^T in fp32
    times scale * log2(e), plus the bias clamped at BIAS_FLOOR times
    log2(e)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5 * LOG2E)
    if bias is not None:
        s = s + torch.clamp_min(bias.float(), BIAS_FLOOR) * LOG2E
    return s


def attention_train_stats_plain(q, k, bias=None, allow_zero_attn: bool = False):
    """The forward kernel's residual as it stores it: (B, H, N, 2) fp32, each
    row's max logit in log2 units (at least 0 for softmax1, whose implicit
    zero logit joins the max) and 1 / its sum of exp2(logit - max) (plus
    exp2(-max) for softmax1's zero logit)."""
    s = _logits2(q, k, bias)
    m = s.amax(dim=-1)
    if allow_zero_attn:
        m = torch.clamp_min(m, 0.0)
    l = torch.exp2(s - m[..., None]).sum(dim=-1)
    if allow_zero_attn:
        l = l + torch.exp2(-m)
    return torch.stack([m, 1.0 / l], dim=-1)


def attention_train_bwd_stats_plain(q, k, v, bias, o, do, stats):
    """dq, dk, dv the way csrc/attention_train.cu computes them: p = exp2(logit
    - max) * (1 / sum) from the saved statistics (log2 units, as
    attention_train_stats_plain gives them) instead of a softmax, then the
    formulas and roundings of attention_train_bwd_plain."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    p = torch.exp2(_logits2(q, k, bias) - stats[..., :1]) * stats[..., 1:]
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    D = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - D)).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _bias_mode(bias, B: int, N: int, M: int) -> Optional[str]:
    """"none", "key" (B, 1, 1, M) or "full" (B, 1, N, M); None for a bias the
    kernels do not take (per-head, or not of the batch)."""
    if bias is None:
        return "none"
    if bias.ndim != 4 or bias.shape[1] != 1 or bias.shape[-1] != M \
            or bias.shape[0] not in (1, B) or bias.shape[2] not in (1, N):
        return None
    return "key" if bias.shape[2] == 1 else "full"


def attention_train_takes(q: torch.Tensor, k: torch.Tensor,
                          bias: Optional[torch.Tensor]) -> bool:
    """Whether attention_train holds this problem, by dtype and shape: the
    port's counterpart of fused_train_attention_eligible
    (attention_bwd.py:282). The bias must be none, key-only or full, with
    one head row. On CUDA q and k must be bf16 and the head dim HEAD_DIM; N
    and M are free (the forward streams K/V tiles, the backward query tiles
    through fixed shared memory, checked at compile time, and sums the dq
    of several key tiles in a second pass). The twins take any dtype and
    shape. A refused problem takes the plain autograd path
    (ops/transformer.py:dot_product_attention)."""
    B, _, N, Dh = q.shape
    if _bias_mode(bias, B, N, k.shape[2]) is None:
        return False
    return q.device.type == "cpu" or (Dh == HEAD_DIM and all_bf16(q, k))


def _strides_ok(t: torch.Tensor) -> bool:
    return t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1]) and aligned(t, 16)


def _usable(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernels can read it through its strides, else one
    contiguous copy."""
    return t if _strides_ok(t) else t.contiguous()


def _heads_first(shape, dtype, dev):
    """A (B, N, H, Dh) buffer seen as (B, H, N, Dh): moving heads back next
    to channels is then free for the caller."""
    B, H, N, Dh = shape
    return torch.empty((B, N, H, Dh), dtype=dtype, device=dev).permute(0, 2, 1, 3)


def _bias_strides(bias, mode):
    """The bias's (batch, row, key) element strides, 0 on a broadcast axis."""
    if mode == "none":
        return 0, 0, 0
    return (0 if bias.shape[0] == 1 else bias.stride(0), 0 if mode == "key" else bias.stride(2),
            bias.stride(3))


def _tma_bias(bias, mode):
    """A full bias as the backward's TMA map reads it -- contiguous keys, 16-byte
    aligned rows and batch stride -- or one padded copy (the keys past M
    are masked in the kernel whatever their value)."""
    if mode != "full":
        return bias
    sbb, sbn, sbm = _bias_strides(bias, mode)
    if sbm == 1 and sbn % 4 == 0 and sbb % 4 == 0 and aligned(bias, 16):
        return bias
    B, _, N, M = bias.shape
    padded = torch.zeros((B, 1, N, -(-M // 4) * 4), dtype=bias.dtype, device=bias.device)
    padded[..., :M] = bias
    return padded[..., :M]


def _dims(q, k, v, o, do, dq, dk, dv, bias, mode):
    B, H, N, _ = q.shape
    M = k.shape[2]
    vals = [B, H, N, M]
    for t in (q, k, v, o, do, dq, dk, dv):
        vals += list(t.stride()[:3])
    vals += list(_bias_strides(bias, mode))
    return (ctypes.c_int * len(vals))(*vals)


def _checked(name, q, k, v, bias):
    dev = require_cuda(name, q, k, v, bias)
    require_takes(name, all_bf16(q, k, v), q, k, v)
    B, H, N, Dh = q.shape
    M = k.shape[2]
    require(tuple(k.shape) == (B, H, M, Dh) and tuple(v.shape) == (B, H, M, Dh),
            lambda: f"{name}: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q")
    mode = _bias_mode(bias, B, N, M)
    require(mode is not None, lambda: f"{name}: bias {tuple(bias.shape)} is not none, "
                                      f"(B, 1, 1, M) or (B, 1, N, M)")
    if bias is not None:
        require(bias.dtype == torch.float32, f"{name}: bias must be fp32")
    require(attention_train_takes(q, k, bias),
            lambda: f"{name}: the kernel does not take N={N}, M={M}, Dh={Dh}")
    return dev, mode


def attention_train_fwd(q, k, v, bias=None, allow_zero_attn: bool = False):
    """Forward kernel, csrc/attention.cu's with its statistics output: (o (B,
    H, N, Dh) in q.dtype, stats (B, H, N, 2) fp32), the stats being each
    row's max logit in log2 units -- (q.k * scale + bias) * log2(e), the
    bias clamped at BIAS_FLOOR; for softmax1 at least 0 -- and 1 / its
    softmax sum: the backward's residual, which it reads in the same units
    (attention_train_stats_plain computes them on the CPU)."""
    name = "attention_train_fwd"
    dev, mode = _checked(name, q, k, v, bias)
    q, k, v = _usable(q), _usable(k), _usable(v)
    B, H, N, Dh = q.shape
    M = k.shape[2]
    o = _heads_first(q.shape, q.dtype, dev)
    stats = torch.empty((B, H, N, 2), dtype=torch.float32, device=dev)
    require(max(t.storage_offset() + t.stride(0) * t.shape[0] for t in (q, k, v)) < 2**31,
            f"{name}: too large")
    sbb, sbn, sbm = _bias_strides(bias, mode)
    _launch(name, q, k, v, o, q.stride()[:3], k.stride()[:3], v.stride()[:3], o.stride()[:3],
            bias, (sbb, 0, sbn, sbm), (None,) * 4, B, H, N, M, Dh, 1e-6, allow_zero_attn, dev,
            stats)
    attention_train_fwd.launches += 1
    return o, stats


attention_train_fwd.launches = 0


def attention_train_bwd(q, k, v, bias, o, stats, do):
    """Backward kernel: (dq, dk, dv), each of its input's shape and dtype.
    stats: attention_train_fwd's (B, H, N, 2), log2 units."""
    name = "attention_train_bwd"
    dev, mode = _checked(name, q, k, v, bias)
    require_takes(name, all_bf16(o, do), o, do)
    q, k, v, o, do = (_usable(t) for t in (q, k, v, o, do))
    B, H, N, Dh = q.shape
    M = k.shape[2]
    require(tuple(stats.shape) == (B, H, N, 2) and stats.dtype == torch.float32
            and stats.is_contiguous(), f"{name}: stats must be attention_train_fwd's")
    bias = _tma_bias(bias, mode)
    dq = _heads_first(q.shape, q.dtype, dev)
    dk = _heads_first(k.shape, k.dtype, dev)
    dv = _heads_first(v.shape, v.dtype, dev)
    # past one CTA's keys each key tile's CTA leaves an fp32 dq partial
    tiles = -(-M // KEYS_PER_CTA)
    dq_part = None if tiles == 1 else torch.empty((tiles, B, H, N, Dh), dtype=torch.float32,
                                                  device=dev)
    from . import _build

    code = _build.entry(name)(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(stats), ptr(bias), ptr(dq), ptr(dk),
        ptr(dv), ptr(dq_part), _dims(q, k, v, o, do, dq, dk, dv, bias, mode),
        float(Dh) ** -0.5, stream(dev))
    _build.check(name, code)
    attention_train_bwd.launches += 1
    return dq, dk, dv


attention_train_bwd.launches = 0


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, allow_zero_attn):
        if q.device.type == "cpu":
            o, stats = attention_train_fwd_plain(q, k, v, bias, allow_zero_attn), None
        else:
            o, stats = attention_train_fwd(q, k, v, bias, allow_zero_attn)
        ctx.allow_zero_attn = allow_zero_attn
        ctx.save_for_backward(q, k, v, bias, o, stats)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, stats = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_train_bwd_plain(q, k, v, bias, o, do, ctx.allow_zero_attn)
        else:
            dq, dk, dv = attention_train_bwd(q, k, v, bias, o, stats, do)
        return dq, dk, dv, None, None


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    allow_zero_attn: bool = False) -> torch.Tensor:
    """Differentiable softmax(q k^T * Dh^-0.5 + bias) v. q: (B, H, N, Dh),
    k, v: (B, H, M, Dh), any strides; bias fp32 (B, 1, 1|N, M), a constant
    mask. The caller has checked attention_train_takes. Returns (B, H, N, Dh)
    in q.dtype (on CUDA a (B, N, H, Dh) buffer seen through a permute)."""
    return _AttentionTrain.apply(q, k, v, bias, allow_zero_attn)
