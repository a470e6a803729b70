"""Differentiable attention for the training step: `attention_train`, a
torch.autograd.Function whose forward and backward are CUDA kernels
(csrc/attention_train.cu).

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
`attention_train_bwd.launches` (one per backward: D pre-pass, dk/dv and dq
kernels).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._checks import aligned, all_bf16, ptr, require, require_cuda, require_takes, stream
from .attention import softmax1

HEAD_DIM = 64  # TR_DH of csrc/attention_train.cu: the only head dim the kernels take


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
    and M are free (csrc/attention_train.cu streams K/V and query tiles
    through fixed shared memory, checked at compile time). The twins take
    any dtype and shape. A refused problem takes the plain autograd path
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


def _dims(q, k, v, o, do, dq, dk, dv, bias, mode):
    B, H, N, _ = q.shape
    M = k.shape[2]
    vals = [B, H, N, M]
    for t in (q, k, v, o, do, dq, dk, dv):
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    if mode == "none":
        vals += [0, 0, 0]
    else:
        vals += [0 if bias.shape[0] == 1 else bias.stride(0),
                 0 if mode == "key" else bias.stride(2), bias.stride(3)]
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
    """Forward kernel: (o (B, H, N, Dh) in q.dtype, stats (B, H, N, 2) fp32:
    each row's max logit and inverse softmax sum, the backward's residual)."""
    name = "attention_train_fwd"
    dev, mode = _checked(name, q, k, v, bias)
    q, k, v = _usable(q), _usable(k), _usable(v)
    B, H, N, _ = q.shape
    o = _heads_first(q.shape, q.dtype, dev)
    stats = torch.empty((B, H, N, 2), dtype=torch.float32, device=dev)
    require(max(t.storage_offset() + t.stride(0) * t.shape[0] for t in (q, k, v)) < 2**31,
            f"{name}: too large")
    from . import _build

    code = _build.entry(name)(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(stats), ptr(bias),
        _dims(q, k, v, o, None, None, None, None, bias, mode),
        float(q.shape[-1]) ** -0.5, int(allow_zero_attn), stream(dev))
    _build.check(name, code)
    attention_train_fwd.launches += 1
    return o, stats


attention_train_fwd.launches = 0


def attention_train_bwd(q, k, v, bias, o, stats, do):
    """Backward kernels: (dq, dk, dv), each of its input's shape and dtype."""
    name = "attention_train_bwd"
    dev, mode = _checked(name, q, k, v, bias)
    require_takes(name, all_bf16(o, do), o, do)
    q, k, v, o, do = (_usable(t) for t in (q, k, v, o, do))
    dq = _heads_first(q.shape, q.dtype, dev)
    dk = _heads_first(k.shape, k.dtype, dev)
    dv = _heads_first(v.shape, v.dtype, dev)
    dsum = torch.empty(stats.shape[:3], dtype=torch.float32, device=dev)
    from . import _build

    code = _build.entry(name)(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(stats), ptr(bias), ptr(dq), ptr(dk),
        ptr(dv), ptr(dsum), _dims(q, k, v, o, do, dq, dk, dv, bias, mode),
        float(q.shape[-1]) ** -0.5, stream(dev))
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
