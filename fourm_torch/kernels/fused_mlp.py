"""Fused LayerNorm + matmul and LayerNorm + MLP + residual.

Counterparts of fourm_tpu/kernels/fused_mlp.py: `ln_matmul` is
pallas_ln_matmul (the pre-norm QKV projection), `ln_mlp` is pallas_ln_mlp
(the MLP half of a block). Each wrapper launches its CUDA kernel
(csrc/ln_matmul.cu, csrc/ln_mlp.cu) for CUDA tensors, counting launches in
`<wrapper>.launches`, and raises on a call its predicate (`ln_matmul_takes`,
`ln_mlp_takes`) refuses; it computes its plain PyTorch twin for CPU tensors.

Weights use the nn.Linear layout (out_features, in_features), as the port's
modules hold them. The twins follow the TPU kernels' arithmetic: LN
statistics in fp32, one rounding to the compute dtype (the weights' dtype),
products accumulated in fp32, biases added in fp32. Exact-erf GELU, as the
XLA path of the JAX package computes it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ._checks import aligned, all_bf16, f32, ptr, require, require_cuda, require_takes, stream


def layer_norm_fp32(x32: torch.Tensor, gamma, beta, eps: float) -> torch.Tensor:
    """LayerNorm in fp32: (x - mean) * rsqrt(var + eps) * gamma (+ beta)."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y


def _mm(a: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """a @ w.T + b, the products of compute-dtype values summed in fp32."""
    out = torch.matmul(a.float(), w.float().t())
    if b is not None:
        out = out + b.float()
    return out


def ln_matmul_plain(x, gamma, beta, w, b=None, eps: float = 1e-6) -> torch.Tensor:
    h = layer_norm_fp32(x.float(), gamma, beta, eps).to(w.dtype)
    return _mm(h, w, b).to(w.dtype)


def ln_matmul_takes(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether csrc/ln_matmul.cu takes LN(x) @ w.T, from dtypes, shapes and
    alignment alone: bf16 x and w, D and F multiples of 8 (TMA's 16-byte
    row strides), contiguous 16-byte aligned x and w, at least one row."""
    D, Fo = x.shape[-1], w.shape[0]
    return (all_bf16(x, w) and D % 8 == 0 and Fo % 8 == 0 and x.numel() > 0
            and x.is_contiguous() and w.is_contiguous() and aligned(x, 16) and aligned(w, 16)
            and x.numel() // D * max(D, Fo) < 2**31)


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
              w: torch.Tensor, b: Optional[torch.Tensor] = None,
              eps: float = 1e-6) -> torch.Tensor:
    """LN(x) @ w.T + b over (..., D) rows; w is (F, D). Returns (..., F) in
    w.dtype."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, gamma, beta, w, b, eps)
    name = "ln_matmul"
    dev = require_cuda(name, x, gamma, beta, w, b)
    D = x.shape[-1]
    Fo = w.shape[0]
    require(w.shape == (Fo, D), f"{name}: w must be (F, {D}), got {tuple(w.shape)}")
    require_takes(name, ln_matmul_takes(x, w), x, w)
    M = x.numel() // D
    h = torch.empty_like(x)  # the LN prologue's output, the GEMM's A operand
    out = torch.empty(x.shape[:-1] + (Fo,), dtype=torch.bfloat16, device=dev)
    g32, b32, bias32 = f32(gamma), f32(beta), f32(b)
    from . import _build

    code = _build.entry(name)(ptr(x), ptr(g32), ptr(b32), ptr(w), ptr(bias32), ptr(h),
                              ptr(out), M, D, Fo, float(eps), stream(dev))
    _build.check(name, code)
    ln_matmul.launches += 1
    return out


ln_matmul.launches = 0


def ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2, w3=None, b3=None,
                 eps: float = 1e-6, gated: bool = False) -> torch.Tensor:
    dt = w1.dtype
    h = layer_norm_fp32(x.float(), gamma, beta, eps).to(dt)
    g = _mm(h, w1, b1)
    if gated:
        act = F.silu(g) * _mm(h, w3, b3)
    else:
        act = F.gelu(g, approximate="none")
    out = _mm(act.to(dt), w2, b2)
    return x + out.to(x.dtype)


def ln_mlp_takes(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 w3: Optional[torch.Tensor] = None) -> bool:
    """Whether csrc/ln_mlp.cu takes x + fc2(act(fc1(LN x))), from dtypes,
    shapes and alignment alone: bf16 x, w1, w2 (and w3), D a multiple of 8,
    any hidden width, contiguous 16-byte aligned tensors (w2 may be a view
    with rows apart, as the MLP modules keep a ragged bf16 fc2 weight: the
    wrapper copies it), at least one row."""
    D, HID = x.shape[-1], w1.shape[0]
    hid8 = -(-HID // 8) * 8
    ts = [t for t in (x, w1, w3) if t is not None]
    return (all_bf16(*ts, w2) and D % 8 == 0 and HID >= 1 and x.numel() > 0
            and all(t.is_contiguous() and aligned(t, 16) for t in ts)
            and w2.stride(-1) == 1 and aligned(w2, 16)
            and x.numel() // D * max(D, hid8) < 2**31)


def ln_mlp(x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
           w1: torch.Tensor, b1: Optional[torch.Tensor], w2: torch.Tensor,
           b2: Optional[torch.Tensor], w3: Optional[torch.Tensor] = None,
           b3: Optional[torch.Tensor] = None, eps: float = 1e-6,
           gated: bool = False) -> torch.Tensor:
    """x + fc2(act(fc1(LN x))) over (..., D) rows. w1, w3: (HID, D); w2:
    (D, HID). act is silu(fc1) * fc3 when gated, else exact GELU. Returns
    x.shape in x.dtype. Any hidden width: when HID is not a multiple of 8
    (SwiGLU's int(2 * 4D / 3): 1365, 2730, 5461) the kernel reads a copy of
    w2 zero-padded to a multiple of 8, made on each call; the module's
    parameters keep their shapes."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2, w3, b3, eps, gated)
    name = "ln_mlp"
    dev = require_cuda(name, x, gamma, beta, w1, b1, w2, b2, w3, b3)
    D = x.shape[-1]
    HID = w1.shape[0]
    require(tuple(w1.shape) == (HID, D) and tuple(w2.shape) == (D, HID),
            f"{name}: w1 must be ({HID}, {D}) and w2 ({D}, {HID})")
    require(not gated or (w3 is not None and tuple(w3.shape) == (HID, D)),
            f"{name}: gated needs w3 of shape ({HID}, {D})")
    require_takes(name, ln_mlp_takes(x, w1, w2, w3 if gated else None), x, w1, w2,
                  w3 if gated else None)
    M = x.numel() // D
    hid8 = -(-HID // 8) * 8
    # TMA's 16-byte row stride, over hid8 columns
    w2k = w2.contiguous() if hid8 == HID else F.pad(w2, (0, hid8 - HID))
    h = torch.empty_like(x)  # the LN prologue's output
    act = torch.empty((M, hid8), dtype=torch.bfloat16, device=dev)  # the hidden activation
    out = torch.empty_like(x)
    # fp32 copies stay referenced until the launch is queued
    g32, be32, b1_32, b2_32 = f32(gamma), f32(beta), f32(b1), f32(b2)
    b3_32 = f32(b3) if gated else None
    from . import _build

    code = _build.entry(name)(
        ptr(x), ptr(g32), ptr(be32), ptr(w1), ptr(b1_32),
        ptr(w3 if gated else None), ptr(b3_32), ptr(w2k), ptr(b2_32), ptr(h), ptr(act),
        ptr(out), M, D, HID, int(gated), float(eps), stream(dev))
    _build.check(name, code)
    ln_mlp.launches += 1
    return out


ln_mlp.launches = 0
