"""Fused LayerNorm + matmul and LayerNorm + MLP + residual.

Counterparts of fourm_tpu/kernels/fused_mlp.py: `ln_matmul` is
pallas_ln_matmul (the pre-norm QKV projection), `ln_mlp` is pallas_ln_mlp
(the MLP half of a block). Each wrapper launches its CUDA kernel
(csrc/ln_matmul.cu, csrc/ln_mlp.cu) for CUDA tensors, counting launches in
`<wrapper>.launches`, and computes its plain PyTorch twin for CPU tensors.

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

from ._checks import aligned, f32, ptr, require, require_bf16, require_cuda, stream


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


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
              w: torch.Tensor, b: Optional[torch.Tensor] = None,
              eps: float = 1e-6) -> torch.Tensor:
    """LN(x) @ w.T + b over (..., D) rows; w is (F, D). Returns (..., F) in
    w.dtype."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, gamma, beta, w, b, eps)
    name = "ln_matmul"
    dev = require_cuda(name, x, gamma, beta, w, b)
    require_bf16(name, x, w)
    D = x.shape[-1]
    Fo = w.shape[0]
    require(w.shape == (Fo, D), f"{name}: w must be (F, {D}), got {tuple(w.shape)}")
    require(x.is_contiguous() and w.is_contiguous(), f"{name}: x and w must be contiguous")
    require(D % 16 == 0 and D <= 2048, f"{name}: D={D} must be a multiple of 16, <= 2048")
    require(Fo % 16 == 0, f"{name}: F={Fo} must be a multiple of 16")
    require(aligned(x, 16) and aligned(w, 32), f"{name}: x/w pointers misaligned")
    require(x.numel() < 2**31 and x.numel() // D * Fo < 2**31, f"{name}: too large")
    M = x.numel() // D
    out = torch.empty(x.shape[:-1] + (Fo,), dtype=torch.bfloat16, device=dev)
    g32, b32, bias32 = f32(gamma), f32(beta), f32(b)
    from . import _build

    code = _build.entry(name)(ptr(x), ptr(g32), ptr(b32), ptr(w), ptr(bias32), ptr(out),
                              M, D, Fo, float(eps), stream(dev))
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


def ln_mlp(x: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
           w1: torch.Tensor, b1: Optional[torch.Tensor], w2: torch.Tensor,
           b2: Optional[torch.Tensor], w3: Optional[torch.Tensor] = None,
           b3: Optional[torch.Tensor] = None, eps: float = 1e-6,
           gated: bool = False) -> torch.Tensor:
    """x + fc2(act(fc1(LN x))) over (..., D) rows. w1, w3: (HID, D); w2:
    (D, HID). act is silu(fc1) * fc3 when gated, else exact GELU. Returns
    x.shape in x.dtype. HID a multiple of the kernel's hidden chunk (64;
    128 at D = 2048), or, gated at D = 1024 or 2048, any HID >= 16: SwiGLU's
    ragged width at 4M-L / 4M-XL (2730, 5461) takes the kernel's predicated
    tail, with the weights as they are."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2, w3, b3, eps, gated)
    name = "ln_mlp"
    dev = require_cuda(name, x, gamma, beta, w1, b1, w2, b2, w3, b3)
    require_bf16(name, x, w1, w2, w3)
    D = x.shape[-1]
    HID = w1.shape[0]
    require(D in (256, 512, 768, 1024, 2048), f"{name}: D={D} not one of 256/512/768/1024/2048")
    chunk = 128 if D == 2048 else 64
    require(HID % chunk == 0 or (gated and D in (1024, 2048) and HID >= 16),
            f"{name}: hidden width {HID} must be a multiple of {chunk} (any width >= 16 "
            "only for a gated MLP at D = 1024 or 2048)")
    require(tuple(w1.shape) == (HID, D) and tuple(w2.shape) == (D, HID),
            f"{name}: w1 must be ({HID}, {D}) and w2 ({D}, {HID})")
    require(not gated or (w3 is not None and tuple(w3.shape) == (HID, D)),
            f"{name}: gated needs w3 of shape ({HID}, {D})")
    tensors = [x, w1, w2] + ([w3] if gated else [])
    require(all(t.is_contiguous() for t in tensors), f"{name}: inputs must be contiguous")
    require(aligned(x, 16) and all(aligned(t, 32) for t in tensors[1:]),
            f"{name}: pointers misaligned")
    require(x.numel() < 2**31, f"{name}: too large")
    M = x.numel() // D
    out = torch.empty_like(x)
    # fp32 copies stay referenced until the launch is queued
    g32, be32, b1_32, b2_32 = f32(gamma), f32(beta), f32(b1), f32(b2)
    b3_32 = f32(b3) if gated else None
    from . import _build

    code = _build.entry(name)(
        ptr(x), ptr(g32), ptr(be32), ptr(w1), ptr(b1_32),
        ptr(w3 if gated else None), ptr(b3_32), ptr(w2),
        ptr(b2_32), ptr(out), M, D, HID, int(gated), float(eps), stream(dev))
    _build.check(name, code)
    ln_mlp.launches += 1
    return out


ln_mlp.launches = 0
