"""Argument checks shared by the kernel wrappers: what a CUDA kernel does not
take raises here, before any pointer reaches native code."""

from __future__ import annotations

import torch


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def require_bf16(name: str, *tensors) -> None:
    for t in tensors:
        if t is not None and t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bf16, got {t.dtype}")


def require_cuda(name: str, *tensors) -> torch.device:
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on the same CUDA device, "
                             f"got {t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    return dev


def aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def f32(t):
    """fp32 contiguous copy of a small parameter vector (None passes)."""
    return None if t is None else t.detach().float().contiguous()


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
