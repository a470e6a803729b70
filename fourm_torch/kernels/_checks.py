"""Argument checks shared by the kernel wrappers: what a CUDA kernel does not
take raises here, before any pointer reaches native code."""

from __future__ import annotations

import torch


def require(cond: bool, what) -> None:
    """Raise ValueError(what) unless cond; `what` may be a callable that
    builds the message, so a hot path formats nothing when the check holds."""
    if not cond:
        raise ValueError(what() if callable(what) else what)


def all_bf16(*tensors) -> bool:
    """Whether every tensor given (None passes) is bf16: the dtype half of
    each wrapper's `<wrapper>_takes` predicate."""
    return all(t is None or t.dtype == torch.bfloat16 for t in tensors)


def require_takes(name: str, takes: bool, *tensors) -> None:
    """Raise unless the wrapper's predicate (`<name>_takes`) found that its
    CUDA kernel takes the call: TypeError where one of `tensors` is not
    bf16, else ValueError with their shapes, strides and alignment. A
    wrapper never runs its plain twin on the card; a model that computes in
    another dtype takes the twins at the block layer (ops/transformer.py)."""
    if takes:
        return
    wrong = [t.dtype for t in tensors if t is not None and t.dtype != torch.bfloat16]
    if wrong:
        raise TypeError(f"{name}: the CUDA kernel takes bf16, got {wrong}")
    raise ValueError(f"{name}: the CUDA kernel does not take " + "; ".join(
        f"{tuple(t.shape)} strides {t.stride()} at {t.data_ptr() % 16} mod 16"
        for t in tensors if t is not None) + f" (see {name}_takes)")


def require_cuda(name: str, *tensors) -> torch.device:
    dev = None
    for t in tensors:
        if t is None:
            continue
        index = t.get_device()  # -1 on the CPU
        if dev is None:
            dev = index
        if index < 0 or index != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got "
                             f"{[str(u.device) for u in tensors if u is not None]}")
    return torch.device("cuda", dev)


def aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def f32(t):
    """fp32 contiguous copy of a small parameter vector (None passes)."""
    return None if t is None else t.detach().float().contiguous()


def small_params(*tensors):
    """Small parameter vectors (LN scales and shifts, biases) for a kernel
    that reads them in fp32 or in bf16, one flag for all: returns the
    tensors (None passes) and 1 when they are bf16. Contiguous fp32 or bf16
    vectors of one dtype pass as they are, with no copy kernel; anything
    else goes to fp32 copies."""
    dtype = None
    for t in tensors:
        if t is None:
            continue
        if dtype is None:
            dtype = t.dtype
        if t.dtype is not dtype or dtype not in (torch.float32, torch.bfloat16) \
                or not t.is_contiguous():
            return [f32(u) for u in tensors], 0
    return tensors, int(dtype is torch.bfloat16)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
