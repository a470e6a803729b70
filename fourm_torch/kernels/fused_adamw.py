"""Fused AdamW: one in-place pass over every parameter leaf, in one launch.

Counterpart of fourm_tpu/kernels/fused_adamw.py: `fused_adamw` computes
fused_adamw_leaf's update (fused_adamw.py:15-17 / 59-66) for a whole list of
leaves with one launch of csrc/fused_adamw.cu, where the TPU kernel runs
once per leaf; `adamw_scalars` is adamw_scalars (:116). The gradient clip of
optax.clip_by_global_norm (g / |g| * max_norm when |g| >= max_norm) is
applied in the same pass when a global norm is given.

`fused_adamw_plain`, the twin, runs the same fp32 operations in the same
order with torch ops, leaf by leaf, so the kernel equals it bit for bit on
the card. On CPU tensors the wrapper computes the twin. Launches are
counted in `fused_adamw.launches`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ._checks import require, require_cuda, stream

ADAM_CHUNK = 1 << 16  # elements of a leaf one block takes at a time


@dataclass(frozen=True)
class AdamScalars:
    """fp32 scalars of one step: lr at the pre-increment count, the bias
    corrections c1 = 1/(1 - b1^t) and c2 = 1/(1 - b2^t) at t = count + 1,
    and the constants of the update."""

    lr: float
    c1: float
    c2: float
    b1: float
    b2: float
    eps: float
    wd: float


def adamw_scalars(count: int, lr: float, b1: float, b2: float, eps: float,
                  wd: float) -> AdamScalars:
    """The step's scalars in fp32 (fused_adamw.py:116): count is the
    pre-increment step count, lr the schedule's value at it."""
    f = np.float32
    t = f(count + 1)
    c1 = f(1.0) / (f(1.0) - f(b1) ** t)
    c2 = f(1.0) / (f(1.0) - f(b2) ** t)
    return AdamScalars(float(f(lr)), float(c1), float(c2), b1, b2, eps, wd)


def fused_adamw_plain(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                      exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
                      decay: Sequence[bool], s: AdamScalars,
                      grad_norm: Optional[torch.Tensor] = None,
                      max_norm: Optional[float] = None) -> None:
    """The twin: p, m, v updated in place, leaf by leaf, one torch op per
    rounding of the kernel."""
    clip = grad_norm is not None and not bool(grad_norm < max_norm)
    with torch.no_grad():
        for p, g, m, v, dk in zip(params, grads, exp_avgs, exp_avg_sqs, decay):
            g = torch.zeros_like(p) if g is None else g.float()
            if clip:
                g = g.div(grad_norm).mul(max_norm)
            m2 = m.mul(s.b1).add(g.mul(1.0 - s.b1))
            v2 = v.mul(s.b2).add(g.mul(1.0 - s.b2).mul(g))
            u = m2.mul(s.c1).div(v2.mul(s.c2).sqrt().add(s.eps))
            if dk:
                u = u.add(p.mul(s.wd))
            p.copy_(p.sub(u.mul(s.lr)))
            m.copy_(m2)
            v.copy_(v2)


class AdamwTable:
    """The kernel's static tables for one list of leaves on one device: a
    (L, 4) int64 row [p, m, v, decay] per leaf and a (C, 3) int32 row
    [leaf, start, length] per chunk of at most ADAM_CHUNK elements. Built
    once per optimizer; the tensors it points at must stay allocated."""

    def __init__(self, params, exp_avgs, exp_avg_sqs, decay):
        dev = require_cuda("fused_adamw", *params, *exp_avgs, *exp_avg_sqs)
        for t in (*params, *exp_avgs, *exp_avg_sqs):
            require(t.dtype == torch.float32 and t.is_contiguous(),
                    "fused_adamw: parameters and moments must be contiguous fp32")
        for p, m, v in zip(params, exp_avgs, exp_avg_sqs):
            require(m.shape == p.shape and v.shape == p.shape,
                    "fused_adamw: moments must have their parameter's shape")
        require(len({p.data_ptr() for p in params}) == len(params),
                "fused_adamw: a parameter is listed twice (it would be updated twice)")
        self.device = dev
        self.keys = self._keys(params, exp_avgs, exp_avg_sqs, decay)
        self.leaves = torch.tensor([[p, m, v, d] for p, m, v, _, d in self.keys],
                                   dtype=torch.int64).to(dev)
        chunks = [(i, s, min(ADAM_CHUNK, n - s)) for i, (_, _, _, n, _) in enumerate(self.keys)
                  for s in range(0, n, ADAM_CHUNK)]
        require(max(key[3] for key in self.keys) < 2**31, "fused_adamw: a leaf is too large")
        self.nchunks = len(chunks)
        self.chunks = torch.tensor(chunks, dtype=torch.int32).to(dev)

    @staticmethod
    def _keys(params, exp_avgs, exp_avg_sqs, decay):
        return [(p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(), int(d))
                for p, m, v, d in zip(params, exp_avgs, exp_avg_sqs, decay)]

    def matches(self, params, exp_avgs, exp_avg_sqs, decay) -> bool:
        """Whether the table was built for these tensors and decay flags."""
        return self.keys == self._keys(params, exp_avgs, exp_avg_sqs, decay)


def fused_adamw(params: List[torch.Tensor], grads: List[Optional[torch.Tensor]],
                exp_avgs: List[torch.Tensor], exp_avg_sqs: List[torch.Tensor],
                decay: List[bool], s: AdamScalars, grad_norm: Optional[torch.Tensor] = None,
                max_norm: Optional[float] = None, table: Optional[AdamwTable] = None) -> None:
    """One AdamW step over every leaf, p, m, v in place: one launch on CUDA
    (the twin on CPU tensors). grads[i] None steps leaf i with a zero
    gradient. With grad_norm (a one-element fp32 tensor, the unclipped global
    norm) and max_norm, gradients are clipped first, as optax does. On CUDA
    `table` is required: the AdamwTable of exactly these leaves and decay
    flags, which its owner (FusedAdamW) builds and checks."""
    if params[0].device.type == "cpu":
        fused_adamw_plain(params, grads, exp_avgs, exp_avg_sqs, decay, s, grad_norm, max_norm)
        return
    name = "fused_adamw"
    require(table is not None, f"{name}: the AdamwTable of these leaves is required on the card")
    for p, g in zip(params, grads):
        require(g is None or (g.dtype == torch.float32 and g.is_contiguous()
                              and g.shape == p.shape and g.device == p.device),
                lambda: f"{name}: gradients must be contiguous fp32 of their parameter's shape")
    if grad_norm is not None:
        require(max_norm is not None and grad_norm.dtype == torch.float32
                and grad_norm.numel() == 1 and grad_norm.device == table.device,
                f"{name}: grad_norm must be a one-element fp32 tensor on the card, with max_norm")
    # the gradients move every step: their pointers go up each launch, from
    # pinned memory, so that the host does not wait for the backward
    gptr = torch.tensor([0 if g is None else g.data_ptr() for g in grads], dtype=torch.int64,
                        pin_memory=True).to(table.device, non_blocking=True)
    from . import _build

    code = _build.entry(name)(
        table.leaves.data_ptr(), gptr.data_ptr(), table.chunks.data_ptr(), table.nchunks,
        s.lr, s.c1, s.c2, s.b1, 1.0 - s.b1, s.b2, 1.0 - s.b2, s.eps, s.wd,
        None if grad_norm is None else grad_norm.data_ptr(),
        0.0 if max_norm is None else float(max_norm), stream(table.device))
    _build.check(name, code)
    fused_adamw.launches += 1


fused_adamw.launches = 0
