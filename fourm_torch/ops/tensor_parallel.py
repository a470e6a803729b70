"""Megatron's f / g pair for the tensor-parallel blocks (Shoeybi et al.
2019, section 3), as autograd Functions over a process group:

  copy_to_group(x)     f: identity forward, all-reduce of the gradient
                          backward (before a column-parallel product, whose
                          input gradient is a partial sum on each rank);
  reduce_from_group(x) g: all-reduce forward (after a row-parallel product,
                          whose output is a partial sum on each rank),
                          identity backward.

`TensorGroup` is what a split module holds: the process group, this rank's
index in it and its size. The JAX package expresses the same split as
sharding constraints (fourm_tpu/parallel/mesh.py:activation_sharder) and XLA
inserts the all-reduce; here it is explicit and autograd sees it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TensorGroup:
    group: Any
    rank: int
    size: int


def _all_reduce(x: torch.Tensor, tp: TensorGroup) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=tp.group)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, tp: TensorGroup) -> torch.Tensor:
    """f: x itself forward; its gradient summed over the group backward."""
    return _CopyToGroup.apply(x, tp)


def reduce_from_group(x: torch.Tensor, tp: TensorGroup) -> torch.Tensor:
    """g: x summed over the group forward; the gradient as it is backward."""
    return _ReduceFromGroup.apply(x, tp)
