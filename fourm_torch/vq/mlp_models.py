"""MLP backbones of the global-embedding and pose tokenizers, inference.

Counterpart of fourm_tpu/vq/mlp_models.py (reference
fourm/vq/models/mlp_models.py: BottleneckMLP / StandardMLP, from "Scaling
MLPs: A Tale of Inductive Bias"). Channel-last; an image-shaped input
(B, H, W, C) is treated point-wise. Products compute in `dtype` (the JAX
modules' nn.Dense(dtype=...)), LayerNorms (eps 1e-5) keep fp32 statistics,
the GELU is the exact (erf) one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.transformer import LayerNorm, _dense


def _flatten_image(x: torch.Tensor):
    if x.ndim == 4:
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C), (H, W)
    return x, None


def _unflatten_image(x: torch.Tensor, hw):
    return x if hw is None else x.reshape(x.shape[0], hw[0], hw[1], x.shape[-1])


class BottleneckBlock(nn.Module):
    """Linear(thin -> wide), GELU, Linear(wide -> thin); the reference's
    nn.Sequential, so its weights are `block.0` and `block.2`."""

    def __init__(self, thin: int, wide: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block = nn.Sequential(nn.Linear(thin, wide), nn.GELU(), nn.Linear(wide, thin))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_dense(x, self.block[0], self.dtype), approximate="none")
        return _dense(h, self.block[2], self.dtype)


class BottleneckMLP(nn.Module):
    """Residual bottleneck MLP (reference mlp_models.py:75-113)."""

    def __init__(self, dim_in: int, dim_out: int, block_dims: Sequence[Tuple[int, int]],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        thin0 = block_dims[0][1]
        self.linear_in = nn.Linear(dim_in, thin0)
        self.layernorms = nn.ModuleList(LayerNorm(thin, eps=1e-5, dtype=dtype)
                                        for _, thin in block_dims)
        self.blocks = nn.ModuleList(BottleneckBlock(thin, wide, dtype) for wide, thin in block_dims)
        self.linear_out = nn.Linear(block_dims[-1][1], dim_out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """`train` changes nothing: plain differentiable ops either way."""
        x, hw = _flatten_image(x)
        x = _dense(x, self.linear_in, self.dtype)
        for norm, block in zip(self.layernorms, self.blocks):
            x = x + block(norm(x))
        return _unflatten_image(_dense(x, self.linear_out, self.dtype), hw)


class StandardMLP(nn.Module):
    """Plain MLP with a LayerNorm before each hidden layer (reference
    mlp_models.py:34-72)."""

    def __init__(self, dim_in: int, dim_out: int, widths: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear_in = nn.Linear(dim_in, widths[0])
        self.layernorms = nn.ModuleList(LayerNorm(w, eps=1e-5, dtype=dtype) for w in widths[:-1])
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.linear_out = nn.Linear(widths[-1], dim_out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """`train` changes nothing: plain differentiable ops either way."""
        x, hw = _flatten_image(x)
        z = _dense(x, self.linear_in, self.dtype)
        for norm, layer in zip(self.layernorms, self.layers):
            z = _dense(norm(z), layer, self.dtype)
        return _unflatten_image(_dense(z, self.linear_out, self.dtype), hw)


def build_mlp(model_id: str, dim_in: Optional[int] = None, dim_out: Optional[int] = None,
              dtype: torch.dtype = torch.float32):
    """An MLP from an id like "BottleneckMLP/B_6-Wi_1024" (reference
    mlp_models.py:118-160): B blocks of thin width Wi, wide = 4 * Wi (or the
    expansion factor of a third field); input and output widths default to
    Wi. Returns (module, thin width)."""
    model, architecture = model_id.split("/")
    sep = architecture.split("-")
    num_blocks = int(sep[0].split("_")[1])
    thin = int(sep[1].split("_")[1])
    expansion = int(sep[2].split("_")[1]) if len(sep) == 3 else 4
    dim_in = dim_in if dim_in is not None else thin
    dim_out = dim_out if dim_out is not None else thin
    if model == "BottleneckMLP":
        blocks = [(expansion * thin, thin)] * num_blocks
        return BottleneckMLP(dim_in, dim_out, blocks, dtype), thin
    if model == "MLP":
        return StandardMLP(dim_in, dim_out, [thin] * num_blocks, dtype), thin
    raise ValueError(f"model {model} not supported")
