"""Layers shared by the convolutional diffusion decoders of the port
(vq/unet.py, vq/uvit.py), with the numerics of the flax layers the JAX
package builds them from:
  * `Conv2d` / `ConvTranspose2d`: nn.Conv(dtype=...) / nn.ConvTranspose:
    input, kernel and bias cast to the compute dtype, one product;
  * `GroupNorm`: flax nn.GroupNorm: fp32 statistics and affine, output in
    the compute dtype (the epsilon is the caller's: flax's default 1e-6, not
    torch's 1e-5);
  * `resize_nearest`: jax.image.resize(..., "nearest"), half-pixel centres
    (torch's "nearest-exact" off integer ratios, not "nearest").
Activations are NCHW inside the decoders; their interfaces stay channel-last.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `dtype` whatever dtypes its input and
    parameters are held in."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, groups=groups)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d computing in `dtype`; the weight (in, out, kh, kw)
    is flax's nn.ConvTranspose(transpose_kernel=True) kernel
    (kh, kw, out, in) transposed."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW activations: statistics and affine in fp32,
    output in the compute dtype."""

    def __init__(self, num_groups: int, channels: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(self.dtype)


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output sample of jax.image.resize's nearest
    mode: floor((i + 0.5) * n_in / n_out), computed in fp32 as JAX does."""
    offsets = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
    return np.floor(offsets / np.float32(n_out)).astype(np.int64)


def resize_nearest(x: torch.Tensor, size: Sequence[int], dims: Sequence[int]) -> torch.Tensor:
    """Nearest resize of the axes `dims` of x to `size`, as
    jax.image.resize(..., "nearest") resizes them."""
    for d, n in zip(dims, size):
        if x.shape[d] != n:
            idx = torch.from_numpy(nearest_indices(x.shape[d], n)).to(x.device)
            x = x.index_select(d, idx)
    return x


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)
