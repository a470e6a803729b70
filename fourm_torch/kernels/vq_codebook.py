"""Nearest-codebook search of the VQ tokenizers, exact in fp32.

Counterparts of fourm_tpu/kernels/vq_codebook.py: `nearest_code` is
pallas_nearest_code (argmax of -(||x||^2 - 2 x.e + ||e||^2)) and
`nearest_code_cosine` is pallas_nearest_code_cosine (argmax of x.e on
l2-normalised inputs); both return (N,) int64 indices, the first index on
ties. Each wrapper launches csrc/vq_codebook.cu for CUDA tensors, counting
launches in `<wrapper>.launches`, and computes its plain PyTorch twin for CPU
tensors.

The kernel and the twins share one arithmetic, so on the card they agree
index for index: every dot product and squared norm is summed over d in
order from 0, each product and each sum rounded on its own (the twins build
them with one elementwise multiply and one add per d, never a matmul, which
would sum in another order or in TF32). The JAX function's
precision="default" (single-pass bf16 products) is not ported: no caller uses
it.
"""

from __future__ import annotations

import torch

from ._checks import ptr, require, require_cuda, stream

def _dots(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(N, K) sums over d of x[:, d] * e[:, d], in order, products rounded."""
    acc = torch.zeros(x.shape[0], e.shape[0], dtype=torch.float32, device=x.device)
    for d in range(x.shape[1]):
        acc += x[:, d, None] * e[None, :, d]
    return acc


def _sq_norms(t: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)
    for d in range(t.shape[1]):
        acc += t[:, d] * t[:, d]
    return acc


def _search_plain(x, e, cosine: bool) -> torch.Tensor:
    x, e = x.float(), e.float()
    e2 = None if cosine else _sq_norms(e)
    out = []
    step = max(1, (1 << 24) // max(1, e.shape[0]))  # rows per chunk: bounded memory
    for i in range(0, x.shape[0], step):
        dist = _dots(x[i:i + step], e)
        if not cosine:
            dist = -((_sq_norms(x[i:i + step])[:, None] - 2.0 * dist) + e2[None, :])
        out.append(dist.argmax(dim=-1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=x.device)


def nearest_code_plain(x, embed) -> torch.Tensor:
    return _search_plain(x, embed, False)


def nearest_code_cosine_plain(x_normed, embed_normed) -> torch.Tensor:
    return _search_plain(x_normed, embed_normed, True)


def _search(name: str, x: torch.Tensor, e: torch.Tensor, cosine: bool) -> torch.Tensor:
    dev = require_cuda(name, x, e)
    require(x.dtype == torch.float32 and e.dtype == torch.float32,
            f"{name}: the CUDA kernel takes fp32 latents and codebook, got {x.dtype}/{e.dtype}")
    require(x.ndim == 2 and e.ndim == 2 and x.shape[1] == e.shape[1],
            f"{name}: x (N, D) and codebook (K, D), got {tuple(x.shape)}/{tuple(e.shape)}")
    N, D = x.shape
    K = e.shape[0]
    require(0 < D <= 128 and K > 0, f"{name}: D={D} must be in 1..128, K={K} > 0")
    require(x.is_contiguous() and e.is_contiguous(), f"{name}: x and codebook must be contiguous")
    require(x.numel() < 2**31 and e.numel() < 2**31, f"{name}: too large")
    out = torch.empty(N, dtype=torch.int64, device=dev)
    if N == 0:
        return out
    from . import _build

    code = _build.entry("nearest_code")(ptr(x), ptr(e), ptr(out), N, K, D, int(cosine),
                                        stream(dev))
    _build.check(name, code)
    return out


def nearest_code(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Euclidean nearest-code indices: x (N, D) fp32 latents, embed (K, D)
    fp32 codebook -> (N,) int64, the first index on ties."""
    if x.device.type == "cpu":
        return nearest_code_plain(x, embed)
    out = _search("nearest_code", x, embed, False)
    nearest_code.launches += 1
    return out


nearest_code.launches = 0


def nearest_code_cosine(x_normed: torch.Tensor, embed_normed: torch.Tensor) -> torch.Tensor:
    """Cosine nearest-code indices: argmax of x.e over l2-normalised x (N, D)
    and codebook (K, D), fp32 -> (N,) int64, the first index on ties."""
    if x_normed.device.type == "cpu":
        return nearest_code_cosine_plain(x_normed, embed_normed)
    out = _search("nearest_code_cosine", x_normed, embed_normed, True)
    nearest_code_cosine.launches += 1
    return out


nearest_code_cosine.launches = 0
