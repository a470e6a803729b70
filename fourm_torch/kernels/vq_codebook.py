"""Nearest-codebook search of the VQ tokenizers, exact in fp32.

Counterparts of fourm_tpu/kernels/vq_codebook.py: `nearest_code` is
pallas_nearest_code (argmax of -(||x||^2 - 2 x.e + ||e||^2)) and
`nearest_code_cosine` is pallas_nearest_code_cosine (argmax of x.e on
l2-normalised inputs); both return (N,) int64 indices, the first index on
ties. Each wrapper launches csrc/vq_codebook.cu for CUDA tensors, counting
launches in `<wrapper>.launches`, and computes its plain PyTorch twin for CPU
tensors.

The twins' arithmetic is the result: every dot product and squared norm is
summed over d in order from 0, each product and each sum rounded on its own
(the twins build them with one elementwise multiply and one add per d, never
a matmul, which would sum in another order or in TF32). The kernel screens
every code in TF32 on the tensor cores and rescores, with that arithmetic,
each code whose screen score lies within 2 eps_row of the row's running
screen max, eps_row bounding |screen - exact| (`screen_margin`; the
derivation is in the .cu header); so it agrees with the twins index for
index. The JAX function's precision="default" (single-pass bf16 products) is
not ported: no caller uses it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._checks import aligned, ptr, require, require_cuda, stream

# The screen's margin: eps_row = SCREEN_REL[cosine] * ||x|| * E
# (+ SCREEN_SQ * (||x||^2 + E^2), Euclidean) + SCREEN_ABS * (1 + ||x|| + E),
# E = max_k ||e_k||, norms in fp64 rounded up. The kernel takes these
# numbers from here; csrc/vq_codebook.cu derives them.
SCREEN_REL = {True: 2.0 ** -8, False: 2.0 ** -7}
SCREEN_SQ = 2.0 ** -20
SCREEN_ABS = 2.0 ** -110

# The kernel's tiles (csrc/vq_codebook.cu): 128 rows of x a CTA, 128 codes a
# ring stage, codes split over a cluster of up to 8 CTAs.
SEARCH_ROWS = 128
SEARCH_TILE = 128
_SPLITS = (1, 2, 4, 8)
_STAGE_FIXED = 1024        # a stage's e2 slot
_BLOCK = 128 * 128         # one 32-column block of 128 fp32 rows
_CANDIDATES = 256 * 2 * 4 * 8  # each thread's candidate buffers
_SMEM_TWO = 112 * 1024     # a CTA's share when two fit on an SM
_SMEM_ONE = 232448 - 2048  # one CTA an SM, beside its static barriers


def search_plan(N: int, K: int, D: int, sms: int) -> tuple:
    """(split, stages) of the kernel for N rows, K codes of width D (a
    multiple of 4) on `sms` SMs. The codes of a 128-row block are split
    over a cluster of `split` CTAs (tiles of 128 codes dealt out in
    contiguous runs, no rank left without one): the smallest split that
    gives every SM a CTA, since each split repeats a CTA's set-up and adds
    candidates to rescore. At N = 12544 (98 row blocks) on 132 SMs: split
    2. Stages: as many (up to 4) as let two CTAs share an SM, else as one
    CTA alone holds."""
    tiles = -(-K // SEARCH_TILE)
    blocks = -(-N // SEARCH_ROWS)
    split = 1
    for cand in _SPLITS[1:]:
        if blocks * split >= sms or (cand - 1) * -(-tiles // cand) >= tiles:
            break
        split = cand
    nb = -(-D // 32)
    stage = nb * _BLOCK + _STAGE_FIXED
    fixed = 1024 + nb * _BLOCK + _CANDIDATES + (split - 1) * SEARCH_ROWS * 8
    stages = min(4, (_SMEM_TWO - fixed) // stage)
    if stages < 2:
        stages = min(4, (_SMEM_ONE - fixed) // stage)
    return split, stages


def _norms_up(t: torch.Tensor) -> torch.Tensor:
    """||row|| in fp64, rounded up to fp32, as the kernel computes them."""
    n = t.double().square().sum(-1).sqrt()
    f = n.float()
    return torch.where(f.double() < n, torch.nextafter(f, torch.full_like(f, math.inf)), f)


def screen_margin(x: torch.Tensor, e: torch.Tensor, cosine: bool) -> torch.Tensor:
    """eps_row for each row of x (N, D) against the codebook e (K, D), fp32:
    a bound on |screen score - the twin's score| (Euclidean: the twin's
    score + ||x||^2) for every code, whether the tensor core truncates or
    rounds its TF32 operands."""
    nx, E = _norms_up(x.float()), _norms_up(e.float()).max()
    eps = SCREEN_REL[cosine] * nx * E + SCREEN_ABS * (1.0 + nx + E)
    if not cosine:
        eps = eps + SCREEN_SQ * (nx * nx + E * E)
    return eps


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
    if D % 4:  # TMA's 16-byte row stride: zero columns leave the in-order sums as they are
        pad = -D % 8
        x, e, D = F.pad(x, (0, pad)), F.pad(e, (0, pad)), D + pad
    require(aligned(x, 16) and aligned(e, 16), f"{name}: x and codebook must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split, stages = search_plan(N, K, D, sms)
    tiles = -(-K // SEARCH_TILE)
    e2 = torch.empty(tiles * SEARCH_TILE, dtype=torch.float32, device=dev)
    emax = torch.empty(tiles, dtype=torch.float32, device=dev)
    from . import _build

    code = _build.entry("nearest_code")(
        ptr(x), ptr(e), ptr(e2), ptr(emax), ptr(out), N, K, D, int(cosine), split, stages,
        SCREEN_REL[cosine], SCREEN_SQ, SCREEN_ABS, stream(dev))
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
