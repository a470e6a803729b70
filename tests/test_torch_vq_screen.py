"""The TF32 screen of the codebook search (fourm_torch/kernels/csrc/vq_codebook.cu)
emulated in plain torch on the CPU, against the exact twins.

The kernel screens every code with TF32 products on the tensor cores and
rescores exactly only the codes within 2 eps_row of the row's running screen
max; eps_row is `vq_codebook.screen_margin`, from the constants the kernel is
given. The emulation here rounds x and the codebook to TF32 both ways the
tensor core may (truncating the low 13 bits of each fp32 value, or rounding
them), sums the exact TF32 products in fp32 in a shuffled order, and holds
the result to the twins' exact values: |screen - exact| <= eps_row for every
row and code, the twin's winner survives the kernel's decision (tiles of 128
codes, codes split as `search_plan` splits them, a running max per split),
and the decision then picks the twin's index. It runs over random data and
the adversarial codebooks that chip_smoke.py holds the kernel to on the card:
codes that share their TF32 bits, near ties 1-4 ulps apart, duplicated codes,
K below one tile. On random data the kernel rescores about one candidate a
row for each split of the codes (the bound held below: at most 2 a row on
average for each split, 2 * split + 4 in any row); the screen's error stays
below 0.3 of eps_row there. The Euclidean search's exact values, shifted by
||x||^2, sit on the same bound.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from fourm_torch.kernels import vq_codebook as vc
from fourm_torch.vq import l2norm

SMS = 132  # an H100's SMs: the split the kernel takes there


def _tf32(t: torch.Tensor, mode: str) -> torch.Tensor:
    """fp32 values as the tensor core reads them: the low 13 mantissa bits
    dropped ('trunc') or rounded to nearest ('round')."""
    bits = t.contiguous().view(torch.int32)
    if mode == "round":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _exact(x, e, cosine):
    """The twins' values (N, K): the dot products, or the Euclidean value
    plus ||x||^2 (in fp64, exactly), whose argmax is the same."""
    dots = vc._dots(x, e)
    if cosine:
        return dots.double()
    x2 = vc._sq_norms(x)
    dist = -((x2[:, None] - 2.0 * dots) + vc._sq_norms(e)[None, :])
    return dist.double() + x2.double()[:, None]


def _screen(x, e, cosine, mode, seed):
    """The screen scores (N, K): TF32 products, exact in fp32, summed in
    fp32 in a shuffled order; Euclidean fl(2 acc - e2) in one rounding."""
    xt, et = _tf32(x, mode), _tf32(e, mode)
    acc = torch.zeros(x.shape[0], e.shape[0], dtype=torch.float32)
    for d in np.random.RandomState(seed).permutation(x.shape[1]):
        acc += xt[:, d, None] * et[None, :, d]
    if cosine:
        return acc
    return (2.0 * acc.double() - vc._sq_norms(e).double()[None, :]).float()


def _round_down(v: torch.Tensor) -> torch.Tensor:
    """fp64 values rounded down to fp32, as __fsub_rd rounds."""
    f = v.float()
    return torch.where(f.double() > v, torch.nextafter(f, torch.full_like(f, -np.inf)), f)


def _decide(s, exact, eps, split, K):
    """The kernel's decision: per split of the codes, a running screen max
    over 128-code tiles (each tile's max first), every code at or above the
    rounded-down max - 2 eps a candidate, the candidates still above the
    split's final threshold rescored; the best exact value wins, the first
    index on ties. Returns the indices and the rescored count per row."""
    tiles = -(-K // vc.SEARCH_TILE)
    per = -(-tiles // split)
    N = s.shape[0]
    best_v = torch.full((N,), -np.inf, dtype=torch.float64)
    best_i = torch.full((N,), K, dtype=torch.int64)
    rescored = torch.zeros(N, dtype=torch.int64)
    eps2 = 2.0 * eps.double()
    for rank in range(split):
        lo, hi = rank * per * vc.SEARCH_TILE, min(K, (rank + 1) * per * vc.SEARCH_TILE)
        if lo >= hi:
            continue
        m = torch.full((N,), -np.inf, dtype=torch.float64)
        cand = torch.zeros(N, hi - lo, dtype=torch.bool)
        for k0 in range(lo, hi, vc.SEARCH_TILE):
            k1 = min(hi, k0 + vc.SEARCH_TILE)
            tile = s[:, k0:k1].double()
            m = torch.maximum(m, tile.max(dim=1).values)
            cand[:, k0 - lo:k1 - lo] = tile >= _round_down(m - eps2).double()[:, None]
        final = cand & (s[:, lo:hi].double() >= _round_down(m - eps2).double()[:, None])
        rescored += final.sum(dim=1)
        v = torch.where(final, exact[:, lo:hi], torch.tensor(-np.inf, dtype=torch.float64))
        rv, ri = v.max(dim=1)  # the first index of the max
        better = rv > best_v  # ranks in order: an equal value keeps the smaller index
        best_v = torch.where(better, rv, best_v)
        best_i = torch.where(better, ri + lo, best_i)
    return best_i, rescored


def _check(x, e, cosine, random_data):
    twin = (vc.nearest_code_cosine_plain if cosine else vc.nearest_code_plain)(x, e)
    exact = _exact(x, e, cosine)
    eps = vc.screen_margin(x, e, cosine)
    D = x.shape[1]
    if D % 4:  # the wrapper's zero columns
        x = torch.nn.functional.pad(x, (0, -D % 8))
        e = torch.nn.functional.pad(e, (0, -D % 8))
    split, _ = vc.search_plan(x.shape[0], e.shape[0], x.shape[1], SMS)
    for mode in ("trunc", "round"):
        for seed in (0, 1):
            s = _screen(x, e, cosine, mode, seed)
            err = (s.double() - exact).abs().max(dim=1).values
            assert bool((err <= eps.double()).all()), (mode, seed, float((err / eps).max()))
            idx, rescored = _decide(s, exact, eps, split, e.shape[0])
            assert torch.equal(idx, twin), (mode, seed)
            if random_data:
                assert rescored.float().mean() <= 2.0 * split \
                    and rescored.max() <= 2 * split + 4, \
                    (mode, split, float(rescored.float().mean()), int(rescored.max()))
    return twin


@pytest.mark.parametrize("D", [16, 32, 128, 7])
@pytest.mark.parametrize("cosine", [True, False])
def test_screen_margin_holds_random(cosine, D):
    """Random latents and codebook (l2-normalised for cosine, N(0, 1) for
    the Euclidean form), K ragged against the tile: the bound holds under
    either TF32 reading and summation order, the decision gives the twin's
    indices, and few candidates are rescored."""
    rng = np.random.RandomState(40 + D)
    x = torch.from_numpy(rng.randn(192, D).astype(np.float32))
    e = torch.from_numpy(rng.randn(1000, D).astype(np.float32))
    if cosine:
        x, e = l2norm(x), l2norm(e)
    _check(x, e, cosine, random_data=True)


@pytest.mark.parametrize("name", ["tf32_collisions", "near_ties", "duplicates", "small_K"])
@pytest.mark.parametrize("cosine", [True, False])
def test_screen_margin_holds_adversarial(cosine, name):
    """chip_smoke.py's adversarial codebooks, at a small N: the bound, the
    decision and the twin's indices (first index on ties) hold."""
    gen = torch.Generator().manual_seed(7)
    x, e = chip_smoke.adversarial_codebooks(torch, gen, 256, 32, "cpu")[name]
    _check(x, e, cosine, random_data=False)


@pytest.mark.parametrize("cosine", [True, False])
def test_zero_margin_fails_on_tf32_collisions(cosine):
    """The collision codebook needs the margin: a screen that truncates its
    operands and keeps only the codes at the screen max (a zero margin) picks
    another index than the twin for some rows, as chip_smoke.py's planted
    fault does on the card."""
    gen = torch.Generator().manual_seed(7)
    x, e = chip_smoke.adversarial_codebooks(torch, gen, 256, 32, "cpu")["tf32_collisions"]
    twin = (vc.nearest_code_cosine_plain if cosine else vc.nearest_code_plain)(x, e)
    wrong = chip_smoke.zero_margin_search(torch, x, e, cosine)
    assert int((wrong != twin).sum()) > 0


@pytest.mark.parametrize("D", [7, 30])
@pytest.mark.parametrize("cosine", [True, False])
def test_zero_columns_leave_twin_indices(cosine, D):
    """The wrapper pads D % 4 != 0 with zero columns to a multiple of 8 for
    TMA: the twins' in-order sums, and so their indices, do not change."""
    rng = np.random.RandomState(D)
    x = torch.from_numpy(rng.randn(300, D).astype(np.float32))
    e = torch.from_numpy(rng.randn(700, D).astype(np.float32))
    if cosine:
        x, e = l2norm(x), l2norm(e)
    fn = vc.nearest_code_cosine_plain if cosine else vc.nearest_code_plain
    pad = -D % 8
    padded = fn(torch.nn.functional.pad(x, (0, pad)), torch.nn.functional.pad(e, (0, pad)))
    assert torch.equal(padded, fn(x, e))


def test_search_plan():
    """The split: the smallest that gives every SM a CTA (2 at the tokenize
    shape on an H100), none leaving a rank without a tile; stages: four
    where two CTAs share an SM."""
    assert vc.search_plan(12544, 16384, 32, SMS) == (2, 4)
    assert vc.search_plan(12544, 8192, 32, SMS) == (2, 4)
    assert vc.search_plan(1, 1, 32, SMS) == (1, 4)
    assert vc.search_plan(1, 16384, 32, SMS) == (8, 4)
    assert vc.search_plan(100000, 16384, 32, SMS) == (1, 4)
    assert vc.search_plan(12544, 16384, 128, SMS) == (2, 2)
    for N, K in [(1, 129), (1, 300), (1000, 1000)]:
        split, _ = vc.search_plan(N, K, 32, SMS)
        tiles = -(-K // vc.SEARCH_TILE)
        assert (split - 1) * -(-tiles // split) < tiles
