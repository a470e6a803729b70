"""The decode-step twins at the tile edges of their CUDA kernels' plans, on
the CPU in fp32, against the JAX package's Pallas kernels run with
interpret=True (atol 2e-5, rtol 1e-4, as tests/test_torch_decode.py: the same
fp32 arithmetic in another summation order), with heads of 64 as on the card:

  * self_decode: B in {1, 3, 9, 17}; steps 0, 1, L - 1, L, L + 3 and both
    sides of each boundary between the 32-position chunks its attention
    kernel splits L into over its warps (`self_decode_plan`), at L on both
    sides of the first split (one warp, then two) and past sixteen chunks;
    QK-norm with and without biases; softmax1;
  * residual_mlp: B in {1, 3, 9, 17}; hidden widths 64, 100 and 136 (ragged
    against the 64-row weight tiles, not always a multiple of 8); SwiGLU
    and GELU, with biases;
  * the tile plans (`gemv_plan`, `self_decode_plan`, `residual_mlp_plan`):
    every weight row and K element covered once, the N tile covering B,
    staged tokens within shared memory, at least one wave of the card
    where the rows and K allow.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.kernels.decode_step import pallas_residual_mlp, pallas_self_decode
from fourm_torch.kernels import decode_step as ds

KTOL = dict(atol=2e-5, rtol=1e-4)
DH = 64


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _norm(rng, n, bias):
    return (rng.rand(n) + 0.5).astype(np.float32), \
        (rng.randn(n).astype(np.float32) * 0.1 if bias else None)


def _chunk_edges(L):
    """The steps on both sides of each boundary between self_decode's
    attention chunks (a warp per 32 positions) below L."""
    return [s for j in range(ds.CACHE_CHUNK, L, ds.CACHE_CHUNK) for s in (j - 1, j, j + 1)]


# (heads, B, L, QK-norm: None / "plain" / "biases", biases, softmax1)
SELF_CASES = [
    (2, 1, 16, "plain", False, False),
    (2, 3, 16, "biases", True, True),
    (2, 9, 16, None, True, False),
    (1, 17, 16, "plain", False, True),
    (1, 3, ds.CACHE_CHUNK, "biases", False, False),      # one warp
    (1, 3, ds.CACHE_CHUNK + 1, "plain", True, False),    # two warps: the first split
    (1, 1, 1100, None, True, True),                       # 16 warps of 2-3 chunks each
]


@pytest.mark.parametrize("H,B,L,qk,biases,zero_attn", SELF_CASES)
def test_self_decode_twin_at_tile_edges(H, B, L, qk, biases, zero_attn):
    rng = np.random.RandomState(100 + B + L)
    C = H * DH
    x = rng.randn(B, C).astype(np.float32) * 0.5
    g1, b1 = _norm(rng, C, biases)
    w = (rng.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32)  # JAX layout (C, 3C)
    bq = rng.randn(3 * C).astype(np.float32) * 0.1 if biases else None
    qn = [None] * 4
    if qk is not None:
        qn = [*_norm(rng, DH, qk == "biases"), *_norm(rng, DH, qk == "biases")]
    ck = rng.randn(B, H, L, DH).astype(np.float32) * 0.5
    cv = rng.randn(B, H, L, DH).astype(np.float32) * 0.5
    steps = sorted({0, 1, L - 1, L, L + 3, *_chunk_edges(L)})
    for step in steps:
        ref, rk, rv = pallas_self_decode(
            jnp.asarray(x), jnp.asarray(g1), _j(b1), jnp.asarray(w), _j(bq), *map(_j, qn),
            jnp.asarray(ck.transpose(0, 1, 3, 2)), jnp.asarray(cv.transpose(0, 1, 3, 2)),
            jnp.int32(step), H, allow_zero_attn=zero_attn, interpret=True)
        tk, tv = _t(ck), _t(cv)
        port = ds.self_decode(_t(x), _t(g1), _t(b1), _t(w.T.copy()), _t(bq), *map(_t, qn), tk, tv,
                              torch.tensor([step], dtype=torch.int32), H,
                              allow_zero_attn=zero_attn)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), **KTOL, err_msg=f"step {step}")
        np.testing.assert_allclose(tk.numpy(), np.asarray(rk).transpose(0, 1, 3, 2), **KTOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv).transpose(0, 1, 3, 2), **KTOL)
        untouched = np.arange(L) != step  # a step at or past L writes nothing
        np.testing.assert_array_equal(tk.numpy()[:, :, untouched], ck[:, :, untouched])
        np.testing.assert_array_equal(tv.numpy()[:, :, untouched], cv[:, :, untouched])


# (B, hidden, gated)
MLP_CASES = [(1, 64, True), (3, 100, True), (9, 136, True), (17, 100, True),
             (1, 136, False), (3, 64, False), (9, 100, False), (17, 136, False)]


@pytest.mark.parametrize("B,HID,gated", MLP_CASES)
def test_residual_mlp_twin_at_tile_edges(B, HID, gated):
    rng = np.random.RandomState(200 + B + HID)
    C = 2 * DH
    x, attn = (rng.randn(B, C).astype(np.float32) for _ in range(2))
    wp = (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
    bp = rng.randn(C).astype(np.float32) * 0.1
    g2, be2 = _norm(rng, C, True)
    w1, w3 = ((rng.randn(C, HID) / np.sqrt(C)).astype(np.float32) for _ in range(2))
    w2 = (rng.randn(HID, C) / np.sqrt(HID)).astype(np.float32)
    b1, b3 = (rng.randn(HID).astype(np.float32) * 0.1 for _ in range(2))
    b2 = rng.randn(C).astype(np.float32) * 0.1
    ref = pallas_residual_mlp(
        jnp.asarray(x), jnp.asarray(attn), jnp.asarray(wp), _j(bp), jnp.asarray(g2), _j(be2),
        jnp.asarray(w1), _j(b1), jnp.asarray(w2), _j(b2), _j(w3) if gated else None,
        _j(b3) if gated else None, gated=gated, act_silu=gated, interpret=True)
    port = ds.residual_mlp(_t(x), _t(attn), _t(wp.T.copy()), _t(bp), _t(g2), _t(be2),
                           _t(w1.T.copy()), _t(b1), _t(w2.T.copy()), _t(b2),
                           _t(w3.T.copy()) if gated else None, _t(b3) if gated else None,
                           gated=gated)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **KTOL)


# ------------------------------------------------------------------ the plans

def _check_gemv_plan(p, rows, K, B, dual, ln=False, sms=ds.SMS):
    assert p is not None, (rows, K, B, dual)
    nt = p["nt"]
    covering = next(n for n in ds.GEMV_N_TILES if n >= min(B, 64))
    assert nt in ds.GEMV_N_TILES and nt <= covering  # the smallest that covers B, or ...
    for larger in (n for n in ds.GEMV_N_TILES if nt < n <= covering):  # ... none larger fits
        assert all(ds.gemv_smem(larger, -(-p["nkb"] // s), dual, ln, s) > ds.MAX_SMEM
                   for s in range(1, ds.GEMV_MAX_SPLIT + 1))
    assert p["passes"] * nt >= B > (p["passes"] - 1) * nt
    assert p["tiles"] * ds.GEMV_TM >= rows > (p["tiles"] - 1) * ds.GEMV_TM
    assert ds.gemv_smem(nt, p["kpb"], dual, ln, p["split"]) <= ds.MAX_SMEM
    assert 1 <= p["split"] <= ds.GEMV_MAX_SPLIT
    # every (row, K element) once: a CTA per (64-row tile, rank), rank r of
    # a cluster holding K blocks [r kpb, min((r + 1) kpb, nkb)), every rank
    # some (the grid is the product of the two)
    row_cover = np.zeros(p["tiles"] * ds.GEMV_TM, np.int32)
    for tile in range(p["tiles"]):
        row_cover[tile * ds.GEMV_TM:(tile + 1) * ds.GEMV_TM] += 1
    k_cover = np.zeros(p["split"] * p["kpb"] * ds.GEMV_TK, np.int32)
    for rank in range(p["split"]):
        k0 = rank * p["kpb"] * ds.GEMV_TK
        k1 = min((rank + 1) * p["kpb"], p["nkb"]) * ds.GEMV_TK
        assert k1 > k0, "a rank without K blocks"
        k_cover[k0:k1] += 1
    assert (row_cover[:rows] == 1).all() and (k_cover[:K] == 1).all()
    assert p["nkb"] * ds.GEMV_TK >= K > (p["nkb"] - 1) * ds.GEMV_TK
    # at least one full wave where the rows and K allow, with the whole grid
    # resident at once (two CTAs an SM at most): the smallest such split,
    # else the largest resident one
    def resident(split):
        kpb = -(-p["nkb"] // split)
        smem = ds.gemv_smem(nt, kpb, dual, ln, split)
        per_sm = min(ds.GEMV_CTAS_PER_SM, ds.SM_SMEM // (smem + 1024))
        return (-(-p["nkb"] // kpb) == split and smem <= ds.MAX_SMEM
                and p["tiles"] * split * p["passes"] <= sms * per_sm)

    splits = range(1, max(1, min(p["nkb"] // ds.GEMV_MIN_KPB, ds.GEMV_MAX_SPLIT)) + 1)
    assert p["split"] in splits  # at least GEMV_MIN_KPB K blocks a CTA where K has them
    full = [s for s in splits if resident(s) and p["tiles"] * s * p["passes"] >= sms]
    if full:
        assert p["split"] == full[0], (p, full)
    elif any(resident(s) for s in splits):
        assert p["split"] == max(s for s in splits if resident(s)), p


# the registry's widths, a narrow ragged one, and the predicates' limits
WIDTHS = {"4M-B": (768, 2048), "4M-L": (1024, 2730), "4M-XL": (2048, 5461), "narrow": (384, 100),
          "limits": (2048, 8192)}


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("B", [1, 3, 4, 8, 9, 16, 17, 64, 65, 130])
def test_decode_tile_plans(width, B):
    C, HID = WIDTHS[width]
    hids = -(-HID // 8) * 8
    for gated in (True, False):
        plan = ds.residual_mlp_plan(B, C, HID, gated)
        _check_gemv_plan(plan["proj"], C, C, B, False)
        _check_gemv_plan(plan["hidden"], HID, C, B, gated, ln=True)
        _check_gemv_plan(plan["out"], C, hids, B, False)
    for L in (1, 64, 65, 256, 1100, 8192):
        plan = ds.self_decode_plan(B, C, L)
        _check_gemv_plan(plan["qkv"], 3 * C, C, B, False, ln=True)
        # a warp per 32-position chunk, up to 16: every chunk has a warp
        assert plan["warps"] == min(ds.CACHE_MAX_WARPS, -(-L // ds.CACHE_CHUNK))


def test_xl_path_plans_fill_the_card():
    """The products of the 4M-21 XL and 4M-L decode steps (B = 4) launch at
    least one wave of 132 SMs, and every product keeps at least
    GEMV_MIN_KPB K blocks a CTA (at 4M-B, fewer CTAs than SMs)."""
    for B, C, HID in ((4, 2048, 5461), (4, 1024, 2730), (8, 768, 2048), (16, 768, 2048)):
        plans = dict(ds.residual_mlp_plan(B, C, HID, True),
                     qkv=ds.self_decode_plan(B, C, 256)["qkv"])
        for name, p in plans.items():
            assert p["kpb"] >= min(ds.GEMV_MIN_KPB, p["nkb"]), (B, C, name, p)
            if C == 2048 or (C == 1024 and name != "proj"):
                assert p["tiles"] * p["split"] * p["passes"] >= ds.SMS, (B, C, name, p)
