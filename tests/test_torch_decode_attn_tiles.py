"""The decode attention twins at the edges of csrc/decode_attn.cu's split
plan (`decode_attention_plan`), on the CPU in fp32, against the JAX
package's Pallas kernels run with interpret=True (atol 2e-5, rtol 1e-4, as
tests/test_torch_decode_tiles.py: the same fp32 arithmetic in another
summation order), with heads of 64 as on the card:

  * decode_attention against pallas_decode_attention where M is a multiple
    of 128 (the only M it takes), else against the XLA function it stands in
    for (fourm_tpu.ops.transformer.decode_attention); B in {1, 3, 9}; the
    bias shapes (1, 1, M), (B, 1, M) and (B, H, M) and none; a row whose keys
    are all masked; softmax1;
  * cross_decode_attn against pallas_cross_decode_attn, bf16 and int8 K/V
    (k_scale, v_scale), and decode_attention_int8 on the same q;
  * M = 1, 63, 64, 65 and both sides of each boundary between the plan's
    splits (one split, then several; splits of one 64-key tile and of
    many);
  * the plan itself: every key covered once and in rank order, no rank
    empty, the cluster at most 16 CTAs, the ring as deep as its byte budget
    allows within shared memory, the smallest split that reaches its target
    grid within one wave, and the 4M-21 B and XL chain shapes filling one
    wave of 132 SMs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.kernels.decode_step import pallas_cross_decode_attn, pallas_decode_attention
from fourm_tpu.ops.transformer import decode_attention as xla_decode_attention
from fourm_torch.kernels import decode_step as ds

KTOL = dict(atol=2e-5, rtol=1e-4)
NEG = np.finfo(np.float32).min
DH = 64


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _dm(a):
    """(B, H, M, Dh) -> the TPU kernels' (B, H, Dh, M)."""
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 1, 3, 2)))


def _split_edges(B, H, M_max, int8=False):
    """M = 1, 63, 64, 65 and both sides of each boundary between the splits
    of the plan at M_max, up to M_max."""
    plan = ds.decode_attention_plan(B, H, M_max, int8)
    bounds = [r * plan["keys"] for r in range(1, plan["split"])]
    ms = {1, 63, 64, 65, M_max} | {m + d for m in bounds for d in (-1, 0, 1)}
    return sorted(m for m in ms if 1 <= m <= M_max)


def _bias(rng, kind, B, H, M):
    """An fp32 additive bias of the kind's shape, 40% of the keys masked with
    finfo.min, and, where it has rows per batch, batch row 0 wholly masked
    (uniform weights)."""
    if kind is None:
        return None
    shape = {"11": (1, 1, M), "B1": (B, 1, M), "BH": (B, H, M)}[kind]
    bias = np.where(rng.rand(*shape) < 0.4, NEG, 0.0).astype(np.float32)
    bias += rng.randn(*shape).astype(np.float32) * (bias == 0)
    if kind != "11":
        bias[0] = NEG
    return bias


# (B, H, M_max, bias kind, softmax1)
ATTN_CASES = [
    (1, 2, 640, "B1", False),   # B * H small: ten splits of one 64-key tile
    (3, 2, 300, "BH", True),
    (9, 1, 200, "11", False),
    (3, 1, 130, None, True),
    (9, 6, 2048, "B1", False),  # splits of several tiles (keys 384)
]


@pytest.mark.parametrize("B,H,M_max,kind,zero_attn", ATTN_CASES)
def test_decode_attention_twin_at_split_edges(B, H, M_max, kind, zero_attn):
    rng = np.random.RandomState(300 + B + H + M_max)
    for M in _split_edges(B, H, M_max):
        q = rng.randn(B, H, 1, DH).astype(np.float32)
        k = rng.randn(B, H, M, DH).astype(np.float32)
        v = rng.randn(B, H, M, DH).astype(np.float32)
        bias = _bias(rng, kind, B, H, M)
        if M % 128 == 0:
            ref = pallas_decode_attention(jnp.asarray(q), _dm(k), _dm(v), _j(bias),
                                          allow_zero_attn=zero_attn, interpret=True)
        else:  # pallas_decode_attention takes M % 128 == 0 only
            ref = xla_decode_attention(jnp.asarray(q), _dm(k), _dm(v), _j(bias),
                                       allow_zero_attn=zero_attn)
        port = ds.decode_attention(_t(q), _t(k), _t(v), _t(bias), zero_attn)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), **KTOL, err_msg=f"M={M}")
        assert not torch.isnan(port).any()
        if kind in ("B1", "BH") and not zero_attn:  # the masked row: uniform weights
            np.testing.assert_allclose(port.numpy()[0, :, 0], v[0].mean(axis=1), **KTOL)


# (B, heads, M_max, QK-norm and biases, masked, softmax1)
CROSS_CASES = [
    (1, 2, 200, True, True, False),
    (3, 1, 130, False, True, True),
    (3, 16, 600, True, False, False),  # splits of several tiles (keys 256; 128 in int8)
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,H,M_max,qk_norm,masked,zero_attn", CROSS_CASES)
def test_cross_decode_attn_twin_at_split_edges(B, H, M_max, qk_norm, masked, zero_attn, int8):
    rng = np.random.RandomState(400 + B + H + M_max + int8)
    C = H * DH
    for M in _split_edges(B, H, M_max, int8):
        x = rng.randn(B, C).astype(np.float32) * 0.5
        gq = (rng.rand(C) + 0.5).astype(np.float32)
        bqn = rng.randn(C).astype(np.float32) * 0.1 if qk_norm else None
        wq = (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)  # JAX layout (C_in, C_out)
        bq = rng.randn(C).astype(np.float32) * 0.1 if qk_norm else None
        cq = [(rng.rand(DH) + 0.5).astype(np.float32),
              rng.randn(DH).astype(np.float32) * 0.1] if qk_norm else [None, None]
        k = rng.randn(B, H, M, DH).astype(np.float32)
        v = rng.randn(B, H, M, DH).astype(np.float32)
        bias = _bias(rng, "B1", B, 1, M)[:, 0] if masked else None
        scales = {}
        if int8:
            k8, ks, v8, vs = ds.quantize_kv_decode(_t(k), _t(v))
            k, v = k8.numpy(), v8.numpy()
            scales = dict(k_scale=ks.numpy(), v_scale=vs.numpy())
        ref = pallas_cross_decode_attn(
            jnp.asarray(x), jnp.asarray(gq), _j(bqn), jnp.asarray(wq), _j(bq), *map(_j, cq),
            _dm(k), _dm(v), _j(bias), H, allow_zero_attn=zero_attn,
            **{n: jnp.asarray(s) for n, s in scales.items()}, interpret=True)
        assert ref is not None, f"pallas_cross_decode_attn found no blocking at M={M}"
        args = (_t(x), _t(gq), _t(bqn), _t(wq.T.copy()), _t(bq), *map(_t, cq))
        port = ds.cross_decode_attn(*args, _t(k), _t(v), _t(bias), H, allow_zero_attn=zero_attn,
                                    **{n: _t(s) for n, s in scales.items()})
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), **KTOL, err_msg=f"M={M}")
        assert not torch.isnan(port).any()
        if int8:  # decode_attention_int8 on the same q
            q = ds._cross_q_plain(*args, H, 1e-6)
            b3 = None if bias is None else _t(bias)[:, None, :]
            att = ds.decode_attention_int8(q, _t(k), _t(v), _t(scales["k_scale"]),
                                           _t(scales["v_scale"]), b3, zero_attn)
            np.testing.assert_allclose(att.reshape(B, C).numpy(), np.asarray(ref), **KTOL,
                                       err_msg=f"decode_attention_int8, M={M}")


# ------------------------------------------------------------------ the plan

def _check_plan(B, H, M, int8, sms=ds.SMS):
    p = ds.decode_attention_plan(B, H, M, int8, sms)
    split, keys, stages = p["split"], p["keys"], p["stages"]
    tile = ds.DECODE_TILE
    assert p["tiles"] == -(-M // tile)
    assert 1 <= split <= ds.DECODE_MAX_SPLIT and keys % tile == 0
    # every key once, in rank order, no rank empty (the kernel's ranges)
    cover = np.zeros(M, np.int32)
    last = 0
    for r in range(split):
        lo, hi = r * keys, min((r + 1) * keys, M)
        assert lo == last and hi > lo, (r, lo, hi)
        cover[lo:hi] += 1
        last = hi
    assert last == M and (cover == 1).all()
    # the ring: as deep as DECODE_RING bytes allow (up to 8 stages), no
    # deeper than a rank's tiles; `per_sm` CTAs of it fit an SM
    stage = ds.decode_attention_smem(1, 1, int8) - 1024
    ring = min(ds.DECODE_MAX_STAGES, ds.DECODE_RING // stage)
    assert stages == min(ring, keys // tile) >= 1
    assert ring * stage <= ds.DECODE_RING

    def per_sm(s, st):
        smem = ds.decode_attention_smem(st, s, int8)
        assert smem <= ds.MAX_SMEM
        return min(ds.DECODE_CTAS_PER_SM, ds.SM_SMEM // (smem + ds.DECODE_STATIC_SMEM + 1024))

    assert p["per_sm"] == per_sm(split, stages) >= 1
    # the smallest split whose grid reaches the target (an SM's worth of CTAs
    # in bf16, 1.5 in int8), within one wave and the cluster's 16; then the
    # same keys a rank over as few ranks as cover M
    target = ds.DECODE_TARGET_CTAS[int8] * sms
    fits = [s for s in range(1, min(ds.DECODE_MAX_SPLIT, p["tiles"]) + 1)
            if s == 1 or B * H * s <= sms * per_sm(s, ring)]
    s0 = next((s for s in fits if B * H * s >= target), fits[-1])
    assert split == -(-p["tiles"] // -(-p["tiles"] // s0)), (B, H, M, int8, p)
    assert split == 1 or B * H * split <= sms * p["per_sm"]
    return p


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,H", [(1, 1), (1, 12), (3, 2), (4, 32), (8, 12), (9, 6), (16, 12),
                                 (64, 32)])
def test_decode_attention_plan(B, H, int8):
    for M in (1, 63, 64, 65, 128, 333, 1024, 2048, 2304, 2900, 8192):
        _check_plan(B, H, M, int8)
    _check_plan(B, H, 2304, int8, sms=114)  # another card


def test_chain_plans_fill_one_wave():
    """The decode steps of the 4M-21 B chain (B = 8, 12 heads, M = 2048 and
    2900), the XL chain (B = 4 and 8, 32 heads, M = 2304) and the int8
    microbenchmark shapes run in one wave that covers every SM."""
    for B, H, M, int8 in ((8, 12, 2048, False), (8, 12, 2900, False), (4, 32, 2304, False),
                          (8, 32, 2304, False), (16, 12, 2304, True), (4, 32, 2304, True)):
        p = _check_plan(B, H, M, int8)
        ctas = B * H * p["split"]
        assert ds.SMS <= ctas <= ds.SMS * p["per_sm"], (B, H, M, p)
