"""The attention twins of the port (fourm_torch/kernels/attention.py) against
the JAX package's Pallas kernels run with interpret=True, in fp32 on the CPU,
at the edges of the CUDA kernels' tiles: csrc/attention.cu takes 128 query
rows per CTA and 128 keys per tile, csrc/attn_block.cu 64-row blocks, 128-row
projection chunks and 64-key tiles. So sequence lengths of 1, 127, 129 and
197 (a ragged last tile in N and in M), a per-query-row bias with a fully
masked row, softmax1 over keys that are all masked, and attn_block past one
and two 64-row blocks with a key bias.

The CUDA kernels are held against these twins on the card by chip_smoke.py.
Tolerance: fp32, atol 1e-4 and rtol 1e-4 -- both sides compute the same fp32
arithmetic and differ only in summation order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.kernels.attention import (
    pallas_attention,
    pallas_attn_block,
    pallas_flash_mha,
    pallas_mha_short,
)
from fourm_torch.kernels import attention as at

TOL = dict(atol=1e-4, rtol=1e-4)
NEG = np.finfo(np.float32).min
Dh = 64


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(port, ref):
    out = port.detach().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def _key_bias(rng, B, M, full_row=True):
    mask = rng.rand(B, M) > 0.6
    if full_row:
        mask[-1] = True  # the last batch row: every key masked -> uniform weights
    return np.where(mask, NEG, 0.0).astype(np.float32)


EDGES = [(1, 1), (127, 129), (129, 127), (197, 197), (1, 197), (197, 1)]


def _ln(x32, g, b, eps=1e-6):
    """The QK-norm order of pallas_flash_mha's in-kernel _ln: fp32 mean, fp32
    mean of squared deviations, (x - mean) * rsqrt(var + eps) * g (+ b)."""
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps) * g
    return y + b if b is not None else y


def _jax_mha(q, k, v, H, bias, norms, allow_zero_attn=False):
    """JAX's multi-head attention on (B, N|M, C) heads-concatenated q, k, v:
    pallas_flash_mha where its blocking takes N and M (multiples of 128),
    else the per-head path the JAX model falls back to -- heads split, _ln
    on q and k, pallas_attention."""
    ref = pallas_flash_mha(_j(q), _j(k), _j(v), H, _j(bias), *[_j(a) for a in norms],
                           allow_zero_attn=allow_zero_attn, interpret=True)
    if ref is not None:
        return ref
    B, N, C = q.shape

    def heads(t):
        return jnp.asarray(t).reshape(B, t.shape[1], H, C // H).transpose(0, 2, 1, 3)

    qh, kh, vh = heads(q), heads(k), heads(v)
    if norms[0] is not None:
        qh, kh = _ln(qh, _j(norms[0]), _j(norms[1])), _ln(kh, _j(norms[2]), _j(norms[3]))
    out = pallas_attention(qh, kh, vh, None if bias is None else _j(bias)[:, None, None, :],
                           allow_zero_attn=allow_zero_attn, interpret=True)
    return out.transpose(0, 2, 1, 3).reshape(B, N, C)


@pytest.mark.parametrize("N,M", EDGES + [(128, 256)])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_flash_mha_twin_at_tile_edges(N, M, qk_norm):
    rng = np.random.RandomState(N * 1000 + M)
    B, H = 2, 2
    C = H * Dh
    q = rng.randn(B, N, C).astype(np.float32)
    k, v = (rng.randn(B, M, C).astype(np.float32) for _ in range(2))
    bias = _key_bias(rng, B, M)
    norms = [None] * 4
    if qk_norm:
        norms = [(rng.rand(Dh) + 0.5).astype(np.float32), rng.randn(Dh).astype(np.float32) * 0.1,
                 (rng.rand(Dh) + 0.5).astype(np.float32), rng.randn(Dh).astype(np.float32) * 0.1]
    ref = _jax_mha(q, k, v, H, bias, norms)
    port = at.flash_mha(_t(q), _t(k), _t(v), H, _t(bias), *[_t(a) for a in norms])
    _close(port, ref)


@pytest.mark.parametrize("N,M", EDGES)
@pytest.mark.parametrize("bias_kind", ["row", "key"])
def test_attention_twin_at_tile_edges(N, M, bias_kind):
    """A per-query-row (B, 1, N, M) bias with one query row fully masked, or
    a (B, 1, 1, M) key bias with one batch row fully masked."""
    rng = np.random.RandomState(7 + N * 1000 + M)
    B, H = 2, 3
    q = rng.randn(B, H, N, Dh).astype(np.float32)
    k, v = (rng.randn(B, H, M, Dh).astype(np.float32) for _ in range(2))
    if bias_kind == "row":
        bias = rng.randn(B, 1, N, M).astype(np.float32)
        bias[:, :, N // 2] = NEG
    else:
        bias = _key_bias(rng, B, M)[:, None, None, :]
    ref = pallas_attention(_j(q), _j(k), _j(v), _j(bias), interpret=True)
    port = at.attention(_t(q), _t(k), _t(v), _t(bias))
    _close(port, ref)
    if bias_kind == "row":  # the masked query row attends every key alike
        torch.testing.assert_close(port[:, :, N // 2], _t(v).mean(dim=2), **TOL)


@pytest.mark.parametrize("N,M", [(1, 1), (129, 127), (197, 197)])
def test_softmax1_with_every_key_masked(N, M):
    """softmax1's implicit zero logit wins over keys that all carry finfo.min:
    the output is exactly 0, never NaN, in attention and flash_mha."""
    rng = np.random.RandomState(11 + N)
    B, H = 2, 2
    q = rng.randn(B, H, N, Dh).astype(np.float32)
    k, v = (rng.randn(B, H, M, Dh).astype(np.float32) for _ in range(2))
    bias = np.full((B, 1, 1, M), NEG, dtype=np.float32)
    ref = pallas_attention(_j(q), _j(k), _j(v), _j(bias), allow_zero_attn=True, interpret=True)
    port = at.attention(_t(q), _t(k), _t(v), _t(bias), allow_zero_attn=True)
    _close(port, ref)
    assert float(port.abs().max()) == 0.0
    heads = [np.ascontiguousarray(t.transpose(0, 2, 1, 3).reshape(B, -1, H * Dh))
             for t in (q, k, v)]
    ref = _jax_mha(*heads, H, bias[:, 0, 0], [None] * 4, allow_zero_attn=True)
    port = at.flash_mha(*[_t(t) for t in heads], H, _t(bias[:, 0, 0]), allow_zero_attn=True)
    _close(port, ref)
    assert float(port.abs().max()) == 0.0


@pytest.mark.parametrize("N", [1, 129, 197])
@pytest.mark.parametrize("zero_attn", [False, True])
def test_mha_short_twin_at_tile_edges(N, zero_attn):
    rng = np.random.RandomState(13 + N)
    B, H = 3, 2
    qkv = rng.randn(B, N, 3 * H * Dh).astype(np.float32)
    bias = _key_bias(rng, B, N)
    ref = pallas_mha_short(_j(qkv), H, _j(bias), allow_zero_attn=zero_attn, interpret=True)
    port = at.mha_short(_t(qkv), H, _t(bias), zero_attn)
    _close(port, ref)


@pytest.mark.parametrize("N", [129, 200])
@pytest.mark.parametrize("zero_attn", [False, True])
def test_attn_block_twin_at_tile_edges(N, zero_attn):
    """Past one 128-row projection chunk (129) and into a fourth 64-key tile
    (200), with a key bias whose last image is fully masked."""
    rng = np.random.RandomState(17 + N)
    B, H = 2, 2
    C = H * Dh
    x = rng.randn(B, N, C).astype(np.float32)
    gamma = (rng.rand(C) + 0.5).astype(np.float32)
    beta = (rng.randn(C) * 0.1).astype(np.float32)
    wq = (rng.randn(C, 3 * C) * C ** -0.5).astype(np.float32)  # JAX layout (in, out)
    bq = (rng.randn(3 * C) * 0.1).astype(np.float32)
    wp = (rng.randn(C, C) * C ** -0.5).astype(np.float32)
    bp = (rng.randn(C) * 0.1).astype(np.float32)
    bias = _key_bias(rng, B, N)
    ref = pallas_attn_block(_j(x), _j(gamma), _j(beta), _j(wq), _j(bq), _j(wp), _j(bp), H,
                            _j(bias), allow_zero_attn=zero_attn, interpret=True)
    port = at.attn_block(_t(x), _t(gamma), _t(beta), _t(wq.T.copy()), _t(bq), _t(wp.T.copy()),
                         _t(bp), H, _t(bias), allow_zero_attn=zero_attn)
    _close(port, ref)
