"""The plain PyTorch twins of the port's kernels (fourm_torch/kernels) against
the JAX package's Pallas kernels run with interpret=True, in fp32 on the CPU.

The CUDA kernels themselves are held against these twins on the card by
chip_smoke.py. Tolerance: fp32, atol 1e-5 and rtol 1e-5 — both sides compute
the same fp32 arithmetic and differ only in summation order (and, for the
GELU MLP, in the Pallas kernel's 1.5e-7 rational erf)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.kernels.attention import flash_attention, pallas_attention, pallas_flash_mha
from fourm_tpu.kernels.fused_mlp import pallas_ln_matmul, pallas_ln_mlp
from fourm_tpu.ops.transformer import mask_to_bias as jax_mask_to_bias
from fourm_torch.kernels.attention import attention, flash_mha
from fourm_torch.kernels.fused_mlp import ln_matmul, ln_mlp
from fourm_torch.ops.transformer import MASK_FILL_VALUE, mask_to_bias

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("norm_bias,mm_bias", [(True, True), (False, False)])
def test_ln_matmul_twin(norm_bias, mm_bias):
    rng = np.random.RandomState(0)
    M, D, F = 96, 64, 192
    x = rng.randn(M, D).astype(np.float32)
    gamma = (rng.rand(D) + 0.5).astype(np.float32)
    beta = rng.randn(D).astype(np.float32) if norm_bias else None
    w = (rng.randn(D, F) / 8).astype(np.float32)  # JAX layout (D, F)
    b = rng.randn(F).astype(np.float32) if mm_bias else None
    ref = pallas_ln_matmul(jnp.asarray(x), jnp.asarray(gamma),
                           None if beta is None else jnp.asarray(beta), jnp.asarray(w),
                           None if b is None else jnp.asarray(b), interpret=True)
    port = ln_matmul(_t(x), _t(gamma), None if beta is None else _t(beta), _t(w.T.copy()),
                     None if b is None else _t(b))
    _close(port, ref)


@pytest.mark.parametrize("gated", [False, True])
def test_ln_mlp_twin(gated):
    rng = np.random.RandomState(1)
    M, D, HID = 80, 64, 128
    x = rng.randn(M, D).astype(np.float32)
    gamma = (rng.rand(D) + 0.5).astype(np.float32)
    beta = rng.randn(D).astype(np.float32)
    w1, w3 = [(rng.randn(D, HID) / 8).astype(np.float32) for _ in range(2)]
    w2 = (rng.randn(HID, D) / 11).astype(np.float32)
    b1, b3 = [rng.randn(HID).astype(np.float32) * 0.1 for _ in range(2)]
    b2 = rng.randn(D).astype(np.float32) * 0.1
    j = jnp.asarray
    ref = pallas_ln_mlp(j(x), j(gamma), j(beta), j(w1), j(b1), j(w2), j(b2),
                        j(w3) if gated else None, j(b3) if gated else None,
                        gated=gated, interpret=True)
    port = ln_mlp(_t(x), _t(gamma), _t(beta), _t(w1.T.copy()), _t(b1), _t(w2.T.copy()),
                  _t(b2), _t(w3.T.copy()) if gated else None, _t(b3) if gated else None,
                  gated=gated)
    _close(port, ref)


@pytest.mark.parametrize("qk_norm,key_bias,zero_attn",
                         [(False, False, False), (True, True, False), (True, False, True),
                          (False, True, False)])
def test_flash_mha_twin(qk_norm, key_bias, zero_attn):
    rng = np.random.RandomState(2)
    B, N, H, Dh = 2, 128, 4, 16
    C = H * Dh
    qkv = rng.randn(B, N, 3 * C).astype(np.float32)
    bias = None
    if key_bias:
        mask = rng.rand(B, N) > 0.6
        mask[1] = True  # batch row 1: every key masked -> uniform weights
        bias = np.where(mask, np.finfo(np.float32).min, 0.0).astype(np.float32)
    norms = [None] * 4
    if qk_norm:
        norms = [(rng.rand(Dh) + 0.5).astype(np.float32), rng.randn(Dh).astype(np.float32) * 0.1,
                 (rng.rand(Dh) + 0.5).astype(np.float32), rng.randn(Dh).astype(np.float32) * 0.1]
    jq = jnp.asarray(qkv)
    ref = pallas_flash_mha(jq[..., :C], jq[..., C:2 * C], jq[..., 2 * C:], H,
                           None if bias is None else jnp.asarray(bias),
                           *[None if a is None else jnp.asarray(a) for a in norms],
                           allow_zero_attn=zero_attn, interpret=True)
    assert ref is not None
    tq = _t(qkv)
    port = flash_mha(tq[..., :C], tq[..., C:2 * C], tq[..., 2 * C:], H,
                     None if bias is None else _t(bias),
                     *[None if a is None else _t(a) for a in norms], allow_zero_attn=zero_attn)
    _close(port, ref)
    assert not torch.isnan(port).any()


@pytest.mark.parametrize("bias_kind,zero_attn",
                         [("key", False), ("full", False), ("full", True), ("none", True)])
def test_attention_twin(bias_kind, zero_attn):
    rng = np.random.RandomState(3)
    B, H, N, M, Dh = 2, 3, 40, 72, 16
    q, k, v = (rng.randn(B, H, n, Dh).astype(np.float32) for n in (N, M, M))
    bias = None
    if bias_kind == "key":
        bias = np.asarray(jax_mask_to_bias(jnp.asarray(rng.rand(B, 1, M) > 0.4), N))  # (B,1,1,M)
    elif bias_kind == "full":
        bias = rng.randn(B, H, N, M).astype(np.float32)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = pallas_attention(j(q), j(k), j(v), j(bias), allow_zero_attn=zero_attn, interpret=True)
    port = attention(_t(q), _t(k), _t(v), None if bias is None else _t(bias), zero_attn)
    _close(port, ref)


def test_attention_twin_long_stands_for_flash_attention():
    """N*M > 1024^2: pallas_attention hands off to the blocked flash_attention;
    the port's one online-softmax kernel (and its twin) serves both."""
    rng = np.random.RandomState(4)
    B, H, N, M, Dh = 1, 1, 1056, 1024, 16
    assert N * M > 1024 * 1024
    q, k, v = (rng.randn(B, H, n, Dh).astype(np.float32) for n in (N, M, M))
    mask = rng.rand(B, 1, M) > 0.5
    bias = np.asarray(jax_mask_to_bias(jnp.asarray(mask), N))
    ref = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                           interpret=True)
    ref_flash = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias), interpret=True)
    port = attention(_t(q), _t(k), _t(v), _t(bias))
    _close(port, ref)
    _close(port, ref_flash)


def test_fully_masked_rows_are_uniform_not_nan():
    """The CFG unconditional branch masks every conditioning key: the finite
    finfo.min bias must give uniform weights (the mean of v), never NaN."""
    rng = np.random.RandomState(5)
    B, H, N, M, Dh = 2, 2, 8, 24, 16
    q, k, v = (torch.from_numpy(rng.randn(B, H, n, Dh).astype(np.float32)) for n in (N, M, M))
    mask = torch.zeros(B, M, dtype=torch.bool)
    mask[0] = True
    bias = mask_to_bias(mask, N)
    assert bias.min().item() == MASK_FILL_VALUE
    out = attention(q, k, v, bias)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out[0], v[0].mean(dim=1, keepdim=True).expand(H, N, Dh),
                               **TOL)
    ref = pallas_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                           jnp.asarray(v.numpy()), jnp.asarray(bias.numpy()), interpret=True)
    _close(out, ref)
