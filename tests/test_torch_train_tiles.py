"""The train step's attention (fourm_torch/kernels/attention_train.py) at the
edges of its CUDA kernels' tiles, against the JAX package's Pallas pair
(_train_fwd_call / _train_bwd_call) run with interpret=True, in fp32 on the
CPU. The forward (csrc/attention.cu) takes 64 query rows per CTA and 64 keys
per tile; the backward (csrc/attention_train.cu) 128 keys per CTA (two
64-key halves) and 64 query rows per ring stage, and past 128 keys sums the
key tiles' dq partials. So N and M in {1, 5, 63, 65, 127, 129, 200}, mixed;
no bias, a key bias with a batch row whose keys are all masked, a full bias
with a fully masked query row; softmax1, also over keys that are all masked.

(a) the twins and the autograd Function (its CPU path) against the Pallas
pair and jax.vjp of its custom_vjp; (b) the kernels' formulation of the
backward -- p recomputed from the forward's row statistics in the units the
kernel stores them (log2), the bias clamped at -1e30 and folded into log2
units -- (attention_train_stats_plain, attention_train_bwd_stats_plain)
against _train_bwd_call, the reference of the statistics' contract.

Tolerance: atol 2e-5, rtol 1e-4, as tests/test_torch_train_kernels.py --
the same fp32 arithmetic, summed in other orders (values are O(1)). The
CUDA kernels are held to the twins on the card by chip_smoke.py (phase 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourm_tpu.kernels.attention_bwd import _train_bwd_call, _train_fwd_call
from fourm_tpu.kernels.attention_bwd import attention_train as jax_attention_train
from fourm_torch.kernels import attention_train as at

B, H, DH = 2, 2, 64
TOL = dict(atol=2e-5, rtol=1e-4)
NEG = np.finfo(np.float32).min
EDGES = [(1, 1), (1, 129), (63, 65), (65, 63), (127, 129), (129, 127), (200, 200), (5, 200),
         (200, 5), (129, 1)]
MODES = ["none", "key", "full"]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(port, ref):
    out = port.detach().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def _inputs(N, M, mode, seed=0, all_masked=False):
    rng = np.random.RandomState(seed + 7 * N + M)
    q, do = (rng.randn(B, H, N, DH).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, M, DH).astype(np.float32) for _ in range(2))
    bias = None
    if mode == "key":
        mask = rng.rand(B, 1, 1, M) > 0.6
        mask[0] = True  # batch row 0: every key masked -> uniform weights
        if all_masked:
            mask[:] = True
        bias = np.where(mask, NEG, 0.0).astype(np.float32)
    elif mode == "full":
        mask = rng.rand(B, 1, N, M) > 0.6
        mask[1, 0, N // 2] = True  # a fully masked query row
        bias = np.where(mask, NEG, 0.0).astype(np.float32)
    return q, k, v, bias, do


def _pallas(q, k, v, bias, do, zero_attn):
    o = _train_fwd_call(_j(q), _j(k), _j(v), _j(bias), allow_zero_attn=zero_attn,
                        interpret=True)
    grads = _train_bwd_call(_j(q), _j(k), _j(v), _j(bias), o, _j(do),
                            allow_zero_attn=zero_attn, interpret=True)
    return o, grads


@pytest.mark.parametrize("N,M", EDGES)
@pytest.mark.parametrize("mode", MODES)
def test_twins_at_tile_edges(N, M, mode):
    """(a) the forward and backward twins against the Pallas pair."""
    zero_attn = (N + M) % 2 == 1  # softmax1 on every other edge
    q, k, v, bias, do = _inputs(N, M, mode)
    ref_o, ref_g = _pallas(q, k, v, bias, do, zero_attn)
    _close(at.attention_train_fwd_plain(_t(q), _t(k), _t(v), _t(bias), zero_attn), ref_o)
    port = at.attention_train_bwd_plain(_t(q), _t(k), _t(v), _t(bias), _t(ref_o), _t(do),
                                        zero_attn)
    for a, r in zip(port, ref_g):
        _close(a, r)


@pytest.mark.parametrize("N,M", [(1, 1), (63, 65), (129, 127), (5, 200), (200, 5)])
@pytest.mark.parametrize("mode", MODES)
def test_function_grads_at_tile_edges(N, M, mode):
    """(a) the autograd Function (its CPU path) against jax.vjp of the
    Pallas custom-vjp pair."""
    q, k, v, bias, do = _inputs(N, M, mode, seed=1)
    out, vjp = jax.vjp(lambda a, b, c: jax_attention_train(a, b, c, _j(bias), False,
                                                           interpret=True),
                       _j(q), _j(k), _j(v))
    ref_grads = vjp(_j(do))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = at.attention_train(tq, tk, tv, _t(bias), False)
    _close(o, out)
    o.backward(_t(do))
    for g, r in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        assert g.shape == r.shape
        _close(g, r)


@pytest.mark.parametrize("N,M", EDGES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("zero_attn", [False, True])
def test_backward_from_log2_stats_matches_pallas(N, M, mode, zero_attn):
    """(b) the kernels' formulation: the statistics as the forward kernel
    stores them, then the backward from them, against _train_bwd_call."""
    q, k, v, bias, do = _inputs(N, M, mode, seed=2)
    ref_o, ref_g = _pallas(q, k, v, bias, do, zero_attn)
    tq, tk, tv, tb = _t(q), _t(k), _t(v), _t(bias)
    stats = at.attention_train_stats_plain(tq, tk, tb, zero_attn)
    assert stats.shape == (B, H, N, 2) and torch.isfinite(stats).all()
    port = at.attention_train_bwd_stats_plain(tq, tk, tv, tb, _t(ref_o), _t(do), stats)
    for a, r in zip(port, ref_g):
        _close(a, r)


def test_stats_are_log2_units():
    """The statistics' units: the max is the largest logit times log2(e) and
    1 / sum the softmax's normaliser, so exp2(logit2 - max) * (1 / sum) is
    the softmax; read as natural units they would give other weights."""
    q, k, v, bias, _ = _inputs(65, 63, "full", seed=3)
    tq, tk, tb = _t(q), _t(k), _t(bias)
    stats = at.attention_train_stats_plain(tq, tk, tb)
    logits = tq @ tk.transpose(-1, -2) * DH ** -0.5 + tb
    probs = torch.softmax(logits, -1)
    live = torch.isfinite(logits.amax(-1)) & (logits.amax(-1) > -1e30)
    np.testing.assert_allclose(stats[..., 0][live].numpy(),
                               (logits.amax(-1) * at.LOG2E)[live].numpy(), **TOL)
    l2 = at._logits2(tq, tk, tb)
    p = torch.exp2(l2 - stats[..., :1]) * stats[..., 1:]
    _close(p, probs.numpy())
    natural = torch.exp(l2 / at.LOG2E - stats[..., :1]) * stats[..., 1:]
    assert (natural - probs).abs().max() > 1e-2


@pytest.mark.parametrize("N,M", [(1, 1), (129, 127), (5, 200), (200, 5)])
def test_softmax1_with_every_key_masked(N, M):
    """Softmax1 over keys that are all masked: every weight 0 (the zero logit
    takes it all), o = 0, gradients 0 for q and k -- and no NaN, in the twins,
    the Function and the kernels' formulation."""
    q, k, v, bias, do = _inputs(N, M, "key", seed=4, all_masked=True)
    ref_o, ref_g = _pallas(q, k, v, bias, do, True)
    tq, tk, tv, tb = _t(q), _t(k), _t(v), _t(bias)
    _close(at.attention_train_fwd_plain(tq, tk, tv, tb, True), ref_o)
    stats = at.attention_train_stats_plain(tq, tk, tb, True)
    np.testing.assert_array_equal(stats[..., 0].numpy(), 0.0)
    np.testing.assert_array_equal(stats[..., 1].numpy(), 1.0)
    for port in (at.attention_train_bwd_plain(tq, tk, tv, tb, _t(ref_o), _t(do), True),
                 at.attention_train_bwd_stats_plain(tq, tk, tv, tb, _t(ref_o), _t(do), stats)):
        for a, r in zip(port, ref_g):
            _close(a, r)
    xs = [_t(a).requires_grad_(True) for a in (q, k, v)]
    o = at.attention_train(*xs, tb, True)
    o.backward(_t(do))
    _close(o, ref_o)
    for x, r in zip(xs, ref_g):
        _close(x.grad, r)
