"""The train step's kernel twins (fourm_torch/kernels/attention_train.py,
fused_adamw.py) against the JAX package's Pallas kernels in interpret mode
and against optax, on the CPU in fp32.

Tolerances: the attention twins and the Function's gradients within atol
2e-5 / rtol 1e-4 of the Pallas kernels (the same fp32 arithmetic, summed in
other orders; values are O(1)); the AdamW twin within 1 fp32 ulp-scale
(rtol 1e-6, atol 1e-9) of fused_adamw_leaf and of the optax chain over
several steps (XLA may contract a product and a sum into one FMA)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fourm_tpu.kernels.attention_bwd import _train_bwd_call, _train_fwd_call
from fourm_tpu.kernels.attention_bwd import attention_train as jax_attention_train
from fourm_tpu.kernels.fused_adamw import adamw_scalars as jax_adamw_scalars
from fourm_tpu.kernels.fused_adamw import fused_adamw_leaf
from fourm_tpu.ops.transformer import mask_to_bias as jax_mask_to_bias
from fourm_torch.kernels import attention_train as at
from fourm_torch.kernels import fused_adamw as fa
from fourm_torch.ops import transformer as tt

B, H, N, M, DH = 2, 3, 40, 56, 32
CASES = [(mode, z) for mode in ("none", "key", "full") for z in (False, True)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(mode, seed=0):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(B, H, N, DH).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, M, DH).astype(np.float32) for _ in range(2))
    bias = None
    if mode == "key":
        mask = rng.rand(B, 1, M) > 0.6
        mask[0] = True  # a batch row whose keys are all masked
        bias = np.asarray(jax_mask_to_bias(jnp.asarray(mask), N))
    elif mode == "full":
        mask = rng.rand(B, N, M) > 0.6
        mask[1, 3] = True  # a fully masked query row
        bias = np.asarray(jax_mask_to_bias(jnp.asarray(mask), N))
    return q, k, v, bias, do


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(port, ref, atol=2e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


@pytest.mark.parametrize("mode,zero_attn", CASES)
def test_attention_twins_match_pallas(mode, zero_attn):
    q, k, v, bias, do = _inputs(mode)
    ref_o = _train_fwd_call(_j(q), _j(k), _j(v), _j(bias), allow_zero_attn=zero_attn,
                            interpret=True)
    o = at.attention_train_fwd_plain(_t(q), _t(k), _t(v), None if bias is None else _t(bias),
                                     zero_attn)
    _close(o, ref_o)
    ref = _train_bwd_call(_j(q), _j(k), _j(v), _j(bias), ref_o, _j(do),
                          allow_zero_attn=zero_attn, interpret=True)
    port = at.attention_train_bwd_plain(_t(q), _t(k), _t(v), None if bias is None else _t(bias),
                                        _t(ref_o), _t(do), zero_attn)
    for a, b in zip(port, ref):
        _close(a, b)


@pytest.mark.parametrize("mode,zero_attn", CASES)
def test_attention_function_grads_match_jax_vjp(mode, zero_attn):
    """The autograd Function (its CPU path: the twins) against jax.vjp of the
    custom-vjp pair in interpret mode."""
    q, k, v, bias, do = _inputs(mode, seed=1)
    out, vjp = jax.vjp(lambda a, b, c: jax_attention_train(a, b, c, _j(bias), zero_attn,
                                                           interpret=True),
                       _j(q), _j(k), _j(v))
    ref_grads = vjp(_j(do))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = at.attention_train(tq, tk, tv, None if bias is None else _t(bias), zero_attn)
    _close(o, out)
    o.backward(_t(do))
    for g, r in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        assert g.shape == r.shape
        _close(g, r)


def test_attention_function_keeps_strided_inputs():
    """q/k/v arrive as strided head views of one QKV projection; the
    gradients land on the projection with its shape."""
    rng = np.random.RandomState(3)
    qkv = _t(rng.randn(B, N, 3, H, DH).astype(np.float32)).requires_grad_(True)
    q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    at.attention_train(q, k, v).sum().backward()
    ref = qkv.detach().clone().requires_grad_(True)
    rq, rk, rv = [ref[:, :, i].transpose(1, 2) for i in range(3)]
    at.attention_train_fwd_plain(rq, rk, rv).sum().backward()
    assert qkv.grad.shape == qkv.shape
    np.testing.assert_allclose(qkv.grad.numpy(), ref.grad.numpy(), atol=2e-5, rtol=1e-4)


def test_shape_gate_and_fallback():
    """attention_train_takes refuses a bias the kernels do not hold (one row
    per head); the train path then runs the plain autograd ops, whose
    gradients equal the Function's."""
    q, k, v, bias, _ = _inputs("full", seed=4)
    tq, tk = _t(q), _t(k)
    assert at.attention_train_takes(tq, tk, None)
    assert at.attention_train_takes(tq, tk, _t(bias))
    assert at.attention_train_takes(tq, tk, _t(bias)[:, :, :1])  # key-only
    per_head = torch.zeros(B, H, N, M)
    assert not at.attention_train_takes(tq, tk, per_head)
    # off the CPU (meta tensors stand in for the card) the gate is the
    # kernels' head dim and bf16; the CPU twins take any head dim and dtype
    for dh in (at.HEAD_DIM, 32, 128):
        mq, mk = (torch.empty(2, 3, n, dh, device="meta", dtype=torch.bfloat16)
                  for n in (300, 700))
        assert at.attention_train_takes(mq, mk, None) == (dh == at.HEAD_DIM)
        assert not at.attention_train_takes(mq.float(), mk.float(), None)
        assert at.attention_train_takes(torch.empty(mq.shape), torch.empty(mk.shape), None)
    xs = [_t(a).requires_grad_(True) for a in (q, k, v)]
    tt.dot_product_attention(*xs, per_head, train=True).square().sum().backward()
    ys = [_t(a).requires_grad_(True) for a in (q, k, v)]
    at.attention_train(*ys, torch.zeros(B, 1, N, M)).square().sum().backward()
    for a, b in zip(xs, ys):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=2e-5, rtol=1e-4)


def _leaves(seed):
    rng = np.random.RandomState(seed)
    shapes = [(8, 256), (256,), (4, 128)]
    p = [rng.randn(*s).astype(np.float32) for s in shapes]
    g = [rng.randn(*s).astype(np.float32) * 1e-2 for s in shapes]
    m = [rng.randn(*s).astype(np.float32) * 1e-3 for s in shapes]
    v = [rng.rand(*s).astype(np.float32) * 1e-5 for s in shapes]
    return p, g, m, v


@pytest.mark.parametrize("count", [0, 7, 999])
def test_adamw_twin_matches_pallas_leaf(count):
    p, g, m, v = _leaves(count)
    decay = [True, False, True]
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.05, 3e-4
    s = fa.adamw_scalars(count, lr, b1, b2, eps, wd)
    ref_sc = np.asarray(jax_adamw_scalars(jnp.int32(count), lr, b1, b2))
    np.testing.assert_allclose([s.lr, s.c1, s.c2], ref_sc, rtol=1e-6)
    tp, tm, tv = ([_t(a) for a in arr] for arr in (p, m, v))
    fa.fused_adamw(tp, [_t(a) for a in g], tm, tv, decay, s)
    for i in range(3):
        ref = fused_adamw_leaf(jnp.asarray(g[i]), jnp.asarray(p[i]), jnp.asarray(m[i]),
                               jnp.asarray(v[i]), jnp.asarray(ref_sc), b1=b1, b2=b2, eps=eps,
                               wd=wd, decay=decay[i], interpret=True)
        for port, r in zip((tp[i], tm[i], tv[i]), ref):
            np.testing.assert_allclose(port.numpy(), np.asarray(r), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_adamw_twin_matches_optax_over_steps(clip):
    """Four steps of the twin (with the clip's scaling in the same pass)
    against optax.adamw (after clip_by_global_norm) on a cosine schedule; a
    leaf without gradient steps with g = 0, as JAX's zero gradient."""
    from fourm_tpu.utils.optim import cosine_schedule as jax_cosine
    from fourm_torch.utils.optim import cosine_schedule

    p, _, _, _ = _leaves(11)
    names = ["w", "b", "u"]
    mask = {"w": True, "b": False, "u": True}
    tx = optax.adamw(jax_cosine(1e-2, 50, 2), b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.05,
                     mask=mask)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    params = {n: jnp.asarray(a) for n, a in zip(names, p)}
    state = tx.init(params)
    sched = cosine_schedule(1e-2, 50, 2)
    tp = [_t(a) for a in p]
    tm, tv = [torch.zeros_like(a) for a in tp], [torch.zeros_like(a) for a in tp]
    rng = np.random.RandomState(12)
    for count in range(4):
        g = [rng.randn(*a.shape).astype(np.float32) * 0.1 for a in p]
        g[2] = np.zeros_like(g[2])
        grads = {n: jnp.asarray(a) for n, a in zip(names, g)}
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        tg = [_t(a) for a in g[:2]] + [None]
        norm = torch.linalg.vector_norm(torch.stack([a.norm() for a in tg[:2]]))
        s = fa.adamw_scalars(count, sched(count), 0.9, 0.95, 1e-8, 0.05)
        fa.fused_adamw(tp, tg, tm, tv, [mask[n] for n in names], s,
                       norm if clip is not None else None, clip)
        for n, a in zip(names, tp):
            np.testing.assert_allclose(a.numpy(), np.asarray(params[n]), rtol=1e-6, atol=1e-8,
                                       err_msg=f"step {count} leaf {n}")
