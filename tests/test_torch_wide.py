"""The port at the widths of 4M-L (D = 1024, SwiGLU hidden 2730) and 4M-XL
(D = 2048, 32 heads, SwiGLU hidden 5461) against the JAX package, on the
CPU in fp32.

  * the ln_mlp and ln_matmul twins against pallas_ln_mlp / pallas_ln_matmul
    run with interpret=True, on 8-16 rows (atol 1e-4, rtol 1e-4: the same
    fp32 arithmetic in another summation order, over 1024-5461 terms);
  * the residual_mlp twin against the JAX package's own path at these
    widths: pallas_residual_mlp declines them (its VMEM budget), so the
    reference is DecoderBlock.step's XLA tail (transformer.py:1010-1012;
    atol 1e-4, rtol 1e-4);
  * from_jax_params on fm_xlarge_24e_24d_swiglu_qknorm_nobias at full width
    and depth 1 + 1: strict load, the ragged hidden width kept, and
    forward_generation_img logits held to JAX's (atol 2e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.kernels.decode_step import pallas_residual_mlp
from fourm_tpu.kernels.fused_mlp import pallas_ln_matmul, pallas_ln_mlp
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.ops import transformer as jt
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_torch.kernels.decode_step import residual_mlp
from fourm_torch.kernels.fused_mlp import ln_matmul, ln_mlp
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.utils.checkpoint import from_jax_params

# (D, SwiGLU hidden width int(2 * 4D / 3)) of 4M-L and 4M-XL
WIDTHS = [(1024, 2730), (2048, 5461)]
XL = "fm_xlarge_24e_24d_swiglu_qknorm_nobias"


def _t(a):
    return torch.from_numpy(np.array(a))


def _opt_t(a):
    return None if a is None else _t(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _weights(rng, D, HID, biases):
    w1, w3 = ((rng.randn(D, HID) * D ** -0.5).astype(np.float32) for _ in range(2))
    w2 = (rng.randn(HID, D) * HID ** -0.5).astype(np.float32)
    b = [(rng.randn(n) * 0.1).astype(np.float32) if biases else None for n in (HID, HID, D)]
    return w1, w3, w2, b


@pytest.mark.parametrize("D,HID", WIDTHS)
@pytest.mark.parametrize("gated,biases", [(True, False), (False, True)])
def test_ln_mlp_twin_wide(D, HID, gated, biases):
    rng = np.random.RandomState(D + HID + gated)
    rows = 12
    x = rng.randn(rows, D).astype(np.float32)
    gamma = (rng.rand(D) + 0.5).astype(np.float32)
    beta = (rng.randn(D) * 0.1).astype(np.float32) if biases else None
    w1, w3, w2, (b1, b3, b2) = _weights(rng, D, HID, biases)
    ref = pallas_ln_mlp(jnp.asarray(x), jnp.asarray(gamma), _j(beta), jnp.asarray(w1), _j(b1),
                        jnp.asarray(w2), _j(b2), _j(w3) if gated else None,
                        _j(b3) if gated else None, gated=gated, interpret=True)
    port = ln_mlp(_t(x), _t(gamma), _opt_t(beta), _t(w1.T.copy()), _opt_t(b1), _t(w2.T.copy()),
                  _opt_t(b2), _t(w3.T.copy()) if gated else None,
                  _opt_t(b3) if gated else None, gated=gated)
    assert port.shape == x.shape
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("D", [1024, 2048])
def test_ln_matmul_twin_wide(D):
    rng = np.random.RandomState(D)
    rows, F = 8, 3 * D  # the QKV projection
    x = rng.randn(rows, D).astype(np.float32)
    gamma = (rng.rand(D) + 0.5).astype(np.float32)
    w = (rng.randn(D, F) * D ** -0.5).astype(np.float32)
    ref = pallas_ln_matmul(jnp.asarray(x), jnp.asarray(gamma), None, jnp.asarray(w), None,
                           interpret=True)
    port = ln_matmul(_t(x), _t(gamma), None, _t(w.T.copy()), None)
    assert port.shape == (rows, F)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("D,HID", WIDTHS)
def test_residual_mlp_twin_wide(D, HID):
    rng = np.random.RandomState(7 + D)
    B = 5
    x, attn = (rng.randn(B, D).astype(np.float32) for _ in range(2))
    wp = (rng.randn(D, D) * D ** -0.5).astype(np.float32)
    g2 = (rng.rand(D) + 0.5).astype(np.float32)
    w1, w3, w2, _ = _weights(rng, D, HID, False)
    jx, dt = jnp.asarray(x), jnp.float32
    # the JAX package's fused tail declines this width ...
    assert pallas_residual_mlp(jx, jnp.asarray(attn), jnp.asarray(wp), None, jnp.asarray(g2),
                               None, jnp.asarray(w1), None, jnp.asarray(w2), None,
                               jnp.asarray(w3), None, gated=True, act_silu=True,
                               interpret=True) is None
    # ... so its decode step takes the XLA tail (transformer.py:1010-1012)
    x2 = jx + jt._dense(jnp.asarray(attn), jnp.asarray(wp), None, dt)
    h = jt.LayerNorm(use_bias=False).apply({"params": {"weight": jnp.asarray(g2)}}, x2)
    mlp = {"fc1": {"kernel": jnp.asarray(w1)}, "fc3": {"kernel": jnp.asarray(w3)},
           "fc2": {"kernel": jnp.asarray(w2)}}
    ref = x2 + jt.GatedMlp(hidden_dim=4 * D, use_bias=False).apply({"params": mlp}, h)
    port = residual_mlp(_t(x), _t(attn), _t(wp.T.copy()), None, _t(g2), None,
                        _t(w1.T.copy()), None, _t(w2.T.copy()), None, _t(w3.T.copy()), None,
                        gated=True)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_from_jax_params_xl_forward_generation_img():
    mods = ("rgb@224", "tok_clip@224")
    dec = ("tok_clip@224",)
    cut = dict(encoder_depth=1, decoder_depth=1)  # full width, depth cut to 1 + 1
    jcfg = jax_config(XL, mods, dec, **cut)
    assert (jcfg.dim, jcfg.num_heads) == (2048, 32)
    jm = JaxFourM(jcfg)
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(mods, 1, 16, 16))
    variables = jm.init(jax.random.key(0), batch, 16, 16)
    tcfg = create_fourm_config(XL, mods, dec, **cut)
    tm = FourM(tcfg)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)["params"], tcfg),
                       strict=True)
    tm.eval()
    assert tuple(tm.decoder[0].mlp.fc2.weight.shape) == (2048, 5461)

    rng = np.random.RandomState(3)
    B = 2
    md = {"rgb@224": {"tensor": rng.rand(B, 224, 224, 3).astype(np.float32),
                      "input_mask": np.zeros((B, 196), bool),
                      "target_mask": np.ones((B, 196), bool),
                      "decoder_attention_mask": np.zeros((B, 196), np.int32)},
          "tok_clip@224": {"tensor": rng.randint(0, 1024, (B, 196)).astype(np.int32),
                           "input_mask": rng.rand(B, 196) > 0.5,
                           "target_mask": np.zeros((B, 196), bool),
                           "decoder_attention_mask": np.zeros((B, 196), np.int32)}}
    md["tok_clip@224"]["target_mask"] = ~md["tok_clip@224"]["input_mask"]
    sa = rng.rand(B, 196) > 0.3
    ref = jm.apply(variables, jax.tree.map(jnp.asarray, md), "tok_clip@224", jnp.asarray(sa),
                   None, method="forward_generation_img")
    with torch.no_grad():
        port = tm.forward_generation_img(
            {m: {k: _t(v) for k, v in d.items()} for m, d in md.items()}, "tok_clip@224",
            _t(sa), None)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)
