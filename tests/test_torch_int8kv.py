"""The port's int8 cross-K/V decode mode (fourm_torch) against the JAX
package's (fourm_tpu), on the CPU in fp32.

  * quantize_kv_decode on the port's (B, H, M, Dh) layout against JAX's on
    its (B, H, Dh, M) one: int8 values and scales equal;
  * the int8 twin of cross_decode_attn against pallas_cross_decode_attn's
    int8 mode run with interpret=True (atol 2e-5, rtol 1e-4: the same fp32
    arithmetic and fold order, another summation order);
  * DecoderBlock.step with (int8, scale) tuples against the JAX
    DecoderBlock.step with the same tuples (its XLA dequantize path);
  * FourMSampler(kv_quant="int8") tokens at temperature 0 against the JAX
    FourMSampler(kv_quant="int8") (exact);
  * an unknown kv_quant raises ValueError in both packages.
"""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import fourm_tpu.api as jax_api
from fourm_tpu.generate import GenerationSampler as JaxGenerationSampler
from fourm_tpu.kernels.decode_step import pallas_cross_decode_attn
from fourm_tpu.kernels.decode_step import quantize_kv_decode as jax_quantize
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.ops import transformer as jt
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_tpu.utils.text_tokenizer import (generate_sentinel_tokens,
                                            train_unified_wordpiece_tokenizer)
import fourm_torch.api as api
from fourm_torch.generate import GenerationSampler
from fourm_torch.kernels.decode_step import cross_decode_attn, quantize_kv_decode
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.ops.transformer import _key_bias
from fourm_torch.utils.checkpoint import from_jax_params

KTOL = dict(atol=2e-5, rtol=1e-4)
NEG = np.finfo(np.float32).min
TINY = dict(dim=64, encoder_depth=2, decoder_depth=2, num_heads=4)
MODEL = "fm_base_12e_12d_swiglu_qknorm_nobias"


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _opt_t(a):
    return None if a is None else _t(a)


def _dm(a):
    """(B, H, M, Dh) <-> (B, H, Dh, M)."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 1, 3, 2))


def _jax_int8(k, v):
    """JAX's quantization of port-layout K/V; returns its outputs in the
    port's layout as numpy: (k_i8, k_scale, v_i8, v_scale)."""
    k_i8, ks, v_i8, vs = jax_quantize(jnp.asarray(_dm(k)), jnp.asarray(_dm(v)))
    return _dm(k_i8), np.asarray(ks), _dm(v_i8), np.asarray(vs)


# --------------------------------------------------------------- quantization

def test_quantize_kv_decode_matches_jax():
    rng = np.random.RandomState(0)
    # 2048 channels of 300 positions: enough that a scale one ulp off
    # (a true division by 127 where XLA multiplies by its reciprocal) moves
    # int8 values across a rounding boundary
    B, H, M, Dh = 4, 8, 300, 64
    k = (rng.randn(B, H, M, Dh) * rng.rand(1, H, 1, Dh) * 4).astype(np.float32)
    v = rng.randn(B, H, M, Dh).astype(np.float32)
    # channel (0, 0, 0): absmax 127, so the halves are ties that round to
    # even; channel (1, 2, 3) all zero: the 1e-12 floor
    k[0, 0, :, 0] = 0.5 + np.arange(M) % 64 - 32
    k[0, 0, 0, 0] = 127.0
    v[1, 2, :, 3] = 0.0
    want = _jax_int8(k, v)
    got = quantize_kv_decode(_t(k), _t(v))
    for g, w, what in zip(got, want, ("k_i8", "k_scale", "v_i8", "v_scale")):
        assert tuple(g.shape) == w.shape, what
        assert g.is_contiguous() and g.dtype == (torch.int8 if "i8" in what else torch.float32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    # scale 1: -30.5, -29.5, -28.5, ... round half to even
    assert got[1][0, 0, 0].item() == 1.0
    np.testing.assert_array_equal(got[0][0, 0, :8, 0].numpy(), [127, -30, -30, -28, -28, -26,
                                                                -26, -24])


# ------------------------------------------------------------------ the twin

@pytest.mark.parametrize("qk_norm,biases,masked,zero_attn,M", [
    (True, False, True, False, 48), (False, True, False, False, 48),
    (True, False, True, True, 48), (False, False, False, True, 130),
    (True, True, True, False, 200)])
def test_cross_decode_attn_int8_twin(qk_norm, biases, masked, zero_attn, M):
    rng = np.random.RandomState(30 + M)
    B, H, Dh = 3, 4, 16
    C = H * Dh
    x = rng.randn(B, C).astype(np.float32) * 0.5
    gq = (rng.rand(C) + 0.5).astype(np.float32)
    bqn = rng.randn(C).astype(np.float32) * 0.1 if biases else None
    wq = (rng.randn(C, C) / 8).astype(np.float32)
    bq = rng.randn(C).astype(np.float32) * 0.1 if biases else None
    cq = [(rng.rand(Dh) + 0.5).astype(np.float32),
          rng.randn(Dh).astype(np.float32) * 0.1] if qk_norm else [None, None]
    k = rng.randn(B, H, M, Dh).astype(np.float32)
    v = rng.randn(B, H, M, Dh).astype(np.float32)
    bias = None
    if masked:
        bias = np.where(rng.rand(B, M) > 0.6, NEG, 0.0).astype(np.float32)
        bias[2] = NEG  # a fully masked row
    k_i8, ks, v_i8, vs = _jax_int8(k, v)
    ref = pallas_cross_decode_attn(
        jnp.asarray(x), jnp.asarray(gq), _j(bqn), jnp.asarray(wq), _j(bq), *[_j(a) for a in cq],
        jnp.asarray(_dm(k_i8)), jnp.asarray(_dm(v_i8)), _j(bias), H, allow_zero_attn=zero_attn,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
    port = cross_decode_attn(_t(x), _t(gq), _opt_t(bqn), _t(wq.T.copy()), _opt_t(bq),
                             *[_opt_t(a) for a in cq], _t(k_i8), _t(v_i8), _opt_t(bias), H,
                             allow_zero_attn=zero_attn, k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **KTOL)
    assert torch.isfinite(port).all()
    # the same K/V in bf16 mode: the quantization error is small, not zero
    bf = cross_decode_attn(_t(x), _t(gq), _opt_t(bqn), _t(wq.T.copy()), _opt_t(bq),
                           *[_opt_t(a) for a in cq], _t(k), _t(v), _opt_t(bias), H,
                           allow_zero_attn=zero_attn)
    rel = float((port - bf).norm() / bf.norm())
    assert 0 < rel < 0.05


def test_cross_decode_attn_needs_both_scales():
    x = torch.zeros(1, 64)
    kv = torch.zeros(1, 1, 4, 64, dtype=torch.int8)
    with pytest.raises(ValueError):
        cross_decode_attn(x, torch.ones(64), None, torch.zeros(64, 64), None, None, None, kv, kv,
                          None, 1, k_scale=torch.ones(1, 1, 64))


# ------------------------------------------------------------- the block step

@pytest.fixture(scope="module")
def models():
    mods = ("rgb@224", "tok_clip@224", "caption", "metadata")
    dec = mods[1:]
    jcfg = jax_config(MODEL, mods, dec, **TINY)
    jm = JaxFourM(jcfg)
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(mods, 2, 32, 32))
    variables = jm.init(jax.random.key(1), batch, 32, 32)
    tcfg = create_fourm_config(MODEL, mods, dec, **TINY)
    tm = FourM(tcfg)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)["params"], tcfg))
    return jcfg, jm, variables, tm.eval()


@pytest.mark.parametrize("step", [0, 3])
def test_decoder_block_step_int8_matches_jax(models, step):
    jcfg, _, variables, tm = models
    rng = np.random.RandomState(60 + step)
    B, L, M = 3, 10, 24
    H, C = jcfg.num_heads, jcfg.dim
    Dh = C // H
    x = rng.randn(B, 1, C).astype(np.float32) * 0.5
    ck, cv, xk, xv = (rng.randn(B, H, n, Dh).astype(np.float32) * 0.5 for n in (L, L, M, M))
    mask = rng.rand(B, M) > 0.6
    mask[1] = True  # a fully masked conditioning row
    k_i8, ks, v_i8, vs = _jax_int8(xk, xv)
    block = jt.DecoderBlock(dim=C, num_heads=H, qkv_bias=False, proj_bias=False,
                            mlp_bias=False, act=jax.nn.silu, gated_mlp=True, qk_norm=True,
                            norm_bias=False)
    want_x, want_k, want_v = block.apply(
        {"params": variables["params"]["decoder_0"]}, jnp.asarray(x), jnp.asarray(_dm(ck)),
        jnp.asarray(_dm(cv)), (jnp.asarray(_dm(k_i8)), jnp.asarray(ks)),
        (jnp.asarray(_dm(v_i8)), jnp.asarray(vs)), jnp.asarray(mask), jnp.int32(step),
        method="step")
    tk, tv = _t(ck), _t(cv)
    with torch.no_grad():
        got, _, _ = tm.decoder[0].step(_t(x), tk, tv, (_t(k_i8), _t(ks)), (_t(v_i8), _t(vs)),
                                       _key_bias(_t(mask)), torch.tensor([step], dtype=torch.int32))
    tol = dict(atol=5e-5, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **tol)
    np.testing.assert_allclose(tk.numpy(), _dm(want_k), **tol)
    np.testing.assert_allclose(tv.numpy(), _dm(want_v), **tol)


# ------------------------------------------------------------------ the chain

@pytest.fixture(scope="module")
def text_tok(tmp_path_factory):
    """The text tokenizer bench.py builds (bench.py:52-64)."""
    corpus = tmp_path_factory.mktemp("tok") / "corpus.txt"
    corpus.write_text("a photo of a cat and a dog\n" * 200)
    return train_unified_wordpiece_tokenizer(
        str(corpus), vocab_size=300, sentinel_tokens=generate_sentinel_tokens(num=20),
        show_progress=False)


def test_chain_int8_matches_jax(models, text_tok):
    """RGB -> tok_clip + caption + metadata at temperature 0, both samplers
    in int8 mode (the tiny chain of tests/test_torch_decode.py)."""
    _, jm, variables, tm = models
    chain, B = ["tok_clip@224", "caption", "metadata"], 2
    defaults = {t: {**jax_api.DEFAULTS_RGB2X[t], "temp": 0.0} for t in chain}
    jsampler = jax_api.FourMSampler(fm=(jm, variables), text_tokenizer=text_tok, kv_quant="int8")
    port = api.FourMSampler(tm, text_tok, device="cpu", kv_quant="int8")
    assert port.sampler.kv_quant == "int8"
    sample = {"rgb@224": np.random.RandomState(92).rand(B, 224, 224, 3).astype(np.float32)}
    sched = port.build_schedule(["rgb@224"], chain, defaults=defaults)
    jout = jsampler.generate(jsampler.prepare_sample(sample, ["rgb@224"], chain, B), sched,
                             seed=0)
    tout = port.generate(port.prepare_sample(sample, ["rgb@224"], chain, B), sched, seed=0)
    for t in chain:
        for k in ("tensor", "input_mask", "target_mask"):
            np.testing.assert_array_equal(tout[t][k].numpy(), np.asarray(jout[t][k]),
                                          err_msg=f"{t} {k}")
    assert port.sampler._ar_tokens["caption"] > 1 and port.sampler._ar_tokens["metadata"] > 1


def test_unknown_kv_quant_raises(models):
    _, jm, variables, tm = models
    with pytest.raises(ValueError):
        JaxGenerationSampler(jm, variables, kv_quant="fp8")
    with pytest.raises(ValueError):
        GenerationSampler(tm, kv_quant="fp8")
    with pytest.raises(ValueError):
        api.FourMSampler(tm, device="cpu", kv_quant="fp8")
