"""The port's model (fourm_torch) against the JAX package's (fourm_tpu) on the
CPU, in fp32, with the same weights carried over by the weight bridge.

Tiny configs: dim 64, 4 heads, 2+2 layers, in the `gelu` flavour (biases,
plain exact-GELU MLP) and the 4M-21 `swiglu_qknorm_nobias` flavour. The JAX
side runs its XLA path (the CPU), the port its kernels' plain twins.
Tolerance: atol 1e-4 (2e-5 per module) in fp32 — the arithmetic is the same
and only summation orders differ."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.ops import sampling as jax_sampling
from fourm_tpu.ops import token_select as jax_ts
from fourm_tpu.ops import transformer as jt
from fourm_tpu.utils.checkpoint import export_fourm_torch_state
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.ops import sampling
from fourm_torch.ops import token_select as ts
from fourm_torch.utils.checkpoint import from_jax_params

MODS = ("rgb@224", "tok_clip@224", "tok_depth@224", "tok_dinov2@224", "caption", "t5_caption")
DEC_MODS = ("tok_clip@224", "tok_depth@224", "tok_dinov2@224", "caption")
TINY = dict(dim=64, encoder_depth=2, decoder_depth=2, num_heads=4)
FLAVORS = ["fm_base_12e_12d_gelu", "fm_base_12e_12d_swiglu_qknorm_nobias"]


@pytest.fixture(scope="module", params=FLAVORS)
def models(request):
    jcfg = jax_config(request.param, MODS, DEC_MODS, **TINY)
    tcfg = create_fourm_config(request.param, MODS, DEC_MODS, **TINY)
    jm = JaxFourM(jcfg)
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(MODS, 2, 32, 32))
    variables = jm.init(jax.random.key(0), batch, 32, 32)
    params = jax.tree.map(np.asarray, variables)["params"]
    tm = FourM(tcfg)
    tm.load_state_dict(from_jax_params(params, tcfg), strict=True)
    tm.eval()
    return jcfg, jm, variables, params, tm


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


def test_weight_bridge_matches_export(models):
    jcfg, _, variables, params, tm = models
    ours = from_jax_params(params, tm.config)
    ref = export_fourm_torch_state(variables, jcfg)
    assert set(ours) == set(ref)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[k])
    # every key of the port's state dict is covered: strict load
    assert set(tm.state_dict()) == set(ours)


def _block_kw(cfg):
    return dict(dim=cfg.dim, num_heads=cfg.num_heads, qkv_bias=cfg.qkv_bias,
                proj_bias=cfg.proj_bias, qk_norm=cfg.qk_norm)


def test_layer_norm_and_mlp(models):
    jcfg, _, _, params, tm = models
    x = np.random.RandomState(0).randn(2, 10, jcfg.dim).astype(np.float32)
    ref = jt.LayerNorm(use_bias=jcfg.norm_bias).apply(
        {"params": params["encoder_norm"]}, jnp.asarray(x))
    _close(tm.encoder_norm(_t(x)), ref, 2e-5)
    hidden = int(jcfg.dim * jcfg.mlp_ratio)
    if jcfg.gated_mlp:
        jmlp = jt.GatedMlp(hidden_dim=hidden, use_bias=jcfg.mlp_bias)
    else:
        jmlp = jt.Mlp(hidden_dim=hidden, use_bias=jcfg.mlp_bias)
    ref = jmlp.apply({"params": params["encoder_0"]["mlp"]}, jnp.asarray(x))
    _close(tm.encoder[0].mlp(_t(x)), ref, 2e-5)


def test_attention_modules(models):
    jcfg, _, _, params, tm = models
    rng = np.random.RandomState(1)
    B, N, M = 2, 24, 40
    x = rng.randn(B, N, jcfg.dim).astype(np.float32)
    ctx = rng.randn(B, M, jcfg.dim).astype(np.float32)
    key_mask = rng.rand(B, 1, N) > 0.5
    key_mask[0] = True  # fully masked row
    full_mask = rng.rand(B, N, N) > 0.5
    attn = jt.Attention(**_block_kw(jcfg))
    p_attn = {"params": params["encoder_0"]["attn"]}
    port = tm.encoder[0].attn
    for mask in (None, key_mask, full_mask):
        jmask = None if mask is None else jnp.asarray(mask)
        tmask = None if mask is None else _t(mask)
        ref = attn.apply(p_attn, jnp.asarray(x), jmask)
        _close(port(_t(x), tmask), ref, 2e-5)
        # the pre-norm half: ln_matmul + flash_mha (or the generic path for a
        # query-dependent mask) against XLA's x + attn(norm1(x))
        jnorm = jt.LayerNorm(use_bias=jcfg.norm_bias)
        h = jnorm.apply({"params": params["encoder_0"]["norm1"]}, jnp.asarray(x))
        ref = jnp.asarray(x) + attn.apply(p_attn, h, jmask)
        _close(port.fused_prenorm(_t(x), tm.encoder[0].norm1, tmask), ref, 2e-5)
    xattn = jt.CrossAttention(**_block_kw(jcfg))
    xmask = rng.rand(B, 1, M) > 0.5
    xmask[1] = True
    ref = xattn.apply({"params": params["decoder_0"]["cross_attn"]}, jnp.asarray(x),
                      jnp.asarray(ctx), jnp.asarray(xmask))
    _close(tm.decoder[0].cross_attn(_t(x), _t(ctx), _t(xmask)), ref, 2e-5)


def test_blocks(models):
    jcfg, _, _, params, tm = models
    rng = np.random.RandomState(2)
    B, N, M = 2, 24, 40
    x = rng.randn(B, N, jcfg.dim).astype(np.float32)
    ctx = rng.randn(B, M, jcfg.dim).astype(np.float32)
    sa = rng.rand(B, 1, N) > 0.5
    xa = rng.rand(B, 1, M) > 0.5
    xa[0] = True
    act = {"gelu": lambda v: jax.nn.gelu(v, approximate=False), "silu": jax.nn.silu}[jcfg.act]
    kw = dict(_block_kw(jcfg), mlp_bias=jcfg.mlp_bias, act=act, gated_mlp=jcfg.gated_mlp,
              norm_bias=jcfg.norm_bias)
    ref = jt.Block(**kw).apply({"params": params["encoder_0"]}, jnp.asarray(x), jnp.asarray(sa))
    _close(tm.encoder[0](_t(x), _t(sa)), ref, 2e-5)
    ref = jt.DecoderBlock(**kw).apply({"params": params["decoder_0"]}, jnp.asarray(x),
                                      jnp.asarray(ctx), jnp.asarray(sa), jnp.asarray(xa))
    _close(tm.decoder[0](_t(x), _t(ctx), _t(sa), _t(xa)), ref, 2e-5)


def _gen_mod_dict(B, seed):
    rng = np.random.RandomState(seed)
    md = {"rgb@224": {"tensor": rng.rand(B, 224, 224, 3).astype(np.float32),
                      "input_mask": np.zeros((B, 196), bool),
                      "target_mask": np.ones((B, 196), bool),
                      "decoder_attention_mask": np.zeros((B, 196), np.int32)}}
    for m in ("tok_clip@224", "tok_depth@224"):
        md[m] = {"tensor": rng.randint(0, 8192, (B, 196)).astype(np.int32),
                 "input_mask": rng.rand(B, 196) > 0.5,
                 "target_mask": np.zeros((B, 196), bool),
                 "decoder_attention_mask": np.zeros((B, 196), np.int32)}
    md["rgb@224"]["input_mask"][1] = True  # a CFG-style empty conditioning row
    md["caption"] = {"tensor": rng.randint(0, 30000, (B, 20)).astype(np.int32),
                     "input_mask": rng.rand(B, 20) > 0.5,
                     "target_mask": np.ones((B, 20), bool),
                     "decoder_attention_mask": np.zeros((B, 20), np.int32)}
    md["caption"]["tensor"][:, 3] = 0  # a padding token
    md["t5_caption"] = {"tensor": rng.randn(B, 77, 4096).astype(np.float32),
                        "input_mask": np.arange(77)[None].repeat(B, 0) >= 9,
                        "target_mask": np.ones((B, 77), bool),
                        "decoder_attention_mask": np.zeros((B, 77), np.int32)}
    return md, rng.rand(B, 196) > 0.3


@pytest.mark.parametrize("num_encoder_tokens", [None, 256])
def test_forward_generation_img_logits(models, num_encoder_tokens):
    _, jm, variables, _, tm = models
    md, sa = _gen_mod_dict(2, 3)
    ref = jm.apply(variables, jax.tree.map(jnp.asarray, md), "tok_depth@224", jnp.asarray(sa),
                   num_encoder_tokens, method="forward_generation_img")
    with torch.no_grad():
        port = tm.forward_generation_img(
            {m: {k: _t(v) for k, v in d.items()} for m, d in md.items()}, "tok_depth@224",
            _t(sa), num_encoder_tokens)
    assert port.shape == ref.shape
    _close(port, ref, 1e-4)


@pytest.mark.parametrize("num_keep", [5, 37, 64, 100])
def test_select_tokens_exact(num_keep):
    rng = np.random.RandomState(num_keep)
    mask = rng.rand(3, 64) > 0.4
    mask[1] = True
    mask[2] = False
    ref = np.asarray(jax_ts.select_tokens(jnp.asarray(mask), num_keep))
    np.testing.assert_array_equal(ts.select_tokens(_t(mask), num_keep).numpy(), ref)
    np.testing.assert_array_equal(ts.compact_position_ids(_t(mask), 20).numpy(),
                                  np.asarray(jax_ts.compact_position_ids(jnp.asarray(mask), 20)))


def test_adapt_decoder_attention_mask_exact():
    rng = np.random.RandomState(7)
    comp = rng.randint(0, 3, (2, 12)).astype(np.int32)
    modid = rng.randint(0, 2, (2, 12)).astype(np.int32)
    for causal in (False, True):
        ref = jax_ts.adapt_decoder_attention_mask(jnp.asarray(comp), jnp.asarray(modid), causal)
        port = ts.adapt_decoder_attention_mask(_t(comp), _t(modid), causal)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("top_k,top_p", [(0.0, 0.0), (5, 0.0), (0.1, 0.0), (0.0, 0.8),
                                         (7, 0.9)])
def test_sampling_filters_match_jax(top_k, top_p):
    logits = np.random.RandomState(11).randn(3, 5, 64).astype(np.float32)
    ref = jax_sampling.top_k_top_p_filtering(jnp.asarray(logits), top_k, top_p)
    np.testing.assert_array_equal(
        sampling.top_k_top_p_filtering(_t(logits), top_k, top_p).numpy(), np.asarray(ref))
    ref = jax_sampling.top_k_top_p_filtering_dynamic(
        jnp.asarray(logits), jnp.float32(top_k), jnp.float32(top_p))
    np.testing.assert_array_equal(
        sampling.top_k_top_p_filtering_dynamic(_t(logits), top_k, top_p).numpy(),
        np.asarray(ref))
