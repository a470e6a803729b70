"""The port's kernel routes (fourm_torch) on the CPU: each wrapper's
`<wrapper>_takes` predicate as a pure function of dtypes, shapes and
alignment (bf16 at every 4M registry width and at the 4M-B / 4M-21 XL
shapes is taken; float32, a width that is not a multiple of 8 and an
unaligned tensor are refused), the block layer's route of a float32 model
to the plain twins and the error a refused wrapper call raises (with the
card stood in for by meta tensors), and the three narrow registry
models (fm_tiny_6e_6d_gelu, fm_tiny_6e_6d_swiglu_nobias,
fm_small_8e_8d_swiglu_nobias) cut to 2 + 2 layers against the JAX package in
fp32: forward_generation_img logits and ar_prefill + decode_one_token
logits at atol 1e-4 (rtol 1e-4), only summation orders differing."""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_torch import kernels
from fourm_torch.kernels import attention as at
from fourm_torch.kernels import attention_train as atr
from fourm_torch.kernels import decode_step as ds
from fourm_torch.kernels import fused_mlp as fm
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.models.fourm import MODEL_REGISTRY
from fourm_torch.ops import transformer as tt
from fourm_torch.utils.checkpoint import from_jax_params

BF, F32 = torch.bfloat16, torch.float32
# (D, heads, MLP hidden width) of every registry model: GELU 4D, SwiGLU int(2 * 4D / 3)
WIDTHS = sorted({(c["dim"], c["num_heads"],
                  int(2 * 4 * c["dim"] / 3) if c.get("gated_mlp") else 4 * c["dim"])
                 for c in MODEL_REGISTRY.values()})
# rows of the 4M-B and XL shapes the chain runs: encoder budgets and decoder grids
ROWS = {768: (16 * 2048, 16 * 196), 2048: (8 * 2304, 8 * 196)}


def _meta(*shape, dtype=BF):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _unaligned(*shape, dtype=BF):
    """A contiguous CPU tensor whose data starts 2 bytes past an aligned
    address."""
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)
    t = flat[1:].view(*shape)
    assert t.data_ptr() % 16 != 0
    return t


def test_registry_widths():
    assert (384, 6, 1536) in WIDTHS and (384, 6, 1024) in WIDTHS and (512, 8, 1365) in WIDTHS
    assert (2048, 32, 5461) in WIDTHS and all(d == 64 * h for d, h, _ in WIDTHS)


@pytest.mark.parametrize("D,heads,HID", WIDTHS)
def test_ln_predicates_take_bf16_at_registry_widths(D, heads, HID):
    for M in ROWS.get(D, (2 * 196, 3)):
        x = _meta(M, D)
        assert fm.ln_matmul_takes(x, _meta(3 * D, D))
        assert fm.ln_mlp_takes(x, _meta(HID, D), _meta(D, HID), _meta(HID, D))
        assert fm.ln_mlp_takes(x, _meta(HID, D), _meta(D, HID))
        assert not fm.ln_matmul_takes(_meta(M, D, dtype=F32), _meta(3 * D, D, dtype=F32))
        assert not fm.ln_mlp_takes(_meta(M, D, dtype=F32), _meta(HID, D, dtype=F32),
                                   _meta(D, HID, dtype=F32))
        assert not fm.ln_mlp_takes(x, _meta(HID, D, dtype=F32), _meta(D, HID))


def test_ln_predicates_refuse_widths_and_alignment():
    assert not fm.ln_matmul_takes(_meta(10, 100), _meta(64, 100))  # D % 8
    assert not fm.ln_matmul_takes(_meta(10, 64), _meta(60, 64))    # F % 8
    assert not fm.ln_mlp_takes(_meta(10, 100), _meta(64, 100), _meta(100, 64))
    assert fm.ln_mlp_takes(_meta(10, 64), _meta(17, 64), _meta(64, 17))  # any hidden width
    assert not fm.ln_matmul_takes(_meta(0, 64), _meta(64, 64))     # no rows
    x = _unaligned(3, 64)
    assert not fm.ln_matmul_takes(x, _meta(64, 64))
    assert not fm.ln_mlp_takes(x, _meta(128, 64), _meta(64, 128))
    assert not fm.ln_matmul_takes(torch.zeros(64, 3, dtype=BF).t(), _meta(64, 3 * 8))


@pytest.mark.parametrize("D,heads,HID", WIDTHS)
def test_attention_predicates(D, heads, HID):
    B, N = 2, 196
    qkv = _meta(B, N, 3 * D)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    assert at.flash_mha_takes(q, k, v, heads) and at.mha_short_takes(qkv, heads)
    assert not at.flash_mha_takes(q.float(), k.float(), v.float(), heads)
    assert not at.mha_short_takes(qkv.float(), heads)
    assert at.flash_mha_takes(q, k, v, heads * 2) and at.mha_short_takes(qkv, heads * 2)
    assert not at.flash_mha_takes(q, k, v, heads * 4)  # heads of 16
    qh = _meta(B, heads, N, 64)
    kh = _meta(B, heads, 2304, 64)
    assert at.attention_takes(qh, kh, kh)
    assert not at.attention_takes(qh.float(), kh.float(), kh.float())
    assert at.attention_takes(_meta(B, heads, N, 32), _meta(B, heads, 9, 32),
                              _meta(B, heads, 9, 32))
    assert not at.attention_takes(_meta(B, heads, N, 16), _meta(B, heads, 9, 16),
                                  _meta(B, heads, 9, 16))
    # decode step: one token per row, caches (B, H, L, 64), cross K/V (B, H, M, 64)
    x1 = _meta(8, D)
    cache = _meta(8, heads, 256, 64)
    assert ds.self_decode_takes(x1, _meta(3 * D, D), cache, cache, heads)
    assert not ds.self_decode_takes(x1.float(), _meta(3 * D, D, dtype=F32), cache.float(),
                                    cache.float(), heads)
    q1 = _meta(8, heads, 1, 64)
    assert ds.decode_attention_takes(q1, kh[:1].expand(8, -1, -1, -1).contiguous(),
                                     kh[:1].expand(8, -1, -1, -1).contiguous())
    i8 = _meta(8, heads, 2304, 64, dtype=torch.int8)
    assert ds.decode_attention_takes(q1, i8, i8, int8=True)
    assert not ds.decode_attention_takes(q1, i8, i8)
    assert not ds.decode_attention_takes(q1.float(), i8, i8, int8=True)
    assert ds.cross_decode_attn_takes(x1, _meta(D, D), heads)
    assert not ds.cross_decode_attn_takes(x1.float(), _meta(D, D, dtype=F32), heads)
    mlp = (_meta(D, D), _meta(HID, D), _meta(D, HID), _meta(HID, D))
    assert ds.residual_mlp_takes(x1, x1, *mlp)
    assert not ds.residual_mlp_takes(x1.float(), x1.float(), *(w.float() for w in mlp))
    assert not ds.residual_mlp_takes(_unaligned(8, D), x1, *mlp)


def test_attn_block_and_train_predicates(monkeypatch):
    # the CPU twin takes anything
    assert at.attn_block_takes(1000, 64, "cpu") and at.attn_block_takes(10, 384, "cpu", 6)
    cuda = torch.device("cuda")
    # widths the kernel is not built for: refused before the library is asked
    assert not at.attn_block_takes(196, 384, cuda, 6)
    assert not at.attn_block_takes(196, 512, cuda, 16)
    from fourm_torch.kernels import _build

    fits = {"attn_block_fits": lambda N, C: int(N <= 400)}
    monkeypatch.setattr(_build, "entry", lambda name: fits[name])
    for C in (512, 768, 1024):
        assert at.attn_block_takes(196, C, cuda, C // 64)
        assert not at.attn_block_takes(1000, C, cuda, C // 64)
        assert not at.attn_block_takes(196, C, cuda, C // 32)
    # training attention: bf16 at head dim 64 off the CPU; the twins on the CPU
    for dtype in (BF, F32):
        q, k = _meta(32, 12, 128, 64, dtype=dtype), _meta(32, 12, 128, 64, dtype=dtype)
        assert atr.attention_train_takes(q, k, None) == (dtype == BF)
        assert atr.attention_train_takes(torch.empty(q.shape, dtype=dtype),
                                         torch.empty(k.shape, dtype=dtype), None)


def _on_meta(monkeypatch, *modules):
    """Stand the card in with meta tensors: each module's device check
    accepts them, so a wrapper checks its call as on CUDA."""
    for mod in modules:
        monkeypatch.setattr(mod, "require_cuda", lambda name, *ts: torch.device("meta"))


def test_refused_calls_run_the_twin_and_count(monkeypatch):
    """A float32 model off the CPU (meta tensors stand in for the card)
    takes the plain twins at the block layer: every inference half, the
    KV-cached decode step and the training attention run with the shapes
    following and no kernel wrapper called, so every launch count stays 0.
    A bf16 block there goes to the wrappers, which do not take meta
    tensors. The block layer decides by dtype alone: a bf16 block with
    heads of 32 reaches the same wrappers as one with heads of 64, and
    none of its calls goes to a twin by shape."""
    kernels.reset_launch_counts()
    B, N, M, D, H, L = 2, 7, 9, 128, 2, 16
    with torch.device("meta"):
        enc = tt.Block(D, H, gated_mlp=True, act="silu", qk_norm=True).eval()
        short = tt.Block(D, H).eval()
        dec = tt.DecoderBlock(D, H).eval()
        bf16 = tt.Block(D, H, dtype=BF).to(BF).eval()
    x, ctx = _meta(B, N, D, dtype=F32), _meta(B, M, D, dtype=F32)
    key = torch.zeros(B, N, dtype=torch.bool, device="meta")
    assert enc(x, key).shape == x.shape and short(x, key).shape == x.shape
    assert dec(x, ctx).shape == x.shape
    cache = _meta(B, H, L, D // H, dtype=F32)
    kv = dec.cross_kv(ctx)
    y, _, _ = dec.step(x[:, :1], cache, cache, *kv, None,
                       torch.zeros(1, dtype=torch.int32, device="meta"))
    assert y.shape == (B, 1, D)
    q = _meta(B, H, N, D // H, dtype=F32)
    assert tt.dot_product_attention(q, q, q, train=True).shape == q.shape
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError, match="CUDA device"):
        bf16(x.to(BF))

    # bf16 heads of 32 and of 64: each wrapper reached is recorded here in
    # its place (the wrappers do not take meta tensors)
    reached = []
    for name in ("ln_matmul", "ln_mlp", "mha_short", "flash_mha", "attention", "attn_block",
                 "self_decode", "cross_decode_attn", "residual_mlp"):
        twin = getattr(tt, f"{name}_plain")
        monkeypatch.setattr(tt, name, lambda *a, _n=name, _t=twin, **k: (reached.append(_n),
                                                                        _t(*a, **k))[1])
        monkeypatch.setattr(tt, f"{name}_plain", lambda *a, _n=name, **k: pytest.fail(
            f"the block layer called {_n}'s twin"))
    with torch.device("meta"):
        narrow = [tt.Block(64, 2, dtype=BF), tt.DecoderBlock(64, 2, dtype=BF),
                  tt.CrossAttentionBlock(64, 2, dtype=BF)]
        wide = [tt.Block(128, 2, dtype=BF), tt.DecoderBlock(128, 2, dtype=BF),
                tt.CrossAttentionBlock(128, 2, dtype=BF)]
    for D, blocks, heads in ((64, narrow, 32), (128, wide, 64)):
        enc, dec, xblock = (m.to(BF).eval() for m in blocks)
        reached.clear()
        xb, cb = _meta(B, N, D), _meta(B, M, D)
        assert enc(xb, key).shape == dec(xb, cb).shape == xblock(xb, cb).shape == xb.shape
        cache = _meta(B, H, L, heads)
        y, _, _ = dec.step(_meta(B, 1, D), cache, cache, *dec.cross_kv(cb), None,
                           torch.zeros(1, dtype=torch.int32, device="meta"))
        assert y.shape == (B, 1, D)
        assert sorted(reached) == sorted(
            ["ln_matmul", "mha_short"] * 2 + ["ln_mlp"] * 3 + ["attention"] * 2
            + ["self_decode", "cross_decode_attn", "residual_mlp"]), heads
    assert not any(kernels.launch_counts().values())


def test_refused_wrapper_calls_raise(monkeypatch):
    """Given CUDA-like tensors (meta) its predicate refuses, each wrapper
    raises before any launch: TypeError for float32, ValueError for a
    width, stride or alignment its kernel does not take. No wrapper runs
    its plain twin on the card."""
    _on_meta(monkeypatch, fm, at, ds, atr)
    kernels.reset_launch_counts()
    B, N, D, H, HID = 2, 7, 128, 2, 96
    g = _meta(D, dtype=F32)
    x, w = _meta(B, N, D, dtype=F32), _meta(3 * D, D, dtype=F32)
    w1, w2 = _meta(HID, D, dtype=F32), _meta(D, HID, dtype=F32)
    qkv = _meta(B, N, 3 * D, dtype=F32)
    qh = _meta(B, H, N, 64, dtype=F32)
    x1, wq = _meta(B, D, dtype=F32), _meta(D, D, dtype=F32)
    cache, kv = _meta(B, H, 16, 64, dtype=F32), _meta(B, H, 9, 64, dtype=F32)
    q1, sc = _meta(B, H, 1, 64, dtype=F32), _meta(B, H, 64, dtype=F32)
    i8 = _meta(B, H, 9, 64, dtype=torch.int8)
    step = torch.zeros(1, dtype=torch.int32, device="meta")
    calls = [
        lambda: fm.ln_matmul(x, g, None, w),
        lambda: fm.ln_mlp(x, g, None, w1, None, w2, None, w1, None, gated=True),
        lambda: at.flash_mha(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], H),
        lambda: at.mha_short(qkv, H),
        lambda: at.attention(qh, qh, qh),
        lambda: at.attn_block(x, g, None, w, None, wq, None, H),
        lambda: ds.self_decode(x1, g, None, w, None, None, None, None, None, cache, cache,
                               step, H),
        lambda: ds.cross_decode_attn(x1, g, None, wq, None, None, None, kv, kv, None, H),
        lambda: ds.decode_attention(q1, kv, kv),
        lambda: ds.decode_attention_int8(q1, i8, i8, sc, sc),
        lambda: ds.residual_mlp(x1, x1, wq, None, g, None, w1, None, w2, None, w1, None,
                                gated=True),
        lambda: atr.attention_train_fwd(qh, qh, qh),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="bf16"):
            call()
    # bf16, but a width (D % 8), a head dim, a stride or a width attn_block is
    # not built for
    with pytest.raises(ValueError, match="does not take"):
        fm.ln_matmul(_meta(3, 100), g, None, _meta(64, 100))
    with pytest.raises(ValueError, match="does not take"):
        fm.ln_mlp(_meta(3, 100), g, None, _meta(64, 100), None, _meta(100, 64), None)
    with pytest.raises(ValueError, match="does not take"):
        at.attention(_meta(B, H, N, 16), _meta(B, H, 9, 16), _meta(B, H, 9, 16))
    with pytest.raises(ValueError, match="does not take"):
        ds.residual_mlp(_meta(D, B).t(), x1.to(BF), wq.to(BF), None, g, None, w1.to(BF),
                        None, w2.to(BF), None)
    with pytest.raises(ValueError, match="does not take"):
        at.attn_block(_meta(B, N, 384), g, None, _meta(3 * 384, 384), None, _meta(384, 384),
                      None, 6)
    assert not any(kernels.launch_counts().values())


# ------------------------------------------------- the narrow registry models

NARROW = ["fm_tiny_6e_6d_gelu", "fm_tiny_6e_6d_swiglu_nobias", "fm_small_8e_8d_swiglu_nobias"]
MODS = ("rgb@224", "tok_clip@224", "tok_depth@224", "caption")
DEC_MODS = ("tok_clip@224", "tok_depth@224", "caption")
CUT = dict(encoder_depth=2, decoder_depth=2)


@pytest.fixture(scope="module", params=NARROW)
def narrow(request):
    jcfg = jax_config(request.param, MODS, DEC_MODS, **CUT)
    tcfg = create_fourm_config(request.param, MODS, DEC_MODS, **CUT)
    jm = JaxFourM(jcfg)
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(MODS, 2, 32, 32))
    variables = jm.init(jax.random.key(0), batch, 32, 32)
    params = jax.tree.map(np.asarray, variables)["params"]
    tm = FourM(tcfg)
    tm.load_state_dict(from_jax_params(params, tcfg), strict=True)
    return request.param, jm, variables, tm.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def _mod_dict_np(B, seed, decoded_clip: bool):
    rng = np.random.RandomState(seed)
    md = {"rgb@224": {"tensor": rng.rand(B, 224, 224, 3).astype(np.float32),
                      "input_mask": np.zeros((B, 196), bool),
                      "target_mask": np.ones((B, 196), bool),
                      "decoder_attention_mask": np.zeros((B, 196), np.int32)}}
    md["rgb@224"]["input_mask"][1, ::3] = True
    for m in ("tok_clip@224", "tok_depth@224"):
        md[m] = {"tensor": rng.randint(0, 8192, (B, 196)).astype(np.int32),
                 "input_mask": rng.rand(B, 196) > (0.0 if decoded_clip else 0.5),
                 "target_mask": np.ones((B, 196), bool) if decoded_clip
                 else np.zeros((B, 196), bool),
                 "decoder_attention_mask": np.zeros((B, 196), np.int32)}
    md["tok_clip@224"]["input_mask"][:] = False  # an input, fully given
    return md


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_narrow_forward_generation_img_matches_jax(narrow):
    name, jm, variables, tm = narrow
    md = _mod_dict_np(2, 3, decoded_clip=False)
    sa = np.random.RandomState(4).rand(2, 196) > 0.3
    ref = jm.apply(variables, jax.tree.map(jnp.asarray, md), "tok_depth@224", jnp.asarray(sa),
                   None, method="forward_generation_img")
    with torch.no_grad():
        port = tm.forward_generation_img({m: {k: _t(v) for k, v in d.items()}
                                          for m, d in md.items()}, "tok_depth@224", _t(sa), None)
    assert port.shape == ref.shape
    _close(port, ref)


def test_narrow_ar_prefill_and_decode_match_jax(narrow):
    name, jm, variables, tm = narrow
    B, L, target, budget = 2, 8, "caption", 256
    md = _mod_dict_np(B, 5, decoded_clip=True)
    toks = np.random.RandomState(6).randint(0, 30000, (B, 3)).astype(np.int32)
    jkvs, jmask, jemb = jm.apply(variables, jax.tree.map(jnp.asarray, md), target, L, budget,
                                 method="ar_prefill")
    jcaches = jm.apply(variables, B, L, method="init_kv_caches")
    with torch.no_grad():
        kvs, mask, emb = tm.ar_prefill({m: {k: _t(v) for k, v in d.items()}
                                        for m, d in md.items()}, target, L, budget)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        caches = tm.init_kv_caches(B, L)
        step = torch.zeros(1, dtype=torch.int32)
        for t in range(toks.shape[1]):
            jy = jm.apply(variables, target, jnp.asarray(toks[:, t:t + 1]),
                          method="embed_target_token") + jemb[:, t:t + 1]
            jout, jcaches = jm.apply(variables, jy, jcaches, jkvs, jmask, t,
                                     method="decode_one_token")
            ref = jm.apply(variables, target, jout, method="mod_logits")
            y = tm.embed_target_token(target, _t(toks[:, t:t + 1])) + emb[:, t:t + 1]
            out, caches = tm.decode_one_token(y, caches, kvs, mask, step)
            step += 1
            _close(tm.mod_logits(target, out), ref)
