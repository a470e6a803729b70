"""The port's KV-cached autoregressive decoding (fourm_torch) against the JAX
package's (fourm_tpu), on the CPU in fp32.

  * the plain twins of the four decode-step kernels against the Pallas
    kernels run with interpret=True (atol 2e-5, rtol 1e-4: the same fp32
    arithmetic in another summation order);
  * DecoderBlock.step against the JAX DecoderBlock.step on its XLA path
    (atol 5e-5, rtol 1e-3), caches compared after moving the JAX package's
    (B, H, Dh, L) layout to the port's (B, H, L, Dh);
  * ar_prefill + decode_one_token logits of a tiny model (atol 1e-4);
  * the device span merges against the JAX package's host merge_sequences
    (exact);
  * FourMSampler.generate over RGB -> tok_clip + caption + metadata at
    temperature 0 against the JAX FourMSampler (tokens, input masks and
    encoder-budget counts exact).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import fourm_tpu.api as jax_api
from fourm_tpu.generate import GenerationSampler as JaxGenerationSampler
from fourm_tpu.kernels.decode_step import (pallas_cross_decode_attn, pallas_decode_attention,
                                           pallas_residual_mlp, pallas_self_decode)
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.ops import transformer as jt
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_tpu.utils.text_tokenizer import (generate_sentinel_tokens,
                                            train_unified_wordpiece_tokenizer)
import fourm_torch.api as api
from fourm_torch.generate import sampler as tsampler
from fourm_torch.kernels.decode_step import (cross_decode_attn, decode_attention,
                                             residual_mlp, self_decode)
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.ops.transformer import _key_bias
from fourm_torch.utils.checkpoint import from_jax_params

KTOL = dict(atol=2e-5, rtol=1e-4)
NEG = np.finfo(np.float32).min
TINY = dict(dim=64, encoder_depth=2, decoder_depth=2, num_heads=4)
FLAVORS = ["fm_base_12e_12d_gelu", "fm_base_12e_12d_swiglu_qknorm_nobias"]
MODS = ("rgb@224", "tok_clip@224", "caption", "metadata", "human_poses")
DEC_MODS = ("tok_clip@224", "caption", "metadata", "human_poses")


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _opt_t(a):
    return None if a is None else _t(a)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or KTOL))


def _norm_params(rng, n, bias):
    return (rng.rand(n) + 0.5).astype(np.float32), \
        (rng.randn(n).astype(np.float32) * 0.1 if bias else None)


# ------------------------------------------------------------- (a) kernel twins

@pytest.mark.parametrize("qk_norm,biases,step,zero_attn", [
    (False, True, 0, False), (True, False, 5, False), (True, False, 0, False),
    (False, True, 7, True)])
def test_self_decode_twin(qk_norm, biases, step, zero_attn):
    rng = np.random.RandomState(10 + step)
    B, H, Dh, L = 2, 4, 16, 12
    C = H * Dh
    x = rng.randn(B, C).astype(np.float32) * 0.5
    g1, b1 = _norm_params(rng, C, biases)
    w = (rng.randn(C, 3 * C) / 8).astype(np.float32)  # JAX layout (C, 3C)
    bq = rng.randn(3 * C).astype(np.float32) * 0.1 if biases else None
    qn = [None] * 4
    if qk_norm:
        qn = [*_norm_params(rng, Dh, True), *_norm_params(rng, Dh, True)]
    ck = rng.randn(B, H, L, Dh).astype(np.float32) * 0.5  # the port's layout
    cv = rng.randn(B, H, L, Dh).astype(np.float32) * 0.5
    ref, rk, rv = pallas_self_decode(
        jnp.asarray(x), jnp.asarray(g1), _j(b1), jnp.asarray(w), _j(bq), *[_j(a) for a in qn],
        jnp.asarray(ck.transpose(0, 1, 3, 2)), jnp.asarray(cv.transpose(0, 1, 3, 2)),
        jnp.int32(step), H, allow_zero_attn=zero_attn, interpret=True)
    tk, tv = _t(ck), _t(cv)
    port = self_decode(_t(x), _t(g1), _opt_t(b1), _t(w.T.copy()), _opt_t(bq),
                       *[_opt_t(a) for a in qn], tk, tv, torch.tensor([step], dtype=torch.int32),
                       H, allow_zero_attn=zero_attn)
    _close(port, ref)
    _close(tk, np.asarray(rk).transpose(0, 1, 3, 2))
    _close(tv, np.asarray(rv).transpose(0, 1, 3, 2))
    untouched = np.arange(L) != step
    np.testing.assert_array_equal(tk.numpy()[:, :, untouched], ck[:, :, untouched])
    np.testing.assert_array_equal(tv.numpy()[:, :, untouched], cv[:, :, untouched])
    if step == 0 and not zero_attn:  # every cache position masked: the output is v_new
        np.testing.assert_array_equal(port.numpy(), tv.numpy()[:, :, 0].reshape(B, C))


@pytest.mark.parametrize("bias_shape,zero_attn", [
    ((1, 1), False), ("B1", False), ("BH", False), (None, True)])
def test_decode_attention_twin(bias_shape, zero_attn):
    rng = np.random.RandomState(20)
    B, H, Dh, M = 3, 4, 16, 128  # pallas_decode_attention takes M % 128 == 0
    q = rng.randn(B, H, 1, Dh).astype(np.float32)
    k = rng.randn(B, H, M, Dh).astype(np.float32)
    v = rng.randn(B, H, M, Dh).astype(np.float32)
    bias = None
    if bias_shape is not None:
        shape = {(1, 1): (1, 1, M), "B1": (B, 1, M), "BH": (B, H, M)}[bias_shape]
        bias = np.where(rng.rand(*shape) > 0.6, NEG, 0.0).astype(np.float32)
        bias += rng.randn(*shape).astype(np.float32) * (bias == 0)
        if bias_shape == "B1":
            bias[1] = NEG  # a fully masked row: uniform weights, no NaN
    ref = pallas_decode_attention(jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)),
                                  jnp.asarray(v.transpose(0, 1, 3, 2)), _j(bias),
                                  allow_zero_attn=zero_attn, interpret=True)
    port = decode_attention(_t(q), _t(k), _t(v), _opt_t(bias), zero_attn)
    _close(port, ref)
    assert not torch.isnan(port).any()
    if bias_shape == "B1":
        np.testing.assert_allclose(port.numpy()[1, :, 0], v[1].mean(axis=1), **KTOL)


@pytest.mark.parametrize("qk_norm,biases,masked,zero_attn", [
    (True, False, True, False), (False, True, False, False), (True, False, True, True)])
def test_cross_decode_attn_twin(qk_norm, biases, masked, zero_attn):
    rng = np.random.RandomState(30)
    B, H, Dh, M = 3, 4, 16, 48
    C = H * Dh
    x = rng.randn(B, C).astype(np.float32) * 0.5
    gq, bqn = _norm_params(rng, C, biases)
    wq = (rng.randn(C, C) / 8).astype(np.float32)
    bq = rng.randn(C).astype(np.float32) * 0.1 if biases else None
    cq = list(_norm_params(rng, Dh, True)) if qk_norm else [None, None]
    k = rng.randn(B, H, M, Dh).astype(np.float32)
    v = rng.randn(B, H, M, Dh).astype(np.float32)
    bias = None
    if masked:
        bias = np.where(rng.rand(B, M) > 0.6, NEG, 0.0).astype(np.float32)
        bias[2] = NEG  # a fully masked row
    ref = pallas_cross_decode_attn(
        jnp.asarray(x), jnp.asarray(gq), _j(bqn), jnp.asarray(wq), _j(bq), *[_j(a) for a in cq],
        jnp.asarray(k.transpose(0, 1, 3, 2)), jnp.asarray(v.transpose(0, 1, 3, 2)), _j(bias), H,
        allow_zero_attn=zero_attn, interpret=True)
    port = cross_decode_attn(_t(x), _t(gq), _opt_t(bqn), _t(wq.T.copy()), _opt_t(bq),
                             *[_opt_t(a) for a in cq], _t(k), _t(v), _opt_t(bias), H,
                             allow_zero_attn=zero_attn)
    _close(port, ref)
    assert not torch.isnan(port).any()


@pytest.mark.parametrize("gated,biases", [(True, False), (False, True)])
def test_residual_mlp_twin(gated, biases):
    rng = np.random.RandomState(40)
    B, C, HID = 5, 64, 96
    x, attn = (rng.randn(B, C).astype(np.float32) for _ in range(2))
    wp = (rng.randn(C, C) / 8).astype(np.float32)
    bp = rng.randn(C).astype(np.float32) * 0.1 if biases else None
    g2, be2 = _norm_params(rng, C, biases)
    w1, w3 = ((rng.randn(C, HID) / 8).astype(np.float32) for _ in range(2))
    w2 = (rng.randn(HID, C) / 10).astype(np.float32)
    b1, b3 = ((rng.randn(HID).astype(np.float32) * 0.1 if biases else None) for _ in range(2))
    b2 = rng.randn(C).astype(np.float32) * 0.1 if biases else None
    ref = pallas_residual_mlp(
        jnp.asarray(x), jnp.asarray(attn), jnp.asarray(wp), _j(bp), jnp.asarray(g2), _j(be2),
        jnp.asarray(w1), _j(b1), jnp.asarray(w2), _j(b2), _j(w3) if gated else None,
        _j(b3) if gated else None, gated=gated, act_silu=gated, interpret=True)
    port = residual_mlp(_t(x), _t(attn), _t(wp.T.copy()), _opt_t(bp), _t(g2), _opt_t(be2),
                        _t(w1.T.copy()), _opt_t(b1), _t(w2.T.copy()), _opt_t(b2),
                        _t(w3.T.copy()) if gated else None, _opt_t(b3) if gated else None,
                        gated=gated)
    _close(port, ref)


# ------------------------------------------------------- models (b), (c), embed

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
    return jcfg, jm, variables, params, tm.eval()


def _jax_block(jcfg):
    act = {"gelu": lambda v: jax.nn.gelu(v, approximate=False), "silu": jax.nn.silu}[jcfg.act]
    return jt.DecoderBlock(dim=jcfg.dim, num_heads=jcfg.num_heads, qkv_bias=jcfg.qkv_bias,
                           proj_bias=jcfg.proj_bias, mlp_bias=jcfg.mlp_bias, act=act,
                           gated_mlp=jcfg.gated_mlp, qk_norm=jcfg.qk_norm,
                           norm_bias=jcfg.norm_bias)


def _block_inputs(jcfg, seed):
    rng = np.random.RandomState(seed)
    B, L, M = 3, 10, 24
    H, C = jcfg.num_heads, jcfg.dim
    Dh = C // H
    d = dict(x=rng.randn(B, 1, C).astype(np.float32) * 0.5,
             ck=rng.randn(B, H, L, Dh).astype(np.float32) * 0.5,
             cv=rng.randn(B, H, L, Dh).astype(np.float32) * 0.5,
             xk=rng.randn(B, H, M, Dh).astype(np.float32) * 0.5,
             xv=rng.randn(B, H, M, Dh).astype(np.float32) * 0.5,
             mask=rng.rand(B, M) > 0.6)
    d["mask"][1] = True  # a fully masked conditioning row
    return d


@pytest.mark.parametrize("step", [0, 4])
def test_decoder_block_step_matches_jax(models, step):
    jcfg, _, _, params, tm = models
    d = _block_inputs(jcfg, 50 + step)
    tr = lambda a: jnp.asarray(a.transpose(0, 1, 3, 2))  # noqa: E731
    want_x, want_k, want_v = _jax_block(jcfg).apply(
        {"params": params["decoder_0"]}, jnp.asarray(d["x"]), tr(d["ck"]), tr(d["cv"]),
        tr(d["xk"]), tr(d["xv"]), jnp.asarray(d["mask"]), jnp.int32(step), method="step")
    tk, tv = _t(d["ck"]), _t(d["cv"])
    step_t = torch.tensor([step], dtype=torch.int32)
    with torch.no_grad():
        got, _, _ = tm.decoder[0].step(_t(d["x"]), tk, tv, _t(d["xk"]), _t(d["xv"]),
                                       _key_bias(_t(d["mask"])), step_t)
    tol = dict(atol=5e-5, rtol=1e-3)
    _close(got, want_x, **tol)
    _close(tk, np.asarray(want_k).transpose(0, 1, 3, 2), **tol)
    _close(tv, np.asarray(want_v).transpose(0, 1, 3, 2), **tol)


def test_sequence_decoder_embedding_matches_jax(models):
    """human_poses: max_tokens 275 > max_length 263, so AR positions from 263
    on take position-embedding 0 (pos_table's clamp)."""
    jcfg, jm, variables, _, tm = models
    dec = tm.decoder_embeddings["human_poses"]
    assert dec.max_length == 263
    with torch.no_grad():
        _, _, y_emb = tm.ar_prefill(_mod_dict(2, 60), "human_poses", 275)
    _, _, ref = jm.apply(variables, jax.tree.map(jnp.asarray, _mod_dict_np(2, 60)),
                         "human_poses", 275, method="ar_prefill")
    _close(y_emb, ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(y_emb[:, 263:], y_emb[:, :1].expand(-1, 12, -1))
    rng = np.random.RandomState(61)
    ids = rng.randint(0, 30000, (2, 300)).astype(np.int32)
    ids[:, 5] = 0  # padding
    tmask = rng.rand(2, 300) > 0.3
    ref = jm.apply(variables, "caption", jnp.asarray(ids), jnp.asarray(tmask),
                   method=lambda m, mod, i, t: m.decoder_embeddings[mod].embed(i, t))
    got = tm.decoder_embeddings["caption"].embed(_t(ids), _t(tmask))
    for g, r in zip(got, ref):
        _close(g, r, atol=1e-6, rtol=1e-6)


def _mod_dict_np(B, seed):
    rng = np.random.RandomState(seed)
    md = {"rgb@224": {"tensor": rng.rand(B, 224, 224, 3).astype(np.float32),
                      "input_mask": np.zeros((B, 196), bool),
                      "target_mask": np.ones((B, 196), bool),
                      "decoder_attention_mask": np.zeros((B, 196), np.int32)},
          "tok_clip@224": {"tensor": rng.randint(0, 8192, (B, 196)).astype(np.int32),
                           "input_mask": rng.rand(B, 196) > 0.5,
                           "target_mask": np.ones((B, 196), bool),
                           "decoder_attention_mask": np.zeros((B, 196), np.int32)}}
    md["rgb@224"]["input_mask"][1, ::2] = True
    return md


def _mod_dict(B, seed):
    return {m: {k: _t(v) for k, v in d.items()} for m, d in _mod_dict_np(B, seed).items()}


@pytest.mark.parametrize("budget", [None, 256])
def test_ar_prefill_and_decode_logits_match_jax(models, budget):
    """ar_prefill + 8 x (embed_target_token, decode_one_token, mod_logits),
    teacher-forced with the same random tokens on both sides."""
    _, jm, variables, _, tm = models
    B, L, target = 2, 16, "caption"
    md_np = _mod_dict_np(B, 70)
    toks = np.random.RandomState(71).randint(0, 30000, (B, 8)).astype(np.int32)
    toks[0, 3] = 0  # a padding token embeds to zero
    j = jax.tree.map(jnp.asarray, md_np)
    jkvs, jmask, jemb = jm.apply(variables, j, target, L, budget, method="ar_prefill")
    jcaches = jm.apply(variables, B, L, method="init_kv_caches")
    with torch.no_grad():
        kvs, mask, emb = tm.ar_prefill(_mod_dict(B, 70), target, L, budget)
        caches = tm.init_kv_caches(B, L)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        _close(kvs[1][0], np.asarray(jkvs[1][0]).transpose(0, 1, 3, 2), atol=1e-5, rtol=1e-4)
        step = torch.zeros(1, dtype=torch.int32)
        for t in range(8):
            jy = jm.apply(variables, target, jnp.asarray(toks[:, t:t + 1]),
                          method="embed_target_token") + jemb[:, t:t + 1]
            jout, jcaches = jm.apply(variables, jy, jcaches, jkvs, jmask, t,
                                     method="decode_one_token")
            ref = jm.apply(variables, target, jout, method="mod_logits")
            y = tm.embed_target_token(target, _t(toks[:, t:t + 1])) + emb[:, t:t + 1]
            out, caches = tm.decode_one_token(y, caches, kvs, mask, step)
            step += 1
            _close(tm.mod_logits(target, out), ref, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------ (d) merges

@pytest.fixture(scope="module")
def text_tok(tmp_path_factory):
    """The text tokenizer bench.py builds (bench.py:52-64): 300 WordPiece
    tokens, 20 sentinels [S_0]..[S_19]."""
    corpus = tmp_path_factory.mktemp("tok") / "corpus.txt"
    corpus.write_text("a photo of a cat and a dog\n" * 200)
    return train_unified_wordpiece_tokenizer(
        str(corpus), vocab_size=300, sentinel_tokens=generate_sentinel_tokens(num=20),
        show_progress=False)


def _random_out_ids(rng, B, T, s1, sentinels):
    out = rng.randint(30, 300, (B, T)).astype(np.int32)
    out[:, 0] = s1
    slots = rng.rand(B, T) < 0.15
    out[slots] = rng.choice(sentinels, size=int(slots.sum()))
    out[rng.rand(B, T) < 0.1] = s1  # repeated [S_1] continues its span
    out[:, 0] = s1
    for b in range(B):  # finished rows end in PAD
        out[b, rng.randint(T // 2, T):] = 0
    out[rng.rand(B, T) < 0.05] = 0
    return out


@pytest.mark.parametrize("case", ["empty_input", "general_s1_input", "general_text_input"])
def test_device_merges_match_host_merge(text_tok, case):
    rng = np.random.RandomState({"empty_input": 80, "general_s1_input": 81,
                                 "general_text_input": 82}[case])
    target, B = "caption", 4
    sent_ids = sorted(text_tok.get_vocab()[f"[S_{i}]"] for i in range(20))
    s1 = text_tok.token_to_id("[S_1]")
    T_in = 514 if case != "empty_input" else 256
    tensor = np.zeros((B, T_in), np.int32)
    in_mask = np.ones((B, T_in), bool)
    if case == "general_s1_input":
        tensor[:, 0], in_mask[:, 0] = s1, False  # the chain: [S_1] as the one input
    elif case == "general_text_input":
        for b in range(B):  # text with sentinel slots, some repeated, some unused
            n = rng.randint(1, 40)
            seq = rng.randint(30, 300, n)
            slots = rng.rand(n) < 0.3
            seq[slots] = rng.choice(sent_ids[:6], size=int(slots.sum()))
            tensor[b, :n], in_mask[b, :n] = seq, False
        in_mask[0] = True  # an empty input acts as [S_1]
    out_ids = _random_out_ids(rng, B, 256, s1, sent_ids[:6])
    md = {target: {"tensor": tensor, "input_mask": in_mask,
                   "target_mask": np.ones((B, T_in), bool),
                   "decoder_attention_mask": np.zeros((B, T_in), np.int32)}}
    host = JaxGenerationSampler(None, None, text_tok)
    want = host.merge_sequences({target: dict(md[target])}, out_ids, target)[target]
    port = tsampler.GenerationSampler(None, text_tok)
    tmd = {target: {k: _t(v) for k, v in md[target].items()}}
    if case == "empty_input":
        got = port.merge_sequences_device(tmd, _t(out_ids), target)[target]
    else:
        got = port.merge_sequences_device_general(tmd, _t(out_ids), target)[target]
    for k in ("tensor", "input_mask", "target_mask", "decoder_attention_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert port._last_merge_valid == host._last_merge_valid


# ------------------------------------------------------------------- (e) chain

CHAIN = ["tok_clip@224", "caption", "metadata"]


def _record_counts(sampler, names, log):
    for name in names:
        inner = getattr(sampler, name)

        def wrapped(*args, _inner=inner, **kwargs):
            out = _inner(*args, **kwargs)
            log.append(dict(kwargs["counts"]))
            return out

        setattr(sampler, name, wrapped)


@pytest.fixture(scope="module")
def chain_pair():
    name = "fm_base_12e_12d_swiglu_qknorm_nobias"
    mods, dec = ("rgb@224", *CHAIN), tuple(CHAIN)
    jm = JaxFourM(jax_config(name, mods, dec, **TINY))
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(mods, 2, 32, 32))
    variables = jm.init(jax.random.key(1), batch, 32, 32)
    tcfg = create_fourm_config(name, mods, dec, **TINY)
    tm = FourM(tcfg)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)["params"], tcfg))
    return (jm, variables), tm


def test_chain_rgb_to_clip_caption_metadata_matches_jax(chain_pair, text_tok):
    (jm, variables), tm = chain_pair
    B = 2
    defaults = {t: {**jax_api.DEFAULTS_RGB2X[t], "temp": 0.0} for t in CHAIN}
    jsampler = jax_api.FourMSampler(fm=(jm, variables), text_tokenizer=text_tok)
    port = api.FourMSampler(tm, text_tok, device="cpu")
    sample = {"rgb@224": np.random.RandomState(90).rand(B, 224, 224, 3).astype(np.float32)}
    jmd = jsampler.prepare_sample(sample, ["rgb@224"], CHAIN, batch_size=B)
    tmd = port.prepare_sample(sample, ["rgb@224"], CHAIN, batch_size=B)
    sched = port.build_schedule(["rgb@224"], CHAIN, defaults=defaults)
    assert sched == jsampler.build_schedule(["rgb@224"], CHAIN, defaults=defaults)
    assert [s["scheme"] for s in sched] == ["roar", "autoregressive", "autoregressive"]

    jcounts, tcounts = [], []
    _record_counts(jsampler.sampler, ["_generate_one_step"], jcounts)
    _record_counts(port.sampler, ["_generate_img_target", "_generate_seq_target"], tcounts)
    jout = jsampler.generate(jmd, sched, seed=0)
    tout = port.generate(tmd, sched, seed=0)
    assert tcounts == jcounts and len(tcounts) == 3
    assert tcounts[-1]["caption"] > 1 and tcounts[-1]["metadata"] > 1
    for t in CHAIN:
        for k in ("tensor", "input_mask", "target_mask"):
            np.testing.assert_array_equal(tout[t][k].numpy(), np.asarray(jout[t][k]),
                                          err_msg=f"{t} {k}")
    assert port.sampler._ar_tokens == {"caption": 255, "metadata": 39}


def test_caption_with_cfg_matches_jax(chain_pair, text_tok):
    """A sequence target with classifier-free guidance: cond and uncond
    decode in one batch-doubled loop (caches and cross K/V for 2B rows)."""
    (jm, variables), tm = chain_pair
    B = 2
    defaults = {"caption": {**jax_api.DEFAULTS_RGB2X["caption"], "temp": 0.0,
                            "cfg_scale": 2.0}}
    jsampler = jax_api.FourMSampler(fm=(jm, variables), text_tokenizer=text_tok)
    port = api.FourMSampler(tm, text_tok, device="cpu")
    sample = {"rgb@224": np.random.RandomState(91).rand(B, 224, 224, 3).astype(np.float32)}
    sched = port.build_schedule(["rgb@224"], ["caption"], defaults=defaults)
    assert sched[0]["cfg_scale"] == 2.0 and sched[0]["cfg_cond_domains"] == ["rgb@224"]
    jout = jsampler.generate(jsampler.prepare_sample(sample, ["rgb@224"], ["caption"], B),
                             sched, seed=0)
    tout = port.generate(port.prepare_sample(sample, ["rgb@224"], ["caption"], B), sched,
                         seed=0)
    for k in ("tensor", "input_mask"):
        np.testing.assert_array_equal(tout["caption"][k].numpy(), np.asarray(jout["caption"][k]))


def test_sequence_target_without_tokenizer_raises(models):
    _, _, _, _, tm = models
    sampler = api.FourMSampler(tm, device="cpu")
    md = sampler.prepare_sample({"rgb@224": np.zeros((1, 224, 224, 3), np.float32)},
                                ["rgb@224"], ["caption"], batch_size=1)
    with pytest.raises(ValueError, match="tokenizer"):
        sampler.generate(md, sampler.build_schedule(["rgb@224"], ["caption"]), seed=0)


def test_ar_loop_stops_after_every_row_is_done(models, monkeypatch):
    """EOS forced from token 3 for row 0 and token 21 for row 1: row 0
    freezes to PAD, the loop stops within DONE_CHECK_EVERY tokens of the
    last EOS, and the length is the JAX loop's (first all-done step + 1)."""
    _, _, _, _, tm = models
    sampler = tsampler.GenerationSampler(tm)
    md = _mod_dict(2, 95)
    md["caption"] = {k: _t(v) for k, v in _empty_caption(2).items()}
    eos = int(md["caption"]["tensor"][0, -1])
    calls = {"n": 0}
    real = tm.mod_logits

    def forced(mod, y):
        logits = real(mod, y).clone()
        t = calls["n"]
        calls["n"] += 1
        logits[:, 0, 7] = 1e4  # a plain token
        if t >= 2:
            logits[0, 0, eos] = 2e4
        if t >= 20:
            logits[1, 0, eos] = 2e4
        return logits

    monkeypatch.setattr(tm, "mod_logits", forced)
    with torch.no_grad():
        out, length = sampler._ar_decode(md, "caption", (), False, 256, 0.0, 1.0, 0.0, 0.0,
                                         None, torch.Generator().manual_seed(0))
    assert length == 22
    assert sampler._ar_tokens["caption"] == 32  # checked at t = 16, 32
    o = out.numpy()
    assert (o[0, 1:3] == 7).all() and o[0, 3] == eos and (o[0, 4:] == 0).all()
    assert (o[1, 1:21] == 7).all() and o[1, 21] == eos and (o[1, 22:] == 0).all()


def _empty_caption(B):
    from fourm_torch.generate.init_helpers import init_empty_target_modality

    return init_empty_target_modality({}, "caption", B, 256)["caption"]
