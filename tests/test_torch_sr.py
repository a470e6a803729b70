"""224 -> 448 super-resolution in the port (fourm_torch.api.FourMSampler(fm_sr=),
super_resolve, __call__(perform_sr=True)) and decoding at 448, against the
JAX package on the CPU in fp32, with the same weights (from_jax_params,
from_jax_vq_variables) and the same numpy-seeded inputs.

super_resolve runs DEFAULTS_SR (8 MaskGIT cosine steps of 784 tokens per
target, CFG 2.0) with its temperature patched to 0 in both packages at run
time: no random draw then decides anything, so the @448 tokens must equal
the JAX package's exactly. One step's logits: atol 1e-4 (as
tests/test_torch_generation.py). The decoders at 448: to 1e-4 of the
output's magnitude plus 1e-5 (summation orders differ), as
tests/test_torch_decoding.py."""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_leaves import init_variables
import fourm_tpu.api as jax_api
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.utils import decoding as jdec
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_tpu.vq import DiVAE as JaxDiVAE
from fourm_tpu.vq import VQVAE as JaxVQVAE
import fourm_torch.api as api
from fourm_torch.data.transforms import get_transform_resolution
from fourm_torch.generate import (GenerationSampler, init_empty_target_modality,
                                  init_full_input_modality)
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.utils import decoding as tdec
from fourm_torch.utils.checkpoint import from_jax_params, from_jax_vq_variables
from fourm_torch.vq import DiVAE, VQVAE

TINY = dict(dim=128, encoder_depth=2, decoder_depth=2, num_heads=4)
FLAVORS = ["fm_tiny_6e_6d_gelu", "fm_tiny_6e_6d_swiglu_nobias"]
# the SR model: @224 conditions and two @448 targets; tok_dinov2@224 is in
# the chain's output but not embedded by it (nor has it an @448 target)
SR_ENC = ("rgb@224", "tok_rgb@224", "tok_depth@224", "tok_depth@448", "tok_rgb@448")
SR_DEC = ("tok_depth@448", "tok_rgb@448")
BASE_MODS = ("rgb@224", "tok_rgb@224", "tok_depth@224")
SR_TARGETS = ["tok_depth@448", "tok_rgb@448"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rel=1e-4):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, dtype=np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, atol=rel * float(np.abs(ref).max()) + 1e-5, rtol=0)


def _pair(name, enc, dec, seed):
    jm = JaxFourM(jax_config(name, enc, dec, **TINY))
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(enc, 1, 32, 32))
    variables = jm.init(jax.random.key(seed), batch, 32, 32)
    tcfg = create_fourm_config(name, enc, dec, **TINY)
    tm = FourM(tcfg).eval()
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)["params"], tcfg))
    return (jm, variables), tm


@pytest.fixture(scope="module", params=FLAVORS)
def sr_pair(request):
    return _pair(request.param, SR_ENC, SR_DEC, 7)


def _chain_output(B=2, seed=0):
    """What a chain leaves: rgb@224 and three @224 token targets, decoded
    (numpy; tok_dinov2@224 has no @448 counterpart and no SR embedding)."""
    rng = np.random.RandomState(seed)
    md = {"rgb@224": {"tensor": rng.rand(B, 224, 224, 3).astype(np.float32)}}
    for m, vocab, n in (("tok_rgb@224", 16384, 196), ("tok_depth@224", 8192, 196),
                        ("tok_dinov2@224", 8192, 256)):
        md[m] = {"tensor": rng.randint(0, vocab, (B, n)).astype(np.int32)}
    for m in md:
        init_full_input_modality(md, m)
    md["caption"] = {"tensor": np.zeros((B, 8), np.int32), "input_mask": np.ones((B, 8), bool),
                     "target_mask": np.ones((B, 8), bool),
                     "decoder_attention_mask": np.zeros((B, 8), np.int32)}
    return md


def _copy(md):
    return {m: {k: np.array(v) for k, v in d.items()} for m, d in md.items()}


@pytest.fixture
def greedy_sr(monkeypatch):
    """DEFAULTS_SR at temperature 0, in both packages, for this test only."""
    for mod in (jax_api, api):
        monkeypatch.setattr(mod, "DEFAULTS_SR",
                            {k: {**v, "temp": 0.0} for k, v in mod.DEFAULTS_SR.items()})


def test_super_resolve_matches_jax(sr_pair, greedy_sr):
    (jm, variables), tm = sr_pair
    jsampler = jax_api.FourMSampler(fm=(jm, variables), fm_sr=(jm, variables))
    tsampler = api.FourMSampler(tm, fm_sr=tm, device="cpu")
    md = _chain_output(B=1)
    jout = jsampler.super_resolve(_copy(md), seed=0)
    given = _copy(md)
    tout = tsampler.super_resolve(given, seed=0)
    conds = ["rgb@224", "tok_rgb@224", "tok_depth@224", "tok_dinov2@224"]
    assert list(tout) == list(jout) == conds + SR_TARGETS
    for m in tout:
        for k in ("tensor", "input_mask", "target_mask"):
            np.testing.assert_array_equal(tout[m][k].numpy(), np.asarray(jout[m][k]),
                                          err_msg=f"{m} {k}")
    for t in SR_TARGETS:
        d = tout[t]
        assert d["tensor"].shape == (1, 784)
        assert bool(d["target_mask"].all()) and not bool(d["input_mask"].any())
    for m in md:  # the chain's output is copied, not changed
        for k in md[m]:
            np.testing.assert_array_equal(given[m][k], md[m][k])


def test_super_resolve_step_logits_match_jax(sr_pair):
    """The first SR step (tok_depth@448, every position still masked, the
    conditions grown by nothing yet) at the encoder budget generate gives
    it, and over the whole stream."""
    (jm, variables), tm = sr_pair
    md = _chain_output(seed=1)
    sr = {m: md[m] for m in md if m.endswith("@224")}
    for t in SR_TARGETS:
        init_empty_target_modality(sr, t, 2, 784)
    sampler = GenerationSampler(tm)
    sched = api.FourMSampler(tm, device="cpu").build_schedule(list(sr)[:3], SR_TARGETS,
                                                              defaults=api.DEFAULTS_SR)
    group = [s for s in sched if s["target_domain"] == "tok_depth@448"]
    assert len(group) == 8 and sum(s["num_tokens"] for s in group) == 784
    budget = sampler._group_budget(sampler._init_valid_counts(sr), sr, group)
    assert budget == 1536  # 3 x 196 valid condition tokens + 784 = 1372, in 256s
    sa = np.ones((2, 784), bool)
    for b in (budget, None):
        ref = jm.apply(variables, jax.tree.map(jnp.asarray, sr), "tok_depth@448",
                       jnp.asarray(sa), b, method="forward_generation_img")
        with torch.no_grad():
            got = tm.forward_generation_img({m: {k: _t(v) for k, v in d.items()}
                                             for m, d in sr.items()},
                                            "tok_depth@448", _t(sa), b)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_super_resolve_targets_follow_the_chain(sr_pair):
    """Only the DEFAULT_ORDER_SR keys with an @224 counterpart become
    targets, in that order; B comes from the first condition."""
    _, tm = sr_pair
    sampler = api.FourMSampler(tm, fm_sr=tm, device="cpu")
    md = _chain_output(B=1)
    del md["tok_rgb@224"]
    schedule = []
    inner = sampler.sampler_sr.generate

    def recording(sr_dict, sched, **kw):
        schedule.extend(sched)
        return inner(sr_dict, sched, **kw)

    sampler.sampler_sr.generate = recording
    out = sampler.super_resolve(md, seed=1)
    assert list(out) == ["rgb@224", "tok_depth@224", "tok_dinov2@224", "tok_depth@448"]
    assert {s["target_domain"] for s in schedule} == {"tok_depth@448"}
    assert [s["scheme"] for s in schedule] == ["maskgit"] * 8
    assert all(s["cfg_scale"] == 2.0 and s["temperature"] == 1.0 for s in schedule)
    assert schedule[0]["cfg_cond_domains"] == ["rgb@224", "tok_depth@224", "tok_dinov2@224"]
    assert out["tok_depth@448"]["tensor"].shape == (1, 784)


def _vqvae_448(codebook_size=64):
    """A vit_t VQ-VAE trained at 224 (14 x 14 grid), decoding a 28 x 28 grid."""
    kw = dict(image_size=224, patch_size=16, enc_type="vit_t_enc", dec_type="vit_t_dec",
              latent_dim=16, codebook_size=codebook_size)
    jm = JaxVQVAE(**kw)
    variables = init_variables(jm, 70, jnp.zeros((1, 224, 224, 3)))
    pm = VQVAE(**kw, device="cpu")
    pm.load_state_dict(from_jax_vq_variables(variables), strict=True)
    return jm, variables, pm


def test_vit_vqvae_decodes_a_28x28_grid_as_jax():
    jm, variables, pm = _vqvae_448()
    tokens = np.random.RandomState(71).randint(0, 64, (2, 28, 28))
    ref = jm.apply(variables, jnp.asarray(tokens), method="decode_tokens")
    assert ref.shape == (2, 448, 448, 3)
    _close(pm.decode_tokens(_t(tokens)), ref)


def test_decode_dict_at_448_matches_jax():
    """decode_dict reads 448 from the @448 keys (get_transform_resolution),
    so a tok_rgb@448 grid of 784 tokens decodes to 448 x 448."""
    assert get_transform_resolution("tok_rgb@448", 224, to_tuple=False) == 448
    jm, variables, pm = _vqvae_448()
    tokens = np.random.RandomState(72).randint(0, 64, (2, 784))
    md = {"tok_rgb@448": {"tensor": tokens, "input_mask": np.zeros((2, 784), bool),
                          "target_mask": np.ones((2, 784), bool)}}
    ref = jdec.decode_dict(md, {"tok_rgb": jdec.TokenizerBundle(jm, variables)}, None)
    port = tdec.decode_dict(md, {"tok_rgb": tdec.TokenizerBundle(pm)}, None)
    assert port["tok_rgb@448"].shape == (2, 448, 448, 3)
    _close(port["tok_rgb@448"], ref["tok_rgb@448"])


def _divae_pair(kw, seed):
    jm = JaxDiVAE(**kw)
    x = jnp.zeros((1, kw["image_size"], kw["image_size"], 3))
    variables = init_variables(jm, seed, x, x, jnp.asarray([3]))
    pm = DiVAE(**kw, device="cpu")
    pm.load_state_dict(from_jax_vq_variables(variables), strict=True)
    return jm, variables, pm


@pytest.mark.parametrize("dec_type,B", [("uvit_t_p4_f16", 2), ("unet_patched", 1)])
def test_divae_denoise_step_at_448_matches_jax(dec_type, B):
    """One denoise step of a 224-trained diffusion decoder on a 448 x 448
    sample, conditioned on a 28 x 28 token grid: the UViT test preset, and
    the UNet-P4 (its one preset, at full width)."""
    kw = dict(image_size=224, patch_size=16, enc_type="vit_t_enc", latent_dim=16,
              codebook_size=64, dec_type=dec_type)
    jm, variables, pm = _divae_pair(kw, 73)
    rng = np.random.RandomState(74)
    noised = rng.randn(B, 448, 448, 3).astype(np.float32)
    tokens = rng.randint(0, 64, (B, 28, 28))
    t = [500, 20][:B]
    quant = jm.apply(variables, jnp.asarray(tokens), method="tokens_to_embedding")
    ref = jm.apply(variables, jnp.asarray(noised), jnp.asarray(t), quant, method="denoise_step")
    with torch.no_grad():
        got = pm.denoise_step(_t(noised), _t(t), pm.tokens_to_embedding(_t(tokens)))
    assert got.shape == (B, 448, 448, 3)
    _close(got, ref)


# ------------------------------------------------------------ the sampler API

@pytest.fixture(scope="module")
def chain_pair():
    """A base model (rgb@224 + tok_rgb@224 -> tok_depth@224) and an SR model,
    both GELU tiny, and a tok_rgb tokenizer that decodes at 448."""
    _, base = _pair(FLAVORS[0], BASE_MODS, ("tok_depth@224",), 8)
    _, sr = _pair(FLAVORS[0], SR_ENC, SR_DEC, 9)
    return base, sr, {"tok_rgb": tdec.TokenizerBundle(_vqvae_448(16384)[2])}


def _sample(B=2):
    rng = np.random.RandomState(75)
    return {"rgb@224": rng.rand(B, 224, 224, 3).astype(np.float32),
            "tok_rgb@224": rng.randint(0, 16384, (B, 196)).astype(np.int32)}


def _same(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_call_perform_sr_equals_the_steps_by_hand(chain_pair):
    base, sr, toks = chain_pair
    sampler = api.FourMSampler(base, fm_sr=sr, tokenizers=toks, device="cpu")
    conds, targets = ["rgb@224", "tok_rgb@224"], ["tok_depth@224"]
    got = sampler(_sample(), conds, targets, seed=3, batch_size=2, decoding_steps=2,
                  perform_sr=True)
    md = sampler.prepare_sample(_sample(), conds, targets, batch_size=2)
    out = sampler.generate(md, sampler.build_schedule(conds, targets), seed=3)
    out = sampler.super_resolve(out, seed=3)
    assert list(out) == conds + ["tok_depth@224"] + SR_TARGETS
    want = sampler.decode(out, decoding_steps=2, seed=3, keys=list(out))
    _same(got, want)
    assert got["tok_rgb@448"].shape == (2, 448, 448, 3)  # decoded at 448
    assert "tok_depth@448" not in got  # no tokenizer for it


def test_call_perform_sr_without_fm_sr_decodes_every_key(chain_pair):
    base, _, toks = chain_pair
    sampler = api.FourMSampler(base, tokenizers=toks, device="cpu")
    assert sampler.sampler_sr is None
    conds, targets = ["rgb@224", "tok_rgb@224"], ["tok_depth@224"]
    got = sampler(_sample(), conds, targets, seed=4, batch_size=2, perform_sr=True)
    md = sampler.prepare_sample(_sample(), conds, targets, batch_size=2)
    out = sampler.generate(md, sampler.build_schedule(conds, targets), seed=4)
    _same(got, sampler.decode(out, seed=4, keys=list(out)))
    assert set(got) == {"rgb@224", "tok_rgb@224"}  # tok_depth has no tokenizer
    with pytest.raises(AttributeError, match="fm_sr"):
        sampler.super_resolve(out)
