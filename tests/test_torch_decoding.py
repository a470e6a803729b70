"""Token decoding in the port (fourm_torch: VQVAE / DiVAE decoders,
build_mlp, ViTDecoder, utils.decoding.decode_dict, FourMSampler.decode and
__call__, the decoder weight bridge, the colormaps) against the JAX package
(fourm_tpu) on the CPU, in fp32, with every JAX leaf redrawn from a seeded
generator (tests/_jax_leaves.py) before the bridge.

Tolerances: the MLP and ViT decoders to 1e-4 of the output's magnitude
plus 1e-5 (summation orders differ); decode_dict's diffusion images,
given the JAX package's noise, likewise; its text, metadata, box and
palette outputs exactly; the SAM instance images with at most 4 pixels
differing, those whose bicubic mask value may lie within rounding of the
0.5 threshold (cv2's resize computes its coefficients in fp32, torch's in
fp64; the resize itself to 1e-6 of cv2's; no pixel differs at the test's
seed); the pose drawings exactly (both draw with cv2 from integer pixel
coordinates); the colormaps exactly against matplotlib."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_leaves import init_variables
from fourm_tpu.utils import decoding as jdec
from fourm_tpu.utils.checkpoint import export_vq_torch_state
from fourm_tpu.vq import DiVAE as JaxDiVAE
from fourm_tpu.vq import VQVAE as JaxVQVAE
from fourm_tpu.vq.mlp_models import build_mlp as jax_build_mlp
from fourm_tpu.vq.vit_models import ViTDecoder as JaxViTDecoder
from fourm_torch import api
from fourm_torch.utils import decoding as tdec
from fourm_torch.utils.checkpoint import from_jax_vq_variables
from fourm_torch.utils.colormaps import TABLES, colormap
from fourm_torch.vq import DiVAE, VQVAE, ViTDecoder, build_mlp
from fourm_torch.vq import scheduling as tsched


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rel=1e-4):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, dtype=np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, atol=rel * float(np.abs(ref).max()) + 1e-5, rtol=0)


def _load(port_module, params):
    port_module.load_state_dict(from_jax_vq_variables({"params": params}), strict=True)
    return port_module.eval()


# ------------------------------------------------------------------- modules

@pytest.mark.parametrize("model_id", ["BottleneckMLP/B_2-Wi_32", "MLP/B_3-Wi_24",
                                      "BottleneckMLP/B_1-Wi_16-X_2"])
def test_build_mlp_matches_jax(model_id):
    rng = np.random.RandomState(30)
    x4 = rng.randn(2, 3, 3, 20).astype(np.float32)
    jm, thin = jax_build_mlp(model_id, dim_out=7)
    params = init_variables(jm, 31, jnp.asarray(x4))["params"]
    pm, pthin = build_mlp(model_id, 20, 7)
    assert pthin == thin
    _load(pm, params)
    for x in (x4, x4[:, 0]):
        with torch.no_grad():
            _close(pm(_t(x)), jm.apply({"params": params}, jnp.asarray(x)))


VIT_DEC_CASES = {  # (kwargs, input grid)
    "patch_proj": (dict(out_channels=3, patch_size=4, resolution=16), 4),
    "post_mlp_out_conv": (dict(out_channels=5, patch_size=4, resolution=16, post_mlp=True,
                               out_conv=True), 4),
    "feature_map_resized_pos": (dict(out_channels=12, patch_size=16, resolution=64,
                                     patch_proj=False, post_mlp=True), 5),
}


@pytest.mark.parametrize("case", sorted(VIT_DEC_CASES))
def test_vit_decoder_matches_jax(case):
    kw, n = VIT_DEC_CASES[case]
    kw = dict(kw, dim_tokens=64, depth=2, num_heads=2)
    x = np.random.RandomState(32).randn(2, n, n, 64).astype(np.float32)
    jm = JaxViTDecoder(**kw)
    params = init_variables(jm, 33, jnp.asarray(x))["params"]
    pm = _load(ViTDecoder(**kw), params)
    with torch.no_grad():
        _close(pm(_t(x)), jm.apply({"params": params}, jnp.asarray(x)))


TINY_VQ = dict(image_size=32, patch_size=4, enc_type="vit_t_enc", latent_dim=16,
               codebook_size=64)
VQVAE_CASES = {
    "vit": dict(TINY_VQ, dec_type="vit_t_dec", post_mlp=True, out_conv=True),
    "semseg": dict(TINY_VQ, dec_type="vit_t_dec", n_labels=7),
    "mlp": dict(image_size=32, n_channels=27, enc_type="BottleneckMLP/B_2-Wi_32",
                dec_type="BottleneckMLP/B_2-Wi_32", latent_dim=16, codebook_size=64),
}


def _vqvae_input(case):
    rng = np.random.RandomState(34)
    if case == "semseg":
        return rng.randint(0, 7, (2, 32, 32)).astype(np.int32)
    if case == "mlp":
        return rng.randn(2, 8, 1, 27).astype(np.float32)
    return rng.randn(2, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(VQVAE_CASES))
def vqvae_pair(request):
    kw = VQVAE_CASES[request.param]
    x = _vqvae_input(request.param)
    jm = JaxVQVAE(**kw)
    variables = init_variables(jm, 35, jnp.asarray(x))
    pm = VQVAE(**kw, device="cpu")
    pm.load_state_dict(from_jax_vq_variables(variables), strict=True)
    return request.param, jm, variables, pm, x


def test_vqvae_decode_matches_jax(vqvae_pair):
    _, jm, variables, pm, x = vqvae_pair
    tokens = np.asarray(jm.apply(variables, jnp.asarray(x), method="tokenize"))
    ref = jm.apply(variables, jnp.asarray(tokens), method="decode_tokens")
    _close(pm.decode_tokens(_t(tokens)), ref)
    _close(pm.autoencode(_t(x)), jm.apply(variables, jnp.asarray(x), method="autoencode"))


def test_vqvae_bridge_keys_match_export(vqvae_pair):
    _, _, variables, pm, _ = vqvae_pair
    ours, ref = from_jax_vq_variables(variables), export_vq_torch_state(variables)
    training_state = {k for k in ref if k.endswith(("embed_avg", "cluster_size", "initted"))}
    assert set(ours) == set(ref) - training_state == set(pm.state_dict())
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[k])


def _divae_init(kw, seed):
    x = np.random.RandomState(36).rand(1, kw["image_size"], kw["image_size"], 3)
    x = jnp.asarray(x.astype(np.float32) * 2 - 1)
    jm = JaxDiVAE(**kw)
    return jm, init_variables(jm, seed, x, x, jnp.asarray([3]))


TINY_DIVAE = dict(TINY_VQ, image_size=64, patch_size=16, dec_type="uvit_t_p4_f16")


def test_divae_uvit_bridge_and_denoise_step():
    jm, variables = _divae_init(TINY_DIVAE, 37)
    pm = DiVAE(**TINY_DIVAE, device="cpu")
    pm.load_state_dict(from_jax_vq_variables(variables), strict=True)
    ref_keys = {k for k in export_vq_torch_state(variables)
                if not k.endswith(("embed_avg", "cluster_size", "initted"))}
    assert set(pm.state_dict()) == ref_keys
    rng = np.random.RandomState(38)
    noised = rng.randn(2, 64, 64, 3).astype(np.float32)
    tokens = rng.randint(0, 64, (2, 4, 4))
    quant = np.asarray(jm.apply(variables, jnp.asarray(tokens), method="tokens_to_embedding"))
    ref = jm.apply(variables, jnp.asarray(noised), jnp.asarray([10, 700]), jnp.asarray(quant),
                   method="denoise_step")
    with torch.no_grad():
        _close(pm.denoise_step(_t(noised), _t([10, 700]), pm.tokens_to_embedding(_t(tokens))),
               ref)


def test_divae_unet_bridge_full_width():
    """The released configuration's decoder (unet_patched, 256 channels):
    every leaf drawn, loaded strictly, names equal to
    export_vq_torch_state's."""
    kw = dict(TINY_VQ, image_size=32, patch_size=4, dec_type="unet_patched")
    jm = JaxDiVAE(**kw)
    x = jnp.zeros((1, 32, 32, 3))
    variables = init_variables(jm, 39, x, x, jnp.asarray([3]))
    state = from_jax_vq_variables(variables)
    ref = {k for k in export_vq_torch_state(variables)
           if not k.endswith(("embed_avg", "cluster_size", "initted"))}
    assert set(state) == ref
    pm = DiVAE(**kw, device="cpu")
    pm.load_state_dict(state, strict=True)
    unet = variables["params"]["decoder"]["unet"]
    w = unet["up_blocks" if "up_blocks" in unet else "up_3_upsample"]["kernel"]
    np.testing.assert_array_equal(pm.decoder.unet.up_blocks["3"]["upsamplers"][0].weight.numpy(),
                                  np.transpose(w, (3, 2, 0, 1)))


def test_bf16_decoder_after_load():
    """A bf16 tokenizer keeps its norm scales and biases in fp32 after
    load_state_dict (the forward's LayerNorm / GroupNorm take them in fp32);
    a whole decoder moved to bf16 by .to() still runs, its norm parameters
    widened in the forward, close to the fp32 run."""
    jm, variables = _divae_init(TINY_DIVAE, 40)
    bf = DiVAE(**TINY_DIVAE, dtype="bfloat16", device="cpu")
    bf.load_state_dict(from_jax_vq_variables(variables), strict=True)
    dec = bf.decoder
    assert dec.conv_in.weight.dtype == torch.bfloat16
    assert dec.conv_norm_out.weight.dtype == torch.float32
    assert dec.mid_block.mid_block[0].norm1.weight.dtype == torch.float32
    f32 = DiVAE(**TINY_DIVAE, device="cpu")
    f32.load_state_dict(from_jax_vq_variables(variables), strict=True)
    rng = np.random.RandomState(41)
    args = (_t(rng.randn(2, 64, 64, 3).astype(np.float32)), _t([10, 700]),
            f32.tokens_to_embedding(_t(rng.randint(0, 64, (2, 4, 4)))))
    with torch.no_grad():
        ref = f32.denoise_step(*args)
        out = bf.denoise_step(*args)
        f32.decoder.to(torch.bfloat16)
        assert f32.decoder.conv_norm_out.weight.dtype == torch.bfloat16
        widened = f32.denoise_step(*args)
    assert out.dtype == torch.bfloat16
    for o in (out, widened):
        err = (o.float() - ref).abs().max().item()
        assert err < 0.05 * ref.abs().max().item(), err


# --------------------------------------------------------------- decode_dict

WORDS = ["a", "cat", "dog", "photo", "of", "person", "point", "polygon", "none", "camera",
         "shape", "global", "pose", "bbox", "bicycle", "red"]


class WordTokenizer:
    """A word-level stand-in for the text tokenizer: [PAD] [UNK] [SOS] [EOS],
    20 sentinels, some words, then v0=0..999 to v3=0..999."""

    def __init__(self):
        self.vocab = (["[PAD]", "[UNK]", "[SOS]", "[EOS]"] + [f"[S_{i}]" for i in range(20)]
                      + WORDS + [f"v{a}={i}" for a in range(4) for i in range(1000)])
        self.ids = {w: i for i, w in enumerate(self.vocab)}

    def get_vocab(self):
        return dict(self.ids)

    def token_to_id(self, token):
        return self.ids.get(token)

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(self.vocab[i] for i in ids)


def _seq_entry(tok, rows, length):
    """A generated sequence target: each row [S_0] (input), then [S_0] and
    the row's words, [EOS] (target), then [PAD]."""
    B = len(rows)
    tensor = np.zeros((B, length), np.int64)
    input_mask = np.ones((B, length), bool)
    target_mask = np.ones((B, length), bool)
    s0, eos = tok.ids["[S_0]"], tok.ids["[EOS]"]
    for b, words in enumerate(rows):
        ids = [s0, s0] + [tok.ids[w] for w in words.split()] + [eos]
        tensor[b, :len(ids)] = ids
        input_mask[b, 0] = False
        target_mask[b, 1:len(ids)] = False
    return {"tensor": tensor, "input_mask": input_mask, "target_mask": target_mask}


def _pose_string(rng):
    w = ["bbox"] + [f"v0={v}" for v in rng.randint(100, 900, 4)]
    w += ["camera"] + [f"v0={v}" for v in rng.randint(40, 60, 3)]
    w += ["shape"] + [f"v0={v}" for v in rng.randint(0, 999, 10)]
    w += ["global"] + [f"v0={v}" for v in rng.randint(0, 999, 9)]
    w += ["pose"] + [f"v{rng.randint(2)}={v}" for v in rng.randint(0, 512, 8)]
    assert len(w) == 39
    return " ".join(w)


def _sam_string(rng, n):
    parts = []
    for _ in range(n):
        x0, y0 = rng.randint(0, 30, 2)
        bbox = [x0, y0, x0 + rng.randint(5, 34), y0 + rng.randint(5, 34)]
        toks = [f"v{rng.randint(2)}={v}" for v in rng.randint(0, 512, 16)]
        parts += ["point", f"v0={rng.randint(64)}", f"v1={rng.randint(64)}", "polygon"]
        parts += [f"v0={v}" for v in bbox] + toks
    return " ".join(parts)


def _mod_dict(tok, B=2):
    rng = np.random.RandomState(42)
    md = {"rgb@64": {"tensor": rng.randn(B, 64, 64, 3).astype(np.float32)}}
    for k, vocab, n in (("tok_clip@64", 64, 4), ("tok_dinov2@64", 64, 4),
                        ("tok_depth@64", 64, 4), ("tok_normal@64", 64, 4),
                        ("tok_canny_edge@64", 64, 4), ("tok_semseg@64", 64, 4),
                        ("tok_dinov2_global", 64, 4)):
        md[k] = {"tensor": rng.randint(0, vocab, (B, n * n)),
                 "input_mask": np.zeros((B, n * n), bool), "target_mask": np.ones((B, n * n), bool)}
    md["caption"] = _seq_entry(tok, ["a photo of a cat", "red dog"][:B], 24)
    md["det"] = _seq_entry(tok, ["v0=10 v1=20 v2=500 v3=900 cat v0=1 v1=2 v2=3 v3=4 red dog",
                                 "v0=999 v1=0 v2=5 v3=7 person"][:B], 24)
    md["metadata"] = _seq_entry(tok, ["v1=0 v0=20 v1=9 v0=25 v1=14 v0=7 v1=2 v0=300",
                                      "v1=1 v0=14 v1=19 v0=1 v1=30 v0=3"][:B], 24)
    md["color_palette"] = _seq_entry(tok, ["v1=2 v0=255 v0=10 v0=0 v0=3 v0=200 v0=90",
                                           "v1=0"][:B], 24)
    md["human_poses"] = _seq_entry(tok, [_pose_string(rng) + " " + _pose_string(rng),
                                         _pose_string(rng)][:B], 96)
    md["sam_instance"] = _seq_entry(tok, [_sam_string(rng, 3), _sam_string(rng, 2)][:B], 96)
    return md


class _JaxBundle(jdec.TokenizerBundle):
    """fourm_tpu's TokenizerBundle with its rng passed through:
    `rng or jax.random.key(0)` (fourm_tpu/utils/decoding.py:46) raises on a
    key array, so the JAX decode_dict cannot run a diffusion decoder as it
    stands."""

    def decode_tokens(self, tokens, timesteps=None, image_size=None, rng=None):
        if not self.is_diffusion:
            return super().decode_tokens(tokens)
        from fourm_tpu.vq.vqvae import divae_decode_tokens

        return divae_decode_tokens(self.model, self.variables, tokens, rng,
                                   timesteps=timesteps, image_size=image_size)


def _jax_tokenizers():
    """Tiny tokenizers of every kind decode_dict reads, JAX modules with
    redrawn leaves: (JAX bundles, port bundles)."""
    vit = dict(TINY_VQ, image_size=64, patch_size=16, dec_type="vit_t_dec")
    specs = {
        "tok_clip": (JaxVQVAE, VQVAE, dict(vit, n_channels=12, patch_proj=False, post_mlp=True),
                     (1, 4, 4, 12)),
        "tok_dinov2": (JaxVQVAE, VQVAE, dict(vit, n_channels=10, patch_proj=False),
                       (1, 4, 4, 10)),
        "tok_semseg": (JaxVQVAE, VQVAE, dict(vit, n_labels=6), None),
        "tok_dinov2_global": (JaxVQVAE, VQVAE, dict(
            image_size=64, n_channels=20, enc_type="BottleneckMLP/B_1-Wi_16",
            dec_type="BottleneckMLP/B_1-Wi_16", latent_dim=16, codebook_size=64),
            (1, 1, 1, 20)),
        "human_poses": (JaxVQVAE, VQVAE, dict(
            image_size=64, n_channels=207, enc_type="BottleneckMLP/B_1-Wi_32",
            dec_type="BottleneckMLP/B_1-Wi_32", latent_dim=16, codebook_size=1024),
            (1, 8, 1, 207)),
        "sam_instance": (JaxVQVAE, VQVAE, dict(TINY_VQ, image_size=32, patch_size=8,
                                               n_channels=1, dec_type="vit_t_dec",
                                               codebook_size=1024, post_mlp=True),
                         (1, 32, 32, 1)),
        "tok_depth": (JaxDiVAE, DiVAE, dict(TINY_DIVAE, prediction_type="sample",
                                            beta_schedule="linear", zero_terminal_snr=False),
                      None),
        "tok_normal": (JaxDiVAE, DiVAE, dict(TINY_DIVAE), None),
        "tok_canny_edge": (JaxDiVAE, DiVAE, dict(TINY_DIVAE, conditioning="xattn"), None),
    }
    jb, tb = {}, {}
    for i, (k, (jcls, tcls, kw, shape)) in enumerate(specs.items()):
        if jcls is JaxDiVAE:
            jm, variables = _divae_init(kw, 50 + i)
        else:
            if shape is None:  # class map
                x = jnp.zeros((1, kw["image_size"], kw["image_size"]), jnp.int32)
            else:
                x = jnp.zeros(shape)
            jm = jcls(**kw)
            variables = init_variables(jm, 50 + i, x)
        pm = tcls(**kw, device="cpu")
        pm.load_state_dict(from_jax_vq_variables(variables), strict=True)
        jb[k] = _JaxBundle(jm, variables)
        tb[k] = tdec.TokenizerBundle(pm)
    return jb, tb


@pytest.fixture(scope="module")
def decoded():
    tok = WordTokenizer()
    md = _mod_dict(tok)
    jb, tb = _jax_tokenizers()
    steps, seed = 4, 3
    ref = jdec.decode_dict({k: dict(v) for k, v in md.items()}, jb, tok, image_size=64,
                           decoding_steps=steps, seed=seed)
    # the port's loops draw, key after key in mod_dict order, what the JAX
    # package draws there: repeat its key splits, hand the draws over
    draws = []
    key = jax.random.key(seed)
    for k in md:
        kk = k.split("@")[0]
        if kk not in ("tok_depth", "tok_normal", "tok_canny_edge"):
            continue
        key, r = jax.random.split(key)
        t = max(steps // 2, 1) if kk == "tok_canny_edge" else steps
        n = len(tsched.spaced_timesteps(1000, t, "trailing"))
        r, r0 = jax.random.split(r)
        shape = (2, 64, 64, 3)
        draws.append(np.asarray(jax.random.normal(r0, shape, jnp.float32)))
        for _ in range(n):
            r, rs = jax.random.split(r)
            draws.append(np.asarray(jax.random.normal(rs, shape, jnp.float32)))
    queue = list(reversed(draws))

    def handed_over(shape, generator, device):
        d = queue.pop()
        assert tuple(d.shape) == tuple(shape)
        return _t(d).to(device)

    orig = tsched._randn
    tsched._randn = handed_over
    try:
        sampler = api.FourMSampler.__new__(api.FourMSampler)  # decode needs no model
        sampler.tokenizers, sampler.text_tokenizer = tb, tok
        port = sampler.decode(md, image_size=64, decoding_steps=steps, seed=seed)
    finally:
        tsched._randn = orig
    assert not queue
    return md, jb, tb, tok, ref, port


def test_decode_dict_keys_and_text_exact(decoded):
    md, _, _, _, ref, port = decoded
    assert list(port) == list(ref) == list(md)
    for k in ("caption", "det"):
        assert port[k] == ref[k]
    assert port["metadata"] == ref["metadata"]
    assert port["metadata"][0]["original_width"] == 20 * 32
    np.testing.assert_array_equal(port["color_palette"], ref["color_palette"])
    np.testing.assert_array_equal(port["rgb@64"], ref["rgb@64"])
    box = tdec.convert_string_to_bboxes(port["det"][0])
    assert box == jdec.convert_string_to_bboxes(ref["det"][0]) and len(box) == 2


def test_decode_dict_images_match_jax(decoded):
    _, _, _, _, ref, port = decoded
    for k in ("tok_clip@64", "tok_dinov2@64", "tok_dinov2_global", "tok_normal@64",
              "tok_canny_edge@64"):
        _close(port[k], ref[k])
    # depth and semseg through the colormaps: equal where the normalised
    # value is not within the decoders' error of a colormap bin edge
    for k in ("tok_depth@64", "tok_semseg@64"):
        differ = np.abs(port[k] - np.asarray(ref[k])).max(-1) > 0
        assert differ.mean() < 0.01, (k, differ.mean())
    assert port["tok_depth@64"].shape == (2, 64, 64, 3)


def test_decode_sam_instances_matches_cv2_path(decoded):
    md, jb, tb, tok, ref, port = decoded
    a, b = port["sam_instance"], np.asarray(ref["sam_instance"])
    assert a.shape == b.shape == (2, 64, 64, 3) and a.dtype == np.uint8
    assert b.any()
    differ = (a != b).any(-1)
    # pixels on the threshold: cv2's fp32 coefficients against torch's fp64
    assert differ.sum() <= 4, int(differ.sum())


def test_sam_resize_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(43)
    for h, w, oh, ow in ((16, 16, 37, 21), (16, 16, 5, 9), (8, 12, 64, 64)):
        m = rng.rand(h, w)
        ref = cv2.resize(m, (ow, oh), interpolation=cv2.INTER_CUBIC)
        np.testing.assert_allclose(tdec.resize_bicubic(m, ow, oh), ref, atol=1e-6, rtol=0)


def test_visualize_human_poses_matches_jax(decoded):
    md, jb, tb, tok, ref, port = decoded
    np.testing.assert_array_equal(port["human_poses"], np.asarray(ref["human_poses"]))
    assert port["human_poses"].shape == (2, 64, 64, 3) and port["human_poses"].max() > 0


def test_colormaps_equal_matplotlib():
    plt = pytest.importorskip("matplotlib.pyplot")
    edges = np.arange(257) / 256.0
    x = np.concatenate([edges, np.nextafter(edges, 2), np.nextafter(edges, -1),
                        np.linspace(-0.5, 1.5, 1001), [np.nan, np.inf, -np.inf]])
    for name in ("turbo", "viridis"):
        assert TABLES[name].shape == (256, 3)
        for xs in (x, x.astype(np.float32)):
            np.testing.assert_array_equal(colormap(xs, name), plt.get_cmap(name)(xs)[..., :3])


def test_sampler_call_and_sr_raise(decoded):
    """Without an SR model, super_resolve fails as the JAX package's does (no
    sampler_sr) and __call__(perform_sr=True) skips the super-resolution
    and decodes every key of the generated dict; decode(keys=...) decodes
    those keys alone."""
    md, _, tb, tok, _, _ = decoded
    sampler = api.FourMSampler.__new__(api.FourMSampler)  # decode needs no model
    sampler.tokenizers, sampler.text_tokenizer, sampler.sampler_sr = tb, tok, None
    with pytest.raises(AttributeError, match="fm_sr"):
        sampler.super_resolve(md)
    keys = ["rgb@64", "tok_clip@64", "caption", "metadata"]
    generated = {k: md[k] for k in keys}
    sampler.prepare_sample = lambda sample, conds, targets, batch_size: dict(sample)
    sampler.build_schedule = lambda conds, targets: []
    sampler.generate = lambda mod_dict, schedule, seed=None: mod_dict
    out = sampler(generated, ["rgb@64"], ["caption"], seed=1, perform_sr=True)
    assert list(out) == keys
    want = sampler.decode(generated, seed=1)
    for k in keys:
        np.testing.assert_array_equal(np.asarray(out[k], dtype=object),
                                      np.asarray(want[k], dtype=object))
    assert list(sampler(generated, ["rgb@64"], ["caption"], seed=1)) == ["caption"]
    sub = sampler.decode(md, image_size=64, keys=["caption", "metadata"])
    assert list(sub) == ["caption", "metadata"]


def test_init_vq_weights_draws_the_zero_initialised_layers():
    """Seeded random weights for a decoder: the same seed gives the same
    weights; with spread, every vector is drawn (norm scales around 1), and
    the layers JAX initialises to zero are not zero, so the output is not."""
    from fourm_torch.vq import init_vq_weights

    a = init_vq_weights(DiVAE(**TINY_DIVAE, device="cpu"), 3, spread=0.1)
    b = init_vq_weights(DiVAE(**TINY_DIVAE, device="cpu"), 3, spread=0.1)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert p.abs().max() > 0, name
    mid = a.decoder.mid_block
    assert mid.mask_token.std() > 0.05
    assert abs(mid.mid_block[0].norm1.weight.mean().item() - 1.0) < 0.05
    plain = init_vq_weights(DiVAE(**TINY_DIVAE, device="cpu"), 3)
    assert plain.decoder.conv_norm_out.weight.eq(1).all()
    assert plain.decoder.conv_norm_out.bias.eq(0).all()
    q = a.tokens_to_embedding(torch.randint(0, 64, (1, 4, 4)))
    with torch.no_grad():
        assert a.denoise_step(torch.randn(1, 64, 64, 3), 500, q).abs().max() > 0
