"""VQ tokenization in the port (fourm_torch) against the JAX package
(fourm_tpu) on the CPU: the plain twins of the attn_block, mha_short and
codebook-search kernels against the Pallas kernels run with interpret=True,
and VQ / ViTTeacher against the JAX modules (XLA path) with the same weights
carried over by the weight bridge.

Tolerances: the attention twins in fp32 to atol 2e-5 (as
tests/test_kernels.py holds pallas_attn_block to the unfused math; only
summation orders differ), in bf16 to two bf16 ulps of the largest value
(both sides round the same fp32 sums, summed in other orders); the codebook
searches exactly (index for index) at the tests' seeds; the encoder latents
and teacher features to atol 1e-4 in fp32; tokens exactly, with the number
of rows whose fp32 top-2 gap lies within the latents' error counted and
asserted to be 0 at the seed (so the exact match is not luck)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.kernels.attention import pallas_attn_block, pallas_mha_short
from fourm_tpu.kernels.vq_codebook import pallas_nearest_code, pallas_nearest_code_cosine
from fourm_tpu.utils.checkpoint import export_vq_torch_state
from fourm_tpu.vq import VQ as JaxVQ
from fourm_tpu.vq.quantizer import euclidean_distance_logits
from fourm_tpu.vq.quantizer import l2norm as jax_l2norm
from fourm_tpu.vq.teachers import TEACHER_PRESETS as JAX_PRESETS
from fourm_tpu.vq.teachers import ViTTeacher as JaxTeacher
from fourm_torch.kernels import attention as at
from fourm_torch.kernels.vq_codebook import (
    nearest_code,
    nearest_code_cosine,
    nearest_code_plain,
)
from fourm_torch.ops import transformer as tt
from fourm_torch.utils.checkpoint import from_jax_teacher_params, from_jax_vq_variables
from fourm_torch.vq import TEACHER_PRESETS, VQ, ViTTeacher, l2norm

NEG = np.finfo(np.float32).min
TINY = dict(image_size=32, patch_size=4, enc_type="vit_t_enc", latent_dim=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _attn_inputs(rng, B, N, C, key_bias, biases):
    x = rng.randn(B, N, C).astype(np.float32)
    gamma = (rng.rand(C) + 0.5).astype(np.float32)
    beta = (rng.randn(C) * 0.1).astype(np.float32) if biases else None
    wq = (rng.randn(C, 3 * C) * C ** -0.5).astype(np.float32)  # JAX layout (in, out)
    bq = (rng.randn(3 * C) * 0.1).astype(np.float32) if biases else None
    wp = (rng.randn(C, C) * C ** -0.5).astype(np.float32)
    bp = (rng.randn(C) * 0.1).astype(np.float32) if biases else None
    bias = None
    if key_bias:
        mask = rng.rand(B, N) > 0.6
        mask[-1] = True  # the last image: every key masked -> uniform weights
        bias = np.where(mask, NEG, 0.0).astype(np.float32)
    return x, gamma, beta, wq, bq, wp, bp, bias


def _bf16_tol(ref):
    return 2.0 ** -6 * float(np.abs(ref).max())


ATTN_CASES = [(False, False, True), (True, False, True), (True, True, False), (False, True, False)]


@pytest.mark.parametrize("key_bias,zero_attn,biases", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_block_twin(dtype, key_bias, zero_attn, biases):
    rng = np.random.RandomState(10)
    B, N, H, Dh = 3, 40, 4, 16
    x, gamma, beta, wq, bq, wp, bp, bias = _attn_inputs(rng, B, N, H * Dh, key_bias, biases)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    ref = pallas_attn_block(j(x).astype(jdt), j(gamma), j(beta), j(wq).astype(jdt), j(bq),
                            j(wp).astype(jdt), j(bp), H, j(bias), allow_zero_attn=zero_attn,
                            interpret=True)
    port = at.attn_block(_t(x).to(tdt), _t(gamma), t(beta), _t(wq.T.copy()).to(tdt), t(bq),
                         _t(wp.T.copy()).to(tdt), t(bp), H, t(bias), allow_zero_attn=zero_attn)
    ref = np.asarray(ref.astype(jnp.float32))
    assert port.dtype == tdt and port.shape == (B, N, H * Dh)
    tol = 2e-5 if dtype == "float32" else _bf16_tol(ref)
    np.testing.assert_allclose(_np(port), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("key_bias,zero_attn", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_short_twin(dtype, key_bias, zero_attn):
    rng = np.random.RandomState(11)
    B, N, H, Dh = 3, 37, 4, 16
    qkv = rng.randn(B, N, 3 * H * Dh).astype(np.float32)
    bias = _attn_inputs(rng, B, N, 8, key_bias, False)[-1]
    jdt = jnp.dtype(dtype)
    ref = pallas_mha_short(jnp.asarray(qkv).astype(jdt), H,
                           None if bias is None else jnp.asarray(bias),
                           allow_zero_attn=zero_attn, interpret=True)
    port = at.mha_short(_t(qkv).to(getattr(torch, dtype)), H,
                        None if bias is None else _t(bias), zero_attn)
    ref = np.asarray(ref.astype(jnp.float32))
    tol = 2e-5 if dtype == "float32" else _bf16_tol(ref)
    np.testing.assert_allclose(_np(port), ref, atol=tol, rtol=0)
    assert not torch.isnan(port).any()


@pytest.mark.parametrize("N,K,D", [(300, 1000, 32), (1000, 1000, 32), (77, 333, 16)])
@pytest.mark.parametrize("cosine", [False, True])
def test_nearest_code_twin_exact(cosine, N, K, D):
    """Index for index against the Pallas kernel (ragged N and K against its
    blocks) and the XLA argmax."""
    rng = np.random.RandomState(12)
    x = jnp.asarray(rng.randn(N, D).astype(np.float32))
    e = jnp.asarray(rng.randn(K, D).astype(np.float32))
    if cosine:
        x, e = jax_l2norm(x), jax_l2norm(e)
        xla = jnp.argmax(jnp.dot(x, e.T, precision=jax.lax.Precision.HIGHEST), axis=-1)
        pallas = pallas_nearest_code_cosine(x, e, block_n=128, block_k=256, interpret=True)
        port = nearest_code_cosine(_t(x), _t(e))
    else:
        xla = jnp.argmax(euclidean_distance_logits(x, e), axis=-1)
        pallas = pallas_nearest_code(x, e, block_n=128, block_k=256, interpret=True)
        port = nearest_code(_t(x), _t(e))
    assert port.dtype == torch.int64 and port.shape == (N,)
    np.testing.assert_array_equal(port.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(port.numpy(), np.asarray(xla))


@pytest.mark.parametrize("cosine", [False, True])
def test_nearest_code_tie_break_first_index(cosine):
    """Duplicate codebook rows: the first occurrence wins (test_kernels.py:75-80)."""
    embed = np.tile(np.eye(8, dtype=np.float32), (4, 1))  # 32 rows, each code 4 times
    x = np.eye(8, dtype=np.float32)
    fn = nearest_code_cosine if cosine else nearest_code
    np.testing.assert_array_equal(fn(_t(x), _t(embed)).numpy(), np.arange(8))
    ref = pallas_nearest_code(jnp.asarray(x), jnp.asarray(embed), block_n=8, block_k=8,
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(ref), np.arange(8))


def test_nearest_code_twin_row_chunks():
    """At the tokenizer's codebook size the twin searches the rows in chunks
    of 2**24 // K: three chunks here, with the last one ragged. The indices
    equal the fp64 argmax wherever its top-2 gap clears fp32 rounding."""
    rng = np.random.RandomState(13)
    N, K, D = 2100, 16384, 8
    x = torch.from_numpy(rng.randn(N, D).astype(np.float32))
    e = torch.from_numpy(rng.randn(K, D).astype(np.float32))
    dist = -torch.cdist(x.double(), e.double()).square()
    top2 = dist.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * dist.abs().max()
    assert clear.float().mean() > 0.9
    got = nearest_code_plain(x, e)
    assert got.shape == (N,) and (2 ** 24 // K) * 2 < N
    assert torch.equal(got[clear], dist.argmax(-1)[clear])


# ------------------------------------------------------------------ modules

VQ_VARIANTS = {
    # RGB images with ImageNet standardisation undone, cosine codebook
    "rgb": (dict(n_channels=3, undo_std=True, codebook_size=512), (2, 32, 32, 3)),
    # a feature map through a 1x1 projection and the fp32 tanh post-MLP
    # (the CLIP / DINOv2 tokenizer shape)
    "post_mlp_1x1": (dict(n_channels=24, patch_proj=False, post_mlp=True, codebook_size=1000),
                     (2, 8, 8, 24)),
    # class maps through cls_emb, Euclidean codebook
    "class_map": (dict(n_channels=8, n_labels=5, norm_codes=False, codebook_size=64),
                  (2, 32, 32)),
    # two codebooks: project_in / project_out, Euclidean
    "heads2": (dict(n_channels=3, num_codebooks=2, norm_codes=False, codebook_size=64),
               (2, 32, 32, 3)),
}


def _vq_input(shape, seed):
    rng = np.random.RandomState(seed)
    if len(shape) == 3:
        return rng.randint(0, 5, shape).astype(np.int32)
    return rng.randn(*shape).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(VQ_VARIANTS))
def vq_pair(request):
    kw, shape = VQ_VARIANTS[request.param]
    kw = dict(TINY, **kw)
    jm = JaxVQ(**kw)
    x = _vq_input(shape, 20)
    variables = jm.init({"params": jax.random.key(8), "rng": jax.random.key(2)},
                        jnp.asarray(x[:1]))
    variables = jax.tree.map(np.asarray, variables)
    tm = VQ(**kw, device="cpu")
    tm.load_state_dict(from_jax_vq_variables(variables), strict=True)
    return request.param, jm, variables, tm, x


def _jax_latents(jm, variables, x):
    return np.asarray(jm.apply(variables, jnp.asarray(x),
                               method=lambda m, v: m.quant_proj(m.encoder(m.prepare_input(v)))))


def test_vq_weight_bridge_matches_export(vq_pair):
    _, _, variables, tm, _ = vq_pair
    ours = from_jax_vq_variables(variables)
    ref = export_vq_torch_state(variables)
    training_state = {k for k in ref if k.endswith(("embed_avg", "cluster_size", "initted"))}
    assert set(ours) == set(ref) - training_state
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[k])
    assert set(tm.state_dict()) == set(ours)


def _doubtful_rows(variables, cosine, lat_ref, lat_err):
    """Rows whose fp32 top-2 gap is within what the latents' error can move:
    a token there could flip without any fault."""
    flat, err = lat_ref.reshape(-1, lat_ref.shape[-1]), lat_err.reshape(-1, lat_ref.shape[-1])
    q = variables["params"].get("quantize", {})
    if "project_in" in q:  # the codebooks see project_in's output, split in heads
        w, b = q["project_in"]["kernel"], q["project_in"]["bias"]
        flat, err = flat @ w + b, np.abs(err) @ np.abs(w)
    embed = np.asarray(variables["codebook"]["quantize"]["embed"])
    flat, err = flat.reshape(-1, embed.shape[1]), err.reshape(-1, embed.shape[1])
    if cosine:
        dist = np.asarray(jax_l2norm(flat)) @ np.asarray(jax_l2norm(embed)).T
        move = 2 * np.linalg.norm(err, axis=-1) / np.linalg.norm(flat, axis=-1)
    else:  # ||x||^2 is common to a row: a gap moves by 2 dx.(e1 - e2) at most
        dist = np.asarray(euclidean_distance_logits(flat, embed))
        move = 4 * np.linalg.norm(err, axis=-1) * np.linalg.norm(embed, axis=-1).max()
    top2 = np.sort(dist, axis=-1)[:, -2:]
    rounding = 4 * flat.shape[1] * np.finfo(np.float32).eps * np.abs(dist).max()
    return int(((top2[:, 1] - top2[:, 0]) <= 2 * move + rounding).sum())


def test_vq_encode_matches_jax(vq_pair):
    variant, jm, variables, tm, x = vq_pair
    lat_ref = _jax_latents(jm, variables, x)
    lat = _np(tm.latents(_t(x)))
    np.testing.assert_allclose(lat, lat_ref, atol=1e-4, rtol=0)
    quant_ref, _, tokens_ref = jm.apply(variables, jnp.asarray(x), method="encode")
    quant, loss, tokens = tm.encode(_t(x))
    assert float(loss) == 0.0
    assert tuple(tokens.shape) == np.asarray(tokens_ref).shape
    cosine = VQ_VARIANTS[variant][0].get("norm_codes", True)
    assert _doubtful_rows(variables, cosine, lat_ref,
                          np.full_like(lat_ref, np.abs(lat - lat_ref).max())) == 0
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(tokens_ref))
    np.testing.assert_allclose(_np(quant), np.asarray(quant_ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm.tokenize(_t(x)).numpy(), tokens.numpy())
    emb = tm.tokens_to_embedding(tokens)
    emb_ref = jm.apply(variables, jnp.asarray(tokens_ref), method="tokens_to_embedding")
    np.testing.assert_allclose(_np(emb), np.asarray(emb_ref), atol=1e-5, rtol=0)
    if variant != "heads2":  # one codebook: the quantized latents are the looked-up codes
        np.testing.assert_allclose(_np(emb), _np(quant), atol=1e-6, rtol=0)


def test_vq_bf16_on_cpu_tracks_fp32(vq_pair):
    """The bf16 compute path (what the card runs, here through the twins)
    stays near the fp32 latents."""
    variant, _, variables, tm, x = vq_pair
    kw = dict(TINY, **VQ_VARIANTS[variant][0])
    bf = VQ(**kw, dtype="bfloat16", device="cpu")
    bf.load_state_dict(from_jax_vq_variables(variables), strict=True)
    assert bf.quantize.codebook.dtype == torch.float32
    assert bf.encoder.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert bf.encoder.blocks[0].norm1.weight.dtype == torch.float32
    lat32, lat16 = tm.latents(_t(x)), bf.latents(_t(x))
    assert lat16.dtype == torch.bfloat16
    err = (lat16.float() - lat32).abs().max().item()
    assert err < 0.05 * lat32.abs().max().item() + 0.05
    assert bf.tokenize(_t(x)).shape == tm.tokenize(_t(x)).shape


@pytest.mark.parametrize("task", ["CLIP-B16", "DINOv2-B14", "DINOv2-B14-global"])
def test_teacher_matches_jax(task):
    """The preset's geometry (patch size, 224 input, activation, ln_pre,
    layer scale, output projection) at a tiny width and depth."""
    assert TEACHER_PRESETS[task] == JAX_PRESETS[task]
    kw = dict(TEACHER_PRESETS[task], width=64, depth=2, num_heads=2)
    if kw.get("output_dim"):
        kw["output_dim"] = 24
    x = np.random.RandomState(21).rand(2, 224, 224, 3).astype(np.float32)
    jm = JaxTeacher(**kw)
    variables = jm.init(jax.random.key(3), jnp.asarray(x[:1]))
    params = jax.tree.map(np.asarray, variables)["params"]
    tm = ViTTeacher(**kw, device="cpu")
    tm.load_state_dict(from_jax_teacher_params(params), strict=True)
    is_global = task.endswith("-global")
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), return_global=is_global))
    out = tm(_t(x), return_global=is_global)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), ref, atol=1e-4, rtol=0)


def test_block_routing(monkeypatch):
    """Which kernel wrapper each attention half runs: attn_block for a short
    unnormed sequence under a key-only mask, ln_matmul + mha_short where the
    device's attn_block does not hold N (the twin holds any N; the card's
    kernel says for itself, as phase 2 of chip_smoke.py checks),
    ln_matmul + flash_mha with QK-norm or past N = 1024, `attention` under a
    query-dependent mask; Attention.forward takes mha_short on the short
    cases."""
    calls = []
    for name in ("attn_block", "mha_short", "flash_mha", "ln_matmul", "attention"):
        fn = getattr(tt, name)
        monkeypatch.setattr(tt, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n)
                            or _fn(*a, **k))

    def ran(block, x, mask=None):
        calls.clear()
        block(x, mask)
        return calls

    torch.manual_seed(0)
    plain = tt.Block(64, 4).eval()
    normed = tt.Block(64, 4, qk_norm=True).eval()
    x = torch.randn(1, 24, 64)
    key = torch.rand(1, 24) > 0.5
    assert at.attn_block_takes(1000, 64, "cpu")
    assert ran(plain, x) == ["attn_block"]
    assert ran(plain, x, key[:, None, :]) == ["attn_block"]
    assert ran(plain, torch.randn(1, 1000, 64)) == ["attn_block"]
    monkeypatch.setattr(tt, "attn_block_takes", lambda N, C, device, heads: N <= 400)
    assert ran(plain, torch.randn(1, 1000, 64)) == ["ln_matmul", "mha_short"]
    assert ran(plain, torch.randn(1, 1030, 64)) == ["ln_matmul", "flash_mha"]
    assert ran(normed, x, key) == ["ln_matmul", "flash_mha"]
    assert ran(plain, x, torch.rand(1, 24, 24) > 0.5) == ["attention"]
    calls.clear()
    plain.attn(x, key)
    assert calls == ["mha_short"]
    calls.clear()
    normed.attn(x, key)
    assert calls == ["attention"]


def test_vq_entry_points_need_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        VQ(**TINY, codebook_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        ViTTeacher(width=64, depth=1, num_heads=1)
    assert VQ(**TINY, codebook_size=64, device="cpu").device.type == "cpu"


def test_vq_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="resnet_enc"):
        VQ(enc_type="resnet_enc", device="cpu")
    # the MLP encoders are ported: a BottleneckMLP id builds and tokenizes
    # its input point-wise
    mlp = VQ(enc_type="BottleneckMLP/B_2-Wi_32", n_channels=20, latent_dim=16, codebook_size=64,
             device="cpu")
    assert tuple(mlp.tokenize(torch.zeros(2, 4, 4, 20)).shape) == (2, 4, 4)
    vq = VQ(**TINY, codebook_size=64, device="cpu")
    # a grid other than the training one resizes its positions bicubically
    # (tests/test_torch_posemb.py holds it to JAX)
    assert tuple(vq.tokenize(torch.zeros(1, 48, 48, 3)).shape) == (1, 12, 12)
