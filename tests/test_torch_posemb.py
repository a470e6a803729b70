"""The bicubic position resize of the port's ViT encoder (fourm_torch
vq/vit_models.py:interp_posemb) against jax.image.resize(..., "bicubic"),
which fourm_tpu's _interp_posemb calls: Keys' cubic with a = -0.5,
half-pixel centres, antialiased when downsizing. Up (14 -> 28, 16 -> 24) and
down (16 -> 12, 14 -> 9), square and not, at atol 1e-5 (JAX builds its
weights and sums in fp32, the port in fp64). Then ViTEncoder / VQ.tokenize
of a tokenizer trained at 224 (ViT-T width: 64 channels, 2 blocks) on
448 and 160 inputs against the JAX VQ: latents at atol 1e-4, tokens equal,
with the rows whose fp32 top-2 gap lies within the latents' error counted
and asserted to be 0 at the seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.ops.posemb import build_2d_sincos_posemb as jax_sincos
from fourm_tpu.vq import VQ as JaxVQ
from fourm_tpu.vq.quantizer import l2norm as jax_l2norm
from fourm_torch.utils.checkpoint import from_jax_vq_variables
from fourm_torch.vq import VQ
from fourm_torch.vq.vit_models import interp_posemb, resize_weights

RESIZES = [((14, 14), (28, 28)), ((16, 16), (24, 24)), ((14, 16), (28, 20)),
           ((16, 16), (12, 12)), ((14, 14), (9, 9)), ((16, 12), (12, 20))]


def _jax_resize(pos, nh, nw):
    return np.asarray(jax.image.resize(jnp.asarray(pos), (nh, nw, pos.shape[-1]),
                                       method="bicubic"))


@pytest.mark.parametrize("src,dst", RESIZES)
def test_interp_posemb_matches_jax(src, dst):
    (h0, w0), (nh, nw) = src, dst
    tables = [np.asarray(jax_sincos(h0, w0, 64)).reshape(h0, w0, 64),
              np.random.RandomState(h0 * w0).uniform(-1, 1, (h0, w0, 48)).astype(np.float32)]
    for pos in tables:
        ref = _jax_resize(pos, nh, nw)
        out = interp_posemb(torch.from_numpy(np.array(pos)), nh, nw)
        assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_resize_weights():
    # the identity keeps the table; each output's weights sum to 1
    pos = torch.randn(14, 14, 8)
    assert interp_posemb(pos, 14, 14) is pos
    for n_in, n_out in ((14, 28), (16, 12), (3, 50), (50, 3)):
        w = resize_weights(n_in, n_out)
        np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-12)
    # downsizing widens the kernel by the scale: more taps than upsizing
    assert (resize_weights(16, 8) != 0).sum(axis=0).max() > \
        (resize_weights(8, 16) != 0).sum(axis=0).max()
    # Keys' a = -0.5 at distances 1.25, 0.25, 0.75, 1.75 (output 3 of a 2x
    # upsize samples input position 1.25); a = -0.75 would give -0.10546875, ...
    w = resize_weights(4, 8)[:, 3]
    np.testing.assert_allclose(w, [-0.0703125, 0.8671875, 0.2265625, -0.0234375], atol=1e-12)


TINY224 = dict(image_size=224, patch_size=16, enc_type="vit_t_enc", latent_dim=16,
               n_channels=3, codebook_size=256)


@pytest.fixture(scope="module")
def vq224():
    jm = JaxVQ(**TINY224)
    x = np.random.RandomState(1).randn(1, 224, 224, 3).astype(np.float32)
    variables = jm.init({"params": jax.random.key(3), "rng": jax.random.key(4)},
                        jnp.asarray(x))
    variables = jax.tree.map(np.asarray, variables)
    tm = VQ(**TINY224, device="cpu")
    tm.load_state_dict(from_jax_vq_variables(variables), strict=True)
    return jm, variables, tm


def _doubtful_rows(variables, lat_ref, lat_err):
    """Rows whose fp32 top-2 cosine gap is within what the latents' error can
    move (a token there could flip without any fault)."""
    flat = lat_ref.reshape(-1, lat_ref.shape[-1])
    embed = np.asarray(variables["codebook"]["quantize"]["embed"])
    dist = np.asarray(jax_l2norm(flat)) @ np.asarray(jax_l2norm(embed)).T
    move = 2 * np.sqrt(flat.shape[1]) * lat_err / np.linalg.norm(flat, axis=-1)
    top2 = np.sort(dist, axis=-1)[:, -2:]
    return int(((top2[:, 1] - top2[:, 0]) <= 2 * move + 1e-6).sum())


@pytest.mark.parametrize("size", [448, 160])
def test_vit_encoder_off_grid_matches_jax(vq224, size):
    jm, variables, tm = vq224
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    lat_ref = np.asarray(jm.apply(variables, jnp.asarray(x), method=lambda m, v: m.quant_proj(
        m.encoder(m.prepare_input(v)))))
    with torch.no_grad():
        lat = tm.latents(torch.from_numpy(x)).numpy()
    n = size // 16
    assert lat.shape == lat_ref.shape == (2, n, n, 16)
    np.testing.assert_allclose(lat, lat_ref, atol=1e-4, rtol=0)
    assert _doubtful_rows(variables, lat_ref, float(np.abs(lat - lat_ref).max())) == 0
    _, _, tokens_ref = jm.apply(variables, jnp.asarray(x), method="encode")
    with torch.no_grad():
        tokens = tm.tokenize(torch.from_numpy(x))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(tokens_ref))
