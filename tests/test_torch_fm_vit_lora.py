"""The port's FourMViT and LoRA (fourm_torch/models/fm_vit.py, lora.py)
against the JAX package's on the CPU, at width 64 and depth 2, in fp32:
the same weights (drawn by _jax_leaves.redraw, carried across by
utils/checkpoint.py:from_jax_vit_params) give the same features and head
logits (atol 1e-4, summation orders alone differing); vit_config_from_registry
agrees on every registry name; params_from_fourm takes a FourM's encoder;
LoRA targets the same weights with the same shapes (lora_from_jax renames
and transposes), and on the same down / up the fused forward and the
gradients of the LoRA leaves equal JAX's apply_lora forward and jax.grad
(atol 1e-4); no model parameter gets a gradient; fuse_lora fuses in place,
keeping each weight's storage, and after a warm forward the next forward
sees the fused weights."""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _jax_leaves import init_variables, redraw
from fourm_tpu.models import fm_vit as jvit
from fourm_tpu.models import lora as jlora
from fourm_tpu.models.fourm import MODEL_REGISTRY as JAX_REGISTRY
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.models import fm_vit, lora
from fourm_torch.models.fourm import MODEL_REGISTRY
from fourm_torch.utils.checkpoint import from_jax_vit_params

IMG, PATCH = 32, 8
ATOL = 1e-4
FLAVOURS = {"gelu": dict(), "swiglu_qknorm": dict(act="silu", gated_mlp=True, qkv_bias=False,
                                                  proj_bias=False, mlp_bias=False,
                                                  norm_bias=False, qk_norm=True)}


def _pair(flavour, num_classes=10, seed=0):
    kw = dict(img_size=IMG, patch_size=PATCH, dim=64, encoder_depth=2, num_heads=4,
              num_classes=num_classes, **FLAVOURS[flavour])
    jm = jvit.FourMViT(jvit.FourMViTConfig(**kw))
    x = np.random.RandomState(seed).rand(2, IMG, IMG, 3).astype(np.float32)
    params = init_variables(jm, seed, jnp.asarray(x))["params"]
    tm = fm_vit.FourMViT(fm_vit.FourMViTConfig(**kw))
    missing, unexpected = tm.load_state_dict(from_jax_vit_params(params, IMG), strict=False)
    assert not unexpected and all(k.endswith(("pos_table",)) for k in missing), (missing,
                                                                                unexpected)
    return jm, params, tm.eval(), x


@pytest.fixture(scope="module", params=list(FLAVOURS))
def pair(request):
    return _pair(request.param)


def test_features_and_head_equal_jax(pair):
    jm, params, tm, x = pair
    ref_f = np.asarray(jm.apply({"params": params}, jnp.asarray(x), method="forward_features"))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        feats = tm.forward_features(torch.from_numpy(x))
        logits = tm(torch.from_numpy(x))
    assert feats.shape == (2, (IMG // PATCH) ** 2, 64) and logits.shape == (2, 10)
    np.testing.assert_allclose(feats.numpy(), ref_f, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), ref, atol=ATOL, rtol=0)


def test_registry_configs_equal_jax():
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY) and len(MODEL_REGISTRY) == 13
    for name in MODEL_REGISTRY:
        a = fm_vit.vit_config_from_registry(name, num_classes=1000)
        b = jvit.vit_config_from_registry(name, num_classes=1000)
        assert vars(a) == vars(b), name
    with pytest.raises(KeyError):
        fm_vit.vit_config_from_registry("fm_nope")


def test_params_from_fourm_warm_start():
    """A FourM's encoder (rgb@32 embedding, blocks, norm) loads into a
    FourMViT, whose features then equal FourM's encoder on the same image."""
    torch.manual_seed(0)
    cfg = create_fourm_config("fm_tiny_6e_6d_gelu", ("rgb@224", "caption"), ("caption",),
                              dim=64, encoder_depth=2, decoder_depth=1, num_heads=4)
    fm = FourM(cfg)
    with torch.no_grad():
        for p in fm.parameters():
            p.normal_(0, 0.05)
    warm = fm_vit.params_from_fourm(fm.state_dict())
    assert "encoder.1.mlp.fc2.weight" in warm and "encoder_embeddings.rgb@224.mod_emb" in warm
    assert not any(k.startswith(("decoder", "encoder_embeddings.caption")) for k in warm)
    vit = fm_vit.FourMViT(fm_vit.vit_config_from_registry(
        "fm_tiny_6e_6d_gelu", dim=64, encoder_depth=2, num_heads=4, num_classes=7)).eval()
    missing, unexpected = vit.load_state_dict(warm, strict=False)
    assert not unexpected and sorted(missing) == ["head.bias", "head.weight"]
    x = torch.rand(2, 224, 224, 3)
    mask = torch.zeros(2, 196, dtype=torch.bool)
    with torch.no_grad():
        enc, *_ = fm.encode({"rgb@224": {"tensor": x, "input_mask": mask}})
        feats = vit.forward_features(x)
    torch.testing.assert_close(feats, enc, atol=ATOL, rtol=0)


def test_lora_keys_shapes_and_transfer(pair):
    jm, params, tm, x = pair
    jl = jlora.init_lora_params(jax.random.key(3), params, rank=4)
    tl = lora.init_lora_params(tm, rank=4, generator=torch.Generator().manual_seed(3))
    carried = lora.lora_from_jax(jl)
    assert sorted(carried) == sorted(tl) and len(tl) == 4  # qkv + proj per block
    for k in tl:
        for leaf in ("down", "up"):
            assert carried[k][leaf].shape == tl[k][leaf].shape, (k, leaf)
        assert not tl[k]["up"].any()
    assert tl["encoder.0.attn.qkv.weight"]["down"].shape == (12, 64)  # 3 packed x rank 4
    assert lora.lora_param_count(tl) == jlora.lora_param_count(jl)
    # a rank whose packed width passes the weight's is skipped, as in JAX
    assert sorted(lora.init_lora_params(tm, rank=32)) == sorted(
        lora.lora_from_jax(jlora.init_lora_params(jax.random.key(0), params, rank=32)))


def _random_lora(params, seed):
    jl = jlora.init_lora_params(jax.random.key(seed), params, rank=4)
    return {k: {"down": v["down"], "up": redraw({"up": v["up"]}, seed)["up"]}
            for k, v in jl.items()}


def test_lora_forward_and_grads_equal_jax(pair):
    jm, params, tm, x = pair
    jl = _random_lora(params, 5)
    tgt = np.random.RandomState(9).randn(2, 10).astype(np.float32)

    def jloss(lo):
        out = jm.apply({"params": jlora.apply_lora(params, lo, scale=0.5)}, jnp.asarray(x))
        return jnp.sum((out - tgt) ** 2), out

    (jval, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jl)
    tl = lora.lora_from_jax(jl)
    for v in tl.values():
        v["down"].requires_grad_(True)
        v["up"].requires_grad_(True)
    before = {k: p.detach().clone() for k, p in tm.state_dict().items()}
    out = lora.apply_lora(tm, tl, torch.from_numpy(x), train=True, scale=0.5)
    loss = ((out - torch.from_numpy(tgt)) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    carried = lora.lora_from_jax(jgrad)
    for k, v in tl.items():
        for leaf in ("down", "up"):
            np.testing.assert_allclose(v[leaf].grad.numpy(), carried[k][leaf].numpy(),
                                       atol=ATOL, rtol=1e-4, err_msg=f"{k} {leaf}")
    assert all(p.grad is None for p in tm.parameters())
    for k, p in tm.state_dict().items():  # apply_lora leaves the model as it was
        assert torch.equal(p, before[k]), k


def test_fuse_lora_in_place_after_a_warm_forward(pair):
    jm, params, tm, x = pair
    tm = fm_vit.FourMViT(tm.config).eval()
    tm.load_state_dict(from_jax_vit_params(params, IMG), strict=False)
    jl = _random_lora(params, 6)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        warm = tm(xt)
        ptrs = {n: p.data_ptr() for n, p in tm.named_parameters()}
        lora.fuse_lora(tm, lora.lora_from_jax(jl), scale=0.5)
        fused = tm(xt)
    assert {n: p.data_ptr() for n, p in tm.named_parameters()} == ptrs
    ref = np.asarray(jm.apply({"params": jlora.fuse_lora(params, jl, scale=0.5)}, jnp.asarray(x)))
    np.testing.assert_allclose(fused.numpy(), ref, atol=ATOL, rtol=0)
    # the check would catch a forward that still read the weights before fusion
    assert np.abs(warm.numpy() - ref).max() > 100 * ATOL
