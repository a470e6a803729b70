"""The port's generation (fourm_torch.api.FourMSampler) against the JAX
package's, on the CPU in fp32: RGB pixels -> a chain of image-token targets
with ROAR and batch-doubled CFG, plus the port's import boundary (sequence
targets: tests/test_torch_decode.py).

One decoding step per target at temperature 0 makes both sides
deterministic (no random draw decides anything), so generated tokens must
be equal exactly."""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import fourm_tpu.api as jax_api
import fourm_tpu.data.modality_info as jax_mi
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.utils.synthetic import synthetic_mod_batch
import fourm_torch.api as api
import fourm_torch.data.modality_info as mi
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.utils.checkpoint import from_jax_params

REPO = Path(__file__).resolve().parents[1]
TARGETS = ["tok_clip@224", "tok_dinov2@224", "tok_depth@224"]
MODS = ("rgb@224", *TARGETS)
TINY = dict(dim=64, encoder_depth=2, decoder_depth=2, num_heads=4)
NAME = "fm_base_12e_12d_swiglu_qknorm_nobias"


@pytest.fixture(scope="module")
def pair():
    jm = JaxFourM(jax_config(NAME, MODS, TARGETS, **TINY))
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(MODS, 2, 32, 32))
    variables = jm.init(jax.random.key(0), batch, 32, 32)
    tcfg = create_fourm_config(NAME, MODS, TARGETS, **TINY)
    tm = FourM(tcfg)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)["params"], tcfg))
    return (jm, variables), tm


def _rgb(B, seed=0):
    return np.random.RandomState(seed).rand(B, 224, 224, 3).astype(np.float32)


def test_rgb_to_image_tokens_matches_jax(pair):
    (jm, variables), tm = pair
    B = 2
    defaults = {t: {**jax_api.DEFAULTS_RGB2X[t], "temp": 0.0} for t in TARGETS}
    jsampler = jax_api.FourMSampler(fm=(jm, variables))
    tsampler = api.FourMSampler(tm, device="cpu")
    sample = {"rgb@224": _rgb(B)}

    jmd = jsampler.prepare_sample(sample, ["rgb@224"], TARGETS, batch_size=B)
    tmd = tsampler.prepare_sample(sample, ["rgb@224"], TARGETS, batch_size=B)
    assert set(jmd) == set(tmd)
    for m in jmd:
        for k in jmd[m]:
            np.testing.assert_array_equal(tmd[m][k], jmd[m][k])
    jsched = jsampler.build_schedule(["rgb@224"], TARGETS, defaults=defaults)
    tsched = tsampler.build_schedule(["rgb@224"], TARGETS, defaults=defaults)
    assert tsched == jsched
    assert all(s["cfg_scale"] == 2.0 and s["temperature"] == 0.0 for s in tsched)
    assert [s["cfg_cond_domains"] for s in tsched] == [
        ["rgb@224"], ["rgb@224", "tok_clip@224"], ["rgb@224", "tok_clip@224", "tok_dinov2@224"]]

    jout = jsampler.generate(jmd, jsched, seed=0)
    tout = tsampler.generate(tmd, tsched, seed=0)
    for t in TARGETS:
        assert bool(tout[t]["target_mask"].all()) and not bool(tout[t]["input_mask"].any())
        np.testing.assert_array_equal(tout[t]["tensor"].numpy(), np.asarray(jout[t]["tensor"]))


def test_roar_four_steps_accept_num_select(pair):
    """A 4-step ROAR target: each step accepts exactly its num_select new
    tokens (a random subset, drawn from the seeded torch.Generator), and the
    target ends fully decoded."""
    _, tm = pair
    sampler = api.FourMSampler(tm, device="cpu")
    B = 2
    md = sampler.prepare_sample({"rgb@224": _rgb(B, 1)}, ["rgb@224"], ["tok_depth@224"],
                                batch_size=B)
    defaults = {"tok_depth@224": {**api.DEFAULTS_RGB2X["tok_depth@224"], "decoding_steps": 4,
                                  "temp": 1.0}}
    sched = sampler.build_schedule(["rgb@224"], ["tok_depth@224"], defaults=defaults)
    assert [s["num_tokens"] for s in sched] == [49, 49, 49, 49]

    steps = []
    inner = sampler.sampler._img_step

    def recording(md_step, target_mod, *args, **kwargs):
        before = md_step[target_mod]["target_mask"].clone()
        out = inner(md_step, target_mod, *args, **kwargs)
        steps.append((before, out[2]))
        return out

    sampler.sampler._img_step = recording
    out = sampler.generate(md, sched, seed=3)
    assert len(steps) == 4
    for (before, after), s in zip(steps, sched):
        new = after & ~before
        assert (new.sum(dim=1) == s["num_tokens"]).all()
    d = out["tok_depth@224"]
    assert bool(d["target_mask"].all()) and not bool(d["input_mask"].any())
    assert int(d["tensor"].min()) >= 0 and int(d["tensor"].max()) < 8192


def test_defaults_and_registry_copies_match_jax():
    assert api.DEFAULT_ORDER == jax_api.DEFAULT_ORDER
    assert api.DEFAULT_ORDER_SR == jax_api.DEFAULT_ORDER_SR
    assert api.DEFAULTS_RGB2X == jax_api.DEFAULTS_RGB2X
    assert api.DEFAULTS_X2RGB == jax_api.DEFAULTS_X2RGB
    assert api.DEFAULTS_SR == jax_api.DEFAULTS_SR
    assert mi.MODALITY_INFO.keys() == jax_mi.MODALITY_INFO.keys()
    for k, spec in mi.MODALITY_INFO.items():
        assert vars(spec) == vars(jax_mi.MODALITY_INFO[k])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_fourm_tpu():
    files = (sorted((REPO / "fourm_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + [REPO / "scripts" / f"{name}.py" for name in ("chip_tokenizer", "chip_transfer",
                                                             "chip_parallel", "chip_multicard",
                                                             "chip_controlnet", "chip_orbax",
                                                             "chip_examples")]
             + [REPO / "examples" / f"{name}.py" for name in ("end_to_end_demo_torch",
                                                              "retrieval_demo_torch")])
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):  # every import, inside functions too
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "fourm_tpu", "tokenizers",
                                "safetensors", "yaml", "huggingface_hub", "orbax", "tensorstore",
                                "zstandard", "webdataset", "datasets", "wandb", "PIL",
                                "cv2"), (f, mod)
        text = f.read_text()
        assert "import jax" not in text and "from jax" not in text, f
        # matplotlib is absent on the machine with the card: nothing imports
        # it at the top of a module
        for node in ast.parse(text).body:
            top = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                   [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert "matplotlib" not in {m.split(".")[0] for m in top}, (f, top)
    # and at run time: importing the whole port loads no JAX module, none of
    # the `tokenizers`, `safetensors`, PyYAML, Hub or orbax packages and no
    # drawing library, which the machine with the card lacks
    code = ("import sys, fourm_torch.api, fourm_torch.utils.checkpoint, fourm_torch.kernels, "
            "fourm_torch.vq, fourm_torch.utils.decoding, "
            "fourm_torch.utils.text_tokenizer, fourm_torch.cli.generate, "
            "fourm_torch.cli.train_4m, fourm_torch.vq.loader, fourm_torch.utils.config, "
            "fourm_torch.data.generation_datasets, fourm_torch.data.pretrain_utils, "
            "fourm_torch.data.datasets, fourm_torch.data.transforms, "
            "fourm_torch.data.augmenters, fourm_torch.data.masking, fourm_torch.data.batching, "
            "fourm_torch.data.loader, fourm_torch.data.image_io, fourm_torch.native, "
            "fourm_torch.utils.synthetic_shards, fourm_torch.parallel, "
            "fourm_torch.parallel.launch, fourm_torch.parallel.mesh, "
            "fourm_torch.parallel.shard, fourm_torch.ops.tensor_parallel, "
            "fourm_torch.data.transfer, fourm_torch.models.fm_vit, fourm_torch.models.lora, "
            "fourm_torch.utils.remote, fourm_torch.utils.profiling, fourm_torch.utils.drawing, "
            "fourm_torch.utils.orbax, fourm_torch.vq.teachers, fourm_torch.cli.save_vq_tokens, "
            "fourm_torch.cli.train_vqcontrolnet, fourm_torch.cli.train_text_tokenizer, "
            "fourm_torch.utils.logger, fourm_torch.data.image_enhance; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'fourm_tpu', 'tokenizers', 'safetensors', 'yaml', "
            "'huggingface_hub', 'orbax', 'tensorstore', 'zstandard', 'PIL', 'cv2', "
            "'matplotlib', 'webdataset', 'datasets', 'wandb')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_point_needs_the_card_unless_cpu_is_asked(pair):
    _, tm = pair
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.FourMSampler(tm)
    assert api.FourMSampler(tm, device="cpu").device.type == "cpu"


def test_sampler_call_generates_then_decodes(pair):
    """FourMSampler.__call__: prepare, generate, decode, the decoded targets
    only; the same as the three steps run by hand with the same seed, and
    its VQ-VAE decode the JAX package's decode_dict of the same tokens."""
    from _jax_leaves import init_variables
    from fourm_tpu.utils import decoding as jdec
    from fourm_tpu.vq import VQVAE as JaxVQVAE
    from fourm_torch.utils.checkpoint import from_jax_vq_variables
    from fourm_torch.utils.decoding import TokenizerBundle
    from fourm_torch.vq import VQVAE, DiVAE, init_vq_weights

    _, tm = pair
    clip_kw = dict(image_size=224, patch_size=16, enc_type="vit_t_enc", dec_type="vit_t_dec",
                   n_channels=12, patch_proj=False, latent_dim=16, codebook_size=8192)
    jclip = JaxVQVAE(**clip_kw)
    variables = init_variables(jclip, 60, jnp.zeros((1, 14, 14, 12)))
    clip = VQVAE(**clip_kw, device="cpu")
    clip.load_state_dict(from_jax_vq_variables(variables), strict=True)
    depth = init_vq_weights(DiVAE(image_size=224, patch_size=16, enc_type="vit_t_enc",
                                  dec_type="uvit_t_p4_f16", latent_dim=16, codebook_size=8192,
                                  device="cpu"), 61, spread=0.1)
    sampler = api.FourMSampler(tm, device="cpu", tokenizers={"tok_clip": TokenizerBundle(clip),
                                                             "tok_depth": TokenizerBundle(depth)})
    targets = ["tok_clip@224", "tok_depth@224"]
    sample = {"rgb@224": _rgb(2, 2)}
    out = sampler(sample, ["rgb@224"], targets, seed=4, batch_size=2, decoding_steps=2)
    assert list(out) == targets
    assert out["tok_clip@224"].shape == (2, 14, 14, 3)
    assert out["tok_depth@224"].shape == (2, 224, 224, 3)
    md = sampler.prepare_sample(sample, ["rgb@224"], targets, batch_size=2)
    gen = sampler.generate(md, sampler.build_schedule(["rgb@224"], targets), seed=4)
    by_hand = sampler.decode(gen, decoding_steps=2, seed=4, keys=targets)
    for t in targets:
        np.testing.assert_array_equal(out[t], by_hand[t])
    ref = jdec.decode_dict({"tok_clip@224": {k: v.numpy() for k, v in gen["tok_clip@224"].items()}},
                           {"tok_clip": jdec.TokenizerBundle(jclip, variables)}, None)
    np.testing.assert_allclose(out["tok_clip@224"], ref["tok_clip@224"], atol=1e-4, rtol=0)


def test_load_sampler_matches_jax(pair, tmp_path):
    """fourm_torch.load_sampler on a release .safetensors (the pair's JAX
    weights in the reference names, the release's config metadata) against
    fourm_tpu.load_sampler on the same file: equal tokens at temperature
    0, on the CPU when asked (the card by default)."""
    from safetensors.numpy import save_file

    import fourm_tpu
    import fourm_torch
    from fourm_tpu.utils.checkpoint import export_fourm_torch_state

    (jm, variables), _ = pair
    cfg = jm.config
    meta = {"domains_in": list(cfg.encoder_modalities),
            "domains_out": list(cfg.decoder_modalities), "dim": cfg.dim,
            "encoder_depth": cfg.encoder_depth, "decoder_depth": cfg.decoder_depth,
            "num_heads": cfg.num_heads, "mlp_ratio": cfg.mlp_ratio, "qkv_bias": cfg.qkv_bias,
            "proj_bias": cfg.proj_bias, "mlp_bias": cfg.mlp_bias, "norm_bias": cfg.norm_bias,
            "act_layer": "SiLU", "gated_mlp": cfg.gated_mlp, "qk_norm": cfg.qk_norm,
            "decoder_causal_mask": cfg.decoder_causal_mask,
            "decoder_sep_mask": cfg.decoder_sep_mask, "num_register_tokens": 0,
            "share_modality_embeddings": cfg.share_modality_embeddings, "image_size": 224,
            "patch_size": 16}
    state = export_fourm_torch_state(variables, cfg)
    for m in cfg.decoder_modalities:  # a release's logits are untied
        emb = f"decoder_embeddings.{m}."
        state.setdefault(emb + "to_logits.weight", state[emb + "token_emb.weight"])
    path = str(tmp_path / "fm.safetensors")
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in state.items()}, path,
              metadata={"config": str(meta)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fourm_torch.load_sampler(path)
    ours, ref = fourm_torch.load_sampler(path, device="cpu"), fourm_tpu.load_sampler(path)
    assert ours.model.config.dim == 64 and fourm_torch.FourM is type(ours.model)
    targets = TARGETS[:2]
    defaults = {t: {**jax_api.DEFAULTS_RGB2X[t], "temp": 0.0} for t in targets}
    outs = []
    for s in (ours, ref):
        md = s.prepare_sample({"rgb@224": _rgb(2, 4)}, ["rgb@224"], targets, batch_size=2)
        outs.append(s.generate(md, s.build_schedule(["rgb@224"], targets, defaults=defaults),
                               seed=0))
    for t in targets:
        np.testing.assert_array_equal(np.asarray(outs[0][t]["tensor"]),
                                      np.asarray(outs[1][t]["tensor"]))
