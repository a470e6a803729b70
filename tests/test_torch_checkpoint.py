"""Checkpoints of the port (fourm_torch/utils/checkpoint.py, vq/loader.py)
against the JAX package's on the same files, on the CPU.

The safetensors reader against `safetensors` itself on every dtype it
takes (bit for bit) and the writer read back by it and by the JAX loader;
the metadata forms parsed as the JAX loader parses them; the config
field by field; a JAX FourM (dim 64, 2 + 2 layers, 4M-21 flavour, its
leaves drawn from the module's shapes) in the release format, loaded by both packages: logits in fp32
within atol 1e-5, with the file's sin-cos tables in either layout, and a
wrong table, a missing key and an extra key raising with their names; a
bf16 load at SwiGLU hidden 2730 that keeps fc2's padded storage; the
tokenizers (vit_t VQ-VAE, UViT-t DiVAE, a legacy .pth) through both
get_image_tokenizer: tokens equal, decodes within rel 1e-4, weights equal;
and the train CLI's resume, bit for bit, with a corrupt checkpoint raising.
"""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from _jax_leaves import init_variables
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.ops.posemb import build_1d_sincos_posemb as jax_1d
from fourm_tpu.ops.posemb import build_2d_sincos_posemb as jax_2d
from fourm_tpu.utils import checkpoint as jck
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_tpu.vq import DiVAE as JaxDiVAE
from fourm_tpu.vq import VQVAE as JaxVQVAE
from fourm_tpu.vq import get_image_tokenizer as jax_get_image_tokenizer
from fourm_tpu.vq import loader as jax_loader
from fourm_torch.data.modality_info import MODALITY_INFO
from fourm_torch.models import FourM
from fourm_torch.utils import checkpoint as tck
from fourm_torch.vq import DiVAE, VQVAE
from fourm_torch.vq.loader import get_image_tokenizer

MODS = ("rgb@224", "tok_clip@224", "caption")
DEC_MODS = ("tok_clip@224", "caption")
# the reference's str(config) of a 4M-21 flavour model at dim 64, 2 + 2 layers
META = {"domains_in": list(MODS), "domains_out": list(DEC_MODS), "dim": 64,
        "encoder_depth": 2, "decoder_depth": 2, "num_heads": 4, "mlp_ratio": 4.0,
        "qkv_bias": False, "proj_bias": False, "mlp_bias": False, "norm_bias": False,
        "act_layer": "SiLU", "gated_mlp": True, "qk_norm": True, "decoder_causal_mask": False,
        "decoder_sep_mask": True, "num_register_tokens": 0,
        "share_modality_embeddings": False, "image_size": 224, "patch_size": 16,
        "modality_info": None}
ST_DTYPES = ["F32", "F16", "BF16", "I64", "I32", "I16", "I8", "U8", "BOOL"]


def _sample(dtype: str, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if dtype in ("F32", "F16", "BF16"):
        return torch.randn(3, 5, generator=g).to(tck._ST_DTYPES[dtype])
    if dtype == "BOOL":
        return torch.rand(4, 3, generator=g) > 0.5
    info = torch.iinfo(tck._ST_DTYPES[dtype])
    return torch.randint(info.min, info.max, (2, 7), generator=g, dtype=tck._ST_DTYPES[dtype])


@pytest.mark.parametrize("dtype", ST_DTYPES)
def test_reader_matches_safetensors(dtype, tmp_path):
    """A file of the `safetensors` library (with an empty and a 0-d tensor
    beside) read by the port: dtype, shape and bytes equal what the
    library reads (numpy, or torch for BF16, which numpy lacks)."""
    ts = {"a": _sample(dtype, 0), "b": _sample(dtype, 1)[:1, :2].contiguous(),
          "empty": torch.zeros(0, 3, dtype=tck._ST_DTYPES[dtype]),
          "scalar": _sample(dtype, 2).reshape(-1)[0].clone()}
    path = str(tmp_path / "x.safetensors")
    st_save_torch(ts, path, metadata={"format": "pt"})
    got, meta = tck.load_safetensors(path)
    ref = st_load_torch(path) if dtype == "BF16" else {
        k: torch.from_numpy(v) for k, v in st_load_numpy(path).items()}
    assert set(got) == set(ref) and meta == {"format": "pt"}
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k].view(torch.uint8) if v.dtype == torch.bool else got[k],
                           v.view(torch.uint8) if v.dtype == torch.bool else v), k


def test_writer_read_back_by_safetensors_and_jax(tmp_path):
    ts = {d: _sample(d, i) for i, d in enumerate(ST_DTYPES)}
    path = str(tmp_path / "w.safetensors")
    tck.save_safetensors(ts, path, metadata={"config": "{'dim': 64, 'act_layer': None}"})
    ref = st_load_torch(path)
    assert set(ref) == set(ts)
    for k, v in ts.items():
        assert ref[k].dtype == v.dtype and torch.equal(ref[k], v), k
    numpy_path = str(tmp_path / "n.safetensors")  # the JAX loader reads through numpy
    tck.save_safetensors({k: v for k, v in ts.items() if k != "BF16"}, numpy_path,
                         metadata={"config": "{'dim': 64, 'act_layer': None}"})
    tensors, meta = jck.load_safetensors(numpy_path)
    for k, v in tensors.items():
        np.testing.assert_array_equal(v, ts[k].numpy())
        assert v.dtype == ts[k].numpy().dtype, k
    assert meta == {"config": {"dim": 64, "act_layer": None}}


def test_unsupported_dtype_raises(tmp_path):
    path = str(tmp_path / "f64.safetensors")
    st_save_numpy({"x": np.zeros(3, np.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        tck.load_safetensors(path)


METADATA_FORMS = {
    "python_literal": str(META),
    "json": json.dumps(META),
    "block_yaml": __import__("yaml").safe_dump({k: v for k, v in META.items()}),
    "scalar": "pt",
    "none_scalar": "None",
}


@pytest.mark.parametrize("form", sorted(METADATA_FORMS))
def test_metadata_forms_parse_as_jax(form, tmp_path):
    path = str(tmp_path / "m.safetensors")
    st_save_numpy({"x": np.zeros(2, np.float32)}, path,
                  metadata={"config": METADATA_FORMS[form]})
    _, ref = jck.load_safetensors(path)
    _, got = tck.load_safetensors(path)
    assert got == ref


@pytest.mark.parametrize("bad", ["{'dim': 64, 'domains_in': ['rgb@224'}",
                                 "{'act_layer': <class 'torch.nn.SiLU'>}"])
def test_metadata_other_forms_raise(bad, tmp_path):
    """What neither JSON, a Python literal nor the YAML subset reads raises;
    the JAX loader keeps the first as its raw string and reads the second
    as a YAML flow mapping of strings."""
    path = str(tmp_path / "m.safetensors")
    st_save_numpy({"x": np.zeros(2, np.float32)}, path, metadata={"config": bad})
    ref = jck.load_safetensors(path)[1]["config"]
    assert ref == bad if "<" not in bad else ref == {"act_layer": "<class 'torch.nn.SiLU'>"}
    with pytest.raises(ValueError):
        tck.load_safetensors(path)


def test_config_from_metadata_field_by_field():
    ref = jck.fourm_config_from_metadata(META)
    got = tck.fourm_config_from_metadata(META)
    names = {f for f in vars(ref)}
    assert names == set(vars(got))
    for f in names:
        assert getattr(got, f) == getattr(ref, f), f
    assert got.act == "silu" and got.decoder_share_embedding is False


# ------------------------------------------------------------- FourM files

@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A JAX FourM's parameter tree (its leaves drawn from the module's
    shapes, _jax_leaves.init_variables) as the reference state dict
    (export_fourm_torch_state) and its JAX logits of forward_generation_img."""
    cfg = jck.fourm_config_from_metadata(META)
    jm = JaxFourM(cfg)
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(MODS, 2, 32, 32))
    variables = init_variables(jm, 7, batch, 32, 32)
    state = jck.export_fourm_torch_state(variables, cfg)
    md, sa = _gen_inputs()
    logits = np.asarray(jm.apply(variables, jax.tree.map(jnp.asarray, md), "tok_clip@224",
                                 jnp.asarray(sa), None, method="forward_generation_img"))
    return state, logits, tmp_path_factory.mktemp("release")


def _gen_inputs():
    rng = np.random.RandomState(3)
    B = 2
    md = {"rgb@224": {"tensor": rng.rand(B, 224, 224, 3).astype(np.float32),
                      "input_mask": np.zeros((B, 196), bool),
                      "target_mask": np.ones((B, 196), bool),
                      "decoder_attention_mask": np.zeros((B, 196), np.int32)},
          "tok_clip@224": {"tensor": rng.randint(0, 8192, (B, 196)).astype(np.int32),
                           "input_mask": rng.rand(B, 196) > 0.5,
                           "target_mask": np.zeros((B, 196), bool),
                           "decoder_attention_mask": np.zeros((B, 196), np.int32)},
          "caption": {"tensor": rng.randint(0, 30000, (B, 20)).astype(np.int32),
                      "input_mask": rng.rand(B, 20) > 0.5,
                      "target_mask": np.ones((B, 20), bool),
                      "decoder_attention_mask": np.zeros((B, 20), np.int32)}}
    return md, rng.rand(B, 196) > 0.3


def _sincos_tensors(layout: str, dim: int = 64) -> dict:
    """The sin-cos tables as the reference stores them, from the JAX
    package's posemb functions: sequences (1, N, D); image grids (1, N, D) or the
    reference's (1, D, h, w)."""
    out = {}
    for top, mods in (("encoder_embeddings", MODS), ("decoder_embeddings", DEC_MODS)):
        for m in mods:
            spec = MODALITY_INFO[m]
            if spec.max_length is not None:
                out[f"{top}.{m}.pos_emb"] = np.asarray(jax_1d(512, dim))[None, :spec.max_length]
                continue
            n = spec.input_size // spec.patch_size
            table = np.asarray(jax_2d(n, n, dim))
            out[f"{top}.{m}.pos_emb"] = (table[None] if layout == "nd" else
                                         table.reshape(n, n, dim).transpose(2, 0, 1)[None])
    return out


def _write(path, state, extra=None, drop=()):
    tensors = {k: v for k, v in state.items() if k not in drop}
    tensors.update(extra or {})
    tensors = {k: np.ascontiguousarray(v, np.float32) for k, v in tensors.items()}
    st_save_numpy(tensors, str(path), metadata={"config": str(META)})
    return str(path)


def _port_logits(model):
    md, sa = _gen_inputs()
    with torch.no_grad():
        return model.forward_generation_img(
            {m: {k: torch.from_numpy(v) for k, v in d.items()} for m, d in md.items()},
            "tok_clip@224", torch.from_numpy(sa), None).numpy()


@pytest.mark.parametrize("layout", ["none", "nd", "dhw"])
def test_fourm_release_loads_as_jax(release, layout):
    state, ref_logits, tmp = release
    path = _write(tmp / f"fm_{layout}.safetensors", state,
                  None if layout == "none" else _sincos_tensors(layout))
    if layout != "dhw":  # JAX's importer reshapes a (1, D, h, w) table wrongly
        jcfg, jvars = jck.load_fourm_safetensors(path)
        jm = JaxFourM(jcfg)
        md, sa = _gen_inputs()
        jl = jm.apply(jvars, jax.tree.map(jnp.asarray, md), "tok_clip@224", jnp.asarray(sa),
                      None, method="forward_generation_img")
        np.testing.assert_array_equal(np.asarray(jl), ref_logits)
    config, model = tck.load_fourm_safetensors(path, device="cpu")
    assert config == tck.fourm_config_from_metadata(META)
    got = _port_logits(model)
    assert got.shape == ref_logits.shape
    np.testing.assert_allclose(got, ref_logits, atol=1e-5, rtol=0)


def test_fourm_release_refuses_what_it_cannot_place(release):
    state, _, tmp = release
    tables = _sincos_tensors("dhw")
    key = "encoder_embeddings.tok_clip@224.pos_emb"
    wrong = dict(tables, **{key: tables[key] + np.float32(1e-3)})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        tck.load_fourm_safetensors(_write(tmp / "wrong.safetensors", state, wrong), device="cpu")
    # a grid stored (h, w) transposed is a wrong table too
    swapped = dict(tables, **{key: tables[key].transpose(0, 1, 3, 2).copy()})
    with pytest.raises(ValueError, match="sin-cos"):
        tck.load_fourm_safetensors(_write(tmp / "swap.safetensors", state, swapped),
                                   device="cpu")
    gone = "decoder.1.mlp.fc2.weight"
    with pytest.raises(KeyError, match=gone.replace(".", r"\.")):
        tck.load_fourm_safetensors(_write(tmp / "missing.safetensors", state, drop=(gone,)),
                                   device="cpu")
    extra = {"encoder.7.attn.qkv.weight": np.zeros((192, 64), np.float32)}
    with pytest.raises(KeyError, match=r"encoder\.7\.attn\.qkv\.weight"):
        tck.load_fourm_safetensors(_write(tmp / "extra.safetensors", state, extra),
                                   device="cpu")
    with pytest.raises(FileNotFoundError, match="local"):
        tck.load_fourm_safetensors("EPFL-VILAB/4M-21_B", device="cpu")


def test_bf16_load_keeps_padded_fc2(tmp_path):
    """SwiGLU hidden 2730 (4M-L's ragged width, here at dim 64): a bf16 load
    copies into fc2's parameters and then casts, so each bf16 W2 is the
    (C, HID) view of zero-padded storage (ops/transformer.py:rows_padded)
    holding the file's values."""
    meta = dict(META, domains_in=["tok_clip@224"], domains_out=["tok_clip@224"],
                encoder_depth=1, decoder_depth=1, mlp_ratio=4095 / 64)
    cfg = tck.fourm_config_from_metadata(meta)
    src = FourM(cfg)
    g = torch.Generator().manual_seed(0)
    state = {k: torch.randn(v.shape, generator=g) for k, v in src.state_dict().items()}
    path = str(tmp_path / "l.safetensors")
    tck.save_safetensors(state, path, metadata={"config": str(meta)})
    _, model = tck.load_fourm_safetensors(path, config_override={"dtype": "bfloat16"},
                                          device="cpu")
    fc2 = [m.fc2.weight for m in model.modules() if hasattr(m, "fc3")]
    assert len(fc2) == 2
    for w, name in zip(fc2, ("encoder.0.mlp.fc2.weight", "decoder.0.mlp.fc2.weight")):
        assert w.dtype == torch.bfloat16 and w.shape == (64, 2730)
        assert w.stride(0) == 2736 and w.stride(1) == 1
        base = torch.as_strided(w, (64, 2736), (2736, 1))
        assert torch.equal(base[:, 2730:], torch.zeros(64, 6, dtype=torch.bfloat16))
        assert torch.equal(w, state[name].to(torch.bfloat16))


# ------------------------------------------------------------- tokenizers

TINY_VQ = dict(image_size=32, patch_size=4, enc_type="vit_t_enc", latent_dim=16,
               codebook_size=64)
VQVAE_CFG = dict(TINY_VQ, dec_type="vit_t_dec", post_mlp=True, out_conv=True, domain="rgb")
DIVAE_CFG = dict(TINY_VQ, image_size=64, patch_size=16, dec_type="uvit_t_p4_f16",
                 beta_schedule="squaredcos_cap_v2", domain="rgb")


def _jax_kw(cfg):
    return {k: v for k, v in cfg.items() if k != "domain"}


_JAX_INIT = jax_loader._init_variables


@pytest.fixture(autouse=True)
def _shapes_only(monkeypatch):
    """The JAX loader's model.init only gives import_vq_state_dict the tree
    it fills (every leaf of these files is present): its shapes, by
    jax.eval_shape, skip compiling and running the model."""
    monkeypatch.setattr(jax_loader, "_init_variables",
                        lambda model, rngs=None: jax.eval_shape(lambda: _JAX_INIT(model, rngs)))


@pytest.fixture(scope="module")
def vqvae_file(tmp_path_factory):
    x = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    variables = init_variables(JaxVQVAE(**_jax_kw(VQVAE_CFG)), 41, jnp.asarray(x))
    path = str(tmp_path_factory.mktemp("vq") / "rgb.safetensors")
    jck.export_vq_safetensors(variables, VQVAE_CFG, path)
    return path, x


def test_vqvae_release_through_both_loaders(vqvae_file):
    path, x = vqvae_file
    jm, jvars = jax_get_image_tokenizer(path, verbose=False)
    pm, none = get_image_tokenizer(path, verbose=False, device="cpu")
    assert none is None and isinstance(pm, VQVAE) and not pm.training
    ref_tokens = np.asarray(jm.apply(jvars, jnp.asarray(x), method="tokenize"))
    with torch.no_grad():
        tokens = pm.tokenize(torch.from_numpy(x))
        np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
        rec = pm.decode_tokens(tokens).numpy()
    ref = np.asarray(jm.apply(jvars, jnp.asarray(ref_tokens), method="decode_tokens"))
    np.testing.assert_allclose(rec, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_tokenizer_pth_and_encoder_only(vqvae_file, tmp_path):
    """The legacy .pth ({'model': state dict, 'args': Namespace}) gives the
    same tokens in both packages; encoder_only builds the port's VQ."""
    path, x = vqvae_file
    state = {k: torch.from_numpy(v.copy()) for k, v in st_load_numpy(path).items()}
    pth = str(tmp_path / "rgb.pth")
    torch.save({"model": state, "args": argparse.Namespace(**VQVAE_CFG)}, pth)
    jm, jvars = jax_get_image_tokenizer(pth, verbose=False)
    pm, _ = get_image_tokenizer(pth, verbose=False, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(
            pm.tokenize(torch.from_numpy(x)).numpy(),
            np.asarray(jm.apply(jvars, jnp.asarray(x), method="tokenize")))
    enc, _ = get_image_tokenizer(path, encoder_only=True, verbose=False, device="cpu")
    assert type(enc).__name__ == "VQ" and not hasattr(enc, "decoder")
    with torch.no_grad():
        assert torch.equal(enc.tokenize(torch.from_numpy(x)), pm.tokenize(torch.from_numpy(x)))


def test_divae_release_weights_equal(tmp_path):
    x = jnp.zeros((1, 64, 64, 3))
    variables = init_variables(JaxDiVAE(**_jax_kw(DIVAE_CFG)), 43, x, x, jnp.asarray([3]))
    path = str(tmp_path / "depth.safetensors")
    jck.export_vq_safetensors(variables, DIVAE_CFG, path)
    jm, jvars = jax_get_image_tokenizer(path, verbose=False)
    pm, _ = get_image_tokenizer(path, verbose=False, device="cpu")
    assert isinstance(pm, DiVAE) and type(jm).__name__ == "DiVAE"
    ref = jck.export_vq_torch_state(jax.tree.map(np.asarray, jvars))
    ours = pm.state_dict()
    assert set(ours) == {k for k in ref if not k.endswith(tck._VQ_UNUSED)}
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    assert pm.scheduler_kw["beta_schedule"] == jm.beta_schedule == "squaredcos_cap_v2"


def test_tokenizer_refusals(vqvae_file, tmp_path):
    path, _ = vqvae_file
    state = st_load_numpy(path)
    cn = str(tmp_path / "cn.safetensors")
    st_save_numpy(dict(state, **{"controlnet.input_blocks.0.weight": np.zeros(2, np.float32)}),
                  cn, metadata={"config": "{'domain': 'rgb'}"})
    # `controlnet` keys make a VQControlNet, whose default 224 px latent (28)
    # the UNet's three halvings do not divide: refused before any key is read
    with pytest.raises(ValueError, match="latent size 28 is not a multiple of 8"):
        get_image_tokenizer(cn, verbose=False, device="cpu")
    extra = str(tmp_path / "extra.safetensors")
    st_save_numpy(dict(state, **{"decoder.blocks.9.mlp.fc1.weight": np.zeros(2, np.float32)}),
                  extra, metadata={"config": __import__("yaml").safe_dump(VQVAE_CFG)})
    with pytest.raises(KeyError, match=r"decoder\.blocks\.9\.mlp\.fc1\.weight"):
        get_image_tokenizer(extra, verbose=False, device="cpu")
    missing = str(tmp_path / "missing.safetensors")
    st_save_numpy({k: v for k, v in state.items() if k != "quant_proj.weight"}, missing,
                  metadata={"config": __import__("yaml").safe_dump(VQVAE_CFG)})
    with pytest.raises(KeyError, match=r"quant_proj\.weight"):
        get_image_tokenizer(missing, verbose=False, device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        get_image_tokenizer(str(tmp_path), verbose=False, device="cpu")


def test_port_export_reads_back_in_both_packages(vqvae_file, tmp_path):
    """export_vq_safetensors of the port: its YAML metadata equals
    yaml.safe_load's reading, and both loaders take the file."""
    path, x = vqvae_file
    pm, _ = get_image_tokenizer(path, verbose=False, device="cpu")
    out = str(tmp_path / "again.safetensors")
    tck.export_vq_safetensors(pm, VQVAE_CFG, out)
    assert jck.load_safetensors(out)[1] == tck.load_safetensors(out)[1] == {"config": VQVAE_CFG}
    jm, jvars = jax_get_image_tokenizer(out, verbose=False)
    again, _ = get_image_tokenizer(out, verbose=False, device="cpu")
    for k, v in pm.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    with torch.no_grad():
        np.testing.assert_array_equal(
            again.tokenize(torch.from_numpy(x)).numpy(),
            np.asarray(jm.apply(jvars, jnp.asarray(x), method="tokenize")))


# ------------------------------------------------------------ train state

TRAIN = ["--device", "cpu", "--synthetic_data", "--model", "fm_base_12e_12d_swiglu_nobias",
         "--in_domains", "rgb@224-tok_clip@224-caption", "--out_domains", "tok_clip@224-caption",
         "--dim", "64", "--num_heads", "4", "--encoder_depth", "2", "--decoder_depth", "2",
         "--dtype", "float32", "--batch_size", "2", "--num_input_tokens", "32",
         "--num_target_tokens", "32", "--print_freq", "1", "--scheduler", "constant",
         "--warmup_tokens", "3e-7", "--epoch_size", "4", "--blr", "0.1",
         # the eval (every epoch and at the end) on one held-out batch
         "--eval_size", "2"]


def _losses(run):
    with open(os.path.join(run, "log.txt")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}


def test_train_resume_equals_uninterrupted(tmp_path):
    """4 steps in one run against 2 steps, then a second run that resumes
    from the step-2 checkpoint (warmup over 2 steps: the schedule's position
    matters; stochastic masking draws from the step's generator): the
    losses of steps 3-4 and the final fp32 masters equal bit for bit."""
    from fourm_torch.cli.train_4m import main

    main(TRAIN + ["--output_dir", str(tmp_path / "a"), "--max_steps", "4"])
    main(TRAIN + ["--output_dir", str(tmp_path / "b"), "--max_steps", "2"])
    assert tck.latest_checkpoint_steps(str(tmp_path / "b" / "checkpoints")) == [2]
    main(TRAIN + ["--output_dir", str(tmp_path / "b"), "--max_steps", "4"])
    la, lb = _losses(tmp_path / "a"), _losses(tmp_path / "b")
    assert la == lb and sorted(la) == [0, 1, 2, 3]
    wa = tck.load_checkpoint(str(tmp_path / "a" / "weights"), 4)
    wb = tck.load_checkpoint(str(tmp_path / "b" / "weights"), 4)
    assert set(wa) == set(wb)
    for k in wa:
        assert wa[k].dtype == torch.float32 and torch.equal(wa[k], wb[k]), k
    ca = tck.load_checkpoint(str(tmp_path / "a" / "checkpoints"), 4)
    cb = tck.load_checkpoint(str(tmp_path / "b" / "checkpoints"), 4)
    assert ca["optimizer"]["count"] == cb["optimizer"]["count"] == 4
    for k in ca["optimizer"]["mu"]:
        assert torch.equal(ca["optimizer"]["nu"][k], cb["optimizer"]["nu"][k]), k
    assert not [n for n in os.listdir(tmp_path / "b" / "checkpoints") if n.endswith(".tmp")]


def test_corrupt_checkpoint_raises(tmp_path):
    from fourm_torch.cli.train_4m import main

    run = tmp_path / "c"
    main(TRAIN + ["--output_dir", str(run), "--max_steps", "1"])
    with open(run / "checkpoints" / "step_1" / "state.pt", "r+b") as f:
        f.seek(40)
        f.write(b"\0" * 64)
    with pytest.raises(Exception):
        main(TRAIN + ["--output_dir", str(run), "--max_steps", "2"])
    assert tck.latest_checkpoint_steps(str(run / "checkpoints")) == [1]


def test_checkpoints_pruned_and_finetune_drops_pos_emb(release, tmp_path):
    """save_checkpoint keeps the newest `keep`; --finetune from a release
    file copies every tensor but `.pos_emb` into the train model."""
    for s in (1, 2, 3, 4):
        tck.save_checkpoint(str(tmp_path / "k"), {"step": s}, s, keep=2)
    assert tck.latest_checkpoint_steps(str(tmp_path / "k")) == [3, 4]
    assert tck.auto_resume(str(tmp_path / "k"))[0] == {"step": 4}
    assert tck.auto_resume(str(tmp_path / "none")) == (None, 0)
    from fourm_torch.cli.train_4m import load_finetune_weights

    state, _, tmp = release
    path = _write(tmp / "ft.safetensors", state, _sincos_tensors("dhw"))
    cfg = tck.fourm_config_from_metadata(META)
    model = FourM(cfg)
    load_finetune_weights(path, model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
