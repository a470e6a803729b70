"""The port's generation CLI (python -m fourm_torch.cli.generate) and its
config reader against the JAX package's, on the CPU.

The YAML reader (fourm_torch/utils/config.py) equals yaml.safe_load on
every generation config of the repository, and its writer reads back
equal in both; the PNG writer's pixels equal what PIL saves. Then both
CLIs run on one tiny model file (a JAX FourM, dim 64, 2 + 2 layers, its
leaves drawn from the module's shapes), one VQ-VAE tokenizer file (vit_t, its leaves drawn so the decoder
is not zero), one text tokenizer and one prompt TSV, at temperature 0 with
MaskGIT and one-step ROAR image targets and an autoregressive caption, as
tests/test_torch_generate_api.py runs the samplers: the saved tokens equal
exactly for the `prompts`, `folder` and `empty` datasets, and so do the
text files and the PNG of the folder's RGB condition; the VQ-VAE-decoded
PNGs (tok_rgb@224), read back with PIL, differ from the
JAX CLI's in at most one level and in at most 1 pixel value in 1000 (the
two fp32 decoders differ in their last bits, and a value that lands on a
step of the uint8 conversion may round either way)."""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from PIL import Image
from safetensors.numpy import save_file as st_save_numpy

from _jax_leaves import init_variables
from fourm_tpu.cli import generate as jax_cli
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.utils import checkpoint as jck
from fourm_tpu.utils.config import parse_args_with_config as jax_parse
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_tpu.utils.text_tokenizer import (generate_sentinel_tokens,
                                            train_unified_wordpiece_tokenizer)
from fourm_tpu.vq import VQVAE as JaxVQVAE
from fourm_tpu.vq import loader as jax_loader
from fourm_torch.cli import generate as port_cli
from fourm_torch.utils.config import dump_yaml, parse_args_with_config, safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "cfgs/default/generation/**/*.yaml"),
                           recursive=True) +
                 glob.glob(os.path.join(REPO, "cfgs/generation/**/*.yaml"), recursive=True))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_yaml_reader_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert safe_load(text, path) == yaml.safe_load(text)


def test_yaml_writer_and_refusals():
    d = {"a": 1, "b": 1.5, "c": 1e-6, "d": None, "e": True, "f": "yes", "g": "224",
         "h": "x: y", "i": ["a", 1, None, "No"], "j": "", "k": "it's", "l": [], "m": "café",
         "n": "tok_rgb@224", "o": "a #b", "p": "1e-3", "q": "0x1F", "r": float("inf")}
    for text in (dump_yaml(d), yaml.safe_dump(d)):
        assert safe_load(text) == yaml.safe_load(text) == d
    # nested block mappings and flow sequences of scalars (the data and alphas configs)
    for text in ("a:\n  b: 1\n", "a: [1, 2]\n", "a: [1, 'x y', 0., ]\nb:\n- 1\n- c\n",
                 "x:\n  y:\n    z: [a]\n  w: 2\nq: 3\n"):
        assert safe_load(text) == yaml.safe_load(text)
    ascii_only = {k: v for k, v in d.items() if k != "m"}  # safe_dump escapes the rest
    nested = {"train": {"datasets": {"x": {**ascii_only, "k": {"p": "/a/[b,c]/{0..3}.tar"}}}},
              "e": 1}
    assert dump_yaml(nested) == yaml.safe_dump(nested)
    assert safe_load(dump_yaml(nested)) == yaml.safe_load(dump_yaml(nested)) == nested
    for bad in ("a: {b: 1}\n", "a: &x 1\nb: *x\n", "a: [[1]]\n", "a: 1\n  b: 2\n",
                "a: 1\n---\nb: 2\n", "a: |\n  text\n", "a: !!str 1\n"):
        with pytest.raises(ValueError):
            safe_load(bad)


def test_config_injection_matches_jax(tmp_path):
    cfg = os.path.join(REPO, "cfgs/default/generation/settings_base/"
                             "T2CR_roar49-25_cfg3_t6-0.5.yaml")
    argv = ["--fm_ckpt", "x.safetensors", "--config", cfg, "--temps", "0.5"]
    ref = vars(jax_parse(jax_cli.get_parser(), argv))
    got = vars(parse_args_with_config(port_cli.get_parser(), argv))
    assert {k: got[k] for k in ref} == ref and got["temps"] == "0.5"
    assert got["decoding_steps"] == "49-25" and got["cfg_scales"] == 3.0
    bad = tmp_path / "bad.yaml"
    bad.write_text("dataset: folder\nnot_an_option: 1\n")
    with pytest.raises(ValueError, match="unknown config keys"):
        parse_args_with_config(port_cli.get_parser(), ["--fm_ckpt", "x", "--config", str(bad)])


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 1, 3), (224, 224, 3)])
def test_png_writer_pixels_equal_pil(shape, tmp_path):
    arr = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    port_cli.write_png(str(tmp_path / "p.png"), arr)
    Image.fromarray(arr).save(str(tmp_path / "q.png"))
    a, b = Image.open(tmp_path / "p.png"), Image.open(tmp_path / "q.png")
    assert a.mode == b.mode and a.size == b.size
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(a), arr)


# ------------------------------------------------------------- both CLIs

MODS = ("rgb@224", "tok_rgb@224", "tok_clip@224", "caption")
DEC_MODS = ("tok_rgb@224", "tok_clip@224", "caption")
META = {"domains_in": list(MODS), "domains_out": list(DEC_MODS), "dim": 64,
        "encoder_depth": 2, "decoder_depth": 2, "num_heads": 4, "mlp_ratio": 4.0,
        "qkv_bias": False, "proj_bias": False, "mlp_bias": False, "norm_bias": False,
        "act_layer": "SiLU", "gated_mlp": True, "qk_norm": True,
        "share_modality_embeddings": False}
VQ_CFG = dict(image_size=224, patch_size=16, enc_type="vit_t_enc", dec_type="vit_t_dec",
              codebook_size=16384, latent_dim=8, domain="rgb")
# per dataset: conditioning, targets and the schedule (temperature 0)
RUNS = {
    "prompts": ["--cond_domains", "caption", "--target_domains", "tok_rgb@224",
                "--autoregression_schemes", "maskgit", "--decoding_steps", "3",
                "--token_decoding_schedules", "cosine", "--cfg_scales", "2.0"],
    "folder": ["--cond_domains", "rgb@224", "--target_domains", "tok_clip@224-caption",
               "--autoregression_schemes", "roar-autoregressive", "--decoding_steps", "1-1",
               "--tokens_per_target", "196-12", "--cfg_scales", "1.5-1.0"],
    "empty": ["--cond_domains", "", "--target_domains", "tok_rgb@224-caption",
              "--autoregression_schemes", "maskgit-autoregressive", "--decoding_steps", "2-1",
              "--tokens_per_target", "196-10", "--cfg_scales", "1.0"],
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cfg = jck.fourm_config_from_metadata(META)
    jm = JaxFourM(cfg)
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(MODS, 1, 32, 32))
    variables = init_variables(jm, 11, batch, 32, 32)
    fm = str(d / "fm.safetensors")
    st_save_numpy({k: np.ascontiguousarray(v, np.float32)
                   for k, v in jck.export_fourm_torch_state(variables, cfg).items()},
                  fm, metadata={"config": str(META)})
    vq_kw = {k: v for k, v in VQ_CFG.items() if k != "domain"}
    vq_vars = init_variables(JaxVQVAE(**vq_kw), 12, jnp.zeros((1, 224, 224, 3)))
    tok_rgb = str(d / "rgb.safetensors")
    jck.export_vq_safetensors(vq_vars, VQ_CFG, tok_rgb)
    (d / "corpus.txt").write_text("a photo of a cat and a dog on the grass\n" * 100)
    tok = train_unified_wordpiece_tokenizer(str(d / "corpus.txt"), vocab_size=300,
                                            sentinel_tokens=generate_sentinel_tokens(num=20),
                                            show_progress=False)
    text_tok = str(d / "tokenizer.json")
    tok.save(text_tok)
    tsv = d / "prompts.tsv"
    tsv.write_text("Prompt\tCategory\na photo of a cat\tAnimals\na dog on the grass\tAnimals\n")
    img_dir = d / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(13)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (40 + 8 * i, 56, 3)).astype(np.uint8)).save(
            str(img_dir / f"img_{i}.png"))
    return {"fm": fm, "tok_rgb": tok_rgb, "text": text_tok, "tsv": str(tsv),
            "images": str(img_dir)}


def _argv(files, dataset, out):
    return (["--fm_ckpt", files["fm"], "--text_tokenizer_path", files["text"],
             "--tokenizer", f"tok_rgb={files['tok_rgb']}", "--dataset", dataset,
             "--prompts_tsv", files["tsv"], "--data_path", files["images"],
             "--num_samples", "1", "--temps", "0.0", "--temp_schedules", "constant",
             "--detokenizer_steps", "2",
             "--output_dir", out, "--seed", "3"] + RUNS[dataset])


_JAX_INIT = jax_loader._init_variables


@pytest.mark.parametrize("dataset", sorted(RUNS))
def test_cli_saves_what_the_jax_cli_saves(files, dataset, tmp_path, monkeypatch):
    # the JAX loader's model.init only gives its importer the tree to fill
    # (every leaf of the file is present): its shapes suffice
    monkeypatch.setattr(jax_loader, "_init_variables",
                        lambda model, rngs=None: jax.eval_shape(lambda: _JAX_INIT(model, rngs)))
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli.main(_argv(files, dataset, jax_out))
    port_cli.main(_argv(files, dataset, port_out) + ["--device", "cpu"])
    names = sorted(os.listdir(jax_out))
    assert sorted(os.listdir(port_out)) == names
    assert any(n.endswith(".png") for n in names) and any(n.endswith(".npz") for n in names)
    for n in names:
        a, b = os.path.join(jax_out, n), os.path.join(port_out, n)
        if n.endswith(".npz"):
            ref, got = np.load(a), np.load(b)
            assert sorted(ref.files) == sorted(got.files)
            for k in ref.files:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{n} {k}")
        elif n.endswith(".txt"):
            with open(a) as fa, open(b) as fb:
                assert fb.read() == fa.read(), n
        else:
            ref, got = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
            assert ref.shape == got.shape == (224, 224, 3), n
            diff = np.abs(got - ref)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (n, diff.max(),
                                                                   (diff > 0).mean())
