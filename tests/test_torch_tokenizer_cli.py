"""The tokenizer stage's entry points in the port, on the CPU
(`--device cpu`, fp32, vit_t / 32 px: patch 4, 64 codes of 8, B = 2):

  * `python -m fourm_torch.cli.train_vqvae` (main): a VQ-VAE (LPIPS loss,
    its eval with the VGG FID) and a DiVAE (UViT, v-prediction), 2 steps
    each on synthetic batches, finite losses, checkpoints and the exported
    tokenizer; a semseg VQ-VAE 2 steps from a seeded folder of palette
    PNGs (SemsegTransform, a random crop); a run of 3 steps equal, bit for
    bit, to 2 steps and a resumed third;
  * the weights across: the CLI's export read back by get_image_tokenizer
    (full and encoder only) equal to the trained model, the codebook's EMA
    state included; a release-layout file without that state loads with
    JAX's init (embed_avg = embed, cluster_size 0, initted 1);
  * LPIPS and InceptionV3 (one forward at B = 2 at 75 px, the smallest
    input the trunk takes, and `preprocess` resizing up and down) loading
    one seeded reference-format state dict in both packages, and
    `ms_ssim`, `frechet_distance`, `inception_score`, `binary_iou`
    against the JAX package's;
  * `save_vq_tokens`' tokens equal to JAX's `tokenize_folder` given the
    same in-memory weights and the same crop-settings directory; a second
    run skips every file; a corrupt-samples log of 2 ids re-tokenizes
    exactly those, and an unreadable file is logged;
  * both entry points refuse to run without a card unless asked for the
    CPU.
"""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _jax_leaves import init_variables
from fourm_tpu.cli import save_vq_tokens as jsave
from fourm_tpu.vq import VQ as JaxVQ
from fourm_tpu.vq import inception as jinc
from fourm_tpu.vq import percept_losses as jpl
from fourm_torch.cli import save_vq_tokens as tsave
from fourm_torch.cli import train_vqvae as tcli
from fourm_torch.utils.checkpoint import (from_jax_vq_variables, load_checkpoint,
                                          load_safetensors, save_safetensors)
from fourm_torch.vq import VQ, get_image_tokenizer
from fourm_torch.vq import inception as tinc
from fourm_torch.vq import percept_losses as tpl

TINY = ["--device", "cpu", "--dtype", "float32", "--input_size", "32", "--patch_size", "4",
        "--enc_type", "vit_t_enc", "--latent_dim", "8", "--codebook_size", "64", "--post_mlp",
        "--batch_size", "2", "--print_freq", "1", "--fid_extractor", "none"]


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The CLI runs this file reads, made once."""
    root = tmp_path_factory.mktemp("tok")
    out = {}
    vq = str(root / "vqvae")
    out["vqvae"] = tcli.main(TINY + [
        "--synthetic_data", "--dec_type", "vit_t_dec", "--total_steps", "2", "--eval_freq", "2",
        "--save_ckpt_freq", "1", "--percept_loss_weight", "0.1", "--fid_extractor", "vgg",
        "--model_ema", "--output_dir", vq]), vq
    dv = str(root / "divae")
    out["divae"] = tcli.main(TINY + [
        "--synthetic_data", "--model_type", "divae", "--dec_type", "uvit_t_p4_f16",
        "--total_steps", "2", "--save_ckpt_freq", "2", "--output_dir", dv]), dv
    data = root / "data"
    rng = np.random.default_rng(3)
    (data / "semseg_coco" / "c").mkdir(parents=True)
    for i in range(4):
        h, w = (int(v) for v in rng.integers(36, 60, 2))
        img = Image.fromarray(rng.integers(0, 6, (h, w)).astype(np.uint8), mode="P")
        img.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
        img.save(data / "semseg_coco" / "c" / f"{i}.png")
    sem = str(root / "semseg")
    out["semseg"] = tcli.main(TINY + [
        "--data_path", str(data), "--domain", "semseg_coco", "--n_labels", "7",
        "--loss_fn", "cross_entropy", "--dec_type", "vit_t_dec", "--total_steps", "2",
        "--eval_freq", "2", "--output_dir", sem]), sem
    resume = ["--synthetic_data", "--dec_type", "vit_t_dec", "--save_ckpt_freq", "2",
              "--seed", "5"]
    full, part = str(root / "full"), str(root / "part")
    tcli.main(TINY + resume + ["--total_steps", "3", "--output_dir", full])
    tcli.main(TINY + resume + ["--total_steps", "2", "--output_dir", part])
    out["resumed"] = tcli.main(TINY + resume + ["--total_steps", "3", "--output_dir", part])
    out["full"], out["part"] = full, part
    return out


@pytest.mark.parametrize("kind", ["vqvae", "divae", "semseg"])
def test_train_cli_runs(runs, kind):
    trainer, out = runs[kind]
    log = _log(out)
    losses = [r["loss"] for r in log if "loss" in r]
    assert [r["step"] for r in log if "loss" in r] == [0, 1]
    assert all(np.isfinite(losses))
    assert os.path.isfile(os.path.join(out, "checkpoints", "step_2", "state.pt"))
    assert int(trainer.opt.count) == 2
    if kind != "divae":  # the eval of a VQ-VAE
        ev = [r for r in log if "eval_psnr" in r]
        assert len(ev) == 1 and np.isfinite(ev[0]["eval_psnr"])
        assert 0 < ev[0]["eval_codebook_usage"] <= 1
    if kind == "vqvae":
        assert {"eval_lpips", "eval_vgg_fid", "eval_ms_ssim"} <= set(ev[0])
        assert os.path.isfile(os.path.join(out, "tokenizer_ema.safetensors"))
        # steps 1 and 2 both checkpointed (--save_ckpt_freq 1), the newest kept
        assert os.path.isdir(os.path.join(out, "checkpoints", "step_1"))


def test_resume_is_bit_for_bit(runs):
    a = load_checkpoint(os.path.join(runs["full"], "checkpoints"), 3)
    b = load_checkpoint(os.path.join(runs["part"], "checkpoints"), 3)
    assert a["step"] == b["step"] == 3
    for group in ("params", "codebook", "ema_params"):
        if a[group] is None:
            continue
        for k, v in a[group].items():
            assert torch.equal(v, b[group][k]), (group, k)
    for k in ("mu", "nu"):
        for name, v in a["opt_state"][k].items():
            assert torch.equal(v, b["opt_state"][k][name]), (k, name)
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 3


@pytest.mark.parametrize("kind", ["vqvae", "divae"])
def test_export_reads_back(runs, kind):
    trainer, out = runs[kind]
    path = os.path.join(out, "tokenizer.safetensors")
    model, _ = get_image_tokenizer(path, verbose=False, device="cpu",
                                   config_override={"dtype": "float32"})
    assert type(model).__name__ == type(trainer.model).__name__
    want = trainer.model.state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    enc, _ = get_image_tokenizer(path, encoder_only=True, verbose=False, device="cpu",
                                 config_override={"dtype": "float32"})
    x = torch.rand(2, 32, 32, 3) * 2 - 1
    with torch.no_grad():
        assert torch.equal(enc.tokenize(x), trainer.model.tokenize(x))


def test_release_file_without_ema_state(runs, tmp_path):
    _, out = runs["vqvae"]
    state, meta = load_safetensors(os.path.join(out, "tokenizer.safetensors"))
    lean = {k: v for k, v in state.items()
            if not k.endswith(("embed_avg", "cluster_size", "initted"))}
    path = str(tmp_path / "release.safetensors")
    save_safetensors(lean, path, metadata={"config": json.dumps(meta["config"])})
    model, _ = get_image_tokenizer(path, verbose=False, device="cpu")
    cb = model.quantize._codebook
    assert torch.equal(cb.embed, state["quantize._codebook.embed"])
    assert torch.equal(cb.embed_avg, cb.embed)
    assert not cb.cluster_size.any() and float(cb.initted) == 1.0


# ------------------------------------------------------------ percept / FID

def _seeded_state(model: torch.nn.Module, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            out[k] = (0.5 + rng.rand(*shape)).astype(np.float32)
        elif len(shape) >= 2:
            out[k] = (rng.randn(*shape) * np.prod(shape[1:]) ** -0.5).astype(np.float32)
        else:
            out[k] = (0.1 * rng.randn(*shape) + (k.endswith("bn.weight"))).astype(np.float32)
    return out


def _jax_import(module, importer, state, x):
    """What the JAX loader gives (load_lpips / load_inception: init, then
    the importer), the init's arrays drawn from its shapes alone."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *x))
    return importer(state, jax.tree.map(lambda t: np.zeros(t.shape, t.dtype), shapes))


def test_lpips_equals_jax(tmp_path):
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **_seeded_state(tpl.LPIPS(), 80))
    jm = jpl.LPIPS()
    x0 = jnp.zeros((1, 32, 32, 3))
    jvars = _jax_import(jm, jpl.import_lpips_state, dict(np.load(path)), (x0, x0))
    pm = tpl.load_lpips(path, device="cpu")
    rng = np.random.RandomState(81)
    a, b = (rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    want = jm.apply(jvars, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = pm(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    fa, fb = rng.randn(2, 5, 7).astype(np.float32), rng.randn(2, 5, 7).astype(np.float32)
    for loss in ("cosine", "l1"):
        np.testing.assert_allclose(
            tpl.feature_perceptual_loss([torch.from_numpy(fa)], [torch.from_numpy(fb)],
                                        loss).numpy(),
            np.asarray(jpl.feature_perceptual_loss([jnp.asarray(fa)], [jnp.asarray(fb)], loss)),
            rtol=1e-5)


def test_inception_equals_jax(tmp_path):
    path = str(tmp_path / "inception.npz")
    np.savez(path, **_seeded_state(tinc.InceptionV3(), 90))
    jm = jinc.InceptionV3()
    jvars = _jax_import(jm, jinc.import_inception_state, dict(np.load(path)),
                        (jnp.zeros((1, 299, 299, 3)),))
    pm = tinc.load_inception(path, device="cpu")
    x = np.random.RandomState(91).rand(2, 75, 75, 3).astype(np.float32) * 2 - 1
    jf, jl = jax.jit(jm.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        pf, plog = pm(torch.from_numpy(x))
    for got, want in ((pf, jf), (plog, jl)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
    img = np.random.RandomState(92).rand(2, 20, 24, 3).astype(np.float32)
    for size in (37, 11):  # up and down (antialiased)
        np.testing.assert_allclose(tinc.preprocess(torch.from_numpy(img), size).numpy(),
                                   np.asarray(jinc.preprocess(jnp.asarray(img), size)),
                                   atol=1e-5)


def test_metrics_equal_jax():
    rng = np.random.RandomState(95)
    a = rng.rand(2, 180, 180, 3) * 2 - 1
    b = np.clip(a + 0.2 * rng.randn(*a.shape), -1, 1)
    assert tpl.ms_ssim(a, b) == jpl.ms_ssim(a, b)
    fr, ff = rng.randn(40, 6), rng.randn(40, 6) + 0.3
    assert tpl.frechet_distance(fr, ff) == jpl.frechet_distance(fr, ff)
    probs = rng.dirichlet(np.ones(10), 30)
    assert tpl.inception_score(probs, 3) == jpl.inception_score(probs, 3)
    assert tpl.binary_iou(a > 0, b > 0) == jpl.binary_iou(a > 0, b > 0)


# ----------------------------------------------------------- save_vq_tokens

def test_save_vq_tokens_equals_jax(tmp_path):
    rng = np.random.default_rng(100)
    root = tmp_path / "data"
    (root / "rgb" / "c").mkdir(parents=True)
    for i in range(5):
        h, w = (int(v) for v in rng.integers(40, 70, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / "rgb" / "c" / f"{i}.png")
    kw = dict(image_size=32, patch_size=4, enc_type="vit_t_enc", latent_dim=8,
              codebook_size=64, post_mlp=True)
    jm = JaxVQ(**kw)
    variables = init_variables(jm, 101, jnp.zeros((1, 32, 32, 3)))
    pm = VQ(**kw, device="cpu")
    pm.load_state_dict(from_jax_vq_variables(variables), strict=True)
    cs = str(tmp_path / "crops")
    out_j, out_p = str(tmp_path / "tok_j"), str(tmp_path / "tok_p")
    assert tsave.tokenize_folder(pm, str(root), "rgb", out_p, input_size=32, n_crops=3,
                                 crop_settings_dir=cs, seed=7) == 5
    assert jsave.tokenize_folder(jm, variables, str(root), "rgb", out_j, input_size=32,
                                 n_crops=3, crop_settings_dir=cs) == 5
    for i in range(5):
        got = np.load(os.path.join(out_p, "c", f"{i}.npy"))
        want = np.load(os.path.join(out_j, "c", f"{i}.npy"))
        assert got.dtype == want.dtype == np.int16 and got.shape == (3, 64)
        np.testing.assert_array_equal(got, want)
    stamp = {i: os.path.getmtime(os.path.join(out_p, "c", f"{i}.npy")) for i in range(5)}
    assert tsave.tokenize_folder(pm, str(root), "rgb", out_p, input_size=32,
                                 crop_settings_dir=cs) == 0  # every file exists
    log = str(tmp_path / "corrupt.txt")
    with open(log, "w") as f:
        f.write("c/1\nc/3\n")
    os.remove(os.path.join(out_p, "c", "1.npy"))
    assert tsave.tokenize_folder(pm, str(root), "rgb", out_p, input_size=32,
                                 crop_settings_dir=cs, corrupt_samples_log=log) == 2
    for i in (0, 2, 4):
        assert os.path.getmtime(os.path.join(out_p, "c", f"{i}.npy")) == stamp[i]
    np.testing.assert_array_equal(np.load(os.path.join(out_p, "c", "1.npy")),
                                  np.load(os.path.join(out_j, "c", "1.npy")))
    with open(root / "rgb" / "c" / "5.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nbroken")
    log2 = str(tmp_path / "corrupt2.txt")
    assert tsave.tokenize_folder(pm, str(root), "rgb", out_p, input_size=32,
                                 crop_settings_dir=cs, corrupt_samples_log=log2) == 0
    assert open(log2).read() == "c/5\n"


def test_entry_points_need_a_card_or_cpu(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--synthetic_data", "--total_steps", "1"])
    _, ckpt = runs["vqvae"]  # a train_vqvae output directory
    (tmp_path / "rgb" / "c").mkdir(parents=True)
    Image.fromarray(np.zeros((40, 48, 3), np.uint8)).save(tmp_path / "rgb" / "c" / "0.png")
    argv = ["--data_root", str(tmp_path), "--out_dir", str(tmp_path / "tok"), "--ckpt", ckpt,
            "--input_size", "32"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tsave.main(argv)
    assert tsave.main(argv + ["--device", "cpu", "--dtype", "float32"]) == 1
    assert np.load(tmp_path / "tok" / "c" / "0.npy").shape == (3, 64)
