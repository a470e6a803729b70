"""The VQControlNet tokenizer of the port (fourm_torch/vq/controlnet.py,
vq/vqvae.py:VQControlNet, controlnet_decode_tokens, get_image_tokenizer on
a ControlNet file, cli/train_vqcontrolnet) against the JAX package
(fourm_tpu) on the CPU, in fp32 at the tiny size of tests/test_controlnet.py
(vit_t encoder at 32 px, patch 4, 64 codes of 8; UNet width 32, mult
(1, 2), attention at level 1, 2 heads; VAE width 32, mult (1, 2); B = 2).

Every JAX leaf is redrawn from a seed (tests/_jax_leaves.py) before the
weights are carried across by from_jax_vq_variables: the JAX init leaves the
ResBlocks' output convolutions, every attention's proj_out, the branch's
residual taps and its conditioning embedding's output at zero, so that the
ControlNet branch adds exactly nothing and a port without it would pass.
JAX's random draws (the VAE sample, noise, timesteps, dead codes, the
condition dropout, the sampler's first latent) are fed to the port.

Held at atol 1e-5, rtol 1e-4: the decoder's conditional, unconditional,
cond_scale, cond_mask and prompt_emb paths; AutoencoderKL.encode (mean and
a fed sample) and decode; Token2VAE and .sample; the training forward
(prediction, code loss, the codebook after the EMA); controlnet_decode_tokens
at 3 DDIM steps without and with guidance 2; one cli.train_vqcontrolnet step
against the same step built from JAX's pieces (train_vqcontrolnet.py:
167-193): the loss and every gradient, the branch's parameters after the
clipped AdamW step within test_torch_vq_train.py's bound, every other
parameter bit for bit, with the attentions in one chunk of query rows and
in many (the chunk budget shrunk, as a full-width step splits them). Also:
spatial_attention over many chunks against plain autograd attention, the
trainable set against vqcontrolnet_trainable_mask,
controlnet_params_from_unet, a JAX export_vq_safetensors file read by
get_image_tokenizer (a VQControlNet, strict), the CLI as a subprocess (2
steps and an eval), and a latent side that the UNet's levels do not
divide, refused by both packages.
"""

import os
import subprocess
import sys

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _jax_leaves import init_variables, redraw
from fourm_tpu.utils import optim as joptim
from fourm_tpu.vq import Token2VAE as JaxToken2VAE
from fourm_tpu.vq import VQControlNet as JaxVQControlNet
from fourm_tpu.vq import controlnet_decode_tokens as jax_decode_tokens
from fourm_tpu.vq import controlnet_params_from_unet as jax_from_unet
from fourm_tpu.vq import vqcontrolnet_trainable_mask as jax_trainable_mask
from fourm_torch.cli import train_vqcontrolnet as cli
from fourm_torch.utils.checkpoint import from_jax_vq_variables
from fourm_torch.vq import controlnet
from fourm_torch.vq import (Token2VAE, VQControlNet, controlnet_decode_tokens,
                            controlnet_params_from_unet, get_image_tokenizer,
                            vqcontrolnet_trainable_mask)

ATOL, RTOL = 1e-5, 1e-4
B, S, SL, HQ = 2, 32, 16, 8
TINY = dict(image_size=S, patch_size=4, enc_type="vit_t_enc", codebook_size=64,
            latent_dim=8, model_channels=32, channel_mult=(1, 2), attention_levels=(1,),
            num_heads=2, context_len=4, context_dim=16, vae_base_channels=32,
            vae_ch_mult=(1, 2))
CFG = dict(TINY, cls_free_guidance_dropout=0.5, masked_cfg=True)
CLI_ARGS = ["--device", "cpu", "--dtype", "float32", "--input_size", str(S), "--patch_size",
            "4", "--enc_type", "vit_t_enc", "--codebook_size", "64", "--latent_dim", "8",
            "--model_channels", "32", "--channel_mult", "1", "2", "--attention_levels", "1",
            "--num_heads", "2", "--context_len", "4", "--context_dim", "16",
            "--vae_base_channels", "32", "--vae_ch_mult", "1", "2", "--masked_cfg",
            "--cls_free_guidance_dropout", "0.5", "--batch_size", str(B), "--warmup_steps", "0"]
LR = 1e-4 * B / 256.0


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(port, ref, what=""):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sub_rng(module, variables, key, path=None):
    """The key a module's make_rng("rng") gives first in an apply with
    rngs={"rng": key} (at the submodule `path`)."""
    def first(m):
        return (getattr(m, path) if path else m).make_rng("rng")

    return module.apply(variables, method=first, rngs={"rng": key})


def _cond_draws(jm, variables, key) -> dict:
    """JAX's draws of sample_cond_mask (vqvae.py:229-244) in a forward with
    rngs={"rng": key}, under the names DiVAE.forward takes."""
    rng_b, rng_n, rng_k = jax.random.split(_sub_rng(jm, variables, key), 3)
    n = HQ * HQ
    return {"cond_drop": np.asarray(jax.random.bernoulli(rng_b, jm.cls_free_guidance_dropout,
                                                         (B,))),
            "cond_k": np.asarray(jax.random.randint(rng_k, (B,), jm.masked_cfg_low, n + 1)),
            "cond_noise": np.asarray(jax.random.uniform(rng_n, (B, n)))}


def _quant_draws(jm, variables, key) -> dict:
    qkey = _sub_rng(jm, variables, key, "quantize")
    return {"expire_idx": np.asarray(jax.random.randint(qkey, (64,), 0, B * HQ * HQ))}


def _step_ref(jm, variables, x, key):
    """One JAX train_vqcontrolnet step (train_vqcontrolnet.py:167-193) with
    the CLI's defaults: the loss, the masked gradients, the codebook after
    the step, the parameters after the clipped, masked AdamW update, and
    the step's draws."""
    params, codebook = {"params": variables["params"]}, {"codebook": variables["codebook"]}
    trainable = jax_trainable_mask(params)
    sched = jm.noise_scheduler()
    rng_noise, rng_t, rng_q, rng_vae = jax.random.split(key, 4)
    batch = jnp.asarray(x)
    z = jm.apply({**params, **codebook}, batch, rng_vae, method="vae_encode")
    noise = jax.random.normal(rng_noise, z.shape, jnp.float32)
    t = jax.random.randint(rng_t, (B,), 0, 1000)
    noised = sched.add_noise(z.astype(jnp.float32), noise, t)

    def loss(p):
        (pred, _), mut = jm.apply({**p, **codebook}, batch, noised, t, train=True,
                                  mutable=["codebook"], rngs={"rng": rng_q})
        return jnp.mean(jnp.square(pred.astype(jnp.float32) - noise)), mut

    (rec, mut), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    grads = jax.tree.map(lambda g, m: g * m, grads, trainable)
    tx = joptim.create_optimizer(params, joptim.cosine_schedule(LR, 10, 0), weight_decay=0.01,
                                 clip_grad=1.0)

    def update(g, p):
        u = tx.update(g, tx.init(p), p)[0]
        return optax.apply_updates(p, jax.tree.map(lambda a, m: a * m, u, trainable))

    new_params = jax.jit(update)(grads, params)
    draws = {"vae_noise": np.asarray(jax.random.normal(rng_vae, z.shape, jnp.float32)),
             "noise": np.asarray(noise), "timesteps": np.asarray(t),
             **_quant_draws(jm, variables, rng_q), **_cond_draws(jm, variables, rng_q)}
    return dict(rec=rec, grads=grads["params"], new_params=new_params["params"],
                codebook=mut["codebook"], draws=draws)


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference of this file, computed once."""
    rs = np.random.RandomState(0)
    x = (rs.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    z = rs.randn(B, SL, SL, 4).astype(np.float32)
    q = rs.randn(B, HQ, HQ, 8).astype(np.float32)
    t = np.array([10, 640])
    mask = rs.rand(B, HQ, HQ) < 0.5
    prompt = rs.randn(B, 4, 16).astype(np.float32)
    jm = JaxVQControlNet(**CFG)
    v = init_variables(jm, 0, jnp.asarray(x), jnp.asarray(z), jnp.zeros((B,), jnp.int32),
                       method="init_all")
    out = dict(x=x, z=z, q=q, t=t, mask=mask, prompt=prompt, variables=v)

    def step(**kw):
        return np.asarray(jm.apply(v, jnp.asarray(z), jnp.asarray(t), jnp.asarray(q),
                                   method="denoise_step", **kw))

    out["paths"] = {"cond": step(), "uncond": step(unconditional=True),
                    "scale": step(cond_scale=0.5), "mask": step(cond_mask=jnp.asarray(mask)),
                    "prompt": step(prompt_emb=jnp.asarray(prompt))}
    key = jax.random.key(3)
    out["vae_mean"] = np.asarray(jm.apply(v, jnp.asarray(x), method="vae_encode"))
    out["vae_sample"] = np.asarray(jm.apply(v, jnp.asarray(x), key, method="vae_encode"))
    out["vae_noise"] = np.asarray(jax.random.normal(key, (B, SL, SL, 4), jnp.float32))
    out["vae_decode"] = np.asarray(jm.apply(v, jnp.asarray(z), method="vae_decode"))

    fkey = jax.random.key(4)
    (pred, code_loss), mut = jm.apply(v, jnp.asarray(x), jnp.asarray(z), jnp.asarray(t),
                                      train=True, mutable=["codebook"], rngs={"rng": fkey})
    draws = {**_quant_draws(jm, v, fkey), **_cond_draws(jm, v, fkey)}
    assert draws["cond_drop"].any()  # the condition dropout is exercised
    out["train"] = dict(pred=np.asarray(pred), code_loss=float(code_loss),
                        codebook=jax.tree.map(np.asarray, mut["codebook"]), draws=draws)

    tokens = jm.apply(v, jnp.asarray(x), method="tokenize")
    dkey = jax.random.key(5)
    out["tokens"] = np.asarray(tokens)
    out["decode_noise"] = np.asarray(jax.random.normal(jax.random.split(dkey)[1],
                                                       (B, SL, SL, 4), jnp.float32))
    out["decode"] = {g: np.asarray(jax_decode_tokens(jm, v, tokens, dkey, timesteps=3,
                                                     guidance_scale=g)) for g in (0.0, 2.0)}

    tm = JaxToken2VAE(in_channels=8, block_out_channels=(32, 64), layers_per_block=1)
    tv = {"params": redraw(jax.eval_shape(lambda: tm.init(jax.random.key(0), jnp.asarray(q)))[
        "params"], 7)}
    stats = tm.apply(tv, jnp.asarray(q))
    skey = jax.random.key(6)
    out["token2vae"] = dict(variables=tv, stats=np.asarray(stats),
                            sample=np.asarray(tm.sample(stats, rng=skey)),
                            noise=np.asarray(jax.random.normal(skey, (B, 16, 16, 4))))

    out["step"] = _step_ref(jm, v, x, jax.random.key(8))
    out["from_unet"] = jax.tree.map(np.asarray, jax_from_unet(v)["params"])
    out["mask_tree"] = jax.tree.map(
        lambda m, p: np.full(p.shape, float(m), np.float32),
        jax_trainable_mask({"params": v["params"]})["params"], v["params"])
    return out


def _port(r, **kw):
    model = VQControlNet(**dict(CFG, **kw), device="cpu")
    model.load_state_dict(from_jax_vq_variables(r["variables"]), strict=True)
    return model


@pytest.mark.parametrize("path", ["cond", "uncond", "scale", "mask", "prompt"])
def test_decoder_paths_equal_jax(ref, path):
    m = _port(ref)
    kw = {"cond": {}, "uncond": dict(unconditional=True), "scale": dict(cond_scale=0.5),
          "mask": dict(cond_mask=_t(ref["mask"])), "prompt": dict(prompt_emb=_t(ref["prompt"]))}
    with torch.no_grad():
        out = m.denoise_step(_t(ref["z"]), _t(ref["t"]), _t(ref["q"]), **kw[path])
    _close(out, ref["paths"][path], what=path)
    if path == "scale":  # the branch contributes: its scale moves the output
        assert np.abs(ref["paths"]["cond"] - ref["paths"]["scale"]).max() > 1e-2


def test_vae_equals_jax(ref):
    m = _port(ref)
    with torch.no_grad():
        _close(m.vae_encode(_t(ref["x"])), ref["vae_mean"], "mean")
        _close(m.vae_encode(_t(ref["x"]), _t(ref["vae_noise"])), ref["vae_sample"], "sample")
        _close(m.vae_decode(_t(ref["z"])), ref["vae_decode"], "decode")


def test_token2vae_equals_jax(ref):
    r = ref["token2vae"]
    m = Token2VAE(in_channels=8, block_out_channels=(32, 64), layers_per_block=1)
    m.load_state_dict(from_jax_vq_variables(r["variables"]), strict=True)
    with torch.no_grad():
        stats = m(_t(ref["q"]))
        _close(stats, r["stats"], "stats")
        _close(m.sample(stats, _t(r["noise"])), r["sample"], "sample")
        z = m.sample(stats)
    assert torch.equal(m.sample(z), z)  # 4 channels pass through


def test_train_forward_equals_jax(ref):
    r = ref["train"]
    m = _port(ref)
    draws = {k: _t(v) for k, v in r["draws"].items()}
    with torch.no_grad():
        pred, code_loss = m(_t(ref["x"]), _t(ref["z"]), _t(ref["t"]), train=True, draws=draws)
    _close(pred, r["pred"], "prediction")
    _close(code_loss, r["code_loss"], "code loss")
    for name in ("embed", "embed_avg", "cluster_size"):
        _close(getattr(m.quantize._codebook, name), r["codebook"]["quantize"][name], name)


@pytest.mark.parametrize("guidance", [0.0, 2.0])
def test_decode_tokens_equal_jax(ref, guidance):
    m = _port(ref)
    with torch.no_grad():
        img = controlnet_decode_tokens(m, _t(ref["tokens"]), timesteps=3,
                                       guidance_scale=guidance, noise=_t(ref["decode_noise"]))
    assert img.shape == (B, S, S, 3)
    _close(img, ref["decode"][guidance], what=f"guidance {guidance}")


# a chunk budget that splits the tiny model's attentions: a self-attention
# over 64 positions (B 2, 2 heads: 1 KB of logits a row) into 64 one-row
# chunks, a cross-attention into 4 keys into 5 chunks of 15 rows and one of 4
FEW_BYTES = 1000


@pytest.fixture(params=["whole", "chunked"])
def chunking(request, monkeypatch):
    """The attentions in one chunk of query rows, or in many; yields the
    chunk counts of the attention passes made (forward and backward)."""
    if request.param == "chunked":
        monkeypatch.setattr(controlnet, "_CHUNK_BYTES", FEW_BYTES)
    counts, split = [], controlnet._row_chunks

    def recorded(q, k):
        chunks = split(q, k)
        counts.append(len(chunks))
        return chunks

    monkeypatch.setattr(controlnet, "_row_chunks", recorded)
    yield request.param, counts


def test_spatial_attention_chunks_equal_plain(monkeypatch):
    """spatial_attention's forward and q / k / v gradients over many
    chunks of query rows (of unequal length) against plain autograd
    attention (fp32 logits and softmax), at fp32."""
    rs = np.random.RandomState(11)
    B, N, M, H, d = 2, 37, 29, 2, 8
    monkeypatch.setattr(controlnet, "_CHUNK_BYTES", 5 * B * H * M * 4)
    q, k, v = (rs.randn(B, n, H * d).astype(np.float32) for n in (N, M, M))
    g = torch.from_numpy(rs.randn(B, N, H * d).astype(np.float32))
    assert len(controlnet._row_chunks(_t(q).reshape(B, N, H, d).transpose(1, 2),
                                      _t(k).reshape(B, M, H, d).transpose(1, 2))) == 8
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = controlnet.spatial_attention(*ins, H)
    out.backward(g)
    ref = [_t(a).requires_grad_(True) for a in (q, k, v)]
    qh, kh, vh = (t.reshape(B, -1, H, d).transpose(1, 2) for t in ref)
    p = torch.softmax(qh @ kh.transpose(-1, -2) / d ** 0.5, dim=-1)
    want = (p @ vh).transpose(1, 2).reshape(B, N, H * d)
    want.backward(g)
    _close(out, want.detach().numpy(), "output")
    for name, a, b in zip("qkv", ins, ref):
        _close(a.grad, b.grad.numpy(), f"d{name}")


def test_cli_step_equals_jax(ref, chunking):
    """One Trainer.train_step against _step_ref: the loss, every gradient,
    the branch after AdamW within 2e-2 lr (2 lr where JAX's gradient is
    below 1e-6: test_torch_vq_train.py's bound, beyond the fp32 spacing),
    the other parameters bit for bit, the codebook after the EMA; with the
    attentions in one chunk and in many (the backward's dq rows written a
    chunk at a time, dk and dv summed over the chunks), as at full width."""
    mode, chunk_counts = chunking
    r = ref["step"]
    args = cli.get_parser().parse_args(CLI_ARGS + ["--total_steps", "10"])
    trainer = cli.Trainer(args, torch.device("cpu"))
    m = trainer.model
    m.load_state_dict(from_jax_vq_variables(ref["variables"]), strict=True)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    metrics = trainer.train_step(_t(ref["x"]), {k: _t(v) for k, v in r["draws"].items()})
    _close(metrics["loss"], r["rec"], "loss")
    grads = from_jax_vq_variables({"params": jax.tree.map(np.asarray, r["grads"])})
    new = from_jax_vq_variables({"params": jax.tree.map(np.asarray, r["new_params"])})
    moved = 0
    for name, p in m.named_parameters():
        if not name.startswith("decoder.controlnet."):
            assert p.grad is None and torch.equal(p, before[name]), name
            assert torch.equal(p, new[name]), name
            continue
        _close(p.grad, grads[name], what=f"grad {name}")
        want = new[name].numpy()
        err = np.abs(_np(p) - want) - np.spacing(np.abs(want))
        bound = np.where(np.abs(grads[name].numpy()) < 1e-6, 2 * LR, 2e-2 * LR)
        assert (err <= bound).all(), (name, float((err - bound).max()))
        moved += int(not torch.equal(p, before[name]))
    assert moved > 0
    for name in ("embed", "embed_avg", "cluster_size"):
        _close(getattr(m.quantize._codebook, name), r["codebook"]["quantize"][name], name)
    assert int(trainer.opt.count) == 1
    assert {n for n, _ in trainer.opt.named_params()} == vqcontrolnet_trainable_mask(m)
    assert chunk_counts and (min(chunk_counts) >= 5 if mode == "chunked"
                             else max(chunk_counts) == 1), chunk_counts


def test_trainable_set_equals_jax_mask(ref):
    mask = from_jax_vq_variables({"params": ref["mask_tree"]})
    m = _port(ref)
    want = {n for n, t in mask.items() if t.flatten()[0] == 1.0}
    assert vqcontrolnet_trainable_mask(m) == want
    assert want and all(n.startswith("decoder.controlnet.") for n in want)
    assert set(mask) == {n for n, _ in m.named_parameters()}


def test_controlnet_from_unet_equals_jax(ref):
    m = controlnet_params_from_unet(_port(ref))
    want = from_jax_vq_variables({"params": ref["from_unet"]})
    copied = 0
    for name, p in m.named_parameters():
        assert torch.equal(p, want[name]), name
        copied += name.startswith(("decoder.controlnet.time_embed.",
                                   "decoder.controlnet.encoder."))
    assert copied > 0


def test_jax_export_read_by_get_image_tokenizer(ref, tmp_path):
    from fourm_tpu.utils.checkpoint import export_vq_safetensors

    path = str(tmp_path / "cn.safetensors")
    config = dict(CFG, channel_mult=[1, 2], attention_levels=[1], vae_ch_mult=[1, 2],
                  domain="rgb")
    export_vq_safetensors({"params": ref["variables"]["params"],
                           "codebook": ref["variables"]["codebook"]}, config, path)
    model, none = get_image_tokenizer(path, verbose=False, device="cpu")
    assert isinstance(model, VQControlNet) and none is None
    want = from_jax_vq_variables(ref["variables"])
    got = model.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    with torch.no_grad():
        out = model.denoise_step(_t(ref["z"]), _t(ref["t"]), _t(ref["q"]))
    _close(out, ref["paths"]["cond"], "loaded model")


def test_cli_subprocess(tmp_path):
    out = tmp_path / "run"
    argv = CLI_ARGS + ["--synthetic_data", "--total_steps", "2", "--eval_freq", "2",
                       "--eval_timesteps", "2", "--print_freq", "1", "--output_dir", str(out)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "fourm_torch.cli.train_vqcontrolnet"] + argv,
                         capture_output=True, text=True, cwd=root, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    log = open(out / "log.txt").read().splitlines()
    assert sum('"rec"' in line for line in log) == 2
    assert sum('"eval_mse"' in line for line in log) == 1
    assert (out / "checkpoints" / "step_2" / "state.pt").is_file()
    model, _ = get_image_tokenizer(str(out / "tokenizer.safetensors"), verbose=False,
                                   device="cpu")
    assert isinstance(model, VQControlNet)


def test_refused_latent_shape():
    """A 12 px image through a 2x VAE gives a latent of 6, which three UNet
    levels take down to 3 and 2 and back up to 4 against a skip of 3."""
    kw = dict(TINY, image_size=12, channel_mult=(1, 1, 1))
    jm = JaxVQControlNet(**kw)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0), "rng": jax.random.key(1)},
            jnp.zeros((1, 12, 12, 3)), jnp.zeros((1, 6, 6, 4)), jnp.zeros((1,), jnp.int32),
            method="init_all"))
    with pytest.raises(ValueError, match="latent size 6 is not a multiple of 4"):
        VQControlNet(**kw, device="cpu")


def test_entry_points_need_the_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        VQControlNet(**TINY)
    argv = [a for a in CLI_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv + ["--synthetic_data", "--output_dir", str(tmp_path / "run")])


def test_chip_script_imports_no_jax():
    """scripts/chip_controlnet.py runs on the machine with the card, which
    has no JAX: it imports none of it, nor the JAX package (the port's files
    are walked by tests/test_torch_generation.py)."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = ast.parse(open(os.path.join(root, "scripts", "chip_controlnet.py")).read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m.split(".")[0] for m in mods} & {"jax", "flax", "optax", "fourm_tpu", "yaml",
                                                   "safetensors"}, mods
