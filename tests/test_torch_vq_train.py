"""Tokenizer training in the port (fourm_torch/vq: the quantizer's training
side, Memcodes, the training forwards of VQVAE and DiVAE; cli/train_vqvae's
step) against the JAX package (fourm_tpu) on the CPU, in fp32 at vit_t /
32 px size (patch 4, 64 codes of 8, B = 2), with the weights carried
across by from_jax_vq_variables and JAX's random draws fed to the port.

  * VectorQuantize(train=True), Euclidean and cosine, dead-code expiry by
    batch_random and linde_buzo_gray: quantize, indices, the commitment +
    orthogonal loss, the gradient through the straight-through estimator,
    and the codebook's embed / embed_avg / cluster_size after the EMA;
  * kmeans (N >= K and N < K, both metrics) given the same first means,
    gumbel_sample given the same uniforms (indices exact), the orthogonal
    loss;
  * one cli.train_vqvae step of a VQ-VAE (ViT decoder, post-MLP, MSE) and
    of a DiVAE (UViT decoder, v-prediction; JAX's noise and timesteps
    fed): the loss, every gradient leaf and the codebook state to atol
    1e-5, rtol 1e-4, and the parameters after the clipped AdamW step
    within 2e-2 * lr of JAX's (Adam's first step divides each gradient by
    its own magnitude, so a gradient near zero may move its parameter by
    up to lr in either package), beyond the fp32 spacing of the parameter
    (each package rounds p - lr * u once, and at |p| ~ 0.25 one spacing,
    3e-8, is 0.04 lr); where JAX's gradient is below 1e-6, 100 times
    Adam's eps, within 2 lr: such a gradient is rounding noise (the
    attention's key bias, which the softmax cancels, has gradient 0 up to
    rounding), whose sign and size Adam's first step turns into a step of
    up to lr either way;
  * freeze_enc: JAX's encoder gradients are zero; the port's encoder is
    the same, bit for bit, after the step, its other leaves as above;
  * the AdamW decay mask equal to fourm_tpu.utils.optim.weight_decay_mask
    on the VQ tree, leaf for leaf;
  * Memcodes: eval and training outputs, indices and gradients.
"""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _jax_leaves import init_variables
from fourm_tpu.utils import optim as joptim
from fourm_tpu.vq import DiVAE as JaxDiVAE
from fourm_tpu.vq import VQVAE as JaxVQVAE
from fourm_tpu.vq import quantizer as jq
from fourm_tpu.vq.memcodes import Memcodes as JaxMemcodes
from fourm_torch.cli import train_vqvae as cli
from fourm_torch.utils.checkpoint import from_jax_vq_variables
from fourm_torch.utils.optim import weight_decay_mask
from fourm_torch.vq import quantizer as tq
from fourm_torch.vq.memcodes import Memcodes

ATOL, RTOL = 1e-5, 1e-4
B, S = 2, 32
TINY = dict(image_size=S, patch_size=4, enc_type="vit_t_enc", latent_dim=8, codebook_size=64,
            post_mlp=True)
CLI_ARGS = ["--device", "cpu", "--dtype", "float32", "--input_size", str(S), "--patch_size",
            "4", "--enc_type", "vit_t_enc", "--latent_dim", "8", "--codebook_size", "64",
            "--post_mlp", "--batch_size", str(B), "--total_steps", "10", "--warmup_steps", "0"]
LR = 1e-4 * B / 256.0


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(port, ref, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32), atol=atol, rtol=rtol,
                               err_msg=what)


def _sub_rng(module, variables, key, path=None):
    """The key a module's make_rng("rng") gives first in an apply with
    rngs={"rng": key} (at the submodule `path`)."""
    def first(m):
        return (getattr(m, path) if path else m).make_rng("rng")

    return module.apply(variables, method=first, rngs={"rng": key})


# ------------------------------------------------------------- the quantizer

QUANT_CASES = [(cos, pol) for cos in (False, True) for pol in ("batch_random", "linde_buzo_gray")]


def _quant_ref(cos, pol, seed):
    jm = jq.VectorQuantize(dim=8, codebook_size=64, decay=0.8, use_cosine_sim=cos,
                           threshold_ema_dead_code=0.5, code_replacement_policy=pol,
                           commitment_weight=1.0, orthogonal_reg_weight=0.1)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 16, 8).astype(np.float32)
    g = rng.randn(B, 16, 8).astype(np.float32)
    embed = rng.randn(64, 8).astype(np.float32)
    cb = {"embed": embed / np.linalg.norm(embed, axis=1, keepdims=True),
          "embed_avg": rng.randn(64, 8).astype(np.float32),
          "cluster_size": np.abs(rng.randn(64)).astype(np.float32),  # some above the threshold
          "initted": np.float32(1.0)}
    variables = {"codebook": cb}
    key = jax.random.key(seed)

    def f(xx):
        (q, ind, loss), mut = jm.apply(variables, xx, train=True, mutable=["codebook"],
                                       rngs={"rng": key})
        return loss + jnp.sum(q * g), (q, ind, loss, mut["codebook"])

    (_, (q, ind, loss, new_cb)), gx = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(x))
    qkey = _sub_rng(jm, variables, key)
    draws = {"expire_idx": np.asarray(jax.random.randint(qkey, (64,), 0, B * 16)),
             "expire_noise": np.asarray(jax.random.normal(qkey, (64, 8), jnp.float32))}
    return dict(x=x, g=g, cb=cb, q=q, ind=ind, loss=loss, new_cb=new_cb, gx=gx, draws=draws)


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference of this file, computed once."""
    out = {("quant",) + c: _quant_ref(*c, seed=i) for i, c in enumerate(QUANT_CASES)}
    out["vqvae"] = _step_ref("vqvae", dict(TINY, dec_type="vit_t_dec"), 40)
    out["divae"] = _step_ref("divae", dict(TINY, dec_type="uvit_t_p4_f16",
                                           prediction_type="v_prediction",
                                           beta_schedule="squaredcos_cap_v2"), 41)
    out["frozen"] = _step_ref("vqvae", dict(TINY, dec_type="vit_t_dec", freeze_enc=True), 42)
    return out


@pytest.mark.parametrize("cos,pol", QUANT_CASES)
def test_quantizer_train_equals_jax(ref, cos, pol):
    r = ref[("quant", cos, pol)]
    pm = tq.VectorQuantize(8, 64, use_cosine_sim=cos, decay=0.8, threshold_ema_dead_code=0.5,
                           code_replacement_policy=pol, commitment_weight=1.0,
                           orthogonal_reg_weight=0.1)
    pm._codebook.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in r["cb"].items()})
    x = torch.tensor(r["x"], requires_grad=True)
    draws = {k: torch.from_numpy(v) for k, v in r["draws"].items()}
    q, ind, loss = pm(x, train=True, draws=draws)
    (loss + (q * torch.from_numpy(r["g"])).sum()).backward()
    assert torch.equal(ind, torch.from_numpy(np.asarray(r["ind"])).long())
    _close(q, r["q"], what="quantize")
    _close(loss, r["loss"], what="loss")
    _close(x.grad, r["gx"], what="dL/dx")
    for name in ("embed", "embed_avg", "cluster_size"):
        _close(getattr(pm._codebook, name), r["new_cb"][name], what=name)
    expired = (np.asarray(r["new_cb"]["cluster_size"]) < 0.5)
    assert expired.any() and not expired.all()  # both kinds of code are held


@pytest.mark.parametrize("cos", [False, True])
@pytest.mark.parametrize("n", [200, 40])
def test_kmeans_equals_jax(cos, n):
    rng = np.random.RandomState(50 + n)
    samples = rng.randn(n, 8).astype(np.float32)
    if cos:
        samples = samples / np.linalg.norm(samples, axis=1, keepdims=True)
    k, key = (16 if n >= 64 else 64), jax.random.key(n)
    means, bins = jq.kmeans(key, jnp.asarray(samples), k, use_cosine_sim=cos)
    init = (jax.random.permutation(key, n)[:k] if n >= k else
            jax.random.randint(key, (k,), 0, n))
    pm, pb = tq.kmeans(torch.from_numpy(samples), k, use_cosine_sim=cos,
                       init_idx=torch.from_numpy(np.asarray(init)).long())
    _close(pm, means, what="means")
    np.testing.assert_array_equal(_np(pb), np.asarray(bins))


def test_gumbel_and_orthogonal_equal_jax():
    rng = np.random.RandomState(60)
    logits = rng.randn(32, 64).astype(np.float32)
    key = jax.random.key(61)
    for temp in (0.0, 0.7):
        want = jq.gumbel_sample(key, jnp.asarray(logits), temp)
        u = jax.random.uniform(key, logits.shape, minval=1e-20, maxval=1.0)
        got = tq.gumbel_sample(torch.from_numpy(logits), temp,
                               uniform=torch.from_numpy(np.asarray(u)))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    codes = rng.randn(64, 8).astype(np.float32)
    _close(tq.orthogonal_loss_fn(torch.from_numpy(codes)), jq.orthogonal_loss_fn(
        jnp.asarray(codes)))


# ------------------------------------------------------------------ a step

def _step_ref(kind, kw, seed):
    """One JAX train_vqvae step (train_vqvae.py:273-325) of a fresh tree:
    the loss, the gradients, the codebook after the step, the parameters
    after the clipped AdamW update, and the step's draws."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    is_divae = kind == "divae"
    jm = (JaxDiVAE if is_divae else JaxVQVAE)(**kw)
    args = (jnp.asarray(x),) + ((jnp.asarray(x), jnp.zeros((B,), jnp.int32)) if is_divae else ())
    variables = init_variables(jm, seed, *args)
    params, codebook = {"params": variables["params"]}, {"codebook": variables["codebook"]}
    key = jax.random.key(seed)
    rng_noise, rng_t, rng_q = jax.random.split(key, 3)
    batch = jnp.asarray(x)
    noise = jax.random.normal(rng_noise, batch.shape, jnp.float32)
    t = jax.random.randint(rng_t, (B,), 0, 1000)

    def loss(p):
        if is_divae:
            sched = jm.noise_scheduler()
            noised = sched.add_noise(batch, noise, t)
            (pred, code_loss), mut = jm.apply({**p, **codebook}, batch, noised, t, train=True,
                                              mutable=["codebook"], rngs={"rng": rng_q})
            target = sched.get_velocity(batch, noise, t)
        else:
            (pred, code_loss), mut = jm.apply({**p, **codebook}, batch, train=True,
                                              mutable=["codebook"], rngs={"rng": rng_q})
            target = batch
        rec = jnp.mean(jnp.square(pred.astype(jnp.float32) - target))
        return rec + code_loss, mut

    (total, mut), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tx = joptim.create_optimizer(params, joptim.cosine_schedule(LR, 10, 0), weight_decay=0.05,
                                 clip_grad=1.0)
    new_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        grads, params)
    qkey = _sub_rng(jm, {**params, **codebook}, rng_q, "quantize")
    draws = {"expire_idx": np.asarray(jax.random.randint(qkey, (64,), 0, B * 64))}
    if is_divae:
        draws.update(noise=np.asarray(noise), timesteps=np.asarray(t))
    np_tree = jax.tree.map(np.asarray, {"params": variables["params"],
                                        "codebook": variables["codebook"]})
    mask = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                        joptim.weight_decay_mask(params)["params"], params["params"])
    return dict(x=x, kw=kw, variables=np_tree, total=total, grads=grads["params"],
                new_params=new_params["params"], codebook=mut["codebook"], draws=draws,
                mask=mask)


def _port_step(r, kind, extra=()):
    flags = CLI_ARGS + ["--model_type", kind, "--dec_type", r["kw"]["dec_type"]] + list(extra)
    if kind == "divae":
        flags += ["--prediction_type", "v_prediction", "--beta_schedule", "squaredcos_cap_v2"]
    trainer = cli.Trainer(cli.get_parser().parse_args(flags), torch.device("cpu"))
    trainer.model.load_state_dict(from_jax_vq_variables(r["variables"]), strict=True)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    draws = {k: torch.from_numpy(v) for k, v in r["draws"].items()}
    metrics = trainer.train_step(torch.from_numpy(r["x"]), draws)
    return trainer, before, metrics


def _check_step(trainer, metrics, r, skip=()):
    m = trainer.model
    _close(metrics["loss"], r["total"], what="loss")
    grads = from_jax_vq_variables({"params": jax.tree.map(np.asarray, r["grads"])})
    new = from_jax_vq_variables({"params": jax.tree.map(np.asarray, r["new_params"])})
    for name, p in m.named_parameters():
        if name.startswith(skip):
            continue
        # a leaf the forward does not use (the UViT's mask token without a
        # condition mask) has no gradient in the port, zeros in JAX
        _close(torch.zeros_like(p) if p.grad is None else p.grad, grads[name],
               what=f"grad {name}")
        want = new[name].numpy()
        err = np.abs(_np(p) - want) - np.spacing(np.abs(want))
        bound = np.where(np.abs(grads[name].numpy()) < 1e-6, 2 * LR, 2e-2 * LR)
        assert (err <= bound).all(), (name, float((err - bound).max()))
    for name in ("embed", "embed_avg", "cluster_size"):
        _close(getattr(m.quantize._codebook, name), r["codebook"]["quantize"][name], what=name)


@pytest.mark.parametrize("kind", ["vqvae", "divae"])
def test_train_step_equals_jax(ref, kind):
    r = ref[kind]
    trainer, _, metrics = _port_step(r, kind)
    _check_step(trainer, metrics, r)
    assert int(trainer.opt.count) == 1


def test_freeze_enc(ref):
    r = ref["frozen"]
    enc = from_jax_vq_variables({"params": jax.tree.map(np.asarray, r["grads"])})
    for name, g in enc.items():  # JAX's stop-gradient: the encoder gets none
        if name.startswith("encoder."):
            assert not g.any(), name
    trainer, before, metrics = _port_step(r, "vqvae", ["--freeze_enc"])
    _check_step(trainer, metrics, r, skip=("encoder.",))
    for name, p in trainer.model.named_parameters():
        if name.startswith("encoder."):
            assert p.grad is None and torch.equal(p, before[name]), name


def test_decay_mask_equals_jax(ref):
    for kind in ("vqvae", "divae"):
        r = ref[kind]
        want = from_jax_vq_variables({"params": r["mask"]})
        trainer, _, _ = _port_step(r, kind)
        got = weight_decay_mask(trainer.model, vectors=False)
        assert set(got) == set(want)
        for name, decay in got.items():
            assert bool(want[name].flatten()[0]) == decay, name
            assert trainer.opt.decay[name] == decay


# ------------------------------------------------------------------ Memcodes

def test_memcodes_equal_jax():
    rng = np.random.RandomState(70)
    x = rng.randn(B, 12, 8).astype(np.float32)
    g = rng.randn(B, 12, 8).astype(np.float32)
    jm = JaxMemcodes(dim=8, codebook_size=16, heads=2)
    variables = init_variables(jm, 71, jnp.asarray(x))
    pm = Memcodes(8, 16, heads=2)
    pm.load_state_dict({k: torch.from_numpy(np.asarray(v))
                        for k, v in variables["params"].items()}, strict=True)
    out, ind, _ = jm.apply(variables, jnp.asarray(x))
    pout, pind, _ = pm(torch.from_numpy(x))
    _close(pout, out)
    np.testing.assert_array_equal(_np(pind), np.asarray(ind))
    _close(pm.indices_to_embedding(pind), jm.apply(variables, ind,
                                                   method="indices_to_embedding"))
    key = jax.random.key(72)

    def f(p, xx):
        o, i, _ = jm.apply(p, xx, train=True, rngs={"rng": key})
        return jnp.sum(o * g), (o, i)

    (_, (out, ind)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables, jnp.asarray(x))
    mkey = _sub_rng(jm, variables, key)
    u = jax.random.uniform(mkey, (B, 2, 12, 16), minval=1e-20, maxval=1.0)
    xt = torch.tensor(x, requires_grad=True)
    pout, pind, _ = pm(xt, train=True, uniform=torch.from_numpy(np.asarray(u)))
    (pout * torch.from_numpy(g)).sum().backward()
    _close(pout, out)
    np.testing.assert_array_equal(_np(pind), np.asarray(ind))
    _close(xt.grad, gx)
    for name, p in pm.named_parameters():
        _close(p.grad, gp["params"][name], what=name)
