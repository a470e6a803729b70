"""The port's diffusion decoding (fourm_torch.vq.scheduling, .unet, .uvit)
against the JAX package (fourm_tpu.vq) on the CPU, in fp32, with the same
weights (every leaf drawn from a seeded generator, tests/_jax_leaves.py,
then carried over by from_jax_vq_variables) and the same noise (the JAX
package's draws, its key splits repeated here, handed to the port's loops).

Tolerances: the schedule tables (alphas_cumprod, the spaced timesteps)
exactly; a scheduler step to 1e-6 of the largest value (fp32 scalars, the
same operations); the decoders to 1e-4 of the output's magnitude plus 1e-5
(their convolutions and attention sum in other orders than XLA's); the
sampling loops, which run the decoder at each step, to 1e-4 of the
magnitude likewise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_leaves import init_variables
from fourm_tpu.vq import scheduling as js
from fourm_tpu.vq.unet import PatchedUNetCondCat as JaxPatchedUNet
from fourm_tpu.vq.uvit import UVIT_PRESETS as JAX_UVIT_PRESETS
from fourm_tpu.vq.uvit import UViT as JaxUViT
from fourm_torch.utils.checkpoint import from_jax_vq_variables
from fourm_torch.vq import scheduling as ts
from fourm_torch.vq.layers import nearest_indices
from fourm_torch.vq.unet import PatchedUNetCondCat
from fourm_torch.vq.uvit import UVIT_PRESETS, UViT


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rel=1e-4):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, dtype=np.float32)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=rel * float(np.abs(ref).max()) + 1e-5, rtol=0)


SCHEDULES = [("linear", False), ("scaled_linear", False), ("squaredcos_cap_v2", True),
             ("squaredcos_cap_v2", False), ("linear", True), ("shifted_cosine:2.0", False)]


@pytest.mark.parametrize("schedule,ztsnr", SCHEDULES)
def test_schedule_tables_exact(schedule, ztsnr):
    a = ts.make_alphas_cumprod(1000, schedule, zero_terminal_snr=ztsnr)
    b = js.make_alphas_cumprod(1000, schedule, zero_terminal_snr=ztsnr)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    for mode in ("leading", "trailing", "linspace"):
        for n in (1, 3, 12, 25, 1000):
            np.testing.assert_array_equal(ts.spaced_timesteps(1000, n, mode, 1),
                                          js.spaced_timesteps(1000, n, mode, 1))


def test_nearest_indices_match_jax_resize():
    for n_in, n_out in ((32, 14), (14, 56), (4, 16), (7, 3), (5, 5)):
        x = np.arange(n_in, dtype=np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (n_out,), "nearest"))
        np.testing.assert_array_equal(x[nearest_indices(n_in, n_out)], ref)


@pytest.mark.parametrize("eps", [None, 1e-5])
def test_group_norm_matches_flax(eps):
    """The decoders' GroupNorm against flax's on activations whose group
    variance is near the epsilon, so the epsilon counts: the UNet's norms
    take flax's default (1e-6, unet.GN_EPS), the UViT's its norm_eps."""
    from flax import linen as fnn

    from fourm_torch.vq.layers import GroupNorm
    from fourm_torch.vq.unet import GN_EPS

    rng = np.random.RandomState(2)
    x = (rng.randn(2, 5, 5, 64) * 3e-3).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.randn(64)).astype(np.float32), rng.randn(64).astype(np.float32)
    kw = {} if eps is None else {"epsilon": eps}
    ref = fnn.GroupNorm(num_groups=32, **kw).apply({"params": {"scale": scale, "bias": bias}},
                                                  jnp.asarray(x))
    gn = GroupNorm(32, 64, GN_EPS if eps is None else eps)
    gn.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    with torch.no_grad():
        port = gn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


STEP_CASES = [  # (kind, prediction, thresholding, clip_sample, eta, t, prev_t)
    ("ddpm", "v_prediction", True, False, 0.0, 733, 499),
    ("ddpm", "sample", True, False, 0.0, 40, -1),
    ("ddpm", "epsilon", False, True, 0.0, 999, 958),
    ("ddpm", "sample", False, False, 0.0, 0, -1),
    ("ddim", "epsilon", False, True, 0.0, 800, 600),
    ("ddim", "v_prediction", True, False, 0.5, 600, 400),
    ("ddim", "sample", False, False, 1.0, 200, -50),
]


@pytest.mark.parametrize("kind,pred,thresh,clip,eta,t,prev_t", STEP_CASES)
def test_scheduler_step_matches_jax(kind, pred, thresh, clip, eta, t, prev_t):
    kw = dict(kind=kind, beta_schedule="squaredcos_cap_v2", prediction_type=pred,
              thresholding=thresh, clip_sample=clip, eta=eta, zero_terminal_snr=False)
    rng = np.random.RandomState(3)
    shape = (2, 8, 8, 3)
    out = (rng.randn(*shape) * 1.5).astype(np.float32)
    sample = (rng.randn(*shape) * 2.0).astype(np.float32)
    key = jax.random.key(7)
    noise = np.asarray(jax.random.normal(key, shape, jnp.float32))
    ref = js.DiffusionScheduler(**kw).step(jnp.asarray(out), jnp.asarray(t), jnp.asarray(prev_t),
                                           jnp.asarray(sample), key)
    port = ts.DiffusionScheduler(**kw).step(_t(out), t, prev_t, _t(sample), noise=_t(noise))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                               atol=1e-6 * float(np.abs(ref).max()), rtol=0)


def test_scheduler_training_helpers_match_jax():
    sch = dict(beta_schedule="squaredcos_cap_v2", zero_terminal_snr=True)
    rng = np.random.RandomState(4)
    x, n = rng.randn(3, 4, 4, 2).astype(np.float32), rng.randn(3, 4, 4, 2).astype(np.float32)
    t = np.array([0, 500, 999])
    for fn in ("add_noise", "get_velocity", "get_noise"):
        ref = getattr(js.DiffusionScheduler(**sch), fn)(jnp.asarray(x), jnp.asarray(n),
                                                        jnp.asarray(t))
        port = getattr(ts.DiffusionScheduler(**sch), fn)(_t(x), _t(n), _t(t))
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def _jax_sample_draws(key, shape, steps):
    """The JAX loop's draws: the initial sample, then one per step."""
    key, k0 = jax.random.split(key)
    draws = [jax.random.normal(k0, shape, jnp.float32)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape, jnp.float32))
    return [_t(np.asarray(d)) for d in draws]


def _toy_model(w):
    """A model function that depends on the sample, t and the condition."""
    def fn(noisy, t, cond, xp):
        return xp.tanh(noisy * w + cond) * (1.0 + t / 1000.0)
    return fn


@pytest.mark.parametrize("kind,cfg,rescale", [("ddpm", 3.0, 0.7), ("ddim", 2.0, 0.0),
                                              ("ddpm", 0.0, 0.0)])
def test_diffusion_sample_matches_jax(kind, cfg, rescale):
    shape, steps = (2, 6, 6, 3), 4
    sched = dict(kind=kind, beta_schedule="squaredcos_cap_v2", prediction_type="v_prediction",
                 thresholding=True, eta=0.3 if kind == "ddim" else 0.0)
    rng = np.random.RandomState(5)
    cond = rng.randn(*shape).astype(np.float32)
    fn = _toy_model(0.7)
    key = jax.random.key(11)
    ref = js.diffusion_sample(lambda x, t, c: fn(x, t, c, jnp), js.DiffusionScheduler(**sched),
                              key, jnp.asarray(cond), shape, timesteps=steps,
                              guidance_scale=cfg, guidance_rescale=rescale,
                              model_fn_uncond=lambda x, t, c: fn(x, t, 0.5 * c, jnp))
    n_steps = len(js.spaced_timesteps(1000, steps, "trailing"))
    draws = _jax_sample_draws(key, shape, n_steps)
    port = ts.diffusion_sample(lambda x, t, c: fn(x, t, c, torch), ts.DiffusionScheduler(**sched),
                               _t(cond), shape, timesteps=steps, guidance_scale=cfg,
                               guidance_rescale=rescale,
                               model_fn_uncond=lambda x, t, c: fn(x, t, 0.5 * c, torch),
                               noise=draws[0], step_noise=draws[1:])
    _close(port, ref)


@pytest.mark.parametrize("steps,pred", [(5, "epsilon"), (1, "v_prediction"), (3, "sample")])
def test_pndm_sample_matches_jax(steps, pred):
    shape = (2, 5, 5, 3)
    sched = dict(kind="pndm", beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012,
                 prediction_type=pred, zero_terminal_snr=False)
    rng = np.random.RandomState(6)
    cond = rng.randn(*shape).astype(np.float32)
    fn = _toy_model(0.4)
    key = jax.random.key(12)
    ref = js.pndm_sample(lambda x, t, c: fn(x, t, c, jnp), js.DiffusionScheduler(**sched), key,
                         jnp.asarray(cond), shape, timesteps=steps)
    noise = _jax_sample_draws(key, shape, 0)[0]
    port = ts.pndm_sample(lambda x, t, c: fn(x, t, c, torch), ts.DiffusionScheduler(**sched),
                          _t(cond), shape, timesteps=steps, noise=noise)
    _close(port, ref)


def test_pndm_step_matches_jax():
    sched = dict(kind="pndm", prediction_type="v_prediction", beta_schedule="linear")
    rng = np.random.RandomState(7)
    x = rng.randn(2, 4, 4, 3).astype(np.float32)
    ets_j, n = jnp.zeros((4, 2, 4, 4, 3)), jnp.int32(0)
    ets_t = []
    for t, prev_t in ((900, 700), (700, 500), (500, 300), (300, 100), (100, -1)):
        eps = rng.randn(2, 4, 4, 3).astype(np.float32)
        ref, ets_j, n = js.pndm_step(js.DiffusionScheduler(**sched), jnp.asarray(eps), t,
                                     prev_t, jnp.asarray(x), ets_j, n)
        port, ets_t = ts.pndm_step(ts.DiffusionScheduler(**sched), _t(eps), t, prev_t, _t(x),
                                   ets_t)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   atol=1e-5 * float(np.abs(ref).max()), rtol=0)
        x = np.asarray(ref)


# ------------------------------------------------------------------ decoders

def _decoder_pair(jax_module, port_module, args, seed):
    """The JAX module's variables with every leaf redrawn, and the port's
    module with them loaded strictly."""
    params = init_variables(jax_module, seed, *[jnp.asarray(a) for a in args])["params"]
    port_module.load_state_dict(from_jax_vq_variables({"params": params}), strict=True)
    return {"params": params}, port_module.eval()


UNET_CASES = {
    "mc32": dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2, 4),
                 channel_mult=(1, 2, 2)),
    "mc64_scale_shift": dict(model_channels=64, num_res_blocks=1, attention_resolutions=(4,),
                             channel_mult=(1, 1, 2), use_scale_shift_norm=True),
}


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_patched_unet_matches_jax(case):
    kw = dict(in_channels=3, out_channels=3, cond_dim=8, patch_size=4, **UNET_CASES[case])
    rng = np.random.RandomState(8)
    sample = rng.randn(2, 32, 32, 3).astype(np.float32)
    cond = rng.randn(2, 4, 4, 8).astype(np.float32)
    t = np.array([17, 900])
    jm = JaxPatchedUNet(**kw)
    variables, pm = _decoder_pair(jm, PatchedUNetCondCat(**kw), (sample, t, cond), 21)
    mask = rng.rand(2, 4, 4) > 0.5
    for cm, uncond in ((None, False), (mask, False), (None, True)):
        ref = jm.apply(variables, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(cond),
                       cond_mask=None if cm is None else jnp.asarray(cm), unconditional=uncond)
        with torch.no_grad():
            port = pm(_t(sample), _t(t), _t(cond), None if cm is None else _t(cm),
                      unconditional=uncond)
        _close(port, ref)


UVIT_CASES = {
    "concat": dict(cond_type="concat"),
    "xattn": dict(cond_type="xattn"),
    "concat_longskip_res": dict(cond_type="concat", mid_layers=3, mid_use_long_skip=True,
                                res_embedding=True),
}


@pytest.mark.parametrize("case", sorted(UVIT_CASES))
def test_uvit_matches_jax(case):
    kw = dict(UVIT_PRESETS["uvit_t_p4_f16"], cond_dim=8, mid_hw_posemb=6, **UVIT_CASES[case])
    assert JAX_UVIT_PRESETS["uvit_t_p4_f16"] == UVIT_PRESETS["uvit_t_p4_f16"]
    rng = np.random.RandomState(9)
    sample = rng.randn(2, 32, 32, 3).astype(np.float32)
    cond = rng.randn(2, 2, 2, 8).astype(np.float32)
    t = np.array([5, 640])
    orig = np.array([[480, 640], [224, 224]])
    jm = JaxUViT(**kw)
    params = init_variables(jm, 22, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(cond),
                            orig_res=jnp.asarray(orig))["params"]
    pm = UViT(**kw).eval()
    pm.load_state_dict(from_jax_vq_variables({"params": params}), strict=True)
    mask = np.array([[[True, False], [False, True]], [[False, False], [True, True]]])
    for cm, uncond in ((None, False), (mask, False), (None, True)):
        ref = jm.apply({"params": params}, jnp.asarray(sample), jnp.asarray(t),
                       jnp.asarray(cond), cond_mask=None if cm is None else jnp.asarray(cm),
                       orig_res=jnp.asarray(orig), unconditional=uncond)
        with torch.no_grad():
            port = pm(_t(sample), _t(t), _t(cond), None if cm is None else _t(cm),
                      orig_res=_t(orig), unconditional=uncond)
        _close(port, ref)
