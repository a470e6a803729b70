"""Diffusion noise schedulers (DDPM / DDIM / PLMS) and the conditional
sampling loop, PyTorch port.

Counterpart of fourm_tpu/vq/scheduling.py (reference forked-diffusers
schedulers, fourm/vq/scheduling/scheduling_ddpm.py:49-436,
scheduling_ddim.py:51-417, scheduling_pndm.py, scheduling_utils.py:19-110,
diffusion_pipeline.py:37-133):
  * the schedule builders are the JAX package's numpy code, copied: the
    tables (alphas_cumprod, the spaced timesteps) are the same arrays;
  * the sampling loops run eagerly over the timesteps (the counterpart of
    the JAX package's one lax.scan): t and prev_t are host integers, so each
    step's coefficients are fp32 scalars computed on the host and the loop
    never waits for the device;
  * the scheduler math is fp32 whatever the model's dtype (as the JAX step
    and the reference pipeline force), classifier-free guidance combines
    the two predictions in the model's output dtype;
  * randomness comes from an explicit torch.Generator on the sample's
    device. Its draws are not jax.random's, so the loops also take the
    initial and per-step noise as tensors (`noise`, `step_noise`): a test
    gives them the JAX package's draws.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


# ----------------------------------------------------------------- schedules
# (fourm_tpu/vq/scheduling.py:36-111, copied)

def enforce_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the last timestep has zero SNR (arXiv:2305.08891;
    reference scheduling_utils.py:19-49)."""
    alphas = 1.0 - betas
    alphas_bar = np.cumprod(alphas)
    sqrt_ab = np.sqrt(alphas_bar)
    sqrt_ab_0, sqrt_ab_T = sqrt_ab[0].copy(), sqrt_ab[-1].copy()
    sqrt_ab = sqrt_ab - sqrt_ab_T
    sqrt_ab = sqrt_ab * sqrt_ab_0 / (sqrt_ab_0 - sqrt_ab_T)
    ab = sqrt_ab**2
    alphas = np.concatenate([ab[:1], ab[1:] / ab[:-1]])
    return (1.0 - alphas).astype(np.float32)


def betas_for_alpha_bar(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """squaredcos_cap_v2 schedule (reference scheduling_utils.py:52-77)."""
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = [
        min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), max_beta)
        for i in range(num_steps)
    ]
    return np.array(betas, dtype=np.float32)


def scaled_cosine_alphas(num_steps: int, noise_shift: float = 1.0) -> np.ndarray:
    """Cosine schedule shifted in log-SNR space (arXiv:2305.18231; reference
    scheduling_utils.py:80-110). Returns alphas_cumprod directly."""
    t = np.linspace(0, 1, num_steps, dtype=np.float64)
    with np.errstate(divide="ignore"):
        log_snr = -2 * (np.log(np.tan(np.pi * t / 2)) + np.log(noise_shift))
    log_snr = np.clip(log_snr, -15, 15).astype(np.float32)
    acp = 1.0 / (1.0 + np.exp(-log_snr))
    acp[-1] = 0.0
    return acp


def make_alphas_cumprod(num_train_timesteps: int, beta_schedule: str,
                        beta_start: float = 0.0001, beta_end: float = 0.02,
                        zero_terminal_snr: bool = True) -> np.ndarray:
    if "shifted_cosine:" in beta_schedule:
        noise_shift = float(beta_schedule.split(":")[1])
        return scaled_cosine_alphas(num_train_timesteps, noise_shift)
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
    elif beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                            dtype=np.float32) ** 2
    elif beta_schedule == "squaredcos_cap_v2":
        betas = betas_for_alpha_bar(num_train_timesteps)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")
    if zero_terminal_snr:
        betas = enforce_zero_terminal_snr(betas)
    return np.cumprod(1.0 - betas).astype(np.float32)


def spaced_timesteps(num_train: int, num_inference: int, mode: str = "trailing",
                     steps_offset: int = 0) -> np.ndarray:
    """Inference timesteps, descending (reference scheduling_ddim.py:218-250)."""
    ratio = num_train // num_inference
    if mode == "leading":
        ts = (np.arange(0, num_inference) * ratio).round()[::-1].astype(np.int64)
    elif mode == "trailing":
        ts = np.arange(num_train, 0, -ratio).round().astype(np.int64) - 1
    elif mode == "linspace":
        ts = np.linspace(num_train, 1, num_inference).round().astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep mode {mode}")
    return ts + steps_offset


# ------------------------------------------------------------------- helpers

@functools.lru_cache(maxsize=16)
def _alphas_cumprod(*args) -> np.ndarray:
    """make_alphas_cumprod, built once per schedule and shared read-only
    (a step reads it on the host several times)."""
    acp = make_alphas_cumprod(*args)
    acp.flags.writeable = False
    return acp


def _f32(x) -> np.float32:
    return np.float32(x)


def _threshold_sample(sample: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Imagen dynamic thresholding (reference scheduling_ddpm.py:262-294):
    each sample clipped to its `ratio` quantile of |x| (at least 1, at most
    max_value) and divided by it."""
    B = sample.shape[0]
    flat = sample.float().abs().reshape(B, -1)
    s = torch.quantile(flat, ratio, dim=1)
    s = s.clamp(1.0, max_value).reshape((B,) + (1,) * (sample.ndim - 1))
    return torch.clamp(sample, -s, s) / s


def _randn(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


@dataclass(frozen=True)
class DiffusionScheduler:
    """Shared scheduler math. `kind` selects the DDPM (ancestral) or DDIM
    update (fourm_tpu/vq/scheduling.py:127-250)."""

    kind: str = "ddpm"  # ddpm | ddim | pndm
    num_train_timesteps: int = 1000
    beta_schedule: str = "linear"
    beta_start: float = 0.0001
    beta_end: float = 0.02
    prediction_type: str = "v_prediction"
    variance_type: str = "fixed_small"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    zero_terminal_snr: bool = True
    eta: float = 0.0  # DDIM stochasticity

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return _alphas_cumprod(self.num_train_timesteps, self.beta_schedule, self.beta_start,
                               self.beta_end, self.zero_terminal_snr)

    def alpha_prod(self, t: int, final: Optional[float] = 1.0) -> np.float32:
        """alphas_cumprod[t] as an fp32 scalar; `final` for t < 0."""
        return _f32(final) if t < 0 else self.alphas_cumprod[t]

    # ------------------------------------------------------------- training

    def _alpha_sigma(self, timesteps: torch.Tensor, ndim: int):
        acp = torch.tensor(self.alphas_cumprod, device=timesteps.device)
        a = acp[timesteps.long()].reshape((-1,) + (1,) * (ndim - 1))
        return torch.sqrt(a), torch.sqrt(1.0 - a)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor):
        sa, ss = self._alpha_sigma(timesteps, original.ndim)
        return sa * original + ss * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor):
        sa, ss = self._alpha_sigma(timesteps, sample.ndim)
        return sa * noise - ss * sample

    def get_noise(self, sample: torch.Tensor, velocity: torch.Tensor, timesteps: torch.Tensor):
        sa, ss = self._alpha_sigma(timesteps, sample.ndim)
        return sa * velocity + ss * sample

    # ------------------------------------------------------------- sampling

    def _pred_x0_eps(self, model_output, sample, alpha_prod_t: np.float32):
        beta_prod_t = _f32(1.0) - alpha_prod_t
        sa, sb = np.sqrt(alpha_prod_t), np.sqrt(beta_prod_t)
        if self.prediction_type == "epsilon":
            x0 = (sample - float(sb) * model_output) / float(sa)
            eps = model_output
        elif self.prediction_type == "sample":
            x0 = model_output
            eps = (sample - float(sa) * x0) / float(sb)
        elif self.prediction_type == "v_prediction":
            x0 = float(sa) * sample - float(sb) * model_output
            eps = float(sa) * model_output + float(sb) * sample
        else:
            raise ValueError(f"unknown prediction type {self.prediction_type}")
        if self.thresholding:
            x0 = _threshold_sample(x0, self.dynamic_thresholding_ratio, self.sample_max_value)
        elif self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_sample_range, self.clip_sample_range)
        return x0, eps

    def step(self, model_output: torch.Tensor, t: int, prev_t: int, sample: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One reverse-diffusion step x_t -> x_{prev_t} in fp32 (t, prev_t:
        host integers, prev_t < 0 past the last step). The DDPM step and a
        DDIM step with eta > 0 add noise: `noise` when given, else a draw
        from `generator`."""
        model_output, sample = model_output.float(), sample.float()
        alpha_prod_t = self.alpha_prod(t)
        alpha_prod_prev = self.alpha_prod(prev_t)
        x0, eps = self._pred_x0_eps(model_output, sample, alpha_prod_t)
        one = _f32(1.0)

        if self.kind == "ddim":
            # reference scheduling_ddim.py:295-366
            var = (one - alpha_prod_prev) / (one - alpha_prod_t) * (
                one - alpha_prod_t / alpha_prod_prev)
            std = _f32(self.eta) * np.sqrt(var)
            direction = float(np.sqrt(max(one - alpha_prod_prev - std**2, _f32(0.0)))) * eps
            prev = float(np.sqrt(alpha_prod_prev)) * x0 + direction
            if self.eta > 0:
                if noise is None:
                    noise = _randn(model_output.shape, generator, model_output.device)
                prev = prev + float(std) * noise
            return prev

        # DDPM (reference scheduling_ddpm.py:296-390)
        beta_prod_t = one - alpha_prod_t
        beta_prod_prev = one - alpha_prod_prev
        current_alpha = alpha_prod_t / alpha_prod_prev
        current_beta = one - current_alpha
        x0_coeff = np.sqrt(alpha_prod_prev) * current_beta / beta_prod_t
        xt_coeff = np.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
        prev = float(x0_coeff) * x0 + float(xt_coeff) * sample

        variance = max(beta_prod_prev / beta_prod_t * current_beta, _f32(1e-20))
        if self.variance_type == "fixed_small":
            std = np.sqrt(variance)
        elif self.variance_type == "fixed_small_log":
            std = np.exp(_f32(0.5) * np.log(variance))
        elif self.variance_type == "fixed_large":
            std = np.sqrt(current_beta)
        elif self.variance_type == "fixed_large_log":
            std = np.exp(_f32(0.5) * np.log(current_beta))
        else:
            raise ValueError(f"unsupported variance type {self.variance_type}")
        if noise is None:  # drawn at every step, as the JAX step draws it
            noise = _randn(model_output.shape, generator, model_output.device)
        if t > 0:
            prev = prev + float(std) * noise
        return prev


# ---------------------------------------------------------------------- PLMS

def DDPMScheduler(**kw) -> DiffusionScheduler:
    return DiffusionScheduler(kind="ddpm", **kw)


def PNDMScheduler(**kw) -> DiffusionScheduler:
    """PNDM / PLMS (reference scheduling_pndm.py:74-430, skip_prk_steps mode;
    fourm_tpu/vq/scheduling.py:257); sample with `pndm_sample`."""
    kw.setdefault("prediction_type", "epsilon")
    return DiffusionScheduler(kind="pndm", **kw)


def DDIMScheduler(**kw) -> DiffusionScheduler:
    return DiffusionScheduler(kind="ddim", **kw)


def _plms_combine(ets: Sequence[torch.Tensor]) -> torch.Tensor:
    """The linear multistep combination of the newest-first epsilon history."""
    n = len(ets)
    if n == 1:
        return ets[0]
    if n == 2:
        return (3 * ets[0] - ets[1]) / 2
    if n == 3:
        return (23 * ets[0] - 16 * ets[1] + 5 * ets[2]) / 12
    return (55 * ets[0] - 59 * ets[1] + 37 * ets[2] - 9 * ets[3]) / 24


def _to_epsilon(scheduler: DiffusionScheduler, pred, sample, t: int):
    a_t = scheduler.alpha_prod(t)
    if scheduler.prediction_type == "v_prediction":
        return float(np.sqrt(a_t)) * pred + float(np.sqrt(_f32(1) - a_t)) * sample
    if scheduler.prediction_type == "sample":
        return (sample - float(np.sqrt(a_t)) * pred) / float(np.sqrt(_f32(1) - a_t))
    return pred


def _pndm_transfer(sample, a_t: np.float32, a_prev: np.float32, eps):
    """PNDM transfer formula (reference scheduling_pndm.py _get_prev_sample)."""
    b_t, b_prev = _f32(1) - a_t, _f32(1) - a_prev
    sample_coeff = np.sqrt(a_prev / a_t)
    denom = a_t * np.sqrt(b_prev) + np.sqrt(a_t * b_t * a_prev)
    return float(sample_coeff) * sample - float(a_prev - a_t) * eps / float(denom)


def pndm_step(scheduler: DiffusionScheduler, eps: torch.Tensor, t: int, prev_t: int,
              sample: torch.Tensor, ets: Sequence[torch.Tensor]):
    """One PLMS step. ets: the epsilon history, newest first (at most 4
    kept). Returns (prev_sample, new history)."""
    sample = sample.float()
    eps = _to_epsilon(scheduler, eps.float(), sample, t)
    ets = [eps] + list(ets)[:3]
    out = _plms_combine(ets)
    prev = _pndm_transfer(sample, scheduler.alpha_prod(t), scheduler.alpha_prod(prev_t), out)
    return prev, ets


def pndm_sample(model_fn: Callable, scheduler: DiffusionScheduler, cond: torch.Tensor,
                sample_shape: Tuple[int, ...], generator: Optional[torch.Generator] = None,
                timesteps: Optional[int] = None, scheduler_timesteps_mode: str = "leading",
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PLMS sampling with the crowsonkb first-step Heun correction the
    reference uses via skip_prk_steps (scheduling_pndm.py:210-222,
    :359-379): the second-highest timestep is visited twice, first to
    complete a 2nd-order (Heun) version of step 0 from the saved pre-step
    sample, then as a regular PLMS step. Deterministic after the initial
    noise (`noise`, else a draw from `generator`)."""
    n_steps = timesteps or scheduler.num_train_timesteps
    delta = scheduler.num_train_timesteps // n_steps
    base = spaced_timesteps(scheduler.num_train_timesteps, n_steps, scheduler_timesteps_mode)
    # the PNDM final alpha: set_alpha_to_one=False -> alphas_cumprod[0]
    final = scheduler.alphas_cumprod[0]
    image = noise.float() if noise is not None else _randn(sample_shape, generator, cond.device)
    if len(base) < 2:
        t = int(base[0])
        eps = _to_epsilon(scheduler, model_fn(image, t, cond).float(), image, t)
        return _pndm_transfer(image, scheduler.alpha_prod(t), scheduler.alpha_prod(t - delta,
                                                                                    final), eps)
    ets: list = []
    first = None
    # (evaluated timestep, updated timestep, Heun pass)
    visits = [(base[0], base[0], False), (base[1], base[0], True)]
    visits += [(t, t, False) for t in base[1:]]
    for i, (t_e, t_u, heun) in enumerate(visits):
        t_e, t_u = int(t_e), int(t_u)
        eps = _to_epsilon(scheduler, model_fn(image, t_e, cond).float(), image, t_e)
        if heun:
            out, base_sample = (ets[0] + eps) / 2, first
        else:
            ets = [eps] + ets[:3]
            out, base_sample = _plms_combine(ets), image
        if i == 0:
            first = image
        image = _pndm_transfer(base_sample, scheduler.alpha_prod(t_u),
                               scheduler.alpha_prod(t_u - delta, final), out)
    return image


# ------------------------------------------------------------------ pipeline

def diffusion_sample(model_fn: Callable, scheduler: DiffusionScheduler, cond: torch.Tensor,
                     sample_shape: Tuple[int, ...], generator: Optional[torch.Generator] = None,
                     timesteps: Optional[int] = None, guidance_scale: float = 0.0,
                     guidance_rescale: float = 0.0, scheduler_timesteps_mode: str = "trailing",
                     model_fn_uncond: Optional[Callable] = None,
                     noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Conditional diffusion sampling (reference PipelineCond,
    diffusion_pipeline.py:37-133), eagerly over the timesteps.

    model_fn(noisy, t, cond) -> the model's prediction (t a host integer).
    With guidance_scale > 1, model_fn_uncond gives the unconditional branch
    and both run each step. The initial sample is `noise` or a draw from
    `generator` on cond's device; each step's noise is step_noise[i] or a
    draw (DDPM draws one at every step)."""
    n_steps = timesteps or scheduler.num_train_timesteps
    ts = spaced_timesteps(scheduler.num_train_timesteps, n_steps, scheduler_timesteps_mode)
    if scheduler.kind == "ddim":
        prev_ts = ts - scheduler.num_train_timesteps // n_steps
    else:
        prev_ts = np.concatenate([ts[1:], np.array([-1], dtype=ts.dtype)])
    image = noise.float() if noise is not None else _randn(sample_shape, generator, cond.device)
    do_cfg = guidance_scale > 1.0
    for i, (t, prev_t) in enumerate(zip(ts.tolist(), prev_ts.tolist())):
        out = model_fn(image, t, cond)
        if do_cfg:
            out_uncond = (model_fn_uncond or model_fn)(image, t, cond)
            out_cfg = out_uncond + guidance_scale * (out - out_uncond)
            if guidance_rescale > 0.0:
                # arXiv:2305.08891 eq. 15-16
                dims = tuple(range(1, out.ndim))
                std_pos = torch.std(out, dim=dims, keepdim=True, correction=0)
                std_cfg = torch.std(out_cfg, dim=dims, keepdim=True, correction=0)
                rescaled = out_cfg * (std_pos / (std_cfg + 1e-8))
                out = guidance_rescale * rescaled + (1.0 - guidance_rescale) * out_cfg
            else:
                out = out_cfg
        image = scheduler.step(out, t, prev_t, image, generator,
                               None if step_noise is None else step_noise[i])
    return image
