"""Optimizer and learning-rate schedules of the training step.

Counterpart of fourm_tpu/utils/optim.py (reference fourm/utils/
optim_factory.py:62-245, scheduler.py:22-83):
  * `weight_decay_mask`: the 4M no-decay rules (biases, norm weights,
    modality / positional embeddings, mask and register tokens, token
    embeddings) over the port's torch parameter names. By name only: the
    JAX rule also spares every leaf of ndim <= 1, but the port holds
    `mod_emb` and `mask_token` as (1, 1, D) and `pos_emb` as (1, L, D), so
    their names decide (the patterns name them all);
  * cosine / inverse-sqrt / constant schedules with linear warmup and
    optional cooldown, evaluated on the host in fp32 at the pre-increment
    step count, as optax's scale_by_schedule reads them;
  * `FusedAdamW`, optax.adamw with the decay mask, optionally after
    optax.clip_by_global_norm, as one `fused_adamw` kernel launch per step
    over every leaf (the clip's scaling inside the same pass).
Per-layer LR decay, skip-grad and the frozen-trunk mask are not ported yet
and raise.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..kernels.fused_adamw import AdamwTable, adamw_scalars, fused_adamw

NO_DECAY_PATTERNS = (
    r".*\.bias$",
    r".*norm\d?\.(weight|bias)$",   # norm1/norm2, encoder_norm, q_norm, query_norm, ...
    r".*mod_emb$",
    r".*pos_emb$",
    r".*mask_token$",
    r".*register_tokens$",
    r".*token_emb\.weight$",
)

_f = np.float32


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True = apply weight decay} over the model's unique
    parameters (a tensor shared by two modules is listed once, under its
    first name)."""
    return {name: not any(re.match(pat, name) for pat in NO_DECAY_PATTERNS)
            for name, _ in model.named_parameters()}


def cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                    min_lr: float = 0.0, cooldown_steps: int = 0) -> Callable[[int], float]:
    """Linear warmup, cosine decay, optional constant-min cooldown
    (reference scheduler.py:22-53), in fp32."""
    decay_steps = max(total_steps - warmup_steps - cooldown_steps, 1)

    def schedule(step: int) -> float:
        step = _f(step)
        if step < warmup_steps:
            return float(_f(base_lr) * step / _f(max(warmup_steps, 1)))
        t = np.clip((step - _f(warmup_steps)) / _f(decay_steps), _f(0), _f(1))
        cos = _f((base_lr - min_lr) * 0.5) * (_f(1) + np.cos(_f(math.pi) * t))
        return float(_f(min_lr) + cos)

    return schedule


def inverse_sqrt_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                          cooldown_steps: int = 0, timescale: float = 10_000.0,
                          min_lr: float = 0.0) -> Callable[[int], float]:
    """Warmup, inverse square root, linear cooldown to min_lr
    (scheduler.py:56-83), in fp32."""
    def isqrt(x):
        # a Python number is summed in double first, as a weak-typed jnp op
        x = _f(x + timescale) if isinstance(x, (int, float)) else x + _f(timescale)
        return _f(base_lr) / np.sqrt(np.maximum(x, _f(timescale)) / _f(timescale))

    cooldown_start = total_steps - cooldown_steps

    def schedule(step: int) -> float:
        step = _f(step)
        if step < warmup_steps:
            out = _f(base_lr) * step / _f(max(warmup_steps, 1))
        else:
            out = isqrt(step - _f(warmup_steps))
        if cooldown_steps > 0 and step >= cooldown_start:
            end_val = isqrt(cooldown_start - warmup_steps)
            frac = np.clip((step - _f(cooldown_start)) / _f(max(cooldown_steps, 1)),
                           _f(0), _f(1))
            out = end_val + (_f(min_lr) - end_val) * frac
        return float(out)

    return schedule


def constant_schedule(base_lr: float, warmup_steps: int = 0) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        step = _f(step)
        if step < warmup_steps:
            return float(_f(base_lr) * step / _f(max(warmup_steps, 1)))
        return float(_f(base_lr))

    return schedule


def make_schedule(name: str, base_lr: float, total_steps: int, warmup_steps: int,
                  min_lr: float = 0.0, cooldown_steps: int = 0):
    if name == "cosine":
        return cosine_schedule(base_lr, total_steps, warmup_steps, min_lr, cooldown_steps)
    if name in ("inverse_sqrt", "isqrt"):
        return inverse_sqrt_schedule(base_lr, total_steps, warmup_steps, cooldown_steps,
                                     min_lr=min_lr)
    if name == "constant":
        return constant_schedule(base_lr, warmup_steps)
    raise ValueError(f"unknown schedule {name}")


class FusedAdamW:
    """AdamW over a model's fp32 master parameters, one `fused_adamw` launch
    per step (fourm_tpu utils/optim.py FusedAdamW and the optax chain of
    create_optimizer). State: the step `count` and the moments `mu`, `nu`
    keyed by parameter name, the names of `from_jax_params`. `init()`
    allocates them where the parameters are; `step(grad_norm)` applies one
    update from the parameters' `.grad` (None = a zero gradient), clipping
    first when `clip_grad` is set (grad_norm: the unclipped global norm)."""

    def __init__(self, model: nn.Module, schedule, betas=(0.9, 0.95), eps: float = 1e-8,
                 weight_decay: float = 0.05, clip_grad: Optional[float] = None):
        self.model = model
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.decay = weight_decay_mask(model)
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self._table: Optional[AdamwTable] = None

    def named_params(self):
        return list(self.model.named_parameters())

    def params(self) -> List[torch.Tensor]:
        return [p for _, p in self.named_params()]

    def init(self) -> "FusedAdamW":
        """Zero moments beside the parameters, count 0."""
        for name, p in self.named_params():
            if p.dtype != torch.float32:
                raise ValueError(f"{name}: master parameters must be fp32, got {p.dtype}")
        with torch.no_grad():
            self.mu = {n: torch.zeros_like(p) for n, p in self.named_params()}
            self.nu = {n: torch.zeros_like(p) for n, p in self.named_params()}
        self.count = 0
        self._table = None
        return self

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        named = self.named_params()
        names = [n for n, _ in named]
        params = [p.detach() for _, p in named]
        mu, nu = [self.mu[n] for n in names], [self.nu[n] for n in names]
        decay = [self.decay[n] for n in names]
        s = adamw_scalars(self.count, self.schedule(self.count), self.b1, self.b2, self.eps,
                          self.weight_decay)
        if params[0].device.type == "cuda" and (
                self._table is None or not self._table.matches(params, mu, nu, decay)):
            self._table = AdamwTable(params, mu, nu, decay)
        clip = self.clip_grad is not None
        if clip and grad_norm is None:
            raise ValueError("clip_grad is set: step() needs the global gradient norm")
        fused_adamw(params, [p.grad for _, p in named], mu, nu, decay, s,
                    grad_norm if clip else None, self.clip_grad, self._table)
        self.count += 1

    def state_dict(self) -> dict:
        """{"count", "mu", "nu"}: what load_state_dict takes back (the moments
        themselves, not copies)."""
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        """Copy count and moments in ({"count", "mu", "nu"}, as
        `fourm_torch.utils.checkpoint.from_jax_adam_state` gives them). Every parameter
        needs its moments; an extra name must be another name of a shared
        parameter (e.g. a decoder's tied `mod_emb`)."""
        aliases = {n for n, _ in self.model.named_parameters(remove_duplicate=False)}
        for key in ("mu", "nu"):
            extra = set(state[key]) - set(self.mu)
            if extra - aliases:
                raise KeyError(f"{key}: unknown parameters {sorted(extra - aliases)}")
            with torch.no_grad():
                for n, t in getattr(self, key).items():
                    t.copy_(state[key][n])
        self.count = int(state["count"])


def create_optimizer(model: nn.Module, schedule, weight_decay: float = 0.05,
                     betas=(0.9, 0.95), eps: float = 1e-8, clip_grad: Optional[float] = None,
                     skip_grad: Optional[float] = None, frozen_mask=None,
                     layer_decay: Optional[float] = None) -> FusedAdamW:
    """AdamW with the 4M parameter-group rules (reference optim_factory.py:
    171-245), optionally after a global-norm clip. Call `init()` (or
    parallel.init_train_state) once the model is on its device."""
    if skip_grad is not None:
        raise NotImplementedError("skip_grad is not ported yet")
    if frozen_mask is not None:
        raise NotImplementedError("the frozen-trunk mask is not ported yet")
    if layer_decay is not None and layer_decay < 1.0:
        raise NotImplementedError("per-layer LR decay is not ported yet")
    return FusedAdamW(model, schedule, betas, eps, weight_decay, clip_grad)
