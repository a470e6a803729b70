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
    optional cooldown, in fp32 at the pre-increment step count, as optax's
    scale_by_schedule reads them; each evaluates a whole range of steps at
    once (`Schedule.table`), which FusedAdamW keeps on the card;
  * `FusedAdamW`, optax.adamw with the decay mask, optionally after
    optax.clip_by_global_norm, as one `fused_adamw` kernel launch per step
    over every leaf (the clip's scaling inside the same pass), with:
      - per-layer LR decay (`layer_decay`): each leaf's learning rate times
        decay ** (max_id - layer_id), weight decay included, as the
        reference's parameter groups (lr * lr_scale, optim_factory.py:
        62-150), i.e. optax.adamw followed by scale_by_tree. The JAX
        package's create_optimizer scales the gradient before AdamW
        instead, which Adam's m / sqrt(v) cancels (ROADMAP, "Not faults of
        the port");
      - `skip_grad` (skip_large_grads, :310-327): a step whose global
        gradient norm is not finite or exceeds it leaves parameters,
        moments and the step count as they were, decided on the card;
      - a frozen mask (optax.masked(set_to_zero)): those leaves' moments
        step, their values stay. The train step's trainable mask
        (parallel/train.py) uses the same flags.
    The step count lives on the card, so that neither a skip nor the
    schedule needs the host; `count` reads it (a host sync).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..kernels.fused_adamw import (AdamScalars, AdamwTable, StepTables, bias_correction_table,
                                   bias_table_length, fused_adamw)

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


def weight_decay_mask(model: nn.Module, vectors: bool = True) -> Dict[str, bool]:
    """{parameter name: True = apply weight decay} over the model's unique
    parameters (a tensor shared by two modules is listed once, under its
    first name). vectors=False also spares every parameter of ndim <= 1, as
    the JAX rule does: the VQ tokenizers' mask, whose vectors (GroupNorm
    and ConvNeXt scales, `norm_mlp`, `conv_norm_out`, the UViT mask token)
    the name patterns do not all name, and whose other parameters have the
    JAX leaves' ndim."""
    return {name: (vectors or p.ndim > 1)
            and not any(re.match(pat, name) for pat in NO_DECAY_PATTERNS)
            for name, p in model.named_parameters()}


class Schedule:
    """A learning-rate schedule: `table(start, stop)` the fp32 values at
    steps start .. stop - 1 (one numpy evaluation), `schedule(step)` one of
    them as a float."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        self.fn = fn

    def table(self, start: int, stop: int) -> np.ndarray:
        return np.asarray(self.fn(np.arange(start, stop).astype(_f)), dtype=_f)

    def __call__(self, step: int) -> float:
        return float(self.table(step, step + 1)[0])


def _warm(base_lr, warmup_steps, step):
    return _f(base_lr) * step / _f(max(warmup_steps, 1))


def cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                    min_lr: float = 0.0, cooldown_steps: int = 0) -> Schedule:
    """Linear warmup, cosine decay, optional constant-min cooldown
    (reference scheduler.py:22-53), in fp32."""
    decay_steps = max(total_steps - warmup_steps - cooldown_steps, 1)

    def fn(step):
        t = np.clip((step - _f(warmup_steps)) / _f(decay_steps), _f(0), _f(1))
        cos = _f((base_lr - min_lr) * 0.5) * (_f(1) + np.cos(_f(math.pi) * t))
        return np.where(step < warmup_steps, _warm(base_lr, warmup_steps, step),
                        _f(min_lr) + cos)

    return Schedule(fn)


def inverse_sqrt_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                          cooldown_steps: int = 0, timescale: float = 10_000.0,
                          min_lr: float = 0.0) -> Schedule:
    """Warmup, inverse square root, linear cooldown to min_lr
    (scheduler.py:56-83), in fp32."""
    def isqrt(x):
        # a Python number is summed in double first, as a weak-typed jnp op
        x = _f(x + timescale) if isinstance(x, (int, float)) else x + _f(timescale)
        return _f(base_lr) / np.sqrt(np.maximum(x, _f(timescale)) / _f(timescale))

    cooldown_start = total_steps - cooldown_steps

    def fn(step):
        out = np.where(step < warmup_steps, _warm(base_lr, warmup_steps, step),
                       isqrt(step - _f(warmup_steps)))
        if cooldown_steps > 0:
            end_val = isqrt(cooldown_start - warmup_steps)
            frac = np.clip((step - _f(cooldown_start)) / _f(max(cooldown_steps, 1)),
                           _f(0), _f(1))
            out = np.where(step >= cooldown_start, end_val + (_f(min_lr) - end_val) * frac, out)
        return out

    return Schedule(fn)


def constant_schedule(base_lr: float, warmup_steps: int = 0) -> Schedule:
    def fn(step):
        return np.where(step < warmup_steps, _warm(base_lr, warmup_steps, step), _f(base_lr))

    return Schedule(fn)


def make_schedule(name: str, base_lr: float, total_steps: int, warmup_steps: int,
                  min_lr: float = 0.0, cooldown_steps: int = 0) -> Schedule:
    if name == "cosine":
        return cosine_schedule(base_lr, total_steps, warmup_steps, min_lr, cooldown_steps)
    if name in ("inverse_sqrt", "isqrt"):
        return inverse_sqrt_schedule(base_lr, total_steps, warmup_steps, cooldown_steps,
                                     min_lr=min_lr)
    if name == "constant":
        return constant_schedule(base_lr, warmup_steps)
    raise ValueError(f"unknown schedule {name}")


def fourm_layer_id(name: str, encoder_depth: int, decoder_depth: int) -> int:
    """Layer id of a parameter for per-layer LR decay (fourm_tpu/utils/
    optim.py:fourm_layer_id, reference optim_factory.py:104-168) on the
    port's names: embeddings, modality embeddings and the mask token 0,
    encoder block i i + 1, the encoder norm encoder_depth + 1, decoder block
    j encoder_depth + 2 + j, the decoder norm, context projection and
    decoder embeddings (the logits) encoder_depth + decoder_depth + 2."""
    if name.endswith(".mod_emb"):
        return 0
    top, _, rest = name.partition(".")
    if top == "encoder":
        return int(rest.split(".")[0]) + 1
    if top == "encoder_norm":
        return encoder_depth + 1
    if top == "decoder":
        return encoder_depth + 1 + int(rest.split(".")[0]) + 1
    if top in ("decoder_norm", "decoder_proj_context", "decoder_embeddings"):
        return encoder_depth + decoder_depth + 2
    return 0


def layerwise_lr_scales(model: nn.Module, decay: float) -> Dict[str, float]:
    """{parameter name: decay ** (max_id - layer_id)}, max_id =
    encoder_depth + decoder_depth + 2."""
    enc, dec = len(model.encoder), len(model.decoder)
    max_id = enc + dec + 2
    return {name: decay ** (max_id - fourm_layer_id(name, enc, dec))
            for name, _ in model.named_parameters()}


class FusedAdamW:
    """AdamW over a model's fp32 master parameters, one `fused_adamw` launch
    per step (fourm_tpu utils/optim.py FusedAdamW and the optax chain of
    create_optimizer). State: the step count (on the card) and the moments
    `mu`, `nu` keyed by parameter name, the names of `from_jax_params`.
    `init()` allocates them where the parameters are; `step(grad_norm,
    trainable=None)` applies one update from the parameters' `.grad` (None =
    a zero gradient), clipping first when `clip_grad` is set and skipping
    the step on the card when `skip_grad` is (grad_norm: the global norm of
    the gradients, unclipped); `trainable` ({name: bool}) leaves the values
    of the others as they are. `lr_scales` ({name: float}) multiplies each
    leaf's step, weight decay included; `frozen` ({name: bool}) are never
    updated (their moments are); `decay` ({name: bool}) replaces the 4M
    decay mask. Over a mesh (parallel/shard.py) the optimizer steps the
    rank's fp32 masters, `use_leaves([(name, master)])` before `init()`,
    each a local shard or the parameter itself, and `step` takes their
    gradients."""

    def __init__(self, model: nn.Module, schedule, betas=(0.9, 0.95), eps: float = 1e-8,
                 weight_decay: float = 0.05, clip_grad: Optional[float] = None,
                 skip_grad: Optional[float] = None,
                 lr_scales: Optional[Dict[str, float]] = None,
                 frozen: Optional[Dict[str, bool]] = None,
                 decay: Optional[Dict[str, bool]] = None):
        self.model = model
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.skip_grad = skip_grad
        self.decay = weight_decay_mask(model) if decay is None else decay
        self.lr_scales = lr_scales
        self.frozen = frozen or {}
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self._count: Optional[torch.Tensor] = None  # (2,) int32, on the parameters' device
        self._calls = 0  # steps since the count was set: its parity
        self._bound = 0  # the largest count the card can hold now
        self._lr: Optional[torch.Tensor] = None
        self._bias: Optional[torch.Tensor] = None
        self._tables: Dict[tuple, AdamwTable] = {}
        self._leaves = None  # [(name, fp32 master)] over a mesh, or a subset
        self.plan = None  # parallel/shard.py's ParallelPlan over a mesh

    def use_leaves(self, leaves) -> "FusedAdamW":
        """Step these (name, tensor) leaves in place of the model's
        parameters (a rank's master shards, or the trainable subset of a
        tokenizer); init() afterwards."""
        self._leaves = list(leaves)
        return self

    def named_params(self):
        return self._leaves if self._leaves is not None else list(self.model.named_parameters())

    def params(self) -> List[torch.Tensor]:
        return [p for _, p in self.named_params()]

    def init(self) -> "FusedAdamW":
        """Zero moments beside the parameters, count 0."""
        named = self.named_params()
        for name, p in named:
            if p.dtype != torch.float32:
                raise ValueError(f"{name}: master parameters must be fp32, got {p.dtype}")
        unknown = set(self.frozen) | set(self.lr_scales or {})
        unknown -= {n for n, _ in self.model.named_parameters(remove_duplicate=False)}
        if unknown:
            raise KeyError(f"frozen / lr_scales name unknown parameters {sorted(unknown)[:5]}")
        dev = named[0][1].device
        with torch.no_grad():
            self.mu = {n: torch.zeros_like(p) for n, p in named}
            self.nu = {n: torch.zeros_like(p) for n, p in named}
        self._count = torch.zeros(2, dtype=torch.int32, device=dev)
        self._calls = self._bound = 0
        self._lr = None
        n = bias_table_length(self.b1, self.b2)
        self._bias = torch.from_numpy(bias_correction_table(self.b1, self.b2, n)).to(dev)
        self._tables = {}
        return self

    @property
    def count(self) -> int:
        """The step count (a read from the card)."""
        return int(self._count[self._calls % 2])

    def _ensure_lr_table(self) -> None:
        """The schedule on the card for every count up to _bound (grown,
        twice as long, before a step could read past it)."""
        if self._lr is not None and self._bound < self._lr.shape[0]:
            return
        n = max(1024, 2 * (self._bound + 1))
        self._lr = torch.from_numpy(self.schedule.table(0, n)).to(self._count.device)

    def step_tables(self) -> StepTables:
        """The step state the next step reads and writes."""
        self._ensure_lr_table()
        return StepTables(self._count, self._calls % 2, self._lr, self._bias)

    def leaf_options(self, names, trainable: Optional[Dict[str, bool]] = None):
        """(decay, lr_scale, trainable) lists of these leaves."""
        decay = [self.decay[n] for n in names]
        scales = None if self.lr_scales is None else [self.lr_scales[n] for n in names]
        train = [not self.frozen.get(n, False) and (trainable is None or trainable[n])
                 for n in names]
        return decay, scales, (None if all(train) else train)

    def step(self, grad_norm: Optional[torch.Tensor] = None,
             trainable: Optional[Dict[str, bool]] = None,
             grads: Optional[List[Optional[torch.Tensor]]] = None) -> None:
        """grads: the leaves' gradients in named_params order (default their
        `.grad`)."""
        named = self.named_params()
        names = [n for n, _ in named]
        params = [p.detach() for _, p in named]
        mu, nu = [self.mu[n] for n in names], [self.nu[n] for n in names]
        decay, scales, train = self.leaf_options(names, trainable)
        if (self.clip_grad is not None or self.skip_grad is not None) and grad_norm is None:
            raise ValueError("clip_grad / skip_grad is set: step() needs the global gradient "
                             "norm")
        table = None
        if params[0].device.type == "cuda":
            key = (tuple(decay), None if scales is None else tuple(scales),
                   None if train is None else tuple(train))
            table = self._tables.get(key)
            if table is None or not table.matches(params, mu, nu, decay, scales, train):
                table = self._tables[key] = AdamwTable(params, mu, nu, decay, scales, train)
        steps = self.step_tables()
        s = AdamScalars(self.b1, self.b2, self.eps, self.weight_decay)
        if grads is None:
            grads = [p.grad for _, p in named]
        fused_adamw(params, grads, mu, nu, decay, s, steps,
                    grad_norm, self.clip_grad, table, lr_scale=scales, trainable=train,
                    skip_max=self.skip_grad)
        self._calls += 1
        self._bound += 1

    def state_dict(self) -> dict:
        """{"count", "mu", "nu"}: what load_state_dict takes back (the moments
        themselves, not copies; the count read from the card)."""
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
        count = int(state["count"])
        self._count.fill_(count)
        self._calls, self._bound = 0, count


def create_optimizer(model: nn.Module, schedule, weight_decay: float = 0.05,
                     betas=(0.9, 0.95), eps: float = 1e-8, clip_grad: Optional[float] = None,
                     skip_grad: Optional[float] = None,
                     frozen_mask: Optional[Dict[str, bool]] = None,
                     layer_decay: Optional[float] = None,
                     decay_mask: Optional[Dict[str, bool]] = None) -> FusedAdamW:
    """AdamW with the 4M parameter-group rules (reference optim_factory.py:
    171-245), optionally after a global-norm clip; skip_grad skips a step
    whose global gradient norm exceeds it (or is not finite); frozen_mask
    ({name: True = frozen}) keeps those values as they are (their moments
    step); layer_decay < 1 scales each leaf's learning rate by
    layerwise_lr_scales; decay_mask ({name: True = decay}) replaces the 4M
    rules (weight_decay_mask(model, vectors=False) for a tokenizer). Call
    `init()` (or parallel.init_train_state) once the model is on its
    device."""
    scales = (layerwise_lr_scales(model, layer_decay)
              if layer_decay is not None and layer_decay < 1.0 else None)
    return FusedAdamW(model, schedule, betas, eps, weight_decay, clip_grad, skip_grad,
                      lr_scales=scales, frozen=frozen_mask, decay=decay_mask)
