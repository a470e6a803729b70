"""Fused AdamW: one in-place pass over every parameter leaf, in one launch.

Counterpart of fourm_tpu/kernels/fused_adamw.py and of the optax chain the
JAX package builds around it: `fused_adamw` computes fused_adamw_leaf's
update (fused_adamw.py:15-17 / 59-66) for a whole list of leaves with one
launch of csrc/fused_adamw.cu, where the TPU kernel runs once per leaf;
`bias_correction_table` holds adamw_scalars' (:116) corrections for every
count. In the same pass:
  * the gradient clip of optax.clip_by_global_norm (g / |g| * max_norm when
    |g| >= max_norm), when a global norm is given;
  * a per-leaf learning-rate scale applied after AdamW and its weight decay,
    as scale_by_tree(layerwise_lr_scales) after optax.adamw (the reference's
    per-group lr x lr_scale, optim_factory.py:62-150);
  * frozen leaves (the trainable mask of build_train_step, or
    create_optimizer's frozen mask): their moments are stepped, p is
    neither read nor written;
  * skip_large_grads (utils/optim.py:310-327): with `skip_max`, a step whose
    global norm is not finite or exceeds it changes no parameter, moment
    or step count. The predicate is read on the card: no host read.
The step's scalars come from `StepTables`, device tables of the schedule's
lr and of the bias corrections indexed by a step count that lives on the
card (two words, swapped each step), so that a skipped step keeps the
count without the host knowing.

`fused_adamw_plain`, the twin, runs the same fp32 operations in the same
order with torch ops, leaf by leaf (reading the same tables and count), so
the kernel equals it bit for bit on the card. On CPU tensors the wrapper
computes the twin. Launches are counted in `fused_adamw.launches`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ._checks import require, require_cuda, stream

ADAM_CHUNK = 1 << 16  # elements of a leaf one block takes at a time
DECAY, TRAINABLE = 1, 2  # leaf flags of the kernel's table


@dataclass(frozen=True)
class AdamScalars:
    """The constants of the update; the step's lr and bias corrections come
    from StepTables."""

    b1: float
    b2: float
    eps: float
    wd: float


def bias_correction_table(b1: float, b2: float, n: int) -> np.ndarray:
    """(n, 2) fp32 rows (c1, c2) at t = count + 1 for count 0 .. n - 1, as
    fourm_tpu's adamw_scalars computes them."""
    f = np.float32
    t = (np.arange(n) + 1).astype(f)
    c1 = f(1.0) / (f(1.0) - np.power(f(b1), t))
    c2 = f(1.0) / (f(1.0) - np.power(f(b2), t))
    return np.stack([c1, c2], 1).astype(f)


def bias_table_length(b1: float, b2: float) -> int:
    """A count past which both corrections are exactly 1.0 in fp32 (b^t
    below 2^-26), so that a table of this length, read at min(count, n - 1),
    holds every count."""
    if not (0.0 <= b1 < 1.0 and 0.0 <= b2 < 1.0):
        raise ValueError(f"betas must lie in [0, 1), got {b1}, {b2}")
    worst = max(b1, b2)
    n = 2 if worst == 0.0 else int(np.ceil(-26 * np.log(2) / np.log(worst))) + 2
    table = bias_correction_table(b1, b2, n)
    assert (table[-1] == 1.0).all(), (b1, b2, table[-1])
    return n


class StepTables:
    """The step state the kernel reads on the card: `count` (2,) int32, the
    current count at count[parity] and the next written to count[1 -
    parity]; `lr` (n,) fp32, the schedule at counts 0 .. n - 1; `bias` (m,
    2) fp32, the corrections (bias_correction_table). Reads clamp to the
    last entry; the owner keeps the tables longer than any count it can
    reach."""

    def __init__(self, count: torch.Tensor, parity: int, lr: torch.Tensor, bias: torch.Tensor):
        self.count, self.parity, self.lr, self.bias = count, parity, lr, bias

    @property
    def count_in(self) -> torch.Tensor:
        return self.count[self.parity:self.parity + 1]

    @property
    def count_out(self) -> torch.Tensor:
        return self.count[1 - self.parity:2 - self.parity]

    @classmethod
    def constant(cls, lr: float, b1: float, b2: float, count: int = 0,
                 device=None) -> "StepTables":
        """A constant learning rate and every bias correction, at `count`."""
        bias = bias_correction_table(b1, b2, bias_table_length(b1, b2))
        return cls(torch.tensor([count, 0], dtype=torch.int32, device=device), 0,
                   torch.tensor([lr], dtype=torch.float32, device=device),
                   torch.from_numpy(bias).to(device))


def _step_scalars(steps: StepTables):
    """(lr, c1, c2) as 0-d fp32 tensors, read at the clamped count."""
    t = steps.count_in.long()
    lr = steps.lr[t.clamp(max=steps.lr.shape[0] - 1)][0]
    c = steps.bias[t.clamp(max=steps.bias.shape[0] - 1)][0]
    return lr, c[0], c[1]


def _skip(grad_norm, skip_max):
    """The skip predicate of skip_large_grads on the card: a bool tensor."""
    return ~(torch.isfinite(grad_norm) & (grad_norm <= skip_max)).reshape(())


def fused_adamw_plain(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                      exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
                      decay: Sequence[bool], s: AdamScalars, steps: StepTables,
                      grad_norm: Optional[torch.Tensor] = None,
                      max_norm: Optional[float] = None, *,
                      lr_scale: Optional[Sequence[float]] = None,
                      trainable: Optional[Sequence[bool]] = None,
                      skip_max: Optional[float] = None) -> None:
    """The twin: p, m, v (and the count) updated in place, leaf by leaf, one
    torch op per rounding of the kernel."""
    n = len(params)
    lr_scale = [1.0] * n if lr_scale is None else lr_scale
    trainable = [True] * n if trainable is None else trainable
    clip = grad_norm is not None and max_norm is not None
    if clip:
        clip = ~(grad_norm.reshape(()) < max_norm)
    skip = _skip(grad_norm, skip_max) if skip_max is not None else None
    lr, c1, c2 = _step_scalars(steps)
    with torch.no_grad():
        t = steps.count_in
        steps.count_out.copy_(t + 1 if skip is None else torch.where(skip, t, t + 1))
        for p, g, m, v, dk, sc, tr in zip(params, grads, exp_avgs, exp_avg_sqs, decay,
                                          lr_scale, trainable):
            g = torch.zeros_like(m) if g is None else g.float()
            if clip is not False:
                g = torch.where(clip, g.div(grad_norm.reshape(())).mul(max_norm), g)
            m2 = m.mul(s.b1).add(g.mul(1.0 - s.b1))
            v2 = v.mul(s.b2).add(g.mul(1.0 - s.b2).mul(g))
            if skip is not None:
                m2, v2 = torch.where(skip, m, m2), torch.where(skip, v, v2)
            m.copy_(m2)
            v.copy_(v2)
            if not tr:  # a frozen leaf's p is not touched
                continue
            u = m2.mul(c1).div(v2.mul(c2).sqrt().add(s.eps))
            if dk:
                u = u.add(p.mul(s.wd))
            p2 = p.sub(u.mul(lr).mul(sc))
            p.copy_(p2 if skip is None else torch.where(skip, p, p2))


def _bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


class AdamwTable:
    """The kernel's static tables for one list of leaves on one device: a
    (L, 5) int64 row [p, m, v, flags, lr scale's fp32 bits] per leaf and a
    (C, 3) int32 row [leaf, start, length] per chunk of at most ADAM_CHUNK
    elements. Built once per optimizer and mask; the tensors it points at
    must stay allocated."""

    def __init__(self, params, exp_avgs, exp_avg_sqs, decay, lr_scale=None, trainable=None):
        dev = require_cuda("fused_adamw", *params, *exp_avgs, *exp_avg_sqs)
        for t in (*params, *exp_avgs, *exp_avg_sqs):
            require(t.dtype == torch.float32 and t.is_contiguous(),
                    "fused_adamw: parameters and moments must be contiguous fp32")
        for p, m, v in zip(params, exp_avgs, exp_avg_sqs):
            require(m.shape == p.shape and v.shape == p.shape,
                    "fused_adamw: moments must have their parameter's shape")
        require(len({p.data_ptr() for p in params}) == len(params),
                "fused_adamw: a parameter is listed twice (it would be updated twice)")
        self.device = dev
        self.keys = self._keys(params, exp_avgs, exp_avg_sqs, decay, lr_scale, trainable)
        self.leaves = torch.tensor([[p, m, v, fl, sc] for p, m, v, _, fl, sc in self.keys],
                                   dtype=torch.int64).to(dev)
        chunks = [(i, s, min(ADAM_CHUNK, n - s)) for i, (_, _, _, n, _, _) in enumerate(self.keys)
                  for s in range(0, n, ADAM_CHUNK)]
        require(max(key[3] for key in self.keys) < 2**31, "fused_adamw: a leaf is too large")
        self.nchunks = len(chunks)
        self.chunks = torch.tensor(chunks, dtype=torch.int32).to(dev)

    @staticmethod
    def _keys(params, exp_avgs, exp_avg_sqs, decay, lr_scale=None, trainable=None):
        n = len(params)
        lr_scale = [1.0] * n if lr_scale is None else lr_scale
        trainable = [True] * n if trainable is None else trainable
        return [(p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                 (DECAY if d else 0) | (TRAINABLE if tr else 0), _bits(float(sc)))
                for p, m, v, d, sc, tr in zip(params, exp_avgs, exp_avg_sqs, decay, lr_scale,
                                              trainable)]

    def matches(self, params, exp_avgs, exp_avg_sqs, decay, lr_scale=None,
                trainable=None) -> bool:
        """Whether the table was built for these tensors, flags and scales."""
        return self.keys == self._keys(params, exp_avgs, exp_avg_sqs, decay, lr_scale,
                                       trainable)


def fused_adamw(params: List[torch.Tensor], grads: List[Optional[torch.Tensor]],
                exp_avgs: List[torch.Tensor], exp_avg_sqs: List[torch.Tensor],
                decay: List[bool], s: AdamScalars, steps: StepTables,
                grad_norm: Optional[torch.Tensor] = None, max_norm: Optional[float] = None,
                table: Optional[AdamwTable] = None, *,
                lr_scale: Optional[Sequence[float]] = None,
                trainable: Optional[Sequence[bool]] = None,
                skip_max: Optional[float] = None) -> None:
    """One AdamW step over every leaf, p, m, v in place: one launch on CUDA
    (the twin on CPU tensors). grads[i] None steps leaf i with a zero
    gradient. With grad_norm (a one-element fp32 tensor, the unclipped global
    norm) and max_norm, gradients are clipped first, as optax does; with
    skip_max (and grad_norm) the step is skipped on the card when the norm
    is not finite or above it. lr_scale / trainable: per leaf (default 1.0 /
    True). steps: the step state (count, lr and bias tables) on the
    parameters' device; s: b1, b2, eps, wd. On CUDA `table` is required: the AdamwTable of
    exactly these leaves, flags and scales, which its owner (FusedAdamW)
    builds and checks."""
    if params[0].device.type == "cpu":
        fused_adamw_plain(params, grads, exp_avgs, exp_avg_sqs, decay, s, steps, grad_norm,
                          max_norm, lr_scale=lr_scale, trainable=trainable, skip_max=skip_max)
        return
    name = "fused_adamw"
    require(table is not None, f"{name}: the AdamwTable of these leaves is required on the card")
    for p, g in zip(params, grads):
        require(g is None or (g.dtype == torch.float32 and g.is_contiguous()
                              and g.shape == p.shape and g.device == p.device),
                lambda: f"{name}: gradients must be contiguous fp32 of their parameter's shape")
    if grad_norm is not None:
        require(grad_norm.dtype == torch.float32 and grad_norm.numel() == 1
                and grad_norm.device == table.device,
                f"{name}: grad_norm must be a one-element fp32 tensor on the card")
    require((max_norm is None and skip_max is None) or grad_norm is not None,
            f"{name}: max_norm and skip_max need grad_norm")
    for t, dt in ((steps.count, torch.int32), (steps.lr, torch.float32),
                  (steps.bias, torch.float32)):
        require(t.dtype == dt and t.is_contiguous() and t.device == table.device,
                f"{name}: the step tables must be contiguous count int32 / fp32 on the card")
    # the gradients move every step: their pointers go up each launch, from
    # pinned memory, so that the host does not wait for the backward
    gptr = torch.tensor([0 if g is None else g.data_ptr() for g in grads], dtype=torch.int64,
                        pin_memory=True).to(table.device, non_blocking=True)
    from . import _build

    clip = max_norm is not None
    code = _build.entry(name)(
        table.leaves.data_ptr(), gptr.data_ptr(), table.chunks.data_ptr(), table.nchunks,
        s.b1, 1.0 - s.b1, s.b2, 1.0 - s.b2, s.eps, s.wd,
        None if grad_norm is None else grad_norm.data_ptr(),
        float(max_norm) if clip else 0.0, int(clip), int(skip_max is not None),
        0.0 if skip_max is None else float(skip_max), steps.count_in.data_ptr(),
        steps.count_out.data_ptr(), steps.lr.data_ptr(), steps.lr.shape[0],
        steps.bias.data_ptr(), steps.bias.shape[0], stream(table.device))
    _build.check(name, code)
    fused_adamw.launches += 1


fused_adamw.launches = 0
