"""The training step on one card.

Counterpart of fourm_tpu/parallel/train.py (reference run_training_4m.py:
676-795) without the mesh: one eager step over the model's fp32 master
parameters, the model computing in its compute dtype (bf16 on the card),
gradients in fp32, then one `FusedAdamW` launch. On the card every attention
core of the step runs `attention_train` (forward and backward kernels), the
update `fused_adamw`; nothing of the inference kernels runs.

Gradient accumulation averages the microbatches' gradients and losses
(train.py:146-159): the leading batch axis is then (accum, micro_batch, ...).
A trainable mask (the frozen-trunk phase, train.py:161-188) multiplies the
gradients by it before the norm and the optimizer, whose moments and step
count then step on the zeros, and keeps the frozen values as they are.
Metrics (train.py:172-176): `loss`, `grad_norm` (the global norm of the
unclipped, masked gradients) and `loss_{mod}` per modality (one microbatch
only), each a tensor on the card, so that a step does not wait for the host
(a skipped step, skip_grad, is decided on the card too).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..api import resolve_device
from ..utils.optim import FusedAdamW


@dataclass
class TrainState:
    """The model (fp32 master parameters), its optimizer and the step count."""

    model: nn.Module
    optimizer: FusedAdamW
    step: int = 0


def init_train_state(model: nn.Module, optimizer: FusedAdamW, device: Optional[str] = None,
                     mesh=None) -> TrainState:
    """Move the model to `device` (the card unless "cpu" is asked; raises
    without one) and give the optimizer zero moments there."""
    if mesh is not None:
        raise NotImplementedError("training over a mesh (FSDP / tensor parallel) is not "
                                  "ported yet: the port trains on one card")
    model.to(resolve_device(device))
    optimizer.init()
    return TrainState(model, optimizer, 0)


def frozen_trunk_mask(model: nn.Module) -> Dict[str, bool]:
    """The trainable mask of the frozen-trunk warm-start phase (train.py:
    64-85; reference run_training_4m.py:522-529, fm.py:762-776
    freeze_shared_params), {parameter name: trainable}: the encoder and
    decoder blocks and their final norms are frozen; the embeddings,
    modality embeddings, mask token and decoder context projection train."""
    frozen = ("encoder.", "decoder.", "encoder_norm.", "decoder_norm.")
    return {name: not name.startswith(frozen) for name, _ in model.named_parameters()}


def _micro(batch, i: int):
    return {m: {k: v[i] for k, v in d.items()} for m, d in batch.items()}


def build_train_step(model: nn.Module, optimizer: FusedAdamW, num_encoder_tokens: int,
                     num_decoder_tokens: int, loss_type: str = "mod", grad_accum_steps: int = 1,
                     mesh=None, trainable_mask: Optional[Dict[str, bool]] = None
                     ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step `step(state, batch, generator=None) -> (state,
    metrics)`, updating the model and optimizer in place. batch: {mod: {key:
    tensor}} on the model's device, with a leading (accum, micro_batch) when
    grad_accum_steps > 1; `generator` draws the stochastic-depth masks.
    trainable_mask ({name: trainable}, e.g. frozen_trunk_mask): the others'
    gradients are zeroed and their values kept."""
    if mesh is not None:
        raise NotImplementedError("training over a mesh is not ported yet: one card only")
    frozen_params = []
    if trainable_mask is not None:
        names = {n for n, _ in model.named_parameters()}
        if set(trainable_mask) != names:
            raise KeyError(f"trainable_mask must name every parameter: differs in "
                           f"{sorted(set(trainable_mask) ^ names)[:5]}")
        frozen_params = [p for n, p in model.named_parameters() if not trainable_mask[n]]

    def loss_fn(batch, generator):
        return model(batch, num_encoder_tokens, num_decoder_tokens, loss_type=loss_type,
                     generator=generator)

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        params = optimizer.params()
        for p in params:
            p.grad = None
        if grad_accum_steps == 1:
            loss, (mod_loss, _count) = loss_fn(batch, generator)
            loss.backward()
            loss = loss.detach()
        else:
            loss = 0.0
            for i in range(grad_accum_steps):
                micro_loss, _aux = loss_fn(_micro(batch, i), generator)
                micro_loss.backward()
                loss = loss + micro_loss.detach()
            grads = [p.grad for p in params if p.grad is not None]
            torch._foreach_div_(grads, float(grad_accum_steps))
            loss = loss / grad_accum_steps
            mod_loss = {}
        frozen_grads = [p.grad for p in frozen_params if p.grad is not None]
        if frozen_grads:
            torch._foreach_mul_(frozen_grads, 0.0)
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        optimizer.step(grad_norm, trainable_mask)
        state.step += 1
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   **{f"loss_{m}": v.detach() for m, v in mod_loss.items()}}
        return state, metrics

    return step_fn
