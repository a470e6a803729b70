"""The training step, on one card or over a (data, fsdp, tensor) mesh.

Counterpart of fourm_tpu/parallel/train.py (reference run_training_4m.py:
676-795, run_training_4m_fsdp.py:516-555): one eager step over the model's
fp32 master parameters, the model computing in its compute dtype (bf16 on
the card), gradients in fp32, then one `FusedAdamW` launch. On the card
every attention core of the step runs `attention_train` (forward and
backward kernels), the update `fused_adamw`; nothing of the inference
kernels runs.

Gradient accumulation averages the microbatches' gradients and losses
(train.py:146-159): the leading batch axis is then (accum, micro_batch, ...).
A trainable mask (the frozen-trunk phase, train.py:161-188) multiplies the
gradients by it before the norm and the optimizer, whose moments and step
count then step on the zeros, and keeps the frozen values as they are.
Metrics (train.py:172-176): `loss`, `grad_norm` (the global norm of the
unclipped, masked gradients) and `loss_{mod}` per modality (one microbatch
only), each a tensor on the card, so that a step does not wait for the host
(a skipped step, skip_grad, is decided on the card too).

Over a mesh (parallel/mesh.py:make_mesh, parallel/shard.py:ParallelPlan)
each rank of the (data, fsdp) group runs its rows of the global batch (the
ranks of a tensor group the same rows). The step is JAX's over the global
batch: each modality's summed loss is divided by its count over the ranks
(the counts all-reduced before the loss), so the ranks' losses and
gradients sum to the global batch's; the stochastic-depth masks are the
global batch's (ops/transformer.py:RankDraws); gradients are summed over
the ranks (at fsdp, reduce-scattered unit by unit during the backward into
the rank's chunks; all-reduced otherwise) and their norm counts each
element once, the same on every rank, so that the clip and skip_grad decide
alike; the update is one `fused_adamw` launch over the rank's masters, which
at fsdp are the parameters' only storage between steps (the forward and
backward gather each unit as they reach it). `loss` and `loss_{mod}` are
the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..api import resolve_device
from ..ops.transformer import RankDraws
from ..utils.optim import FusedAdamW
from .shard import ParallelPlan, leaf_norms


@dataclass
class TrainState:
    """The model (fp32 master parameters), its optimizer, the step count and,
    over a mesh, the plan of the rank's shards."""

    model: nn.Module
    optimizer: FusedAdamW
    step: int = 0
    plan: Optional[object] = None


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != ("data", "fsdp", "tensor"):
        raise TypeError(f"mesh must be a DeviceMesh with the axes (data, fsdp, tensor) "
                        f"(parallel.make_mesh), got {mesh!r}")


def init_train_state(model: nn.Module, optimizer: FusedAdamW, device: Optional[str] = None,
                     mesh=None, shard: Optional[bool] = None, seed: Optional[int] = None
                     ) -> TrainState:
    """Move the model to `device` (the card unless "cpu" is asked; raises
    without one) and give the optimizer zero moments there. With a mesh:
    split the blocks over its tensor axis, hold the parameters the fsdp rule
    shards (and so their gradients, masters and moments) as the rank's fsdp
    chunks (`shard`, default fsdp > 1; parallel/shard.py) and step those. A
    whole model must be built alike on every rank; its sharded storage is
    freed once chunked. A model built under parallel.meta_params() (its
    parameters on the meta device, no storage) is born sharded over the
    mesh: each leaf is drawn whole on `device` as init_weights(model, seed)
    draws it, and the rank keeps its chunk."""
    dev = resolve_device(device)
    meta = any(p.is_meta for p in model.parameters())
    if meta:
        if mesh is None or seed is None:
            raise ValueError("the model's parameters are on the meta device: it is born "
                             "sharded over a mesh from the seed of its init_weights draws "
                             "(init_train_state(..., mesh=, seed=))")
        if any(b.is_meta for b in model.buffers()):
            raise ValueError("the model's buffers are on the meta device: build it under "
                             "fourm_torch.parallel.meta_params(), which keeps them")
        for m in model.modules():
            for k, b in m._buffers.items():
                if b is not None:
                    m._buffers[k] = b.to(dev)
    if mesh is None:
        model.to(dev)
        optimizer.init()
        return TrainState(model, optimizer, 0)
    _check_mesh(mesh)
    if dev.type != mesh.device_type:
        raise ValueError(f"the mesh is over {mesh.device_type} devices, the model goes to {dev}")
    if not meta:
        model.to(dev)
    plan = ParallelPlan(model, mesh, shard, device=dev, seed=seed if meta else None)
    optimizer.use_leaves(plan.named_masters()).init()
    optimizer.plan = plan
    return TrainState(model, optimizer, 0, plan)


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


class _OneCard:
    """The plan of a step without a mesh: the parameters' own gradients, no
    collective."""

    batch_count = 1
    shard = False

    def __init__(self, model: nn.Module):
        self.model = model

    def reduce_grads(self):
        return [p.grad for p in self.model.parameters()]

    @staticmethod
    def grad_norm(grads):
        return leaf_norms([g for g in grads if g is not None]).square().sum().sqrt().float()


def build_train_step(model: nn.Module, optimizer: FusedAdamW, num_encoder_tokens: int,
                     num_decoder_tokens: int, loss_type: str = "mod", grad_accum_steps: int = 1,
                     mesh=None, trainable_mask: Optional[Dict[str, bool]] = None
                     ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step `step(state, batch, generator=None) -> (state,
    metrics)`, updating the model and optimizer in place. batch: {mod: {key:
    tensor}} on the model's device, with a leading (accum, micro_batch) when
    grad_accum_steps > 1; `generator` draws the stochastic-depth masks.
    trainable_mask ({name: trainable}, e.g. frozen_trunk_mask): the others'
    gradients are zeroed and their values kept. mesh: the one
    init_train_state was given (batch: this rank's rows)."""
    plan = optimizer.plan
    if mesh is not None:
        _check_mesh(mesh)
        if plan is None or plan.mesh is not mesh:
            raise ValueError("build_train_step(mesh=...): the optimizer was not initialised "
                             "over this mesh (init_train_state(..., mesh=mesh))")
    elif plan is not None:
        raise ValueError("the optimizer steps a mesh's shards: pass that mesh to "
                         "build_train_step")
    else:
        plan = _OneCard(model)
    names = [n for n, _ in model.named_parameters()]
    if trainable_mask is not None and set(trainable_mask) != set(names):
        raise KeyError(f"trainable_mask must name every parameter: differs in "
                       f"{sorted(set(trainable_mask) ^ set(names))[:5]}")
    frozen = [i for i, n in enumerate(names) if trainable_mask is not None
              and not trainable_mask[n]]
    count_reduce = plan.reduce_batch if plan.batch_count > 1 else None

    def loss_fn(batch, generator):
        return model(batch, num_encoder_tokens, num_decoder_tokens, loss_type=loss_type,
                     generator=generator, count_reduce=count_reduce)

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        for p in model.parameters():
            p.grad = None
        if count_reduce is not None:
            generator = RankDraws(generator, plan.batch_index, plan.batch_count)
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
            loss = loss / grad_accum_steps
            mod_loss = {}
        grads = plan.reduce_grads()
        if grad_accum_steps > 1:
            torch._foreach_div_([g for g in grads if g is not None], float(grad_accum_steps))
        zero = [grads[i] for i in frozen if grads[i] is not None]
        if zero:
            torch._foreach_mul_(zero, 0.0)
        grad_norm = plan.grad_norm(grads)
        optimizer.step(grad_norm, trainable_mask, grads=grads)
        state.step += 1
        losses = {"loss": loss, **{f"loss_{m}": v.detach() for m, v in mod_loss.items()}}
        if count_reduce is not None:
            total = count_reduce(torch.stack([v.reshape(()).float() for v in losses.values()]))
            losses = dict(zip(losses, total))
        metrics = {"loss": losses.pop("loss"), "grad_norm": grad_norm, **losses}
        return state, metrics

    return step_fn
