"""LoRA: low-rank adaptation, PyTorch port (fourm_tpu/models/lora.py;
reference fourm/models/lora_utils.py:44-177).

A LoRA is a dict {parameter name: {"down": (k, in), "up": (out, k)}} beside
a model whose targeted weights W (out, in) it adapts to W + scale * up @
down, k being rank times the number of projections packed in the weight
(3 for qkv, 2 for kv). The targets and the skip rule are the JAX package's
(`fourm_tpu/models/lora.py:21-52`), on the port's parameter names.

  * `fuse_lora(model, lora)` adds scale * up @ down into the weights in
    place (reference fuse_LoRA_into_linear). The storage of each weight is
    kept, so no kernel reads a stale copy: the padded fc2 storage
    (ops/transformer.py:_PaddedFc2) and the TMA descriptors address the
    weight itself, and the kernels' plan caches key on shapes alone.
  * `apply_lora(model, lora, *args)` runs model(*args) on the fused weights
    without touching the model (torch.func.functional_call, every model
    parameter detached): gradients reach the LoRA leaves alone.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# attention projections, as the reference's ATTENTION_MODULES targeting
DEFAULT_TARGETS = r".*(attn|self_attn|cross_attn)\.(qkv|kv|q|proj)\.weight$"


def _num_packed(name: str) -> int:
    return {"qkv": 3, "kv": 2, "qk": 2, "qv": 2}.get(name.split(".")[-2], 1)


def init_lora_params(model: nn.Module, rank: int = 4, targets: str = DEFAULT_TARGETS,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """For each targeted 2-D weight (out, in): down (k, in) ~ N(0, 1) / rank
    and up (out, k) zeros, k = packed projections x rank; a weight narrower
    than k is skipped (reference lora_utils.py:62-69). fp32 leaves on the
    model's device."""
    lora = {}
    for name, p in model.named_parameters():
        if not re.match(targets, name) or p.ndim != 2:
            continue
        k = _num_packed(name) * rank
        if k > min(p.shape):
            continue
        out_f, in_f = p.shape
        down = torch.randn((k, in_f), generator=generator, dtype=torch.float32) / rank
        lora[name] = {"down": down.to(p.device),
                      "up": torch.zeros((out_f, k), dtype=torch.float32, device=p.device)}
    return lora


def fused_weights(model: nn.Module, lora: Mapping, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """{name: W + scale * up @ down} for the targeted weights, in each
    weight's dtype (the sum in fp32, as JAX promotes a bf16 leaf plus an
    fp32 product), W detached."""
    params = dict(model.named_parameters())
    return {name: (params[name].detach().float() + scale * (v["up"] @ v["down"])
                   ).to(params[name].dtype) for name, v in lora.items()}


@torch.no_grad()
def fuse_lora(model: nn.Module, lora: Mapping, scale: float = 1.0) -> nn.Module:
    """W += scale * up @ down for every targeted weight, in place (the
    storage kept); returns the model."""
    params = dict(model.named_parameters())
    for name, w in fused_weights(model, lora, scale).items():
        params[name].copy_(w)
    return model


def apply_lora(model: nn.Module, lora: Mapping, *args, scale: float = 1.0, **kwargs):
    """model(*args, **kwargs) on the fused weights, the model untouched and
    every one of its parameters detached: the LoRA leaves are the only
    tensors a backward reaches."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    params.update(fused_weights(model, lora, scale))
    return torch.func.functional_call(model, params, args, kwargs)


def lora_param_count(lora: Mapping) -> int:
    return sum(int(v["down"].numel() + v["up"].numel()) for v in lora.values())


def _port_name(path: str) -> str:
    """A JAX kernel path ('encoder_0/attn/qkv/kernel') as the port's
    parameter name ('encoder.0.attn.qkv.weight')."""
    segs = path.split("/")
    top = re.fullmatch(r"(encoder|decoder)_(\d+)", segs[0])
    head = [top.group(1), top.group(2)] if top else [segs[0]]
    return ".".join(head + segs[1:-1] + ["weight" if segs[-1] == "kernel" else segs[-1]])


def lora_from_jax(lora: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA tree ({path: {down (in, k), up (k, out)}}) as the port's:
    keys renamed, each leaf transposed."""
    return {_port_name(path): {
        "down": torch.from_numpy(np.ascontiguousarray(np.asarray(v["down"], np.float32).T)),
        "up": torch.from_numpy(np.ascontiguousarray(np.asarray(v["up"], np.float32).T))}
        for path, v in lora.items()}
