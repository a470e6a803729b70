"""Pretrained image-tokenizer loader, PyTorch port (fourm_tpu/vq/loader.py;
reference fourm/vq/__init__.py:8-79).

Loads a tokenizer checkpoint from
  * a `.safetensors` file with the config as metadata (the release format,
    reference utils/checkpoint.py:176-192; utils/checkpoint.py reads it), or
  * a legacy `.pth` file (`{'model': state_dict, 'args': Namespace}`),
applies the reference's legacy argument renames (encoder_type -> enc_type,
input_size -> image_size, input_size_sd -> image_size_sd, ...), infers the
model class from the state dict and the config (`controlnet` keys ->
VQControlNet, built from the config's image_size_sd, decoder and vae_*
fields; beta_schedule -> DiVAE; else VQVAE; `encoder_only` -> VQ), builds it on
`device` (the card unless "cpu" is asked) and copies the checkpoint into
it (utils/checkpoint.py:import_vq_state_dict: a key it cannot place, or a
parameter the file lacks, raises). Returns `(model, None)`: the port's
modules hold their weights, where the JAX loader returns (model,
variables); `TokenizerBundle(model)` takes it for decoding.

Not ported: an orbax run directory of the JAX trainers (orbax is not on
the machine with the card), which raises; the port's trainers write
`tokenizer.safetensors` beside their checkpoints.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .vqvae import VQ, VQVAE, DiVAE, VQControlNet

_RENAMES = {
    "encoder_type": "enc_type",
    "decoder_type": "dec_type",
    "quantizer_ema_decay": "ema_decay",
    "input_size_enc": "image_size_enc",
    "input_size_dec": "image_size_dec",
    "input_size_sd": "image_size_sd",
}


def _remap_args(args: Dict[str, Any], state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Reference vq/__init__.py:37-60 legacy argument handling."""
    args = dict(args)
    domain = str(args.get("domain", ""))
    if any(s in domain for s in ("CLIP", "DINO", "ImageBind")):
        args["patch_proj"] = False
    elif "sam" in domain and "mask_size" in args:
        args["input_size"] = args["mask_size"]
        args["input_size_min"] = args["input_size_max"] = args["mask_size"]
    for old, new in _RENAMES.items():
        if old in args and args.get(new) is None:
            args[new] = args[old]
    if args.get("image_size") is None:
        args["image_size"] = args.get("input_size") or args.get("input_size_max")
    # channel / label counts from the state dict (reference :54-59)
    if "cls_emb.weight" in state:
        args["n_labels"], args["n_channels"] = state["cls_emb.weight"].shape
    elif "encoder.linear_in.weight" in state:
        args["n_channels"] = state["encoder.linear_in.weight"].shape[1]
    elif "encoder.proj.weight" in state:
        args["n_channels"] = state["encoder.proj.weight"].shape[1]
    return args


def _infer_model_type(args: Dict[str, Any], state: Dict[str, torch.Tensor],
                      encoder_only: bool):
    if encoder_only:
        return VQ
    if any("controlnet" in k for k in state):
        return VQControlNet
    if args.get("beta_schedule") is not None:
        return DiVAE
    return VQVAE


def _fields(cls) -> set:
    """The keyword arguments cls takes (its own and VQ's, for **kw)."""
    names = set()
    for c in (cls, VQ):
        names |= {p for p in inspect.signature(c.__init__).parameters
                  if p not in ("self", "kw", "device")}
    return names


def _filter_fields(cls, args: Dict[str, Any]) -> Dict[str, Any]:
    """The config entries cls takes; None values and training-only fields of
    the JAX dataclasses (EMA decay, dead-code threshold, ...) are left out."""
    names = _fields(cls)
    return {k: v for k, v in args.items() if k in names and v is not None}


def _read(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        args = ckpt["args"] if isinstance(ckpt["args"], dict) else vars(ckpt["args"])
        return {k: v.float() for k, v in ckpt["model"].items()}, dict(args)
    if path.endswith(".safetensors"):
        from ..utils.checkpoint import load_safetensors

        state, metadata = load_safetensors(path)
        cfg = metadata.get("config", {})
        return state, dict(cfg) if isinstance(cfg, dict) else {}
    if os.path.isdir(path):
        raise NotImplementedError(f"{path}: an orbax run directory; the port reads "
                                  ".safetensors and .pth tokenizer checkpoints")
    raise ValueError(f"unsupported tokenizer checkpoint: {path}")


def get_image_tokenizer(
    path: str,
    encoder_only: bool = False,
    verbose: bool = True,
    return_none_on_fail: bool = False,
    config_override: Optional[Dict[str, Any]] = None,
    device: Optional[str] = None,
) -> Optional[Tuple[VQ, None]]:
    """Load a tokenizer checkpoint -> (model, None), the model on `device`
    in eval mode. config_override updates the checkpoint's config, e.g.
    {"dtype": "bfloat16"}, the compute dtype of the kernels."""
    if return_none_on_fail and not os.path.exists(path):
        return None
    if verbose:
        print(f"Loading tokenizer {path} ... ", end="")
    state, args = _read(path)
    if config_override:
        args.update(config_override)
    args = _remap_args(args, state)
    cls = _infer_model_type(args, state, encoder_only)
    if encoder_only:
        state = {k: v for k, v in state.items()
                 if "decoder" not in k and "post_quant_proj" not in k and "vae." not in k}
    model = cls(**_filter_fields(cls, args), device=device)
    from ..utils.checkpoint import import_vq_state_dict

    import_vq_state_dict(model, state)
    if verbose:
        print(f"done ({cls.__name__}).")
    return model, None
