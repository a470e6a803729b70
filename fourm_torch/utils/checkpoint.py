"""Weight bridge: the JAX package's parameter trees -> the port's state dicts.

Each function takes a fourm_tpu variables tree as nested dicts of numpy
arrays (what `jax.tree.map(np.asarray, variables)` gives) and returns the
reference-named torch state dict that the port's module takes with
`load_state_dict(..., strict=True)`:
  * `from_jax_params(params, config)`: `variables["params"]` of a FourM, the
    port's own copy of fourm_tpu/utils/checkpoint.py:export_fourm_torch_state;
  * `from_jax_vq_variables(variables)`: a VQ's, VQVAE's or DiVAE's
    `params` and `codebook` collection (the encoder, the quantizer, and the
    ViT, MLP, UNet and UViT decoders), named as
    checkpoint.py:_vq_torch_name / export_vq_torch_state (356-408) name
    them;
  * `from_jax_teacher_params(params)`: a ViTTeacher's `params`;
  * `from_jax_adam_state(opt_state, config)`: optax AdamW's `count`, `mu`
    and `nu` of a FourM, as the port's FusedAdamW state (`load_state_dict`).
Dense kernels (in, out) become nn.Linear weights (out, in), convolution
kernels (kh, kw, in, out) the reference's (out, in, kh, kw), transposed
convolution kernels (kh, kw, out, in; flax's transpose_kernel=True) the
(in, out, kh, kw) of nn.ConvTranspose2d (the same permutation), flax
LayerNorm / GroupNorm scales `weight`, embedding tables keep their layout,
modality and mask tokens take the reference (1, 1, D) shape. Sin-cos
tables are computed, not loaded.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _walk(out: Dict[str, np.ndarray], prefix: str, tree: Mapping) -> None:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            _walk(out, f"{prefix}.{name}", sub)
            continue
        arr = np.asarray(sub)
        if name == "kernel":
            out[f"{prefix}.weight"] = np.ascontiguousarray(arr.T)
        elif name == "embedding":
            out[f"{prefix}.weight"] = arr
        else:
            out[f"{prefix}.{name}"] = arr


def from_jax_params(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """Reference-named torch state dict from a JAX FourM parameter tree."""
    out: Dict[str, np.ndarray] = {}
    for key, val in params.items():
        if re.fullmatch(r"(encoder|decoder)_\d+", key):
            top, idx = key.rsplit("_", 1)
            _walk(out, f"{top}.{idx}", val)
        elif key in ("encoder_norm", "decoder_norm", "decoder_proj_context"):
            _walk(out, key, val)
        elif key == "mask_token":
            out["mask_token"] = np.asarray(val).reshape(1, 1, -1)
        elif key == "register_tokens":
            out["register_tokens"] = np.asarray(val)[None]
        elif key.startswith("mod_emb_"):
            mod = key[len("mod_emb_"):]
            arr = np.asarray(val).reshape(1, 1, -1)
            if mod in config.encoder_modalities:
                out[f"encoder_embeddings.{mod}.mod_emb"] = arr
            if config.share_modality_embeddings and mod in config.decoder_modalities:
                out[f"decoder_embeddings.{mod}.mod_emb"] = arr
        elif key.startswith("dec_mod_emb_"):
            mod = key[len("dec_mod_emb_"):]
            out[f"decoder_embeddings.{mod}.mod_emb"] = np.asarray(val).reshape(1, 1, -1)
        elif key.startswith(("encoder_embeddings_", "decoder_embeddings_")):
            top = ("encoder_embeddings" if key.startswith("encoder_embeddings_")
                   else "decoder_embeddings")
            mod = key[len(top) + 1:]
            for name, sub in val.items():
                if name == "pos_emb":
                    out[f"{top}.{mod}.pos_emb"] = np.asarray(sub)[None]
                elif isinstance(sub, Mapping):
                    _walk(out, f"{top}.{mod}.{name}", sub)
                else:
                    out[f"{top}.{mod}.{name}"] = np.asarray(sub)
        else:
            raise KeyError(f"unhandled JAX param {key}")
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in out.items()}


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in out.items()}


# flax module names -> the reference's (fourm_tpu/utils/checkpoint.py:_VQ_SEG_MAP)
_VQ_SEG_MAP = [
    (re.compile(r"^blocks_(\d+)$"), lambda m: f"blocks.{m.group(1)}"),
    (re.compile(r"^mid_block_(\d+)$"), lambda m: f"mid_block.{m.group(1)}"),
    (re.compile(r"^down_(\d+)_resnet_(\d+)$"),
     lambda m: f"down_blocks.{m.group(1)}.resnets.{m.group(2)}"),
    (re.compile(r"^down_(\d+)_downsample$"), lambda m: f"down_blocks.{m.group(1)}.downsamplers.0"),
    (re.compile(r"^up_(\d+)_resnet_(\d+)$"),
     lambda m: f"up_blocks.{m.group(1)}.resnets.{m.group(2)}"),
    (re.compile(r"^up_(\d+)_upsample$"), lambda m: f"up_blocks.{m.group(1)}.upsamplers.0"),
    (re.compile(r"^out_conv_(\d+)$"), lambda m: f"out_conv.{m.group(1)}"),
    (re.compile(r"^mlp_fc(\d)$"), lambda m: f"mlp.fc{m.group(1)}"),
    (re.compile(r"^xattn_(q|kv|proj)$"), lambda m: f"cross_attn.{m.group(1)}"),
    (re.compile(r"^emb_proj_(\d)$"), lambda m: f"emb_proj.{m.group(1)}"),
    (re.compile(r"^block_(\d)$"), lambda m: f"block.{m.group(1)}"),
    (re.compile(r"^layernorms_(\d+)$"), lambda m: f"layernorms.{m.group(1)}"),
    (re.compile(r"^layers_(\d+)$"), lambda m: f"layers.{m.group(1)}"),
]
_VQ_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _vq_segment(seg: str) -> str:
    for pat, repl in _VQ_SEG_MAP:
        m = pat.match(seg)
        if m:
            return repl(m)
    return seg


def _vq_tree(out: Dict[str, np.ndarray], path: list, tree: Mapping) -> None:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            _vq_tree(out, path + [_vq_segment(name)], sub)
            continue
        arr = np.asarray(sub, dtype=np.float32)
        if name == "kernel":  # Dense (in, out) -> (out, in); conv -> (out|in, in|out, kh, kw)
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (3, 2, 0, 1))
        out[".".join(path + [_VQ_LEAF.get(name, name)])] = np.ascontiguousarray(arr)


def from_jax_vq_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's VQ, VQVAE or DiVAE from the JAX module's
    variables. Of the codebook collection the search and the lookup need
    `embed`; the EMA state (embed_avg, cluster_size, initted) belongs to
    training and is left out."""
    out: Dict[str, np.ndarray] = {}
    _vq_tree(out, [], variables["params"])
    for path, cb in _codebooks(variables.get("codebook", {}), []):
        out[f"{'.'.join(path) or 'quantize'}._codebook.embed"] = np.asarray(cb["embed"],
                                                                            np.float32)
    return _tensors(out)


def _codebooks(tree: Mapping, path: list):
    if "embed" in tree and not isinstance(tree["embed"], Mapping):
        yield path, tree
        return
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _codebooks(v, path + [k])


def from_jax_teacher_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ViTTeacher from a JAX ViTTeacher's params."""
    out: Dict[str, np.ndarray] = {}
    _vq_tree(out, [], params)
    return _tensors(out)


def _adam_states(state):
    """The optax ScaleByAdamState(s) in an optimizer state: any node with
    count, mu and nu, found through tuples, lists and NamedTuples."""
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        yield state
    elif isinstance(state, (tuple, list)):
        for sub in state:
            yield from _adam_states(sub)


def from_jax_adam_state(opt_state, config) -> dict:
    """The port's optimizer state from a JAX optimizer state: the AdamW
    moments under the parameter names of `from_jax_params` and the step
    count, {"count": int, "mu": {name: tensor}, "nu": {name: tensor}}, for
    `FusedAdamW.load_state_dict`. Takes the optax chain of
    fourm_tpu.utils.optim.create_optimizer (one ScaleByAdamState; moment
    trees of variables `{"params": ...}` or of params)."""
    found = list(_adam_states(opt_state))
    if len(found) != 1:
        raise ValueError(f"expected one AdamW state in the optimizer state, found {len(found)}")
    adam = found[0]

    def moments(tree):
        tree = tree["params"] if "params" in tree else tree
        return from_jax_params(_numpy_tree(tree), config)

    return {"count": int(np.asarray(adam.count)), "mu": moments(adam.mu),
            "nu": moments(adam.nu)}


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)
