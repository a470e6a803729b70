"""Weight bridge: the JAX package's parameter tree -> the port's state dict.

`from_jax_params(params, config)` takes `variables["params"]` of a
fourm_tpu FourM as nested dicts of numpy arrays (what
`jax.tree.map(np.asarray, variables)` gives) and returns the reference-named
torch state dict that `FourM.load_state_dict(..., strict=True)` takes. The
mapping is the port's own copy of fourm_tpu/utils/checkpoint.py:
export_fourm_torch_state: Dense kernels (in, out) become nn.Linear weights
(out, in), embedding tables keep their layout, modality and mask tokens take
the reference (1, 1, D) shape. Sin-cos tables are computed, not loaded.
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
