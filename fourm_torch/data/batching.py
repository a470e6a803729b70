"""Batch collation for masked modality dicts + empty-modality padding:
the port's own copy of fourm_tpu/data/batching.py.

`make_empty_mod_dict` mirrors reference unified_datasets.py:488-521 (MixtureDataset
padding): datasets missing a modality contribute fully-masked placeholder tensors so
every batch has identical structure — a hard requirement for fixed-shape jit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .modality_info import ModalitySpec

SEQ_TYPES = ("seq", "seq_token")


def make_empty_mod(spec: ModalitySpec, t5_emb_dim: int = 4096) -> Dict[str, np.ndarray]:
    """Fully-masked placeholder arrays for one missing modality."""
    if spec.type == "img" and spec.encoder_embedding == "image":
        # raw pixel modality: zero NHWC image, masks over the token grid
        n = spec.resolved_max_tokens()
        size = spec.input_size
        return {
            "tensor": np.zeros((size, size, spec.num_channels), dtype=np.float32),
            "input_mask": np.ones(n, dtype=bool),
            "target_mask": np.ones(n, dtype=bool),
            "decoder_attention_mask": np.zeros(n, dtype=np.int32),
        }
    if spec.type == "img":
        n = spec.resolved_max_tokens()
        tensor = np.zeros(n, dtype=np.int32)
    elif spec.type in SEQ_TYPES:
        n = (spec.resolved_max_tokens() + 1) * 2
        tensor = np.zeros(n, dtype=np.int32)
    elif spec.type == "seq_emb":
        n = spec.resolved_max_tokens()
        tensor = np.zeros((n, t5_emb_dim), dtype=np.float32)
    else:
        raise ValueError(f"cannot make empty modality of type {spec.type}")
    return {
        "tensor": tensor,
        "input_mask": np.ones(n, dtype=bool),
        "target_mask": np.ones(n, dtype=bool),
        "decoder_attention_mask": np.zeros(n, dtype=np.int32),
    }


def batch_mod_dicts(samples: List[Dict[str, Dict[str, np.ndarray]]]) -> Dict[str, Dict[str, np.ndarray]]:
    """Stack a list of per-sample masked mod dicts into batched arrays."""
    if not samples:
        raise ValueError("empty batch")
    mods = samples[0].keys()
    out = {}
    for mod in mods:
        keys = samples[0][mod].keys()
        out[mod] = {k: np.stack([s[mod][k] for s in samples], axis=0) for k in keys}
    return out
