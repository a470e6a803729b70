"""Modality-dict initialization for generation (host-side, numpy).

The port's own copy of fourm_tpu/generate/init_helpers.py (no JAX there
either; copied so that fourm_torch imports nothing of fourm_tpu).

Equivalents of reference generate.py:30-195: empty-modality transforms (used for
classifier-free guidance's unconditional pass), empty-target initialization, full-
input initialization, custom text prompts, and batch expansion. The empty_*
functions also exist as torch ops inside the sampler's CFG path
(sampler.py) — these numpy versions build initial mod dicts.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..data.modality_info import MODALITY_INFO

S1_ID = 5  # id of [S_1]: [PAD]=0 [UNK]=1 [SOS]=2 [EOS]=3 [S_0]=4 [S_1]=5
EOS_ID = 3
PAD_ID = 0


def empty_img_modality(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """All tokens masked out as inputs, all are targets (generate.py:30-37)."""
    d = dict(d)
    d["input_mask"] = np.ones_like(d["input_mask"])
    d["target_mask"] = np.zeros_like(d["target_mask"])
    return d


def empty_seq_modality(d: Dict[str, np.ndarray], s1_id: int = S1_ID) -> Dict[str, np.ndarray]:
    """Sequence equivalent to 'everything masked': input [S_1], target
    [S_1] ... [S_2] (generate.py:39-63)."""
    d = dict(d)
    t = np.zeros_like(d["tensor"])
    t[:, 0] = s1_id
    t[:, 1] = s1_id
    t[:, -1] = s1_id + 1
    d["tensor"] = t
    im = np.ones_like(d["input_mask"])
    im[:, 0] = False
    d["input_mask"] = im
    d["target_mask"] = ~im
    dam = np.ones_like(d["decoder_attention_mask"])
    dam[:, 0] = 0
    d["decoder_attention_mask"] = dam
    return d


def empty_seq_emb_modality(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Zeroed embeddings with a single unmasked (empty) input position
    (generate.py:65-80)."""
    d = dict(d)
    d["tensor"] = np.zeros_like(d["tensor"])
    im = np.ones_like(d["input_mask"])
    im[:, 0] = False  # crucial for CFG (generate.py:72-73)
    d["input_mask"] = im
    d["target_mask"] = np.ones_like(d["target_mask"])
    d["decoder_attention_mask"] = np.zeros_like(d["decoder_attention_mask"])
    return d


def init_empty_target_modality(
    mod_dict: Dict, domain: str, batch_size: int, num_tokens: int
) -> Dict:
    """Add an all-target placeholder for a modality to be generated
    (reference generate.py:83-115)."""
    spec = MODALITY_INFO[domain]
    if spec.type == "img":
        d = {
            "tensor": np.zeros((batch_size, num_tokens), dtype=np.int32),
            "input_mask": np.ones((batch_size, num_tokens), dtype=bool),
            "target_mask": np.zeros((batch_size, num_tokens), dtype=bool),
            "decoder_attention_mask": np.zeros((batch_size, num_tokens), dtype=np.int32),
        }
        mod_dict[domain] = empty_img_modality(d)
    elif spec.type in ("seq", "seq_token", "seq_emb"):
        num_tokens = max(num_tokens, 2)
        d = {
            "tensor": np.zeros((batch_size, num_tokens), dtype=np.int32),
            "input_mask": np.ones((batch_size, num_tokens), dtype=bool),
            "target_mask": np.zeros((batch_size, num_tokens), dtype=bool),
            "decoder_attention_mask": np.zeros((batch_size, num_tokens), dtype=np.int32),
        }
        if spec.type in ("seq", "seq_token"):
            mod_dict[domain] = empty_seq_modality(d)
        else:
            mod_dict[domain] = empty_seq_emb_modality(d)
    else:
        raise ValueError(f"cannot init empty target for type {spec.type}")
    return mod_dict


def init_full_input_modality(mod_dict: Dict, domain: str, eos_id: int = EOS_ID) -> Dict:
    """Mark a conditioning modality as fully visible input (generate.py:117-152)."""
    spec = MODALITY_INFO[domain]
    d = mod_dict[domain]
    if domain.startswith("rgb"):
        B = d["tensor"].shape[0]
        H, W = d["tensor"].shape[1:3]  # NHWC
        ps = spec.patch_size
        shape = (B, (H // ps) * (W // ps))
    else:
        shape = d["tensor"].shape[:2]
    d.setdefault("input_mask", np.zeros(shape, dtype=bool))
    d.setdefault("target_mask", np.ones(shape, dtype=bool))
    d.setdefault("decoder_attention_mask", np.zeros(shape, dtype=np.int32))

    if spec.type == "img":
        d["input_mask"][:] = False
        d["target_mask"][:] = True
    elif spec.type in ("seq", "seq_token"):
        tensor = d["tensor"]
        eos_pos = np.nonzero(tensor == eos_id)[1]
        if len(eos_pos) == 0:
            tensor[:, 0] = eos_id
            eos_idx = 0
        else:
            eos_idx = int(eos_pos[0])
        d["input_mask"][:, : eos_idx + 1] = False
        d["input_mask"][:, eos_idx + 1 :] = True
        d["target_mask"][:] = True
    elif spec.type == "seq_emb":
        # T5 embeddings carry a validity mask alongside (generate.py:146-150)
        d["input_mask"] = ~d["mask_valid"]
        d["target_mask"] = np.ones_like(d["mask_valid"])
        d["decoder_attention_mask"] = np.zeros(d["mask_valid"].shape, dtype=np.int32)
    return mod_dict


def custom_text(
    sample: Dict, input_text: str, eos_token: str, key: str, text_tokenizer,
    target_max_len: int = 50, start_token: str = "[S_1]",
) -> Dict:
    """Build a partially-specified text modality: given prefix as input, sentinel-
    slotted remainder as target (reference generate.py:154-183)."""
    input_ids = np.asarray(text_tokenizer.encode(input_text).ids, dtype=np.int32)[None]
    target_text = " ".join([start_token] + ["[PAD]"] * (target_max_len - 2) + [eos_token])
    target_ids = np.asarray(text_tokenizer.encode(target_text).ids, dtype=np.int32)[None]
    all_ids = np.concatenate([input_ids, target_ids], axis=1)
    input_mask = np.concatenate(
        [np.zeros_like(input_ids, dtype=bool), np.ones_like(target_ids, dtype=bool)], axis=1
    )
    target_mask = np.concatenate(
        [np.ones_like(input_ids, dtype=bool), np.zeros_like(target_ids, dtype=bool)], axis=1
    )
    sample[key] = {
        "tensor": all_ids,
        "input_mask": input_mask,
        "target_mask": target_mask,
        "decoder_attention_mask": np.zeros(all_ids.shape, dtype=np.int32),
    }
    return sample


def expand_to_batch(mod_dict: Dict, batch_size: int) -> Dict:
    """Tile singleton batches to batch_size (reference generate.py:185-195)."""
    for mod, d in mod_dict.items():
        for k, v in d.items():
            if k in ("tensor", "input_mask", "target_mask", "decoder_attention_mask", "mask_valid"):
                if v.shape[0] == 1:
                    d[k] = np.repeat(v, batch_size, axis=0)
                elif v.shape[0] != batch_size:
                    raise ValueError(f"invalid batch size {v.shape[0]} != {batch_size}")
    return mod_dict
