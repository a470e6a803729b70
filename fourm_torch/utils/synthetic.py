"""Synthetic modality-dict batches for the training step, benchmarks and
tests: the port's own copy of fourm_tpu/utils/synthetic.py (numpy, the same
draws from the same seed), plus `to_torch` to put a batch on a device.

The batches have the layout of the masking engine (fourm_tpu/data/
masking.py) and need no data or text tokenizer: per-modality budgets sum to
the given input and target token counts; sequence modalities carry [input |
target] segments with an autoregressive compressed attention mask; image
modalities carry disjoint random input and target token sets with a
full-mutual-attention compressed mask.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..data.modality_info import MODALITY_INFO

SEQ_TYPES = ("seq", "seq_token")


def synthetic_mod_batch(
    modalities: Sequence[str],
    batch_size: int,
    num_input_tokens: int = 128,
    num_target_tokens: int = 128,
    seed: int = 0,
    t5_emb_dim: int = 4096,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Random but valid masked batch of numpy arrays (fourm_tpu
    utils/synthetic.py:18-85)."""
    rng = np.random.RandomState(seed)
    mods = list(modalities)
    n_mod = len(mods)
    in_budget = rng.multinomial(num_input_tokens, np.ones(n_mod) / n_mod)
    tgt_budget = rng.multinomial(num_target_tokens, np.ones(n_mod) / n_mod)
    out = {}
    for mod, ib, tb in zip(mods, in_budget, tgt_budget):
        spec = MODALITY_INFO[mod]
        n_tok = spec.resolved_max_tokens()
        if spec.type == "img" and spec.encoder_embedding == "image":
            # raw pixels: the full image is input, never a target
            size = spec.input_size
            tensor = rng.rand(batch_size, size, size, spec.num_channels).astype(np.float32)
            input_mask = np.zeros((batch_size, n_tok), dtype=bool)
            target_mask = np.ones((batch_size, n_tok), dtype=bool)
            dam = np.zeros((batch_size, n_tok), dtype=np.int32)
        elif spec.type == "img":
            ib_, tb_ = min(ib, n_tok), min(tb, n_tok)
            tensor = rng.randint(0, spec.vocab_size, (batch_size, n_tok)).astype(np.int32)
            input_mask = np.ones((batch_size, n_tok), dtype=bool)
            target_mask = np.ones((batch_size, n_tok), dtype=bool)
            dam = np.zeros((batch_size, n_tok), dtype=np.int32)
            for b in range(batch_size):
                perm = rng.permutation(n_tok)
                input_mask[b, perm[:ib_]] = False
                tb_b = min(tb_, n_tok - ib_)
                target_mask[b, perm[ib_: ib_ + tb_b]] = False
                tpos = np.nonzero(~target_mask[b])[0]
                if len(tpos):
                    dam[b, tpos[0]] = tb_b
        elif spec.type in SEQ_TYPES:
            L = (n_tok + 1) * 2
            ib_ = min(ib, n_tok)
            tb_ = min(tb, n_tok)
            tensor = rng.randint(4, spec.vocab_size, (batch_size, L)).astype(np.int32)
            input_mask = np.ones((batch_size, L), dtype=bool)
            target_mask = np.ones((batch_size, L), dtype=bool)
            dam = np.zeros((batch_size, L), dtype=np.int32)
            input_mask[:, :ib_] = False
            target_mask[:, ib_: ib_ + tb_] = False
            dam[:, ib_: ib_ + tb_] = 1
        elif spec.type == "seq_emb":
            tensor = rng.randn(batch_size, n_tok, t5_emb_dim).astype(np.float32)
            input_mask = np.ones((batch_size, n_tok), dtype=bool)
            input_mask[:, : min(ib, n_tok)] = False
            target_mask = np.ones((batch_size, n_tok), dtype=bool)
            dam = np.zeros((batch_size, n_tok), dtype=np.int32)
        else:
            raise ValueError(f"unsupported modality type {spec.type}")
        out[mod] = {
            "tensor": tensor,
            "input_mask": input_mask,
            "target_mask": target_mask,
            "decoder_attention_mask": dam,
        }
    return out


def to_torch(batch: Dict[str, Dict[str, np.ndarray]], device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The same batch as torch tensors on `device`."""
    return {m: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in d.items()}
            for m, d in batch.items()}


# The 4M-7 modality set (reference cfgs/default/4m/models/main/4m-b_mod7_500b.yaml)
MOD7_MODALITIES: Tuple[str, ...] = (
    "rgb@224", "tok_rgb@224", "tok_depth@224", "tok_normal@224",
    "tok_semseg@224", "tok_clip@224", "caption", "det",
)
MOD7_DECODER_MODALITIES: Tuple[str, ...] = (
    "tok_rgb@224", "tok_depth@224", "tok_normal@224",
    "tok_semseg@224", "tok_clip@224", "caption", "det",
)

# The 4M-21 modality set (reference cfgs/default/4m/models/main/4m-b_mod21_*.yaml)
MOD21_MODALITIES: Tuple[str, ...] = (
    "rgb@224", "tok_rgb@224", "tok_depth@224", "tok_normal@224", "tok_semseg@224",
    "tok_clip@224", "caption", "det", "t5_caption", "metadata", "human_poses",
    "color_palette", "sam_instance", "tok_canny_edge@224", "tok_sam_edge@224",
    "tok_dinov2@224", "tok_imagebind@224", "tok_dinov2_global", "tok_imagebind_global",
)
MOD21_DECODER_MODALITIES: Tuple[str, ...] = tuple(
    m for m in MOD21_MODALITIES if m not in ("rgb@224", "t5_caption")
)
