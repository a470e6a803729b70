"""Unified multimodal masking engine of 4M training, PyTorch port.

The port's own copy of fourm_tpu/data/masking.py (reference fourm/data/
masking.py:29-564): Dirichlet-sampled per-modality token budgets (mixtures
with sampling weights, `min_*_tokens` ranges, keep schemes), random
image-token masking, T5-style span masking of sequences, sequence packing
and span masking of caption embeddings. Host-side numpy, in the input
pipeline's workers; it emits the fixed-shape arrays {tensor, input_mask,
target_mask, decoder_attention_mask} per modality that FourM.forward takes.
All randomness flows through one explicit np.random.Generator, so the same
seed gives the JAX package's arrays. The sentinel ids come from the port's
text tokenizer helpers (utils/text_tokenizer.py). TransferMasking is the
fixed input / target split of transfer learning (data/transfer.py).

Mask convention: boolean, True = masked out (not an input / not a target).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.text_tokenizer import get_sentinel_to_id_mapping
from .modality_info import ModalitySpec

SEQ_TYPES = ("seq", "seq_token")


def sample_cosine(rng: np.random.Generator, min_val: float = 0.0, max_val: float = 1.0) -> float:
    """Cosine-distributed sample in [min_val, max_val] (reference masking.py:29-41)."""
    return min_val + 0.5 * (max_val - min_val) * (1 + math.cos(math.pi * rng.uniform(0, 1)))


def simple_span_masking(
    sequence: Sequence[int], sentinel_to_id: Dict[int, int], keep_prob: float,
    rng: np.random.Generator,
) -> Tuple[List[int], List[int]]:
    """T5-style span masking (reference masking.py:58-91).

    Returns (input_sequence, target_sequence): masked spans are replaced by numbered
    sentinels in the input; the target lists each sentinel followed by its span
    contents, terminated by the next unused sentinel.
    """
    masks = rng.random(len(sequence)) > keep_prob  # True = mask
    input_seq: List[int] = []
    target_seq: List[int] = []
    prev_mask = False
    sentinel_count = 0
    for token, mask in zip(sequence, masks):
        if mask:
            if not prev_mask:
                sentinel_count += 1
                input_seq.append(sentinel_to_id[sentinel_count])
                target_seq.append(sentinel_to_id[sentinel_count])
            prev_mask = True
            target_seq.append(token)
        else:
            prev_mask = False
            input_seq.append(token)
    target_seq.append(sentinel_to_id[sentinel_count + 1])
    return input_seq, target_seq


def chunk_span_masking(
    sequence_chunks: Sequence[Sequence[int]], sentinel_to_id: Dict[int, int],
    keep_prob: float, rng: np.random.Generator,
) -> Tuple[List[int], List[int]]:
    """Span masking at the chunk level (reference masking.py:94-127), used for
    metadata where each key=value pair is an atomic chunk."""
    masks = rng.random(len(sequence_chunks)) > keep_prob
    input_seq: List[int] = []
    target_seq: List[int] = []
    prev_mask = False
    sentinel_count = 0
    for chunk, mask in zip(sequence_chunks, masks):
        if mask:
            if not prev_mask:
                sentinel_count += 1
                input_seq.append(sentinel_to_id[sentinel_count])
                target_seq.append(sentinel_to_id[sentinel_count])
            prev_mask = True
            target_seq.extend(chunk)
        else:
            prev_mask = False
            input_seq.extend(chunk)
    target_seq.append(sentinel_to_id[sentinel_count + 1])
    return input_seq, target_seq


class UnifiedMasking:
    """Dirichlet-budgeted multimodal masking (reference masking.py:131-564).

    Args:
      modality_info: ordered {name: ModalitySpec}. Per-modality alphas are passed
        separately (they are training-config, not registry, state).
      text_tokenizer: a tokenizer with sentinel tokens, `encode(text).ids`, `encode_batch`
        and `token_to_id` (utils/text_tokenizer.py:load_tokenizer; None if no seq mods).
      input_tokens_range / target_tokens_range: (min, max) budgets per sample.
      input_alphas / target_alphas: {mod: [alpha_mix0, alpha_mix1, ...]} mixture of
        Dirichlet concentrations; scalars are promoted to 1-mixtures.
      keep_schemes: {mod: [scheme per mixture]} with scheme in random|all|binary.
      sampling_weights: mixture weights (None = uniform choice).
    """

    KEEP_PROB_DECAY = 0.9

    def __init__(
        self,
        modality_info: Dict[str, ModalitySpec],
        text_tokenizer,
        input_tokens_range: Union[int, Tuple[int, int]],
        target_tokens_range: Optional[Union[int, Tuple[int, int]]],
        input_alphas: Optional[Dict[str, Union[float, List[float]]]] = None,
        target_alphas: Optional[Dict[str, Union[float, List[float]]]] = None,
        keep_schemes: Optional[Dict[str, Union[str, List[str]]]] = None,
        sampling_weights: Optional[List[float]] = None,
        max_tries: int = 100,
        seed: Optional[int] = None,
    ):
        self.modality_info = dict(modality_info)
        self.mod_names = list(modality_info.keys())
        n = len(self.mod_names)
        self.input_tokens_range = self._to2(input_tokens_range)
        self.target_tokens_range = self._to2(target_tokens_range) if target_tokens_range is not None else None
        self.max_tries = max_tries
        self.min_tokens = np.array([m.min_tokens for m in modality_info.values()])
        self.max_tokens = np.array([m.resolved_max_tokens() for m in modality_info.values()])
        self.mod_is_img = np.array([m.type == "img" for m in modality_info.values()])

        def to_mixture(alphas, default=1.0):
            out = []
            for name in self.mod_names:
                a = default if alphas is None or name not in alphas else alphas[name]
                out.append([a] if np.isscalar(a) else list(a))
            width = max(len(a) for a in out)
            out = [a * width if len(a) == 1 else a for a in out]
            return np.array(out, dtype=np.float64).T  # (nmix, nmod)

        self.input_alphas = np.clip(to_mixture(input_alphas), 1e-9, None)
        self.target_alphas = np.clip(to_mixture(target_alphas), 1e-9, None)
        if self.input_alphas.shape != self.target_alphas.shape:
            raise ValueError("input/target alpha mixtures must have the same size")
        self.num_mixtures = self.input_alphas.shape[0]
        self.keep_schemes = {}
        for name in self.mod_names:
            ks = "random" if keep_schemes is None or name not in keep_schemes else keep_schemes[name]
            self.keep_schemes[name] = [ks] * self.num_mixtures if isinstance(ks, str) else list(ks)
        self.sampling_weights = (
            np.array(sampling_weights, dtype=np.float64) / np.sum(sampling_weights)
            if sampling_weights is not None else None
        )

        self.text_tokenizer = text_tokenizer
        if text_tokenizer is not None:
            self.sentinel_to_id = get_sentinel_to_id_mapping(text_tokenizer)
            self.sentinel_ids = set(self.sentinel_to_id.values())
            self.pad_id = text_tokenizer.token_to_id("[PAD]")
            self.eos_id = text_tokenizer.token_to_id("[EOS]")
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _to2(v):
        return (v, v) if np.isscalar(v) else tuple(v)

    # ---------------------------------------------------------------- budgets

    def _fill_budget(self, alphas: np.ndarray, num_tokens: int, max_tokens: np.ndarray) -> np.ndarray:
        """One Dirichlet budget draw with remainder top-up (masking.py:190-200)."""
        budget = np.floor(self.rng.dirichlet(alphas) * num_tokens).astype(np.int64)
        diff = num_tokens - budget.sum()
        if diff > 0:
            extra = self.rng.dirichlet(alphas, size=diff).argmax(axis=-1)
            budget += np.bincount(extra, minlength=len(budget))
        return np.minimum(budget, max_tokens)

    def input_token_budget(self, num_input_tokens: int, mix_idx: int = 0) -> List[int]:
        """Sample per-modality input budgets (reference masking.py:181-207)."""
        alphas = self.input_alphas[mix_idx]
        for _ in range(self.max_tries):
            budget = self._fill_budget(alphas, num_input_tokens, self.max_tokens)
            if (budget >= self.min_tokens).all():
                return budget.tolist()
        return budget.tolist()

    def target_token_budget(
        self, input_token_budget: List[int], num_target_tokens: int, mix_idx: int = 0
    ) -> List[int]:
        """Sample per-modality target budgets; image tokens already used as input
        reduce the remaining target capacity (reference masking.py:209-234)."""
        alphas = self.target_alphas[mix_idx]
        remaining = np.where(
            self.mod_is_img, self.max_tokens - np.asarray(input_token_budget), self.max_tokens
        )
        remaining = np.maximum(self.min_tokens, remaining)
        for _ in range(self.max_tries):
            budget = self._fill_budget(alphas, num_target_tokens, remaining)
            if (budget >= self.min_tokens).all():
                return budget.tolist()
        return budget.tolist()

    # ---------------------------------------------------------------- per-type

    def image_mask(self, tensor: np.ndarray, num_tokens: int, input_budget: int,
                   target_budget: Optional[int]) -> Dict[str, np.ndarray]:
        """Random image-token input/target masks + compressed decoder attention mask
        (reference masking.py:236-266): the first target position carries the count
        of target tokens so the cumsum trick yields full mutual attention."""
        perm = self.rng.permutation(num_tokens)
        input_mask = np.ones(num_tokens, dtype=bool)
        input_mask[perm[:input_budget]] = False
        if target_budget is None:
            target_mask = ~input_mask
        else:
            target_mask = np.ones(num_tokens, dtype=bool)
            target_mask[perm[input_budget : input_budget + target_budget]] = False
        decoder_attention_mask = np.zeros(num_tokens, dtype=np.int32)
        unmasked = np.nonzero(~target_mask)[0]
        first = unmasked[0] if len(unmasked) > 0 else 0
        decoder_attention_mask[first] = int((~target_mask).sum())
        return {
            "tensor": np.asarray(tensor),
            "input_mask": input_mask,
            "target_mask": target_mask,
            "decoder_attention_mask": decoder_attention_mask,
        }

    def _keep_prob(self, scheme: str) -> float:
        if scheme == "random":
            return float(self.rng.uniform(0, 1))
        if scheme == "all":
            return 1.0
        if scheme == "binary":
            return float(self.rng.choice([0.0, 1.0]))
        raise ValueError(f"invalid keep scheme {scheme}")

    def _span_mask_budgeted(self, seq_ids, span_fn, input_budget: int, keep_scheme: str):
        """Span-mask with keep-prob decay until the input fits its budget
        (reference masking.py:388-409)."""
        if input_budget == 0:
            _, target_seq = span_fn(seq_ids, self.sentinel_to_id, 0.0, self.rng)
            return [], target_seq
        keep_prob = self._keep_prob(keep_scheme)
        input_seq, target_seq = span_fn(seq_ids, self.sentinel_to_id, keep_prob, self.rng)
        while len(input_seq) > input_budget:
            keep_prob *= self.KEEP_PROB_DECAY
            input_seq, target_seq = span_fn(seq_ids, self.sentinel_to_id, keep_prob, self.rng)
        return input_seq, target_seq

    def _truncate_target_to_budget(self, target_seq: List[int], target_budget: int) -> List[int]:
        """Sentinel-aligned target truncation when over budget (masking.py:425-441)."""
        sentinel_indices = [i for i, t in enumerate(target_seq) if t in self.sentinel_ids]
        chosen = int(self.rng.integers(0, max(1, len(sentinel_indices) - 1)))
        if len(target_seq) - sentinel_indices[chosen] >= target_budget:
            start = sentinel_indices[chosen]
            return target_seq[start : start + target_budget]
        for idx in sentinel_indices:
            if len(target_seq) - idx <= target_budget:
                return target_seq[idx:]
        return target_seq[:target_budget]

    def _pack_sequence(self, input_seq: List[int], target_seq: List[int], max_tokens: int,
                       input_budget: int, target_budget: Optional[int]) -> Dict[str, np.ndarray]:
        """Lay out [input | target] into the fixed (max_tokens+1)*2 array
        (reference masking.py:411-445): input at [0:len], target at
        [input_budget : input_budget+len]."""
        max_length = (max_tokens + 1) * 2
        tensor = np.full(max_length, self.pad_id, dtype=np.int32)
        input_mask = np.ones(max_length, dtype=bool)
        target_mask = np.ones(max_length, dtype=bool)
        decoder_attention_mask = np.zeros(max_length, dtype=np.int32)

        tensor[: len(input_seq)] = input_seq
        input_mask[: len(input_seq)] = False

        if target_budget is not None and len(target_seq) > target_budget:
            target_seq = self._truncate_target_to_budget(target_seq, target_budget)
        t0 = input_budget
        tensor[t0 : t0 + len(target_seq)] = target_seq
        target_mask[t0 : t0 + len(target_seq)] = False
        decoder_attention_mask[t0 : t0 + len(target_seq)] = 1  # autoregressive
        return {
            "tensor": tensor,
            "input_mask": input_mask,
            "target_mask": target_mask,
            "decoder_attention_mask": decoder_attention_mask,
        }

    def sequence_mask(self, sequence, max_tokens: int, input_budget: int,
                      target_budget: Optional[int], keep_scheme: str) -> Dict[str, np.ndarray]:
        """Span-mask a text sequence (str) or chunk list (reference masking.py:345-445)."""
        if isinstance(sequence, str):
            seq_ids = self.text_tokenizer.encode(sequence).ids
            seq_ids.append(self.eos_id)
            seq_ids = seq_ids[:max_tokens]
            span_fn = simple_span_masking
        elif isinstance(sequence, (list, tuple)):
            if len(sequence) > 0 and isinstance(sequence[0], str):
                encoded = self.text_tokenizer.encode_batch(list(sequence))
                seq_ids = [e.ids for e in encoded]
            else:
                seq_ids = [list(c) for c in sequence]
            seq_ids.append([self.eos_id])
            cum = np.cumsum([len(c) for c in seq_ids])
            seq_ids = [c for c, t in zip(seq_ids, cum) if t <= max_tokens]
            span_fn = chunk_span_masking
        else:
            raise ValueError(f"invalid sequence {sequence!r}")
        input_seq, target_seq = self._span_mask_budgeted(seq_ids, span_fn, input_budget, keep_scheme)
        return self._pack_sequence(input_seq, target_seq, max_tokens, input_budget, target_budget)

    def sequence_token_mask(self, sequence_ids: Sequence[int], max_tokens: int, input_budget: int,
                            target_budget: Optional[int], keep_scheme: str,
                            vocab_offset: int = 0) -> Dict[str, np.ndarray]:
        """Span-mask an already-tokenized sequence (e.g. SAM instances): ids are
        offset past the sentinel range (reference masking.py:268-343)."""
        seq_ids = [int(t) + vocab_offset for t in sequence_ids]
        input_seq, target_seq = self._span_mask_budgeted(
            seq_ids, simple_span_masking, input_budget, keep_scheme
        )
        return self._pack_sequence(input_seq, target_seq, max_tokens, input_budget, target_budget)

    def sequence_emb_mask_span(self, emb_tensor: np.ndarray, max_tokens: int,
                               input_budget: int, keep_scheme: str) -> Dict[str, np.ndarray]:
        """Span-mask a continuous embedding sequence; input-only modality
        (reference masking.py:448-516). Masked spans collapse to zero vectors."""
        emb_tensor = np.asarray(emb_tensor)
        L = min(len(emb_tensor), max_tokens)
        fake_ids = list(range(10**6, 10**6 + L))  # ids disjoint from sentinel ids
        if input_budget == 0:
            input_seq = []
        else:
            keep_prob = self._keep_prob(keep_scheme)
            input_seq, _ = simple_span_masking(fake_ids, self.sentinel_to_id, keep_prob, self.rng)
            while len(input_seq) > input_budget:
                keep_prob *= self.KEEP_PROB_DECAY
                input_seq, _ = simple_span_masking(fake_ids, self.sentinel_to_id, keep_prob, self.rng)
        tensor = np.zeros((max_tokens, emb_tensor.shape[1]), dtype=np.float32)
        input_mask = np.ones(max_tokens, dtype=bool)
        for i, fid in enumerate(input_seq):
            if fid not in self.sentinel_ids:
                tensor[i] = emb_tensor[fid - 10**6]
            # sentinel slots stay zero vectors
        input_mask[: len(input_seq)] = False
        return {
            "tensor": tensor,
            "input_mask": input_mask,
            "target_mask": np.ones(max_tokens, dtype=bool),
            "decoder_attention_mask": np.zeros(max_tokens, dtype=np.int32),
        }

    # ---------------------------------------------------------------- call

    def __call__(self, mod_dict: Dict[str, object]) -> Dict[str, Dict[str, np.ndarray]]:
        """Mask one sample: {mod: raw value} -> {mod: fixed-shape arrays}
        (reference masking.py:519-564)."""
        if self.sampling_weights is not None:
            mix_idx = int(self.rng.choice(self.num_mixtures, p=self.sampling_weights))
        else:
            mix_idx = int(self.rng.integers(0, self.num_mixtures))
        num_input_tokens = int(self.rng.integers(self.input_tokens_range[0], self.input_tokens_range[1] + 1))
        num_target_tokens = (
            int(self.rng.integers(self.target_tokens_range[0], self.target_tokens_range[1] + 1))
            if self.target_tokens_range is not None else None
        )
        input_budget = self.input_token_budget(num_input_tokens, mix_idx)
        if num_target_tokens is not None:
            target_budget = self.target_token_budget(input_budget, num_target_tokens, mix_idx)
        else:
            target_budget = [None] * len(self.mod_names)

        out = {}
        for (name, spec), in_b, tgt_b in zip(self.modality_info.items(), input_budget, target_budget):
            value = mod_dict[name]
            scheme = self.keep_schemes[name][mix_idx]
            if spec.type == "img":
                out[name] = self.image_mask(value, spec.resolved_max_tokens(), in_b, tgt_b)
            elif spec.type == "seq":
                out[name] = self.sequence_mask(value, spec.resolved_max_tokens(), in_b, tgt_b, scheme)
            elif spec.type == "seq_token":
                out[name] = self.sequence_token_mask(
                    value, spec.resolved_max_tokens(), in_b, tgt_b, scheme
                )
            elif spec.type == "seq_emb":
                out[name] = self.sequence_emb_mask_span(value, spec.resolved_max_tokens(), in_b, scheme)
            else:
                raise ValueError(f"invalid modality type {spec.type}")
        return out


class TransferMasking:
    """Fixed input/target modality split for transfer learning (the JAX
    package's fourm_tpu/data/masking.py:387-470; reference masking.py:567-
    746): every token of an input modality is an input, every token of a
    target modality a target. Sequences are span-masked with keep
    probability 1.0 (inputs) or 0.0 (targets) on one np.random.Generator
    stream, so the same seed gives the JAX package's arrays draw for draw."""

    def __init__(self, modality_info: Dict[str, ModalitySpec], text_tokenizer,
                 input_modalities: Sequence[str], target_modalities: Sequence[str],
                 seed: Optional[int] = None):
        self.modality_info = dict(modality_info)
        self.input_modalities = set(input_modalities)
        self.target_modalities = set(target_modalities)
        self.text_tokenizer = text_tokenizer
        if text_tokenizer is not None:
            self.sentinel_to_id = get_sentinel_to_id_mapping(text_tokenizer)
            self.sentinel_ids = set(self.sentinel_to_id.values())
            self.pad_id = text_tokenizer.token_to_id("[PAD]")
            self.eos_id = text_tokenizer.token_to_id("[EOS]")
        self.rng = np.random.default_rng(seed)

    def input_image(self, tensor, num_tokens: int) -> Dict[str, np.ndarray]:
        return {
            "tensor": np.asarray(tensor),
            "input_mask": np.zeros(num_tokens, dtype=bool),
            "target_mask": np.ones(num_tokens, dtype=bool),
            "decoder_attention_mask": np.zeros(num_tokens, dtype=np.int32),
        }

    def target_image(self, tensor, num_tokens: int) -> Dict[str, np.ndarray]:
        dam = np.zeros(num_tokens, dtype=np.int32)
        dam[0] = num_tokens
        return {
            "tensor": np.asarray(tensor),
            "input_mask": np.ones(num_tokens, dtype=bool),
            "target_mask": np.zeros(num_tokens, dtype=bool),
            "decoder_attention_mask": dam,
        }

    def _pack(self, input_seq, target_seq, max_tokens) -> Dict[str, np.ndarray]:
        max_length = (max_tokens + 1) * 2
        target_at = max_tokens
        tensor = np.full(max_length, self.pad_id, dtype=np.int32)
        input_mask = np.ones(max_length, dtype=bool)
        target_mask = np.ones(max_length, dtype=bool)
        dam = np.zeros(max_length, dtype=np.int32)
        tensor[: len(input_seq)] = input_seq
        input_mask[: len(input_seq)] = False
        tensor[target_at: target_at + len(target_seq)] = target_seq
        target_mask[target_at: target_at + len(target_seq)] = False
        dam[target_at: target_at + len(target_seq)] = 1
        return {"tensor": tensor, "input_mask": input_mask, "target_mask": target_mask,
                "decoder_attention_mask": dam}

    def _encode(self, sequence_str: str, max_tokens: int) -> List[int]:
        seq_ids = self.text_tokenizer.encode(sequence_str).ids
        seq_ids.append(self.eos_id)
        return seq_ids[:max_tokens]

    def input_sequence(self, sequence_str: str, max_tokens: int) -> Dict[str, np.ndarray]:
        seq_ids = self._encode(sequence_str, max_tokens)
        input_seq, target_seq = simple_span_masking(seq_ids, self.sentinel_to_id, 1.0, self.rng)
        return self._pack(input_seq, target_seq, max_tokens)

    def target_sequence(self, sequence_str: str, max_tokens: int) -> Dict[str, np.ndarray]:
        seq_ids = self._encode(sequence_str, max_tokens)
        input_seq, target_seq = simple_span_masking(seq_ids, self.sentinel_to_id, 0.0, self.rng)
        return self._pack(input_seq, target_seq, max_tokens)

    def __call__(self, mod_dict: Dict[str, object]) -> Dict[str, Dict[str, np.ndarray]]:
        out = {}
        for name, spec in self.modality_info.items():
            if name not in mod_dict:
                continue
            value = mod_dict[name]
            n = spec.resolved_max_tokens()
            if spec.type == "img":
                out[name] = (self.input_image(value, n) if name in self.input_modalities
                             else self.target_image(value, n))
            elif spec.type in SEQ_TYPES:
                out[name] = (self.input_sequence(value, n) if name in self.input_modalities
                             else self.target_sequence(value, n))
            else:
                raise ValueError(f"unsupported transfer modality type {spec.type}")
        return out
