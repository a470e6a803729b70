"""Sentinel helpers of the shared text tokenizer, PyTorch port.

The port's own copies of `get_sentinel_to_id_mapping`, `split_by_sentinel`
and `merge_span_masking` of fourm_tpu/utils/text_tokenizer.py:116-146
(reference fourm/utils/tokenizer/text_tokenizer.py:108-135): the sampler's
device span merges need the first, token decoding (utils/decoding.py) the
host merge. They are duck-typed on a tokenizer object with
`get_vocab()` (token -> id) and `token_to_id(token)`,
so the port needs neither the `tokenizers` package nor JAX: a trained
WordPiece tokenizer serves, and so does any stand-in with the same layout
([PAD]=0, [UNK]=1, [SOS]=2, [EOS]=3, then the sentinels [S_0], [S_1], ...).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional


def get_sentinel_to_id_mapping(tokenizer, match_str: str = "[S_") -> Dict[int, int]:
    """Map sentinel number -> vocab id (reference text_tokenizer.py:108-112)."""
    sentinel_tokens = {k: v for k, v in tokenizer.get_vocab().items() if k.startswith(match_str)}
    return {
        int(k.split("_")[1][:-1]): v
        for k, v in sorted(sentinel_tokens.items(), key=lambda x: x[1])
    }


def split_by_sentinel(seq_ids: List[int], sentinel_ids) -> Dict[Optional[int], List[int]]:
    """The tokens after each sentinel, by sentinel (tokens before the first
    under None)."""
    splits = defaultdict(list)
    cur = None
    for token in seq_ids:
        if token in sentinel_ids:
            cur = token
        else:
            splits[cur].append(token)
    return splits


def merge_span_masking(input_seq: List[int], decoder_seq: List[int], sentinel_ids) -> List[int]:
    """Splice the decoder's span contents back into the sentinel slots of the
    input sequence (fourm_tpu/utils/text_tokenizer.py:136; reference
    text_tokenizer.py:127-135)."""
    decoder_splits = split_by_sentinel(decoder_seq, sentinel_ids)
    out = []
    for token in input_seq:
        if token in sentinel_ids:
            out.extend(decoder_splits[token])
        else:
            out.append(token)
    return out
