"""Sentinel lookup of the shared text tokenizer, PyTorch port.

The port's own copy of `get_sentinel_to_id_mapping` of
fourm_tpu/utils/text_tokenizer.py:116 (reference
fourm/utils/tokenizer/text_tokenizer.py:108-112); the device span merges of
the sampler need nothing else. It is duck-typed on a tokenizer object with
`get_vocab()` (token -> id) and `token_to_id(token)`,
so the port needs neither the `tokenizers` package nor JAX: a trained
WordPiece tokenizer serves, and so does any stand-in with the same layout
([PAD]=0, [UNK]=1, [SOS]=2, [EOS]=3, then the sentinels [S_0], [S_1], ...).
"""

from __future__ import annotations

from typing import Dict


def get_sentinel_to_id_mapping(tokenizer, match_str: str = "[S_") -> Dict[int, int]:
    """Map sentinel number -> vocab id (reference text_tokenizer.py:108-112)."""
    sentinel_tokens = {k: v for k, v in tokenizer.get_vocab().items() if k.startswith(match_str)}
    return {
        int(k.split("_")[1][:-1]): v
        for k, v in sorted(sentinel_tokens.items(), key=lambda x: x[1])
    }
