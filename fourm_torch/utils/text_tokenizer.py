"""The shared text tokenizer of 4M, PyTorch port: the port's own reader of
the WordPiece `tokenizer.json` and the sentinel helpers.

`load_tokenizer(path)` reads the tokenizer JSON of the 4M release
(text_tokenizer_4m_wordpiece_30k.json) and of fourm_tpu/utils/
text_tokenizer.py:train_unified_wordpiece_tokenizer, where the JAX package
calls `tokenizers.Tokenizer.from_file` (the machine with the card has no
`tokenizers`). It implements that family's pipeline as the `tokenizers`
library runs it: the added tokens (`single_word`, `lstrip`, `rstrip`,
`normalized`, `special`: the sentinels [S_i], the coordinate tokens v0=..,
multi-word class names) split out first, then the BertNormalizer
(clean_text, handle_chinese_chars, strip_accents, lowercase), the
BertPreTokenizer and the WordPiece model; decoding by the WordPiece
decoder (with cleanup). It answers `encode(text).ids`, `decode(ids,
skip_special_tokens=)`, `get_vocab()`, `token_to_id()`, `id_to_token()`.
A component of any other type raises, naming it.

The sentinel helpers are the port's own copies of
`get_sentinel_to_id_mapping`, `split_by_sentinel` and `merge_span_masking`
of fourm_tpu/utils/text_tokenizer.py:116-146 (reference
fourm/utils/tokenizer/text_tokenizer.py:108-135): the sampler's device span
merges need the first, token decoding (utils/decoding.py) the host merge.
They are duck-typed on a tokenizer object with `get_vocab()` (token -> id)
and `token_to_id(token)`: the reader above serves, and so does any
stand-in with the same layout ([PAD]=0, [UNK]=1, [SOS]=2, [EOS]=3, then
the sentinels [S_0], [S_1], ...).
"""

from __future__ import annotations

import json
import unicodedata
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple


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


# ------------------------------------------------- the WordPiece tokenizer

# Unicode White_Space (Rust's char::is_whitespace, which the library uses)
_WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                         + "".join(chr(c) for c in range(0x2000, 0x200B)))
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
_CONTROL = ("Cc", "Cf", "Co", "Cs")  # clean_text's "other" (unassigned code points stay)
_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
            (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"),
            (" 're", "'re"))


def _is_word_char(c: str) -> bool:
    """Rust regex's \\w: alphabetic, marks, decimal digits, connector
    punctuation, joiners."""
    cat = unicodedata.category(c)
    return cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d"


def _is_chinese(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _is_punct(c: str) -> bool:
    return c in _ASCII_PUNCT or unicodedata.category(c)[0] == "P"


@dataclass
class Encoding:
    """What `encode` gives."""

    ids: List[int]


class _AddedTokens:
    """Added tokens matched as the library's AddedVocabulary does: leftmost-
    longest, non-overlapping, then a `single_word` match that touches a
    word character on either side is dropped (its text is not searched
    again); `lstrip` / `rstrip` take the blanks beside a match."""

    def __init__(self, tokens: List[dict]):
        """tokens: the JSON's added-token entries, each with "match", the
        text it matches (the content, normalized for a normalized token)."""
        self.tokens = {t["match"]: t for t in tokens}
        self.longest = max((len(c) for c in self.tokens), default=0)

    def split(self, text: str) -> List[Tuple[str, Optional[dict]]]:
        out, start, i = [], 0, 0
        while i < len(text):
            tok = None
            for n in range(min(self.longest, len(text) - i), 0, -1):
                tok = self.tokens.get(text[i:i + n])
                if tok is not None:
                    break
            if tok is None:
                i += 1
                continue
            b, e = i, i + len(tok["match"])
            i = e
            if tok.get("single_word") and ((b > 0 and _is_word_char(text[b - 1])) or
                                           (e < len(text) and _is_word_char(text[e]))):
                continue
            if tok.get("lstrip"):
                while b > start and text[b - 1] in _WHITE_SPACE:
                    b -= 1
            if tok.get("rstrip"):
                while e < len(text) and text[e] in _WHITE_SPACE:
                    e += 1
                i = e
            if start < b:
                out.append((text[start:b], None))
            out.append((text[b:e], tok))
            start = e
        if start < len(text) or not out:
            out.append((text[start:], None))
        return out


class WordPieceTokenizer:
    """A `tokenizer.json` of the BertNormalizer / BertPreTokenizer /
    WordPiece family (see the module docstring)."""

    def __init__(self, spec: dict):
        for part, allowed in (("normalizer", ("BertNormalizer",)),
                              ("pre_tokenizer", ("BertPreTokenizer",)),
                              ("model", ("WordPiece",)), ("decoder", ("WordPiece",))):
            kind = (spec.get(part) or {}).get("type")
            if kind not in allowed:
                raise NotImplementedError(f"tokenizer.json: {part} of type {kind!r} is not "
                                          f"read by the port (it reads {allowed[0]})")
        for part in ("post_processor", "truncation", "padding"):
            if spec.get(part) is not None:
                kind = spec[part].get("type", part) if isinstance(spec[part], dict) else part
                raise NotImplementedError(f"tokenizer.json: {part} {kind!r} is not read by "
                                          "the port")
        norm = spec["normalizer"]
        self.clean_text = norm.get("clean_text", True)
        self.handle_chinese_chars = norm.get("handle_chinese_chars", True)
        self.lowercase = norm.get("lowercase", True)
        strip = norm.get("strip_accents")
        self.strip_accents = self.lowercase if strip is None else strip
        model = spec["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.unk_token = model.get("unk_token", "[UNK]")
        self.prefix = model.get("continuing_subword_prefix", "##")
        self.max_chars = model.get("max_input_chars_per_word", 100)
        self.decoder_prefix = spec["decoder"].get("prefix", "##")
        self.cleanup = spec["decoder"].get("cleanup", True)
        added = spec.get("added_tokens") or []
        self.added = {t["content"]: t["id"] for t in added}
        self.special = {t["content"] for t in added if t.get("special")}
        self._raw = _AddedTokens([dict(t, match=t["content"]) for t in added
                                  if not t.get("normalized")])
        self._normed = _AddedTokens([dict(t, match=self.normalize(t["content"])) for t in added
                                     if t.get("normalized")])
        self.id_to_tok = {i: t for t, i in self.vocab.items()}
        self.id_to_tok.update({i: t for t, i in self.added.items()})

    @classmethod
    def from_file(cls, path: str) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    # -- the pipeline
    def normalize(self, text: str) -> str:
        if self.clean_text:
            text = "".join(" " if c in _WHITE_SPACE else c for c in text
                           if not (c in "\x00\ufffd" or (c not in "\t\n\r" and
                                                          unicodedata.category(c) in _CONTROL)))
        if self.handle_chinese_chars:
            text = "".join(f" {c} " if _is_chinese(c) else c for c in text)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self.lowercase:
            text = "".join(c.lower() for c in text)
        return text

    @staticmethod
    def pre_tokenize(text: str) -> List[str]:
        words, cur = [], []
        for c in text:
            if c in _WHITE_SPACE or _is_punct(c):
                if cur:
                    words.append("".join(cur))
                    cur = []
                if c not in _WHITE_SPACE:
                    words.append(c)
            else:
                cur.append(c)
        if cur:
            words.append("".join(cur))
        return words

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 else self.prefix + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            if start == end:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def encode(self, text: str) -> Encoding:
        ids = []
        for part, tok in self._raw.split(text):
            if tok is not None:
                ids.append(tok["id"])
                continue
            for sub, ntok in self._normed.split(self.normalize(part)):
                if ntok is not None:
                    ids.append(ntok["id"])
                    continue
                for word in self.pre_tokenize(sub):
                    for piece in self.wordpiece(word):
                        if piece not in self.vocab:
                            raise KeyError(f"the WordPiece vocabulary lacks {piece!r}")
                        ids.append(self.vocab[piece])
        return Encoding(ids)

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        tokens = [self.id_to_tok[i] for i in (int(x) for x in ids) if i in self.id_to_tok]
        if skip_special_tokens:
            tokens = [t for t in tokens if t not in self.special]
        out = []
        for n, tok in enumerate(tokens):
            if n:
                tok = (tok[len(self.decoder_prefix):] if tok.startswith(self.decoder_prefix)
                       else " " + tok)
            if self.cleanup:
                for a, b in _CLEANUP:
                    tok = tok.replace(a, b)
            out.append(tok)
        return "".join(out)

    # -- the vocabulary
    def get_vocab(self, with_added_tokens: bool = True) -> Dict[str, int]:
        vocab = dict(self.vocab)
        if with_added_tokens:
            vocab.update(self.added)
        return vocab

    def token_to_id(self, token: str) -> Optional[int]:
        return self.added.get(token, self.vocab.get(token))

    def id_to_token(self, i: int) -> Optional[str]:
        return self.id_to_tok.get(int(i))


def load_tokenizer(path: str) -> WordPieceTokenizer:
    """The tokenizer JSON at `path` (fourm_tpu/utils/text_tokenizer.py:108-112
    reads it with tokenizers.Tokenizer.from_file)."""
    return WordPieceTokenizer.from_file(path)
