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
decoder (with cleanup). It answers `encode(text).ids`, `encode_batch(texts)`, `decode(ids,
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

import heapq
import json
import os
import re
import unicodedata
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union


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


# ASCII text: clean_text drops the control characters but \t \n \r, which
# become blanks; a word is a run of what is neither blank nor punctuation
_ASCII_CLEAN = {c: None for c in (*range(32), 127) if chr(c) not in "\t\n\r"}
_ASCII_CLEAN.update({ord(c): " " for c in "\t\n\r"})
_ASCII_PIECES = re.compile(r"[^\t\n\x0b\x0c\r !-/:-@\[-`{-~]+|[!-/:-@\[-`{-~]")


def bert_normalize(text: str, clean_text: bool = True, handle_chinese_chars: bool = True,
                   strip_accents: bool = True, lowercase: bool = True) -> str:
    """The library's BertNormalizer (strip_accents given, not None)."""
    if text.isascii():  # no CJK, nothing to strip: the same result, fast
        if clean_text:
            text = text.translate(_ASCII_CLEAN)
        return text.lower() if lowercase else text
    if clean_text:
        text = "".join(" " if c in _WHITE_SPACE else c for c in text
                       if not (c in "\x00\ufffd" or (c not in "\t\n\r" and
                                                      unicodedata.category(c) in _CONTROL)))
    if handle_chinese_chars:
        text = "".join(f" {c} " if _is_chinese(c) else c for c in text)
    if strip_accents:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    if lowercase:
        text = "".join(c.lower() for c in text)
    return text


def bert_pre_tokenize(text: str) -> List[str]:
    """The library's BertPreTokenizer: split on blanks, each punctuation mark
    a word of its own."""
    if text.isascii():
        return _ASCII_PIECES.findall(text)
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
        self.spec = spec
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
        return bert_normalize(text, self.clean_text, self.handle_chinese_chars,
                              self.strip_accents, self.lowercase)

    pre_tokenize = staticmethod(bert_pre_tokenize)

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

    def encode_batch(self, texts: Iterable[str]) -> List[Encoding]:
        return [self.encode(t) for t in texts]

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

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        return len(self.get_vocab(with_added_tokens))

    def save(self, path: str) -> None:
        """Write the tokenizer JSON (the library's layout: `tokenizers.
        Tokenizer.from_file` reads it too)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.spec, f, indent=2, ensure_ascii=False)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.added.get(token, self.vocab.get(token))

    def id_to_token(self, i: int) -> Optional[str]:
        return self.id_to_tok.get(int(i))


def load_tokenizer(path: str) -> WordPieceTokenizer:
    """The tokenizer JSON at `path` (fourm_tpu/utils/text_tokenizer.py:108-112
    reads it with tokenizers.Tokenizer.from_file)."""
    return WordPieceTokenizer.from_file(path)


# ------------------------------------------------- training the tokenizer

# The COCO-80 class names (alphabetical): the default object-class tokens
# (fourm_tpu/utils/text_tokenizer.py:27; reference object_classes.json "coco")
COCO_CLASSES = [
    "airplane", "apple", "backpack", "banana", "baseball bat", "baseball glove",
    "bear", "bed", "bench", "bicycle", "bird", "boat", "book", "bottle", "bowl",
    "broccoli", "bus", "cake", "car", "carrot", "cat", "cell phone", "chair",
    "clock", "couch", "cow", "cup", "dining table", "dog", "donut", "elephant",
    "fire hydrant", "fork", "frisbee", "giraffe", "hair drier", "handbag", "horse",
    "hot dog", "keyboard", "kite", "knife", "laptop", "microwave", "motorcycle",
    "mouse", "orange", "oven", "parking meter", "person", "pizza", "potted plant",
    "refrigerator", "remote", "sandwich", "scissors", "sheep", "sink", "skateboard",
    "skis", "snowboard", "spoon", "sports ball", "stop sign", "suitcase",
    "surfboard", "teddy bear", "tennis racket", "tie", "toaster", "toilet",
    "toothbrush", "traffic light", "train", "truck", "tv", "umbrella", "vase",
    "wine glass", "zebra",
]


@dataclass(frozen=True)
class AddedToken:
    """A token matched before the normalizer (the library's AddedToken, with
    its defaults)."""

    content: str
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = True
    special: bool = False


def generate_sentinel_tokens(num: int = 100, start_id: int = 0) -> List[AddedToken]:
    return [AddedToken(content=f"[S_{i}]", single_word=True, normalized=False)
            for i in range(start_id, num + start_id)]


def generate_coord_tokens(bins: int = 1000) -> List[AddedToken]:
    """Coordinate value tokens v0=..v3= used by det/pose/palette/metadata."""
    return [AddedToken(content=s.format(i), single_word=True, normalized=False)
            for s in ("v0={}", "v1={}", "v2={}", "v3={}") for i in range(bins)]


def generate_object_class_tokens(classes: Optional[Sequence[str]] = None) -> List[AddedToken]:
    classes = classes if classes is not None else COCO_CLASSES
    return [AddedToken(content=c, single_word=True, normalized=True) for c in classes]


class _Pos(set):
    """The words that hold a queued pair. Two queue entries of one pair and
    count are equal, as in the library's heap: neither is less."""

    def __lt__(self, other):
        return False


def _merge_word(syms: List[int], a: int, b: int, new: int) -> List[Tuple[Tuple[int, int], int]]:
    """Merge every (a, b) of the word in place, left to right; the pair
    count changes, as the library's Word::merge gives them (the merged pair's
    own count is left as it was)."""
    changes = []
    i = 0
    while i < len(syms):
        if syms[i] == a and i + 1 < len(syms) and syms[i + 1] == b:
            if i > 0:
                changes.append(((syms[i - 1], a), -1))
                changes.append(((syms[i - 1], new), 1))
            syms[i:i + 2] = [new]
            if i < len(syms) - 1:
                changes.append(((b, syms[i + 1]), -1))
                changes.append(((new, syms[i + 1]), 1))
        i += 1
    return changes


def train_wordpiece_vocab(word_counts: Dict[str, int], special_tokens: Sequence[str],
                          vocab_size: int, min_frequency: int = 0, prefix: str = "##",
                          _continuation_order: Sequence[str] = ()) -> Tuple[Dict[str, int], int]:
    """The library's WordPieceTrainer: its BPE trainer with the continuing-
    subword prefix, on the counted words, turned into a WordPiece vocabulary.

    The special tokens take ids 0.. in order, then the alphabet by code
    point, then the `prefix` characters, each at its first appearance in
    `word_counts`' order (the library takes them in hash-map order, so its
    ids differ from run to run, and so may its merges where counts tie).
    `_continuation_order` exists to reproduce one library run: given that
    run's `prefix` characters by id, those that occur come first in that
    order, and the result is that run's vocabulary. A merge takes
    the most frequent pair, a tie the smaller (left id, right id); counts
    live per pair with the words that hold it, only the merged words are
    updated, and a max-heap keeps stale entries until they surface (lazy
    invalidation). Training stops at `vocab_size` tokens or below
    `min_frequency`; specials and alphabet are all kept even past
    `vocab_size`. Returns (token -> id, merges made)."""
    w2id: Dict[str, int] = {}

    def add(tok):
        if tok not in w2id:
            w2id[tok] = len(w2id)
        return w2id[tok]

    for tok in special_tokens:
        add(tok)
    alphabet = set()
    for w in word_counts:
        alphabet.update(w)
    for c in sorted(alphabet):
        add(c)
    inner = {c for w in word_counts for c in w[1:]}
    for tok in _continuation_order:
        if tok.startswith(prefix) and tok[len(prefix):] in inner:
            add(tok)
    words, counts = [], []
    for w, n in word_counts.items():
        words.append([add(c if i == 0 else prefix + c) for i, c in enumerate(w)])
        counts.append(n)
    id2w = list(w2id)

    pair_counts: Dict[Tuple[int, int], int] = {}
    where: Dict[Tuple[int, int], _Pos] = {}
    for i, syms in enumerate(words):
        n = counts[i]
        for p in zip(syms, syms[1:]):
            pair_counts[p] = pair_counts.get(p, 0) + n
            pos = where.get(p)
            if pos is None:
                where[p] = pos = _Pos()
            pos.add(i)
    # min-heap of (-count, pair, words): the most frequent first, then the
    # smaller pair
    queue = [(-pair_counts[p], p, pos) for p, pos in where.items() if pair_counts[p] > 0]
    heapq.heapify(queue)
    merges = 0
    while len(w2id) < vocab_size and queue:
        neg, pair, pos = heapq.heappop(queue)
        count = pair_counts[pair]
        if -neg != count:
            heapq.heappush(queue, (-count, pair, pos))
            continue
        if count < 1 or min_frequency > count:
            break
        a, b = pair
        right = id2w[b]
        if right.startswith(prefix):
            right = right[len(prefix):]
        tok = id2w[a] + right
        new = w2id.get(tok)
        if new is None:
            new = w2id[tok] = len(id2w)
            id2w.append(tok)
        merges += 1
        where = {}
        for iw in pos:
            n = counts[iw]
            for p, change in _merge_word(words[iw], a, b, new):
                pair_counts[p] = pair_counts.get(p, 0) + change * n
                if change > 0:
                    s = where.get(p)
                    if s is None:
                        where[p] = s = _Pos()
                    s.add(iw)
        for p, s in where.items():
            if pair_counts[p] > 0:
                heapq.heappush(queue, (-pair_counts[p], p, s))
    return w2id, merges


def count_words(files: Sequence[str], lowercase: bool = True) -> Dict[str, int]:
    """Word counts of text files after the BertNormalizer and the
    BertPreTokenizer, as the library's trainer counts them (added tokens are
    not split out of the corpus), in order of first appearance."""
    counts: Dict[str, int] = {}
    for path in files:
        with open(path, encoding="utf-8") as f:
            for line in f:
                for word in bert_pre_tokenize(bert_normalize(line, strip_accents=lowercase,
                                                             lowercase=lowercase)):
                    counts[word] = counts.get(word, 0) + 1
    return counts


def _token_entry(tok, id_: int) -> dict:
    if isinstance(tok, str):  # a special token given by its text
        tok = AddedToken(tok, normalized=False)
    return {"id": id_, "content": tok.content, "single_word": tok.single_word,
            "lstrip": tok.lstrip, "rstrip": tok.rstrip, "normalized": tok.normalized,
            "special": True}


def train_unified_wordpiece_tokenizer(
    files: Union[str, Sequence[str]],
    vocab_size: int,
    sentinel_tokens: Optional[List] = None,
    coord_tokens: Optional[List] = None,
    object_class_tokens: Optional[List] = None,
    unk_token: str = "[UNK]",
    pad_token: str = "[PAD]",
    sos_token: str = "[SOS]",
    eos_token: str = "[EOS]",
    additional_special_tokens: Optional[List] = None,
    min_frequency: int = 0,
    lowercase: bool = True,
    wordpieces_prefix: str = "##",
    show_progress: bool = True,
) -> WordPieceTokenizer:
    """Train the shared WordPiece tokenizer (fourm_tpu/utils/text_tokenizer.py:
    61, which runs the `tokenizers` library's WordPieceTrainer; reference
    text_tokenizer.py:47-105), deterministically.

    Special token order is load-bearing: [PAD]=0, [UNK]=1, [SOS]=2, [EOS]=3, then
    sentinels, coords, object classes. `show_progress` prints the counts; the
    tokenizer's `training` holds them ({"word_types", "words", "merges"}).
    Added tokens are not split out of the corpus, as in the library."""
    if isinstance(files, (str, os.PathLike)):
        files = [files]
    specials = [pad_token, unk_token, sos_token, eos_token]
    for extra in (sentinel_tokens, coord_tokens, object_class_tokens, additional_special_tokens):
        if extra is not None:
            specials.extend(extra)
    contents = [t if isinstance(t, str) else t.content for t in specials]
    word_counts = count_words(files, lowercase)
    vocab, merges = train_wordpiece_vocab(word_counts, contents, vocab_size, min_frequency,
                                          wordpieces_prefix)
    if show_progress:
        print(f"wordpiece: {len(word_counts)} word types, {merges} merges, vocab {len(vocab)}",
              flush=True)
    added, seen = [], set()
    for tok, content in zip(specials, contents):
        if content not in seen:
            seen.add(content)
            added.append(_token_entry(tok, vocab[content]))
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": lowercase},
        "pre_tokenizer": {"type": "BertPreTokenizer"}, "post_processor": None,
        "decoder": {"type": "WordPiece", "prefix": wordpieces_prefix, "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": str(unk_token),
                  "continuing_subword_prefix": wordpieces_prefix,
                  "max_input_chars_per_word": 100, "vocab": vocab},
    }
    tokenizer = WordPieceTokenizer(spec)
    tokenizer.training = {"word_types": len(word_counts), "words": sum(word_counts.values()),
                          "merges": merges}
    return tokenizer
