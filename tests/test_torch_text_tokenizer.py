"""The port's WordPiece reader (fourm_torch.utils.text_tokenizer.load_tokenizer)
against the `tokenizers` library on the same tokenizer.json, on the CPU.

The tokenizer is the 4M layout, trained here by the JAX package's
train_unified_wordpiece_tokenizer: [PAD] [UNK] [SOS] [EOS], 100 sentinels,
the 4 x 1000 coordinate tokens and the COCO class names (multi-word ones
such as "teddy bear") as added tokens, then a WordPiece vocabulary. For
each string: the ids of `encode` equal, exactly, and `decode` of those ids
equal with skip_special_tokens True and False; so do the vocabulary, the
id <-> token maps and the decoding of random ids (some outside the
vocabulary)."""

import json
import random

import pytest

from fourm_tpu.utils.text_tokenizer import (generate_coord_tokens, generate_object_class_tokens,
                                            generate_sentinel_tokens,
                                            train_unified_wordpiece_tokenizer)
from fourm_torch.utils.text_tokenizer import WordPieceTokenizer, load_tokenizer

CORPUS = ("a photo of a cat and a dog on the grass. The café's naïve résumé! 東京 is big; "
          "don't stop, it's fine. A teddy bear sits at a dining table with a hot dog.\n"
          "Two people ride bicycles past a stop sign near the traffic light?\n")

STRINGS = [
    "",
    "A photo of a CAT",
    "Café naïve RÉSUMÉ, déjà-vu!",
    "東京タワー 北京 is big",
    "ctrl\x00chars\x07 and\ttabs\nnew\rline\x0b\x0c\x85 zero​width�",
    "[S_0] a cat [S_1] a dog [S_99]",
    "[S_0]cat x[S_1] y [S_5]. b",
    "v0=12 v1=999 v2=0 v3=500",
    "v0=12v1=3 v0=1000 v0=-1",
    "a teddy bear and a Teddy Bear, teddy bears",
    "dining table hot dog cell phone teddy bear[S_2]",
    "xyzzyq qwrtp grasshopper",
    "a" * 150,
    "supercalifragilisticexpialidocious " + "b" * 101,
    "don't do not it's we're I'm they've",
    "   spaces   around   ",
    "(parens) [brackets] {braces} <angles> $5 + 3 = 8 ^_^ ~tilde~ `tick` #hash @at",
    "Ωμέγα Σίσυφος ΣΑΣ",
    "İstanbul ǅ ß ẞ ﬁ",
    "é combining ä",
    "emoji 😀 👍🏽 ★",
    "[PAD] [UNK] [SOS] [EOS] [EOS][EOS]",
    "cat's cat. cat",
    "　ideographic line nbsp",
]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("wordpiece")
    (d / "corpus.txt").write_text(CORPUS * 40)
    tok = train_unified_wordpiece_tokenizer(
        str(d / "corpus.txt"), vocab_size=4600,
        sentinel_tokens=generate_sentinel_tokens(num=100),
        coord_tokens=generate_coord_tokens(bins=1000),
        object_class_tokens=generate_object_class_tokens(), show_progress=False)
    path = str(d / "tokenizer.json")
    tok.save(path)
    return tok, load_tokenizer(path), path


@pytest.mark.parametrize("text", STRINGS, ids=range(len(STRINGS)))
def test_encode_and_decode_match_tokenizers(pair, text):
    ref, port, _ = pair
    ids = ref.encode(text).ids
    assert port.encode(text).ids == ids
    for skip in (True, False):
        assert port.decode(ids, skip_special_tokens=skip) == ref.decode(
            ids, skip_special_tokens=skip), skip


def test_vocabulary_and_random_decodes(pair):
    ref, port, _ = pair
    assert port.get_vocab() == ref.get_vocab()
    n = ref.get_vocab_size()
    assert all(port.id_to_token(i) == ref.id_to_token(i) for i in range(n + 5))
    assert all(port.token_to_id(t) == ref.token_to_id(t) for t in list(ref.get_vocab()) + ["?!"])
    rnd = random.Random(0)
    for _ in range(200):
        ids = [rnd.randrange(n + 40) for _ in range(rnd.randrange(40))]
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip), ids


def test_other_components_raise(pair):
    _, _, path = pair
    with open(path) as f:
        spec = json.load(f)
    for part, kind in (("normalizer", "NFKC"), ("pre_tokenizer", "ByteLevel"),
                       ("model", "BPE"), ("decoder", "ByteLevel")):
        with pytest.raises(NotImplementedError, match=kind):
            WordPieceTokenizer(dict(spec, **{part: {"type": kind}}))
    with pytest.raises(NotImplementedError, match="TemplateProcessing"):
        WordPieceTokenizer(dict(spec, post_processor={"type": "TemplateProcessing"}))
