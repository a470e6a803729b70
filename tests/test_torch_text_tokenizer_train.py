"""The port's WordPiece trainer (fourm_torch.utils.text_tokenizer:
train_unified_wordpiece_tokenizer, cli/train_text_tokenizer) against the
JAX package's, which runs the `tokenizers` library's WordPieceTrainer, on
the CPU.

The library numbers the `##` continuation characters in hash-map order, so
its ids differ from run to run, and where two merges tie on a count the
order of those ids decides, so even its vocabulary may differ. Two kinds of
check follow from that:
  * exact: given the `##` order of one library run, the port's trainer
    gives that run's vocabulary, every id equal, on any corpus (ties
    included);
  * against the library as it runs: seeded corpora drawn by hypothesis,
    built so that no merge up to the cut is decided by a tie between `##`
    ids (word counts are distinct powers of two over words of two or three
    characters; accents, CJK, punctuation and added tokens appear once
    each, below every cut). The library is trained 5 times on each, and
    the 5 runs must give one vocabulary (a corpus that ties at the cut
    fails here, loudly); then the port's token set equals it, the ids of
    the specials, the alphabet and every merged token equal the library's
    wherever its runs agree, the `##` alphabet fills the same id range,
    held-out text encodes to the same token strings, the library reads the
    port's tokenizer.json to the same ids as the port's reader, and two
    port runs write byte-identical files.
"""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import json
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer

from fourm_tpu.cli import train_text_tokenizer as jax_cli
from fourm_tpu.utils import text_tokenizer as jt
from fourm_torch.cli import train_text_tokenizer as port_cli
from fourm_torch.utils import text_tokenizer as pt

SPECIALS = dict(sentinels=4, bins=3, classes=["fire hydrant", "dog"])
EXTRAS = ["Café", "北京", "naïve", "Über", "[S_3]", "v0=7", "fire hydrant", "x,y", "(it)!",
          "dog's"]
HELD_OUT = ["A photo of [S_3] a fire hydrant v0=7 next to the Café.",
            "Über naïve 北京 hello-world, dog! x v1=2 [S_0]",
            "", "zzz qqq", "ab abc ba cab"]


def _specials(mod):
    return dict(sentinel_tokens=mod.generate_sentinel_tokens(SPECIALS["sentinels"]),
                coord_tokens=mod.generate_coord_tokens(SPECIALS["bins"]),
                object_class_tokens=mod.generate_object_class_tokens(SPECIALS["classes"]))


def _lib(path, vocab_size, min_frequency=0):
    return jt.train_unified_wordpiece_tokenizer(str(path), vocab_size, **_specials(jt),
                                                min_frequency=min_frequency,
                                                show_progress=False)


def _port(path, vocab_size, min_frequency=0):
    return pt.train_unified_wordpiece_tokenizer(str(path), vocab_size, **_specials(pt),
                                                min_frequency=min_frequency,
                                                show_progress=False)


def _tie_free_corpus(seed: int) -> str:
    """Word counts 4, 8, 16, ... over 6-9 distinct words of 2-3 letters (an
    accent or two among them), then the extras once each, shuffled."""
    r = random.Random(seed)
    letters = "abcdefghiklmnoprstuwyéñ"
    n, lex, seen = r.randint(6, 9), [], set()
    while len(lex) < n:
        w = "".join(r.choice(letters) for _ in range(r.randint(2, 3)))
        key = w.replace("é", "e").replace("ñ", "n")
        if key not in seen:
            seen.add(key)
            lex.append(w)
    words = [w for i, w in enumerate(lex) for _ in range(4 << i)] + EXTRAS
    r.shuffle(words)
    return "\n".join(" ".join(words[i:i + 9]) for i in range(0, len(words), 9)) + "\n"


def _zipf_corpus(seed: int) -> str:
    """Random words at Zipf-like counts: many ties."""
    r = random.Random(seed)
    lex = ["".join(r.choice("abcdefghiklmnoprstu") for _ in range(r.randint(1, 8)))
           for _ in range(120)]
    words = [r.choice(lex[:r.randint(1, 120)]) for _ in range(1500)] + EXTRAS
    return "\n".join(" ".join(words[i:i + 11]) for i in range(0, len(words), 11)) + "\n"


def _continuation_order(vocab: dict, prefix: str = "##") -> list:
    """The library run's `##` characters, by id."""
    return [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])
            if t.startswith(prefix) and len(t) == len(prefix) + 1]


def _cont(token: str) -> bool:
    """A `##` continuation character of the alphabet."""
    return token.startswith("##") and len(token) == 3


def _special_contents():
    return ["[PAD]", "[UNK]", "[SOS]", "[EOS]"] + [
        t.content for t in (pt.generate_sentinel_tokens(SPECIALS["sentinels"])
                            + pt.generate_coord_tokens(SPECIALS["bins"])
                            + pt.generate_object_class_tokens(SPECIALS["classes"]))]


@pytest.mark.parametrize("seed, extra, min_frequency", [(0, 60, 0), (1, 200, 0), (2, 120, 2),
                                                        (3, 400, 0)])
def test_trainer_equals_a_library_run_given_its_continuation_order(tmp_path, seed, extra,
                                                                    min_frequency):
    """On a corpus full of ties, each of 5 library runs is reproduced id for
    id by the port given that run's `##` order."""
    path = tmp_path / "c.txt"
    path.write_text(_zipf_corpus(seed))
    counts = pt.count_words([str(path)])
    specials = _special_contents()
    base = len(pt.train_wordpiece_vocab(counts, specials, 1)[0])
    for _ in range(5):
        lib = _lib(path, base + extra, min_frequency).get_vocab(with_added_tokens=False)
        port, _ = pt.train_wordpiece_vocab(counts, specials, base + extra, min_frequency,
                                           _continuation_order=_continuation_order(lib))
        assert port == lib


@settings(max_examples=12, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), cut=st.floats(0.0, 1.0),
       min_frequency=st.sampled_from([0, 4, 6]))
def test_trainer_matches_the_library(tmp_path_factory, seed, cut, min_frequency):
    d = tmp_path_factory.mktemp("corpus")
    path = d / "c.txt"
    path.write_text(_tie_free_corpus(seed))
    counts = pt.count_words([str(path)])
    specials = _special_contents()
    base = len(pt.train_wordpiece_vocab(counts, specials, 1)[0])  # no merge
    top = len(pt.train_wordpiece_vocab(counts, specials, 10**6, min_frequency=4)[0])
    vocab_size = base - 3 + round(cut * (top - base + 3))  # a few below the specials too

    runs = [_lib(path, vocab_size, min_frequency) for _ in range(5)]
    vocabs = [r.get_vocab(with_added_tokens=False) for r in runs]
    assert len({frozenset(v) for v in vocabs}) == 1, "the library's runs differ: a tie"
    port = _port(path, vocab_size, min_frequency)
    mine = port.get_vocab(with_added_tokens=False)
    assert set(mine) == set(vocabs[0])
    agreed = {t: i for t, i in vocabs[0].items() if all(v[t] == i for v in vocabs)}
    for t, i in agreed.items():
        if not _cont(t):
            assert mine[t] == i, t
    cont = [t for t in mine if _cont(t)]
    assert sorted(mine[t] for t in cont) == sorted(vocabs[0][t] for t in cont)
    assert port.get_vocab_size() == runs[0].get_vocab_size()

    out_a, out_b = d / "a.json", d / "b.json"
    port.save(str(out_a))
    _port(path, vocab_size, min_frequency).save(str(out_b))
    assert out_a.read_bytes() == out_b.read_bytes()
    reader, lib_reader = pt.load_tokenizer(str(out_a)), Tokenizer.from_file(str(out_a))
    for text in HELD_OUT:
        ids = reader.encode(text).ids
        assert lib_reader.encode(text).ids == ids
        assert [reader.id_to_token(i) for i in ids] == runs[0].encode(text).tokens
        assert reader.decode(ids) == runs[0].decode(runs[0].encode(text).ids)


def test_specials_beyond_vocab_size_and_the_token_helpers(tmp_path):
    """A vocabulary smaller than the specials and alphabet keeps them all, as
    the library does; the token helpers equal the JAX package's."""
    path = tmp_path / "c.txt"
    path.write_text(_tie_free_corpus(5))
    lib, port = _lib(path, 10), _port(path, 10)
    lv, pv = lib.get_vocab(), port.get_vocab()
    assert len(pv) > 10 and set(pv) == set(lv)
    assert {t: i for t, i in pv.items() if not _cont(t)} == \
        {t: i for t, i in lv.items() if not _cont(t)}
    assert sorted(i for t, i in pv.items() if _cont(t)) == \
        sorted(i for t, i in lv.items() if _cont(t))
    assert pt.COCO_CLASSES == jt.COCO_CLASSES
    for name, args in (("generate_sentinel_tokens", (7, 3)), ("generate_coord_tokens", (5,)),
                       ("generate_object_class_tokens", ())):
        ours, ref = getattr(pt, name)(*args), getattr(jt, name)(*args)
        assert [(t.content, t.single_word, t.lstrip, t.rstrip, t.normalized) for t in ours] == \
            [(t.content, t.single_word, t.lstrip, t.rstrip, t.normalized) for t in ref]
    port.save(str(tmp_path / "t.json"))
    spec = json.loads((tmp_path / "t.json").read_text())
    ref = json.loads(lib.to_str())
    assert [dict(t, id=None) for t in spec["added_tokens"]] == \
        [dict(t, id=None) for t in ref["added_tokens"]]
    for part in ("normalizer", "pre_tokenizer", "decoder", "post_processor", "truncation",
                 "padding"):
        assert spec[part] == ref[part], part
    assert {k: v for k, v in spec["model"].items() if k != "vocab"} == \
        {k: v for k, v in ref["model"].items() if k != "vocab"}


def test_ascii_fast_path_equals_the_general_path():
    """bert_normalize / bert_pre_tokenize take ASCII text by a translate
    table and one regex; the per-character path, which a non-ASCII
    character at the end makes them take, gives the same."""
    r = random.Random(0)
    alphabet = [chr(c) for c in range(128)]
    for _ in range(300):
        text = "".join(r.choice(alphabet) for _ in range(r.randint(0, 60)))
        for clean in (True, False):
            for lower in (True, False):
                fast = pt.bert_normalize(text, clean, True, lower, lower)
                assert fast == pt.bert_normalize(text + "\u00e9", clean, True, lower, lower)[:-1]
                assert pt.bert_pre_tokenize(fast) + ["\u00fc"] == \
                    pt.bert_pre_tokenize(fast + " \u00fc")


def test_cli_end_to_end(tmp_path, capsys):
    """`python -m fourm_torch.cli.train_text_tokenizer` with the JAX CLI's
    arguments: the full 4M specials (100 sentinels, 4 x 1000 coordinates,
    the COCO classes), a written corpus; the same closing line and
    vocabulary as the JAX CLI, and the file read by both readers alike."""
    path = tmp_path / "c.txt"
    path.write_text(_tie_free_corpus(11))
    counts = pt.count_words([str(path)])
    specials = (["[PAD]", "[UNK]", "[SOS]", "[EOS]"]
                + [t.content for t in pt.generate_sentinel_tokens() + pt.generate_coord_tokens()
                   + pt.generate_object_class_tokens()])
    vocab = len(pt.train_wordpiece_vocab(counts, specials, 1)[0]) + 12
    lines = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        out = str(tmp_path / f"{name}.json")
        cli.main(["--files", str(path), "--vocab_size", str(vocab), "--output", out])
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("saved tokenizer")][-1].replace(name, "X")
    assert lines["port"] == lines["jax"]
    port, ref = (json.load(open(tmp_path / f"{n}.json")) for n in ("port", "jax"))
    assert set(port["model"]["vocab"]) == set(ref["model"]["vocab"])
    assert len(port["added_tokens"]) == 4 + 100 + 4000 + 80
    text = "a person and a teddy bear [S_7] v2=999 " + " ".join(counts)
    ids = pt.load_tokenizer(str(tmp_path / "port.json")).encode(text).ids
    assert Tokenizer.from_file(str(tmp_path / "port.json")).encode(text).ids == ids
