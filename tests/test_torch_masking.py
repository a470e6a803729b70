"""The port's masking engine (fourm_torch/data/masking.py) against the JAX
package's (fourm_tpu/data/masking.py) on the CPU: the same inputs and seed
give equal arrays (np.array_equal), key for key.

UnifiedMasking on the 4M-21 modality set with its alphas mixture (three
Dirichlet mixtures, keep schemes per sequence modality) at 256 + 256
tokens, with fixed budgets and with `min_*_tokens` ranges, and on the
caption-biased mixture with sampling weights; the span maskers and the
budget draws directly. Inputs are what the transforms hand the masking:
token arrays, the normalized RGB image, caption / coordinate-token strings,
metadata chunks and T5 embeddings, from a seeded numpy generator.
"""

import os

import numpy as np
import pytest

from fourm_tpu.data import masking as jm
from fourm_tpu.data import pretrain_utils as jpu
from fourm_tpu.utils.text_tokenizer import (generate_coord_tokens, generate_object_class_tokens,
                                            generate_sentinel_tokens,
                                            train_unified_wordpiece_tokenizer)
from fourm_torch.data import masking as tm
from fourm_torch.data import pretrain_utils as tpu
from fourm_torch.data.modality_info import MODALITY_INFO
from fourm_torch.utils.config import load_yaml
from fourm_torch.utils.text_tokenizer import load_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHAS = {
    "mod21": ("cfgs/default/4m/models/main/4m-b_mod21_500b.yaml",
              "cfgs/default/4m/alphas_mixture/main/mix_mod21_all2allmix_rgb2all_capT5bias.yaml"),
    "caption_bias": (None,  # the alphas file's own domains
                     "cfgs/default/4m/alphas_mixture/specialized/mix_caption_bias_a0.2_a1.0.yaml"),
}
WORDS = "a the of on and near photo cat dog grass bicycle house person car red".split()


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    d = tmp_path_factory.mktemp("masking")
    (d / "corpus.txt").write_text((" ".join(WORDS) + "\n") * 40)
    tok = train_unified_wordpiece_tokenizer(
        str(d / "corpus.txt"), vocab_size=300, sentinel_tokens=generate_sentinel_tokens(num=100),
        coord_tokens=generate_coord_tokens(bins=1000),
        object_class_tokens=generate_object_class_tokens(), show_progress=False)
    tok.save(str(d / "tokenizer.json"))
    return tok, load_tokenizer(str(d / "tokenizer.json"))


def _dataset_config(name):
    run_cfg, alphas = ALPHAS[name]
    if run_cfg is not None:
        cfg = load_yaml(os.path.join(REPO, run_cfg))
        din, dout = cfg["in_domains"], cfg["out_domains"]
    else:
        din = dout = "-".join(load_yaml(os.path.join(REPO, alphas))["alphas_mixture"])
    return {"in_domains": din, "out_domains": dout, "alphas_config": os.path.join(REPO, alphas)}


def _sample(domains, rng):
    """One transformed sample: what each modality's transform returns."""
    out = {}
    for mod in domains:
        spec = MODALITY_INFO[mod]
        if mod == "rgb@224":
            out[mod] = rng.standard_normal((224, 224, 3)).astype(np.float32)
        elif spec.type == "img":
            out[mod] = rng.integers(0, spec.vocab_size, spec.resolved_max_tokens())
        elif spec.type == "seq_emb":
            out[mod] = rng.standard_normal((int(rng.integers(1, 40)), 4096)).astype(np.float32)
        elif mod == "metadata":
            out[mod] = [f"v1={int(k)} v0={int(v)}" for k, v in
                        zip(rng.permutation(21)[:int(rng.integers(1, 9))],
                            rng.integers(0, 999, 8))]
        elif mod in ("det", "human_poses", "sam_instance"):
            n = int(rng.integers(0, 30))
            out[mod] = " ".join(f"v{int(a)}={int(b)}" if a < 4 else str(rng.choice(WORDS))
                                for a, b in zip(rng.integers(0, 6, n), rng.integers(0, 999, n)))
        else:
            out[mod] = " ".join(rng.choice(WORDS, int(rng.integers(0, 60))))
    return out


def _assert_equal(got, ref):
    assert got.keys() == ref.keys()
    for mod in ref:
        assert got[mod].keys() == ref[mod].keys(), mod
        for k in ref[mod]:
            a, b = np.asarray(got[mod][k]), np.asarray(ref[mod][k])
            assert a.dtype == b.dtype and np.array_equal(a, b), (mod, k)


@pytest.mark.parametrize("budgets", [(256, 256, None, None), (256, 256, 64, 32), (128, 96, 0, 0)],
                         ids=["fixed", "min_tokens", "min_zero"])
@pytest.mark.parametrize("mixture", sorted(ALPHAS))
def test_unified_masking_equals_jax(tokenizers, mixture, budgets):
    jtok, ttok = tokenizers
    cfg = _dataset_config(mixture)
    setup = tpu.setup_sampling_mod_info(cfg)
    assert setup == jpu.setup_sampling_mod_info(cfg)
    domains, in_a, tgt_a, keep, weights = setup
    assert (weights is not None) == (mixture == "caption_bias")
    ni, nt, mi, mt = budgets
    ours = tpu.make_unified_masking(domains, ttok, ni, nt, in_a, tgt_a, keep, weights, mi, mt,
                                   seed=11)
    ref = jpu.make_unified_masking(domains, jtok, ni, nt, in_a, tgt_a, keep, weights, mi, mt,
                                   seed=11)
    rng = np.random.default_rng(5)
    for _ in range(12):
        sample = _sample(domains, rng)
        _assert_equal(ours(dict(sample)), ref(dict(sample)))


@pytest.mark.parametrize("keep_prob", [0.0, 0.3, 1.0])
def test_span_maskers_equal_jax(tokenizers, keep_prob):
    _, ttok = tokenizers
    sentinels = tm.get_sentinel_to_id_mapping(ttok)
    seq = list(range(200, 260))
    chunks = [list(range(300 + 3 * i, 303 + 3 * i)) for i in range(12)]
    for fn, data in (("simple_span_masking", seq), ("chunk_span_masking", chunks)):
        a = getattr(tm, fn)(data, sentinels, keep_prob, np.random.default_rng(2))
        b = getattr(jm, fn)(data, sentinels, keep_prob, np.random.default_rng(2))
        assert a == b, fn
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    assert [tm.sample_cosine(rng_a) for _ in range(5)] == [jm.sample_cosine(rng_b)
                                                            for _ in range(5)]
