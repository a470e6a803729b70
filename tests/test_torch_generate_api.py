"""The rest of the port's generation API (fourm_torch.generate.GenerationSampler:
generate_iter, generate_multi_guided, generate_sam_dense, merge_sequences)
against the JAX package's, on the CPU in fp32, with the same weights
(from_jax_params) and the same numpy-seeded inputs.

No random draw decides anything: image targets are decoded by MaskGIT, or
by one ROAR step over every remaining token, and sequence targets
autoregressively, all at temperature 0, so the tokens, input masks and
target masks of the two packages must be equal exactly. The host span
merge must equal the JAX package's exactly, and the port's device merges
must equal its host merge."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourm_tpu.generate import GenerationSampler as JaxGenerationSampler
from fourm_tpu.generate import build_chained_generation_schedules as jax_schedules
from fourm_tpu.generate import custom_text as jax_custom_text
from fourm_tpu.models import FourM as JaxFourM
from fourm_tpu.models import create_fourm_config as jax_config
from fourm_tpu.utils.synthetic import synthetic_mod_batch
from fourm_tpu.utils.text_tokenizer import (generate_sentinel_tokens,
                                            train_unified_wordpiece_tokenizer)
from fourm_torch.data.modality_info import MODALITY_INFO
from fourm_torch.generate import (GenerationSampler, build_chained_generation_schedules,
                                  custom_text, expand_to_batch, init_empty_target_modality,
                                  init_full_input_modality)
from fourm_torch.models import FourM, create_fourm_config
from fourm_torch.utils.checkpoint import from_jax_params

TINY = dict(dim=64, encoder_depth=2, decoder_depth=2, num_heads=4)
NAME = "fm_base_12e_12d_swiglu_qknorm_nobias"
MODS = ("rgb@224", "tok_clip@224", "tok_depth@224", "caption")
KEYS = ("tensor", "input_mask", "target_mask")


@pytest.fixture(scope="module")
def text_tok(tmp_path_factory):
    """The text tokenizer bench.py builds (bench.py:52-64): 300 WordPiece
    tokens, 20 sentinels [S_0]..[S_19]."""
    corpus = tmp_path_factory.mktemp("tok") / "corpus.txt"
    corpus.write_text("a photo of a cat and a dog\n" * 200)
    return train_unified_wordpiece_tokenizer(
        str(corpus), vocab_size=300, sentinel_tokens=generate_sentinel_tokens(num=20),
        show_progress=False)


@pytest.fixture(scope="module")
def pair(text_tok):
    jm = JaxFourM(jax_config(NAME, MODS, MODS[1:], **TINY))
    batch = jax.tree.map(jnp.asarray, synthetic_mod_batch(MODS, 2, 32, 32))
    variables = jm.init(jax.random.key(4), batch, 32, 32)
    tcfg = create_fourm_config(NAME, MODS, MODS[1:], **TINY)
    tm = FourM(tcfg).eval()
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)["params"], tcfg))
    return (JaxGenerationSampler(jm, variables, text_tok),
            GenerationSampler(tm, text_tok))


def _rgb(B, seed):
    return np.random.RandomState(seed).rand(B, 224, 224, 3).astype(np.float32)


def _mod_dict(B, seed, targets, rgb_input=True):
    """rgb@224 as the condition (an empty one when not rgb_input) and the
    empty targets, as numpy arrays."""
    md = {"rgb@224": {"tensor": _rgb(B, seed)}}
    init_full_input_modality(md, "rgb@224")
    if not rgb_input:
        md["rgb@224"]["input_mask"][:] = True
    for t in targets:
        init_empty_target_modality(md, t, B, MODALITY_INFO[t].resolved_max_tokens())
    return md


def _copy(md):
    return {m: {k: np.array(v) for k, v in d.items()} for m, d in md.items()}


def _equal(port, ref, mods, what):
    for m in mods:
        for k in KEYS:
            np.testing.assert_array_equal(port[m][k].numpy(), np.asarray(ref[m][k]),
                                          err_msg=f"{what}: {m} {k}")


def _schedule(fn):
    """tok_clip@224 by 4 MaskGIT cosine steps with CFG 2.0, tok_depth@224 by
    one ROAR step, caption autoregressively; every step at temperature 0."""
    return fn(["rgb@224"], ["tok_clip@224", "tok_depth@224", "caption"],
              [196, 196, 24], ["maskgit", "roar", "autoregressive"], [4, 1, None],
              ["cosine", "linear", None], [0.0, 0.0, 0.0], ["constant"] * 3,
              [2.0, 2.0, 1.0], ["constant"] * 3, cfg_grow_conditioning=True)


def test_generate_iter_matches_jax_step_by_step(pair):
    jsampler, tsampler = pair
    B = 2
    md = _mod_dict(B, 0, ["tok_clip@224", "tok_depth@224"])
    jax_custom_text(md, "", "[EOS]", "caption", jsampler.text_tokenizer, target_max_len=24)
    md = expand_to_batch(md, B)
    sched = _schedule(build_chained_generation_schedules)
    assert sched == _schedule(jax_schedules)
    assert [s["scheme"] for s in sched] == ["maskgit"] * 4 + ["roar", "autoregressive"]
    jsteps = jsampler.generate_iter(_copy(md), sched, seed=0)
    n = 0
    for tout, step in zip(tsampler.generate_iter(_copy(md), sched, seed=0), sched):
        jout = next(jsteps)
        _equal(tout, jout, ("tok_clip@224", "tok_depth@224", "caption"),
               f"step {n} ({step['target_domain']})")
        n += 1
    assert n == len(sched) and next(jsteps, None) is None
    clip = tout["tok_clip@224"]
    assert bool(clip["target_mask"].all()) and not bool(clip["input_mask"].any())
    # the last yield is generate's result, bit for bit
    gout = tsampler.generate(_copy(md), sched, seed=0)
    for m in gout:
        for k in gout[m]:
            assert torch.equal(gout[m][k], tout[m][k]), (m, k)


def test_generate_iter_yields_a_dict_per_step(pair):
    """Each yield is its own dict: a list of them holds every step's state,
    and MaskGIT's decoded count grows by each step's num_tokens."""
    _, tsampler = pair
    md = _mod_dict(1, 1, ["tok_clip@224"])
    sched = build_chained_generation_schedules(
        ["rgb@224"], ["tok_clip@224"], [196], ["maskgit"], [4], ["cosine"], [1.0],
        ["constant"], [1.0], ["constant"])
    steps = list(tsampler.generate_iter(md, sched, seed=3))
    decoded = [int(s["tok_clip@224"]["target_mask"].sum()) for s in steps]
    assert decoded == list(np.cumsum([s["num_tokens"] for s in sched])) and decoded[-1] == 196


def _multi_dicts(B):
    """An unconditional dict (rgb@224 empty) and two conditioned ones (two
    images), each with tok_clip@224 empty."""
    return (_mod_dict(B, 0, ["tok_clip@224"], rgb_input=False),
            [_mod_dict(B, 10, ["tok_clip@224"]), _mod_dict(B, 11, ["tok_clip@224"])])


@pytest.mark.parametrize("scheme,steps", [("roar", 1), ("maskgit", 2)])
def test_generate_multi_guided_matches_jax(pair, scheme, steps):
    jsampler, tsampler = pair
    B = 2
    schedule = [{"target_domain": "tok_clip@224", "scheme": scheme, "num_tokens": 196 // steps,
                 "temperature": 0.0, "cfg_scale": [1.5, 0.5], "cfg_cond_domains": []}] * steps
    uncond, conds = _multi_dicts(B)
    jout = jsampler.generate_multi_guided(_copy(uncond), [_copy(c) for c in conds], schedule,
                                          seed=0)
    tout = tsampler.generate_multi_guided(_copy(uncond), [_copy(c) for c in conds], schedule,
                                          seed=0)
    _equal(tout, jout, ("tok_clip@224",), scheme)
    d = tout["tok_clip@224"]
    assert bool(d["target_mask"].all()) and not bool(d["input_mask"].any())


def test_generate_multi_guided_rejects_sequence_targets(pair):
    jsampler, tsampler = pair
    uncond, conds = _multi_dicts(1)
    schedule = [{"target_domain": "caption", "scheme": "autoregressive", "num_tokens": 8,
                 "temperature": 0.0, "cfg_scale": [1.5, 0.5], "cfg_cond_domains": []}]
    msg = "multi-guided generation currently supports img targets"
    with pytest.raises(ValueError, match=msg):
        jsampler.generate_multi_guided(uncond, conds, schedule)
    with pytest.raises(ValueError, match=msg):
        tsampler.generate_multi_guided(uncond, conds, schedule)


def test_generate_sam_dense_matches_jax(pair, text_tok):
    """generate_sam_dense over 3 replicas, with caption as the dense key (the
    tiny model has no sam_instance), as the JAX package's own test does."""
    jsampler, tsampler = pair
    md = {"rgb@224": {"tensor": _rgb(1, 5)}}
    init_full_input_modality(md, "rgb@224")
    custom_text(md, "", "[EOS]", "caption", text_tok, target_max_len=12)
    sched = build_chained_generation_schedules(
        ["rgb@224"], ["caption"], [None], ["autoregressive"], [None], [None], [0.0],
        ["constant"], [1.0], ["constant"])
    jout = jsampler.generate_sam_dense(_copy(md), sched, batch_size=3, key="caption", seed=0)
    tout = tsampler.generate_sam_dense(_copy(md), sched, batch_size=3, key="caption", seed=0)
    for k in ("tensor", "input_mask", "target_mask", "decoder_attention_mask"):
        np.testing.assert_array_equal(tout["caption"][k].numpy(), np.asarray(jout["caption"][k]),
                                      err_msg=k)
    merged = tout["caption"]["tensor"]
    assert merged.shape[0] == 1 and merged.shape[1] % 3 == 0 and merged.shape[1] > 0
    np.testing.assert_array_equal(tout["rgb@224"]["tensor"], md["rgb@224"]["tensor"])


def _random_out_ids(rng, B, T, s1, sentinels):
    out = rng.randint(30, 300, (B, T)).astype(np.int32)
    slots = rng.rand(B, T) < 0.15
    out[slots] = rng.choice(sentinels, size=int(slots.sum()))
    out[rng.rand(B, T) < 0.1] = s1  # a repeated [S_1] continues its span
    out[:, 0] = s1
    for b in range(B):  # finished rows end in PAD
        out[b, rng.randint(T // 2, T):] = 0
    out[rng.rand(B, T) < 0.05] = 0
    return out


@pytest.mark.parametrize("case", ["empty_input", "s1_input", "text_input"])
def test_merge_sequences_matches_jax_and_device_merges(pair, text_tok, case):
    """The host merge equals the JAX package's; the device merges (the
    empty-input one where the input region is empty, else the general one)
    equal the port's host merge."""
    jsampler, tsampler = pair
    rng = np.random.RandomState({"empty_input": 60, "s1_input": 61, "text_input": 62}[case])
    target, B, T_in = "caption", 5, 64
    sent_ids = sorted(text_tok.get_vocab()[f"[S_{i}]"] for i in range(20))
    s1 = text_tok.token_to_id("[S_1]")
    tensor = np.zeros((B, T_in), np.int32)
    in_mask = np.ones((B, T_in), bool)
    if case == "s1_input":
        tensor[:, 0], in_mask[:, 0] = s1, False
    elif case == "text_input":
        for b in range(B - 1):  # text with sentinel slots; the last row stays empty
            n = rng.randint(1, 30)
            seq = rng.randint(30, 300, n)
            slots = rng.rand(n) < 0.3
            seq[slots] = rng.choice(sent_ids[:6], size=int(slots.sum()))
            tensor[b, :n], in_mask[b, :n] = seq, False
    out_ids = _random_out_ids(rng, B, 48, s1, sent_ids[:6])
    md = {target: {"tensor": tensor, "input_mask": in_mask,
                   "target_mask": np.ones((B, T_in), bool),
                   "decoder_attention_mask": np.zeros((B, T_in), np.int32)}}
    want = jsampler.merge_sequences(_copy(md), out_ids.copy(), target)[target]
    host = tsampler.merge_sequences(_copy(md), torch.from_numpy(out_ids), target)[target]
    host_valid = tsampler._last_merge_valid
    assert host_valid == jsampler._last_merge_valid
    for k in ("tensor", "input_mask", "target_mask", "decoder_attention_mask"):
        np.testing.assert_array_equal(host[k].numpy(), np.asarray(want[k]), err_msg=k)
    tmd = {target: {k: torch.from_numpy(np.array(v)) for k, v in md[target].items()}}
    if case == "empty_input":
        dev = tsampler.merge_sequences_device(tmd, torch.from_numpy(out_ids), target)[target]
    else:
        dev = tsampler.merge_sequences_device_general(tmd, torch.from_numpy(out_ids),
                                                      target)[target]
    assert tsampler._last_merge_valid == host_valid
    for k in ("tensor", "input_mask", "target_mask", "decoder_attention_mask"):
        assert torch.equal(dev[k], host[k]), k


def test_image_target_steps_share_the_group_budget(pair):
    """Every step of an image target runs at its group's encoder budget, in
    generate and in generate_iter, also when that budget is the whole
    stream (here rgb@224's 196 tokens and the 196-token grid: the last
    step's 392 valid tokens round up past the stream)."""
    _, tsampler = pair
    md = _mod_dict(1, 2, ["tok_clip@224"])
    sched = build_chained_generation_schedules(
        ["rgb@224"], ["tok_clip@224"], [196], ["maskgit"], [4], ["cosine"], [1.0],
        ["constant"], [1.0], ["constant"])
    lengths = []
    hook = tsampler.model.encoder[0].register_forward_pre_hook(
        lambda _m, args: lengths.append(args[0].shape[1]))
    try:
        tsampler.generate(_copy(md), sched, seed=0)
        list(tsampler.generate_iter(_copy(md), sched, seed=0))
    finally:
        hook.remove()
    assert lengths == [392] * 8
