"""Phase 18 of chip_smoke.py: the last JAX modules' counterparts on the card.

    python3 chip_smoke.py --part examples    # this phase alone (after the build)
    python3 scripts/chip_examples.py --cpu   # a rehearsal on the CPU at a tiny size

  E1. `cli.train_text_tokenizer` (the port's own WordPiece trainer) at the
      4M configuration: vocab 30,000, 100 sentinels, 4 x 1000 coordinate
      tokens, the COCO classes, on a corpus the phase writes: WORDS words
      drawn Zipf-wise (s = 1.05) from a seeded lexicon of TYPES syllable
      words. The host seconds of the CLI and its merges a second; the file
      read back by `load_tokenizer`: the special ids in the 4M layout, and
      encode -> decode of held-out text returns the text.
  E2. `fourm_torch.load_sampler` on a 4M-21 B release .safetensors written
      from chip_smoke's seeded model (full width and depth, bf16): one ROAR
      target (tok_clip@224) and one AR target (caption) from RGB at
      temperature 0, 8 requests; the tokens equal the in-memory model's
      sampler's, the launch counts pass_launches' of the passes and tokens.
  E3. `CrossAttentionBlock` in bf16 at 4M-B width (D 768, 12 heads of 64),
      8 x 256 queries against a context of M = 2048: one `attention` and one
      `ln_mlp`, each held to its plain twin (chip_smoke.KernelTap).
  E4. The two examples on the card in bf16, at the JAX demos' numbers:
      examples/end_to_end_demo_torch.py (10 train steps, 25 ROAR steps) and
      examples/retrieval_demo_torch.py (a gallery of 4). Each stage's launch
      counts exact (derived from the recorded passes and calls); the
      tokenize's, the train steps' and the generation's launches held to
      their twins. The retrieval 4M has heads of 32: its `mha_short` and
      `attention` launches are the kernels' at that width.
  E5. The vit_t tokenizer run of tests/orbax_fixtures (heads of 32) in bf16:
      its ln_matmul, mha_short, ln_mlp and codebook search launch, each held
      to its twin. Phase 17's fp32 run of it stays.
  E6. csrc/attention.cu at heads of 32 on what E4 and E5 do not give it:
      flash_mha with QK-norm (its pre-pass over K and the Q tile's LN) in
      both tile shapes, softmax1, and attention's per-row biases (staged by
      TMA in the short shape, read from device memory in the long one),
      each held to its twin (chip_smoke.hold_variants).

Prints, with the card's name and power limit, the phase's seconds. Imports
nothing of JAX or fourm_tpu.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
import platform
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_TOKENIZER = os.path.join(ROOT, "tests", "orbax_fixtures", "vq_run")
WORDS, TYPES = 1_000_000, 50_000
E2_TARGETS = ["tok_clip@224", "caption"]
E3_SHAPE = dict(B=8, N=256, M=2048, D=768, H=12)
TOKENIZE_B = 8
# per call of the end-to-end demo's ViT-S VQ-VAE (8 blocks of 512, N = 196):
# attn_block holds the sequence
VITS_DEPTH = 8


def host_cpu() -> str:
    """The host's CPU model and core count, for host-only seconds."""
    try:
        with open("/proc/cpuinfo") as f:
            name = next(ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name"))
    except (OSError, StopIteration):
        name = platform.processor() or "unknown CPU"
    return f"{name}, {os.cpu_count()} cores"


class Phase:
    """The phase's device and sizes: the card at full size, or the CPU
    rehearsal (tiny sizes; launch counts printed, not held: the CPU runs
    the twins)."""

    def __init__(self, torch, card: str, cpu: bool = False):
        import chip_smoke as cs

        self.torch, self.card, self.cpu, self.cs = torch, card, cpu, cs
        self.check = cs.check
        self.dev = "cpu" if cpu else "cuda"

    def sync(self):
        if not self.cpu:
            self.torch.cuda.synchronize()

    def hold(self, label: str, got: dict, want: dict) -> None:
        """Launch counts exactly as derived."""
        from fourm_torch import kernels

        bad = {k: (got.get(k, 0), want.get(k, 0)) for k in kernels.launch_counts()
               if got.get(k, 0) != want.get(k, 0)}
        if self.cpu:
            print(f"  (CPU rehearsal) {label}: counts not held: {bad}", flush=True)
        else:
            self.check(not bad, f"{label}: counts (got, want) differ: {bad}")


def _add(total: dict, part: dict, n: int = 1) -> dict:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v * n
    return total


def block_launches(N: int, cfg, decoder: bool) -> dict:
    """Launches of one inference block over N tokens under a key-only mask:
    the pre-norm attention half (chip_smoke.prenorm_launches; attn_block is
    built for heads of 64 alone, so other heads take ln_matmul + mha_short
    there), the decoder's `attention`, `ln_mlp`."""
    import chip_smoke as cs

    launches = dict(cs.prenorm_launches(N, cfg), ln_mlp=1)
    if "attn_block" in launches and cfg.dim != 64 * cfg.num_heads:
        launches = {"ln_matmul": 1, "mha_short": 1, "ln_mlp": 1}
    if decoder:
        launches["attention"] = 1
    return launches


class Stages:
    """The `stage` hook of the examples: around each stage the launch
    counts it adds, the passes of a FourM (PassLengths) or the
    token counts of a VQ model's encoder / decoder calls, and a KernelTap
    holding the stage's launches to their twins."""

    TAPS = {"tokenize": ["attn_block", "ln_mlp", "nearest_code_cosine"],
            "train": ["attention_train_fwd", "attention_train_bwd", "fused_adamw"],
            "generate": ["ln_matmul", "ln_mlp", "mha_short", "flash_mha", "attention",
                         "attn_block"],
            "decode": ["attn_block", "ln_mlp"]}

    def __init__(self, ph, label: str):
        self.ph, self.label = ph, label
        self.launches, self.passes, self.calls = {}, {}, {}
        self.taps = {}

    @contextlib.contextmanager
    def __call__(self, name: str, module):
        from fourm_torch import kernels
        from fourm_torch.models import FourM

        cs = self.ph.cs
        if name not in self.taps:
            self.taps[name] = cs.KernelTap(self.ph.torch, f"{self.label} {name}",
                                           self.TAPS[name], self.ph.cpu)
        tap = self.taps[name]
        hooks, lengths = [], None
        if isinstance(module, FourM) and name == "generate":
            lengths = cs.PassLengths(module)
        elif hasattr(module, "encoder") and name == "tokenize":
            hooks.append(module.encoder.blocks[0].register_forward_pre_hook(
                lambda _m, a: self.calls.setdefault(name, []).append(a[0].shape[1])))
        elif name == "decode" and hasattr(getattr(module, "decoder", None), "blocks"):
            hooks.append(module.decoder.blocks[0].register_forward_pre_hook(
                lambda _m, a: self.calls.setdefault(name, []).append(a[0].shape[1])))
        before = kernels.launch_counts()
        try:
            with tap:
                yield
            self.ph.sync()
        finally:
            for h in hooks:
                h.remove()
            if lengths is not None:
                lengths.close()
                p = self.passes.setdefault(name, SimpleNamespace(encoder=[], decoder=[],
                                                                 model=module))
                p.encoder += lengths.encoder
                p.decoder += lengths.decoder
        _add(self.launches.setdefault(name, {}),
             {k: v - before[k] for k, v in kernels.launch_counts().items()})

    def report(self) -> None:
        for name, tap in self.taps.items():
            want = {k: v for k, v in self.launches[name].items() if k in tap.names and v}
            tap.report(want)


# ------------------------------------------------------------------ E1

def write_corpus(path: str, words: int, types: int, seed: int = 0) -> list:
    """`words` words, 12 to a line with a full stop, drawn Zipf-wise (s =
    1.05) from `types` distinct words of 1-4 syllables; returns the
    lexicon, most frequent first."""
    rng = np.random.default_rng(seed)
    cons, vow = "bcdfghjklmnprstvwz", "aeiou"
    syllables = np.array([c + v for c in cons for v in vow]
                         + [c + v + k for c in cons[:8] for v in vow for k in "nrst"])
    lexicon, seen = [], set()
    while len(lexicon) < types:
        n = rng.integers(1, 5, size=2 * types)
        picks = rng.integers(0, len(syllables), size=(2 * types, 4))
        for k, row in zip(n, picks):
            w = "".join(syllables[row[:k]])
            if w not in seen:
                seen.add(w)
                lexicon.append(w)
                if len(lexicon) == types:
                    break
    p = 1.0 / np.arange(1, types + 1) ** 1.05
    drawn = np.asarray(lexicon)[rng.choice(types, size=words, p=p / p.sum())]
    with open(path, "w") as f:
        for i in range(0, words, 12):
            f.write(" ".join(drawn[i:i + 12]) + ".\n")
    return lexicon


def e1_part(ph, tmp: str) -> None:
    from fourm_torch.cli import train_text_tokenizer as cli
    from fourm_torch.utils.text_tokenizer import COCO_CLASSES, load_tokenizer

    check = ph.check
    words, types, vocab = WORDS, TYPES, 30_000  # the CPU rehearsal too: host work alone
    corpus = os.path.join(tmp, "corpus.txt")
    t0 = time.perf_counter()
    lexicon = write_corpus(corpus, words, types)
    corpus_s = time.perf_counter() - t0
    out = os.path.join(tmp, "tokenizer.json")
    t0 = time.perf_counter()
    tok = cli.main(["--files", corpus, "--vocab_size", str(vocab), "--output", out])
    train_s = time.perf_counter() - t0
    merges = tok.training["merges"]
    check(tok.get_vocab_size() == vocab, f"E1: vocab {tok.get_vocab_size()} != {vocab}")
    read = load_tokenizer(out)
    layout = {"[PAD]": 0, "[UNK]": 1, "[SOS]": 2, "[EOS]": 3, "[S_0]": 4, "[S_99]": 103,
              "v0=0": 104, "v3=999": 4103, COCO_CLASSES[0]: 4104, COCO_CLASSES[-1]: 4183}
    got = {t: read.token_to_id(t) for t in layout}
    check(got == layout, f"E1: special ids {got} != {layout}")
    text = " ".join(lexicon[::97][:40]) + " [S_5] v1=42 teddy bear " + " ".join(lexicon[-5:])
    ids = read.encode(text).ids
    back = read.decode(ids, skip_special_tokens=False)
    check(back == text, f"E1: decode(encode(text)) differs: {back[:80]!r} vs {text[:80]!r}")
    print(f"E1 train_text_tokenizer: vocab {vocab} (100 sentinels, 4 x 1000 coordinates, 80 "
          f"COCO classes) from {tok.training['words']} words of {tok.training['word_types']} "
          f"types (a Zipf s = 1.05 draw from {types}; corpus written in {corpus_s:.3f} s): "
          f"{train_s:.3f} s for the CLI with its save, {merges} merges, "
          f"{merges / train_s:.1f} merges/s on the host ({host_cpu()}); read back with the "
          f"4M ids, {len(ids)} ids round-tripped; {ph.card}", flush=True)


# ------------------------------------------------------------------ E2

def e2_part(ph, tmp: str) -> dict:
    import fourm_torch
    from fourm_torch import kernels
    from fourm_torch.api import FourMSampler
    from fourm_torch.utils.checkpoint import save_safetensors
    from fourm_torch.utils.text_tokenizer import load_tokenizer

    torch, cs, check = ph.torch, ph.cs, ph.check
    small = dict(dim=64, num_heads=1, encoder_depth=1, decoder_depth=1) if ph.cpu else {}
    requests = 2 if ph.cpu else cs.REQUESTS
    model = cs.build_model(torch, "bfloat16", ph.dev, **small)
    path, tok_path = os.path.join(tmp, "4m-21_b.safetensors"), os.path.join(tmp, "text.json")
    save_safetensors(cs.release_state(torch, model), path,
                     metadata=cs.release_metadata(model.config))
    cs.write_text_tokenizer(tok_path)
    t0 = time.perf_counter()
    loaded = fourm_torch.load_sampler(path, text_tokenizer_path=tok_path, device=ph.dev,
                                      config_override={"dtype": "bfloat16"})
    ph.sync()
    load_s = time.perf_counter() - t0
    check(loaded.model.config.dtype == "bfloat16"
          and loaded.model.mask_token.device.type == ph.dev, "E2: not a bf16 model on the card")
    memory = FourMSampler(model, load_tokenizer(tok_path), device=ph.dev)
    rgb = np.random.RandomState(5).rand(requests, 224, 224, 3).astype(np.float32)
    outs, launches = [], None
    for s in (memory, loaded):
        defaults = {t: dict(d, temp=0.0) for t, d in s.resolve_defaults(["rgb@224"]).items()}
        sched = s.build_schedule(["rgb@224"], E2_TARGETS, defaults=defaults)
        md = s.prepare_sample({"rgb@224": rgb}, ["rgb@224"], E2_TARGETS, batch_size=requests)
        if s is loaded:
            lengths = cs.PassLengths(s.model)
            kernels.reset_launch_counts()
        outs.append(s.generate(md, sched, seed=0))
        ph.sync()
    launches = kernels.launch_counts()
    lengths.close()
    n_tok = sum(loaded.sampler._ar_tokens.values())
    for t in E2_TARGETS:
        check(torch.equal(outs[0][t]["tensor"], outs[1][t]["tensor"]),
              f"E2: {t} tokens of load_sampler differ from the in-memory model's")
    ph.hold("E2 load_sampler", launches, cs.pass_launches(loaded.model, lengths, n_tok))
    print(f"E2 load_sampler: {cs.MODEL} release file ({os.path.getsize(path)} bytes) -> a "
          f"bf16 FourMSampler on {ph.dev} in {load_s:.3f} s; {requests} requests, "
          f"{E2_TARGETS[0]} (one ROAR step, CFG) and {E2_TARGETS[1]} ({n_tok} tokens) at "
          f"temperature 0: tokens equal the in-memory model's; launches "
          f"{ {k: v for k, v in launches.items() if v} }; {ph.card}", flush=True)
    del model, loaded, memory
    return {"e2_load_sampler": launches}


# ------------------------------------------------------------------ E3

def e3_part(ph) -> dict:
    from fourm_torch import kernels
    from fourm_torch.ops.transformer import CrossAttentionBlock

    torch, cs = ph.torch, ph.cs
    B, N, M, D, H = (E3_SHAPE[k] for k in "BNMDH")
    if ph.cpu:
        B, N, M, D, H = 2, 16, 64, 128, 2
    gen = torch.Generator(device=ph.dev).manual_seed(31)
    with torch.device(ph.dev):
        block = CrossAttentionBlock(D, H, qkv_bias=True, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=ph.dev) * (p.shape[-1] ** -0.5))
    block = block.to(torch.bfloat16).eval()
    x = torch.randn(B, N, D, generator=gen, device=ph.dev).to(torch.bfloat16)
    ctx = torch.randn(B, M, D, generator=gen, device=ph.dev).to(torch.bfloat16)
    mask = torch.rand(B, 1, M, generator=gen, device=ph.dev) < 0.2
    tap = cs.KernelTap(torch, "E3 CrossAttentionBlock", ["attention", "ln_mlp"], ph.cpu)
    kernels.reset_launch_counts()
    with tap, torch.no_grad():
        y = block(x, ctx, mask)
    ph.sync()
    launches = kernels.launch_counts()
    ph.check(bool(torch.isfinite(y).all()) and y.shape == x.shape, "E3: output")
    ph.hold("E3 CrossAttentionBlock", launches, {"attention": 1, "ln_mlp": 1})
    tap.report({"attention": 1, "ln_mlp": 1})
    with torch.no_grad():
        ms = cs.time_ms(torch, lambda: block(x, ctx, mask), 20) if not ph.cpu else float("nan")
    print(f"E3 CrossAttentionBlock: bf16, D {D}, {H} heads, {B} x {N} queries against M {M} "
          f"(a fifth of the keys masked): {ms:.4f} ms a call; {ph.card}", flush=True)
    return {"e3_cross_block": launches}


# ------------------------------------------------------------------ E4

def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def e4_part(ph, tmp: str) -> dict:
    from fourm_torch import kernels

    cs = ph.cs
    kernels.reset_launch_counts()
    # the end-to-end demo at the JAX demo's numbers (its cuts on the CPU)
    st = Stages(ph, "E4 end-to-end")
    cut = dict(train_steps=1, n_images=2, decoding_steps=2) if ph.cpu else {}
    t0 = time.perf_counter()
    out = _example("end_to_end_demo_torch").main(device=ph.dev, workdir=os.path.join(tmp, "e2e"),
                                                 stage=st, **cut)
    e2e_s = time.perf_counter() - t0
    steps = cut.get("train_steps", 10)
    per_step = {"attention_train_fwd": 18, "attention_train_bwd": 18, "fused_adamw": 1}
    vits = SimpleNamespace(dim=512, num_heads=8, qk_norm=False)
    want = {"tokenize": {}, "decode": {}}
    for name in ("tokenize", "decode"):
        for N in st.calls[name]:
            _add(want[name], block_launches(N, vits, False), VITS_DEPTH)
    _add(want["tokenize"], {"nearest_code_cosine": 1}, len(st.calls["tokenize"]))
    want["train"] = {k: v * steps for k, v in per_step.items()}
    want["generate"] = cs.pass_launches(st.passes["generate"].model, st.passes["generate"], 0)
    for name in ("tokenize", "train", "generate", "decode"):
        ph.hold(f"E4 end-to-end {name}", st.launches[name], want[name])
    st.report()
    ph.check(np.isfinite(out["loss"]) and np.isfinite(out["image"]).all()
             and out["tokens"].shape == (1, 196), "E4: end-to-end outputs")
    print(f"E4 end-to-end demo: {e2e_s:.3f} s (text vocab {out['text_vocab']}, "
          f"{len(st.calls['tokenize'])} tokenize calls, {steps} train steps, loss "
          f"{out['loss']:.4f}, {len(st.passes['generate'].decoder)} generation passes, the "
          f"decode {out['image'].shape}); launches by stage "
          f"{ {k: {n: c for n, c in v.items() if c} for k, v in st.launches.items()} }; "
          f"{ph.card}", flush=True)

    # the retrieval demo: a 4M of heads of 32
    rt = Stages(ph, "E4 retrieval")
    gallery = 2 if ph.cpu else 4
    t0 = time.perf_counter()
    res = _example("retrieval_demo_torch").main(device=ph.dev, gallery_size=gallery, stage=rt)
    retr_s = time.perf_counter() - t0
    rmodel = rt.passes["generate"].model
    r_launches = cs.pass_launches(rmodel, rt.passes["generate"], 0)
    ph.hold("E4 retrieval generate", rt.launches["generate"], r_launches)
    ph.hold("E4 retrieval decode", rt.launches["decode"], {})
    ph.check(rmodel.config.dim == 32 * rmodel.config.num_heads
             and r_launches.get("mha_short", 0) > 0 and r_launches.get("attention", 0) > 0,
             f"E4: the retrieval 4M's heads of 32 launch no mha_short / attention: {r_launches}")
    rt.report()
    ph.check(len(res["sims"]) == gallery and np.isfinite(res["sims"]).all(), "E4: retrieval")
    print(f"E4 retrieval demo: {retr_s:.3f} s, gallery {gallery}, ranking {res['ranking']}; "
          f"generation launches {r_launches} (heads of 32); {ph.card}", flush=True)
    return {**{f"e4_e2e_{k}": v for k, v in st.launches.items()},
            "e4_retrieval_generate": rt.launches["generate"]}


# ------------------------------------------------------------------ E5

def e5_part(ph) -> dict:
    from fourm_torch import kernels
    from fourm_torch.vq.loader import get_image_tokenizer

    torch, cs = ph.torch, ph.cs
    tiny, _ = get_image_tokenizer(FIXTURE_TOKENIZER, encoder_only=True, verbose=False,
                                  config_override={"dtype": "bfloat16"}, device=ph.dev)
    gen = torch.Generator(device=ph.dev).manual_seed(37)
    x = torch.rand(TOKENIZE_B, 32, 32, 3, generator=gen, device=ph.dev)
    tap = cs.KernelTap(torch, "E5 vit_t tokenizer (bf16)",
                       ["ln_matmul", "mha_short", "ln_mlp", "nearest_code_cosine"], ph.cpu)
    seen = []
    hook = tiny.encoder.blocks[0].register_forward_pre_hook(
        lambda _m, a: seen.append(a[0].shape[1]))
    kernels.reset_launch_counts()
    with tap, torch.no_grad():
        tok = tiny.tokenize(x)
    ph.sync()
    hook.remove()
    launches = kernels.launch_counts()
    enc = tiny.encoder
    cfg = SimpleNamespace(dim=enc.dim_tokens, num_heads=enc.blocks[0].attn.num_heads,
                          qk_norm=False)
    want = {"nearest_code_cosine": 1}
    for N in seen:
        _add(want, block_launches(N, cfg, False), len(enc.blocks))
    ph.hold("E5 vit_t tokenize", launches, want)
    ph.check(cfg.dim == 32 * cfg.num_heads and want.get("mha_short", 0) == len(enc.blocks),
             f"E5: not heads of 32 through mha_short: {want}")
    tap.report({k: v for k, v in want.items() if v})
    ph.check(tuple(tok.shape) == (TOKENIZE_B, 8, 8) and int(tok.min()) >= 0
             and int(tok.max()) < 64, f"E5: tokens {tuple(tok.shape)}")
    print(f"E5 vit_t fixture tokenizer in bf16 (width {cfg.dim}, heads of "
          f"{cfg.dim // cfg.num_heads}): launches {want}; {ph.card}", flush=True)
    return {"e5_vit_t": launches}


# ------------------------------------------------------------------ E6

def e6_part(ph) -> None:
    from fourm_torch.kernels import attention as at

    torch, cs = ph.torch, ph.cs
    if ph.cpu:
        print("  (CPU rehearsal) E6: the kernels run on the card alone", flush=True)
        return
    gen, rn, key_bias = cs.random_makers(torch, 18)
    H, Dh = 6, 32
    D = H * Dh
    g32 = [torch.rand(Dh, generator=gen, device="cuda") + 0.5,
           torch.randn(Dh, generator=gen, device="cuda") * 0.1] * 2

    def heads(B, N, M):  # q (B, N, D), k and v (B, M, D): column slices of QKV buffers
        qkv, kv = rn(B, N, 3 * D), rn(B, M, 3 * D)
        return qkv[..., :D], kv[..., D:2 * D], kv[..., 2 * D:]

    norm = (*heads(4, 196, 196), H, key_bias(4, 196), *g32)
    norm_long = (*heads(2, 1100, 1300), H, key_bias(2, 1300), *g32)
    norm_odd = (*heads(2, 5, 7), H, key_bias(2, 7), *g32)
    qkv, bias300 = rn(3, 300, 3 * D), key_bias(3, 300, full_rows=1)
    q, k, v = rn(2, H, 100, Dh), rn(2, H, 333, Dh), rn(2, H, 333, Dh)
    rows = torch.randn(2, H, 100, 333, generator=gen, device="cuda")
    ql, kl, vl = rn(1, H, 1100, Dh), rn(1, H, 1200, Dh), rn(1, H, 1200, Dh)
    rows_l = torch.randn(1, 1, 1100, 1200, generator=gen, device="cuda")
    cs.hold_variants(torch, [
        ("heads of 32: flash_mha, QK-norm, key bias, N=M=196",
         lambda: at.flash_mha(*norm), lambda: at.flash_mha_plain(*norm)),
        ("heads of 32: flash_mha, QK-norm, key bias, N=1100, M=1300 (long shape)",
         lambda: at.flash_mha(*norm_long), lambda: at.flash_mha_plain(*norm_long)),
        ("heads of 32: flash_mha, QK-norm, N=5, M=7",
         lambda: at.flash_mha(*norm_odd), lambda: at.flash_mha_plain(*norm_odd)),
        ("heads of 32: mha_short, softmax1, key bias (row 0 all masked), N=300",
         lambda: at.mha_short(qkv, H, bias300, True),
         lambda: at.mha_short_plain(qkv, H, bias300, True)),
        ("heads of 32: attention, (B, H, N, M) bias, softmax1, N=100, M=333",
         lambda: at.attention(q, k, v, rows, True), lambda: at.attention_plain(q, k, v, rows, True)),
        ("heads of 32: attention, (B, 1, N, M) bias, N=1100, M=1200 (long shape)",
         lambda: at.attention(ql, kl, vl, rows_l), lambda: at.attention_plain(ql, kl, vl, rows_l)),
    ])


def examples_phase(torch, card: str, cpu: bool = False) -> dict:
    """Phase 18; returns {path: launch counts} for the kernels line."""
    ph = Phase(torch, card, cpu)
    t0 = time.perf_counter()
    seconds, launches = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_examples_")
    try:
        for name, part in (("E1", lambda: e1_part(ph, tmp)), ("E2", lambda: e2_part(ph, tmp)),
                           ("E3", lambda: e3_part(ph)), ("E4", lambda: e4_part(ph, tmp)),
                           ("E5", lambda: e5_part(ph)), ("E6", lambda: e6_part(ph))):
            t = time.perf_counter()
            launches.update(part() or {})
            seconds[name] = round(time.perf_counter() - t, 3)
            if not cpu:
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 18 seconds: {seconds}", flush=True)
    print(f"phase 18: {time.perf_counter() - t0:.3f} s; {card}", flush=True)
    return launches


if __name__ == "__main__":
    import torch

    sys.path.insert(0, ROOT)
    if "--cpu" not in sys.argv:
        sys.exit("run it through `python3 chip_smoke.py --part examples`, or with --cpu")
    examples_phase(torch, "CPU rehearsal", cpu=True)
