"""Phase 17 of chip_smoke.py: the JAX package's orbax run directories on the card.

    python3 chip_smoke.py --part orbax   # this phase alone (after the build)
    python3 scripts/chip_orbax.py --cpu  # a rehearsal on the CPU at a tiny size

  O1. 4M-21 B (fm_base_12e_12d_swiglu_qknorm_nobias, chip_smoke's MODEL over
      MOD21) at full width and depth, weights drawn on the card from seed 0
      (phase 3's model), written as a train_4m run directory of the JAX
      package (utils/orbax.py:write_orbax_tree of utils/checkpoint.py:
      to_jax_params and to_jax_train_state, in a temporary directory removed
      afterwards): config.json, the params export weights/step_1 and the
      TrainState checkpoints/step_1 with drawn AdamW moments at count 1.
      `cli.generate.load_fm` reads it back: in fp32 every tensor equal, bit
      for bit, to the model's masters, and in bf16 to the model itself; the
      RGB-to-all chain (8 requests, 14 targets, every step at temperature 0)
      from it equals the in-memory model's chain token for token, each with
      chain_launches' counts. Then `cli.train_4m.main` resumes from the
      directory for one step at B = 8 (256 + 256 tokens, synthetic 4M-21
      batches): right after the restore the masters, the moments and the
      count are the written ones bit for bit; the step launches exactly 36 +
      36 `attention_train` and one `fused_adamw`, each held to its plain twin
      on the same inputs (chip_smoke.KernelTap), and its eval
      eval_launches'; the loss is finite; the run's closing checkpoint is
      recorded, not written (phase 11 holds that path). The directory's
      bytes, its write time and each read's time.
  O2. The committed fixtures (tests/orbax_fixtures, written by the JAX
      package's save_checkpoint: orbax's zstd, a sharded TrainState) read by
      the native decoder built on this host, equal to their expected
      arrays (the wide leaf to its draw); get_image_tokenizer on the
      fixture's tokenizer run (vit_t, 32 px) tokenizing on the card in fp32
      (heads of 32: the blocks take the plain twins), its one
      `nearest_code_cosine` held to its twin; a ViT-B tokenizer of
      chip_smoke's VQ_RGB (224 px, 16384 cosine codes) written on the card
      as a tokenizer run directory in the JAX layout (the fixture's tree as
      the template of its names), read by
      get_image_tokenizer (its state bit for bit) and tokenizing 8 images:
      exactly 12 `attn_block`, 12 `ln_mlp` and one `nearest_code_cosine`,
      each held to its twin; and the CLIP-B16 teacher from an OpenAI-layout
      .safetensors drawn on the card, through save_vq_tokens.build_teacher:
      its weights the file's, 12 `mha_short` a call, each held to its twin.
  O3. The zstd decoder's rate (MB/s of decoded bytes, one host thread) on
      the fixtures' small zstd values and on the one frame of their wide
      leaf (640 x 256 float32 with whole mantissas: 605 KB at zstd level
      1, as orbax writes a weight), and read_orbax_tree's on the fixture
      step directories.

Prints, with the card's name and power limit, the phase's seconds. Imports
nothing of JAX or fourm_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "orbax_fixtures")
WIDE = "wide_leaf/step_1"  # one float32 array in one zstd frame of 605 KB
TRAIN_B, TRAIN_TOKENS, TOKENIZE_B = 8, 256, 8
PER_STEP = {"attention_train_fwd": 36, "attention_train_bwd": 36, "fused_adamw": 1}
VITB_TOKENIZE = {"attn_block": 12, "ln_mlp": 12, "nearest_code_cosine": 1}
CLIP_CALL = {"mha_short": 12}
class Phase:
    """The phase's device and sizes: the card at full size, or the CPU
    rehearsal (dim 64, 1 + 1 blocks, B = 2; launch counts printed, not
    held: the CPU runs the twins)."""

    def __init__(self, torch, card: str, cpu: bool = False):
        import chip_smoke as cs

        self.torch, self.card, self.cpu, self.cs = torch, card, cpu, cs
        self.check = cs.check
        self.dev = "cpu" if cpu else "cuda"
        self.small = dict(dim=64, num_heads=4, encoder_depth=1, decoder_depth=1) if cpu else {}
        self.requests = 2 if cpu else cs.REQUESTS
        self.depth = 1 if cpu else cs.DEPTH

    def sync(self):
        if not self.cpu:
            self.torch.cuda.synchronize()

    def hold(self, label: str, got: dict, want: dict) -> None:
        from fourm_torch import kernels

        want = {k: want.get(k, 0) for k in kernels.launch_counts()}
        bad = {k: (got.get(k, 0), v) for k, v in want.items() if got.get(k, 0) != v}
        if self.cpu:
            print(f"  (CPU rehearsal) {label}: launches not held: {bad}", flush=True)
        else:
            self.check(not bad, f"{label}: launch counts (got, want) differ: {bad}")


def _equal_states(torch, a: dict, b: dict) -> list:
    """The keys whose tensors differ (dtype, shape or any bit)."""
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k].to(a[k].device)
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            bad.append(k)
    return bad


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(path) for n in ns)


def _chain(ph, model) -> tuple:
    """The RGB-to-all chain of phase 3 (chip_smoke.chain_phase) at
    temperature 0, once, the launch counters reset just before and read just
    after: (outputs, launches, AR tokens decoded)."""
    from fourm_torch import kernels
    from fourm_torch.api import FourMSampler

    cs, torch = ph.cs, ph.torch
    sampler = FourMSampler(model, cs.StandInTokenizer(), device=ph.dev)
    defaults = {t: dict(d, temp=0.0) for t, d in sampler.resolve_defaults(["rgb@224"]).items()}
    schedule = sampler.build_schedule(["rgb@224"], cs.TARGETS, defaults=defaults)
    ph.check(all(s["temperature"] == 0.0 for s in schedule), "O1: a step above temperature 0")
    rgb = np.random.RandomState(0).rand(ph.requests, 224, 224, 3).astype(np.float32)
    md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], cs.TARGETS,
                                batch_size=ph.requests)
    kernels.reset_launch_counts()
    out = sampler.generate(md, schedule, seed=0)
    ph.sync()
    return out, kernels.launch_counts(), sum(sampler.sampler._ar_tokens.values())


def o1_part(ph, tmp: str) -> dict:
    """O1; returns {path: launch counts}."""
    from fourm_torch import kernels
    from fourm_torch.cli import train_4m
    from fourm_torch.cli.generate import load_fm
    from fourm_torch.utils.checkpoint import to_jax_params, to_jax_train_state
    from fourm_torch.utils.orbax import write_orbax_tree

    torch, cs, check, card = ph.torch, ph.cs, ph.check, ph.card
    model = cs.build_model(torch, "bfloat16", ph.dev, **ph.small)
    cfg = model.config
    masters = {k: v.float() for k, v in model.state_dict().items()}
    # drawn moments, one pair a parameter (a shared tensor keeps one pair under its names)
    gen = torch.Generator(device=ph.dev).manual_seed(17)
    by_id, mu, nu = {}, {}, {}
    for name, p in model.named_parameters(remove_duplicate=False):
        if id(p) not in by_id:
            by_id[id(p)] = (torch.randn(p.shape, generator=gen, device=ph.dev) * 1e-3,
                            torch.rand(p.shape, generator=gen, device=ph.dev) * 1e-6)
        mu[name], nu[name] = by_id[id(p)]
    opt = {"count": 1, "mu": mu, "nu": nu}
    run = os.path.join(tmp, "jax_run")
    os.makedirs(run)
    t0 = time.perf_counter()
    with open(os.path.join(run, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(dataclasses.replace(cfg, dtype="float32")), f)
    tree = {"params": to_jax_params(masters, cfg)}
    convert_s = time.perf_counter() - t0
    write_orbax_tree(os.path.join(run, "weights", "step_1"), tree)
    weights_s = time.perf_counter() - t0
    tree = to_jax_train_state(masters, opt, 1, cfg)
    write_orbax_tree(os.path.join(run, "checkpoints", "step_1"), tree)
    write_s = time.perf_counter() - t0
    del tree
    wbytes = _dir_bytes(os.path.join(run, "weights"))
    cbytes = _dir_bytes(os.path.join(run, "checkpoints"))

    t0 = time.perf_counter()
    m32 = load_fm(run, dtype="float32", device=ph.dev)
    ph.sync()
    read32_s = time.perf_counter() - t0
    bad = _equal_states(torch, masters, m32.state_dict())
    check(not bad, f"O1: load_fm in fp32 differs from the masters in {bad[:5]}")
    del m32
    t0 = time.perf_counter()
    loaded = load_fm(run, dtype="bfloat16", device=ph.dev)
    ph.sync()
    read16_s = time.perf_counter() - t0
    bad = _equal_states(torch, model.state_dict(), loaded.state_dict())
    check(not bad, f"O1: load_fm in bf16 differs from the model in {bad[:5]}")
    print(f"orbax O1 directory: {cs.MODEL} over {len(cs.MOD21)} modalities "
          f"({sum(p.numel() for p in model.parameters())} parameters, {len(masters)} tensors), "
          f"a JAX train_4m run: weights/step_1 {wbytes} bytes written in {weights_s:.3f} s "
          f"({wbytes / weights_s / 1e9:.3f} GB/s; to_jax_params from the card "
          f"{convert_s:.3f} s of it), checkpoints/step_1 (TrainState, AdamW "
          f"moments) {cbytes} bytes, both in {write_s:.3f} s; load_fm read it back in "
          f"{read32_s:.3f} s in fp32 ({wbytes / read32_s / 1e9:.3f} GB/s), every tensor equal "
          f"bit for bit to the masters, and in {read16_s:.3f} s in bf16, equal to the model; "
          f"{card}", flush=True)

    ref, ref_launches, ref_tok = _chain(ph, model)
    out, launches, n_tok = _chain(ph, loaded)
    for t in cs.TARGETS:
        check(torch.equal(out[t]["tensor"], ref[t]["tensor"]),
              f"O1: {t}: the loaded model's tokens differ from the in-memory model's")
    check(n_tok == ref_tok, f"O1: {n_tok} AR tokens from the loaded model, {ref_tok} from the "
                            "in-memory one")
    want = cs.chain_launches(ph.depth, n_tok)
    ph.hold("O1 chain (in-memory model)", ref_launches, want)
    ph.hold("O1 chain (loaded model)", launches, want)
    print(f"orbax O1 chain: {ph.requests} requests x {len(cs.TARGETS)} targets at temperature "
          f"0 from the loaded model: every token equal to the in-memory model's ({n_tok} AR "
          f"tokens); launches {json.dumps({k: v for k, v in launches.items() if v})}; {card}",
          flush=True)
    del model, loaded, out, ref
    if not ph.cpu:
        torch.cuda.empty_cache()

    # the train CLI resumes from the directory for one step
    names = ("attention_train_fwd", "attention_train_bwd", "fused_adamw")
    restored = {}
    real_restore = train_4m.restore_checkpoint

    def restore(state, generator, ckpt):
        step = real_restore(state, generator, ckpt)
        restored["masters"] = _equal_states(torch, masters, state.model.state_dict())
        sd = state.optimizer.state_dict()
        restored["moments"] = (_equal_states(torch, {k: mu[k] for k in sd["mu"]}, sd["mu"])
                               + _equal_states(torch, {k: nu[k] for k in sd["nu"]}, sd["nu"]))
        restored["count"], restored["step"] = sd["count"], step
        kernels.reset_launch_counts()
        return step

    tap = cs.KernelTap(torch, "orbax O1 resumed step", names, ph.cpu)
    argv = ["--synthetic_data", "--model", cs.MODEL, "--in_domains", "-".join(cs.MOD21),
            "--out_domains", "-".join(cs.MOD21_DEC), "--batch_size", str(ph.requests if ph.cpu
                                                                         else TRAIN_B),
            "--num_input_tokens", str(TRAIN_TOKENS), "--num_target_tokens", str(TRAIN_TOKENS),
            "--scheduler", "constant", "--warmup_tokens", "0", "--blr", "1e-4",
            "--print_freq", "1", "--epoch_size", "1", "--eval_size", str(TRAIN_B),
            "--output_dir", run, "--max_steps", "2", "--device", ph.dev]
    argv += [a for k, v in ph.small.items() for a in (f"--{k}", str(v))]
    # the run's closing checkpoint (10 GB by torch.save, phase 11's path) is
    # recorded, not written
    from fourm_torch.utils import checkpoint as ck

    saved, real_save = [], ck.save_checkpoint
    train_4m.restore_checkpoint = restore
    ck.save_checkpoint = lambda ckpt_dir, state, step, keep=3: saved.append(
        (os.path.basename(ckpt_dir), step))
    t0 = time.perf_counter()
    try:
        with tap:
            train_4m.main(argv)
    finally:
        train_4m.restore_checkpoint, ck.save_checkpoint = real_restore, real_save
    ph.sync()
    resume_s = time.perf_counter() - t0
    step_launches = kernels.launch_counts()
    check(restored.get("step") == 1 and restored["count"] == 1 and not restored["masters"]
          and not restored["moments"],
          f"O1 resume: step {restored.get('step')}, count {restored.get('count')}, masters "
          f"differing {restored.get('masters', [])[:5]}, moments {restored.get('moments', [])[:5]}")
    with open(os.path.join(run, "log.txt")) as f:
        log = [json.loads(line) for line in f]
    losses = [r["loss"] for r in log if "loss" in r]
    check(len(losses) == 1 and np.isfinite(losses[0]), f"O1 resume: losses {losses}")
    check(saved == [("checkpoints", 2), ("weights", 2)], f"O1 resume: checkpoints {saved}")
    want = dict(PER_STEP)
    for k, v in cs.eval_launches(cfg, TRAIN_TOKENS).items():
        want[k] = want.get(k, 0) + v
    ph.hold("O1 resumed step and eval", step_launches, want)
    tap.report({k: PER_STEP[k] for k in names})
    print(f"orbax O1 resume: cli.train_4m.main from the directory's TrainState, B = "
          f"{TRAIN_B}: masters, moments and count 1 equal bit for bit after the restore; one "
          f"step (loss {losses[0]:.6f}) and its eval; the whole CLI run {resume_s:.3f} s with "
          f"the restore (its step-2 checkpoints recorded, not written); launches "
          f"{json.dumps({k: v for k, v in step_launches.items() if v})}; {card}", flush=True)
    return {"orbax_chain": launches, "orbax_resume": step_launches}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def wide_leaf(ph) -> np.ndarray:
    """The fixture's wide leaf as scripts/make_orbax_fixtures.py draws it."""
    return ph.cs.script_module("make_orbax_fixtures").wide_leaf()


def fixtures_part(ph) -> None:
    """O2's fixtures against their expected arrays."""
    from fourm_torch.native import native_available
    from fourm_torch.utils.checkpoint import load_safetensors
    from fourm_torch.utils.orbax import read_orbax_tree

    ph.check(native_available(), "O2: the native library did not build")
    exp = load_safetensors(os.path.join(FIXTURES, "expected.safetensors"),
                           return_metadata=False)
    got = {}
    for step in ("fourm_run/checkpoints/step_1", "vq_run/checkpoints/step_1"):
        for k, v in _flat(read_orbax_tree(os.path.join(FIXTURES, step))).items():
            if v is not None:
                got["/".join([step, *map(str, k)])] = v
    # bf16 where it holds the float32 value exactly
    exp = {k: (v.float() if v.dtype == ph.torch.bfloat16 else v).numpy() for k, v in exp.items()}
    bad = sorted(set(got) ^ set(exp)) + [
        k for k, v in exp.items() if k in got and (got[k].dtype != v.dtype
                                                  or got[k].shape != v.shape
                                                  or got[k].tobytes() != v.tobytes())]
    weights = _flat(read_orbax_tree(os.path.join(FIXTURES, "fourm_run/weights/step_1")))
    bad += [k for k, v in weights.items()
            if v.tobytes() != got.get("/".join(["fourm_run/checkpoints/step_1/params",
                                                *map(str, k)]), np.empty(0)).tobytes()]
    wide = read_orbax_tree(os.path.join(FIXTURES, WIDE))["w"]
    bad += [] if wide.tobytes() == wide_leaf(ph).tobytes() else [WIDE]
    ph.check(not bad, f"O2: fixture arrays differ from the expected: {bad[:5]}")
    print(f"orbax O2 fixtures: {len(exp)} arrays of 3 orbax step directories (zstd, a sharded "
          f"TrainState) read equal, bit for bit, to expected.safetensors, and the {wide.shape} "
          f"float32 leaf of {WIDE} to its draw; {ph.card}", flush=True)


def _tokenize(ph, model, x, label: str, want: dict) -> tuple:
    from fourm_torch import kernels

    tap = ph.cs.KernelTap(ph.torch, f"orbax {label}", want, ph.cpu)
    kernels.reset_launch_counts()
    with tap, ph.torch.no_grad():
        tokens = model.tokenize(x)
    ph.sync()
    launches = kernels.launch_counts()
    tap.report({k: launches[k] for k in want})
    return tokens, launches


def jax_layout_like(template: dict, state: dict, blocks: int) -> dict:
    """A JAX VQ variables tree ({"params", "codebook"}) of a port state dict
    (reference names), the names and leaf kinds taken from `template` (a
    JAX tree of the same encoder type): its blocks_0 repeated for `blocks`
    blocks; each leaf the state's tensor under from_jax_vq_variables' name,
    a kernel transposed back (Dense (out, in) -> (in, out); convolution
    (out, in, kh, kw) -> (kh, kw, in, out))."""
    from fourm_torch.utils.checkpoint import _VQ_LEAF, _vq_segment

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    out = {}
    params = _flat(template["params"])
    expanded = {}
    for path, leaf in params.items():
        if path[1:2] and path[1].startswith("blocks_"):
            if path[1] != "blocks_0":
                continue
            for i in range(blocks):
                expanded[(path[0], f"blocks_{i}") + path[2:]] = leaf
        else:
            expanded[path] = leaf
    for path in expanded:
        name = ".".join([_vq_segment(s) for s in path[:-1]] + [_VQ_LEAF.get(path[-1],
                                                                            path[-1])])
        t = state[name].detach().float().cpu().numpy()
        if path[-1] == "kernel":
            t = t.T if t.ndim == 2 else np.transpose(t, (2, 3, 1, 0))
        put(out, ("params",) + path, np.ascontiguousarray(t))
    for path in _flat(template["codebook"]):
        name = ".".join(list(path[:-1]) + ["_codebook", path[-1]])
        put(out, ("codebook",) + path, state[name].detach().float().cpu().numpy())
    return out


def o2_part(ph, tmp: str) -> dict:
    """O2's tokenizers and teacher; returns {path: launch counts}."""
    from fourm_torch.cli.save_vq_tokens import build_teacher
    from fourm_torch.utils.checkpoint import save_safetensors
    from fourm_torch.utils.orbax import read_orbax_tree, write_orbax_tree
    from fourm_torch.vq import VQ, init_vq_weights
    from fourm_torch.vq.loader import get_image_tokenizer

    torch, cs, check, card = ph.torch, ph.cs, ph.check, ph.card
    gen = torch.Generator(device=ph.dev).manual_seed(23)
    # the fixture's tokenizer run on the card in fp32: its heads of 32 are
    # not the attention kernels' 64, so its blocks take the plain twins; the
    # codebook search (fp32 in every dtype) is the kernel
    tiny, _ = get_image_tokenizer(os.path.join(FIXTURES, "vq_run"), encoder_only=True,
                                  verbose=False, config_override={"dtype": "float32"},
                                  device=ph.dev)
    x = torch.rand(TOKENIZE_B, 32, 32, 3, generator=gen, device=ph.dev)
    tok, tiny_launches = _tokenize(ph, tiny, x, "O2 fixture tokenizer",
                                   ["nearest_code_cosine"])
    ph.hold("O2 fixture tokenize", tiny_launches, {"nearest_code_cosine": 1})
    check(tuple(tok.shape) == (TOKENIZE_B, 8, 8) and int(tok.min()) >= 0
          and int(tok.max()) < 64, f"O2: fixture tokens {tuple(tok.shape)}")

    # a ViT-B tokenizer at full width as a JAX tokenizer run directory
    vq_cfg = {k: v for k, v in cs.VQ_RGB.items() if k != "dtype"}
    src = init_vq_weights(VQ(**vq_cfg, dtype="bfloat16", device=ph.dev), 29).eval()
    template = read_orbax_tree(os.path.join(FIXTURES, "vq_run", "checkpoints", "step_1"))
    run = os.path.join(tmp, "vq_run")
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as f:
        json.dump(dict(vq_cfg, domain="rgb"), f)
    t0 = time.perf_counter()
    write_orbax_tree(os.path.join(run, "checkpoints", "step_3"),
                     jax_layout_like(template, src.state_dict(), 12))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vitb, _ = get_image_tokenizer(run, encoder_only=True, verbose=False,
                                  config_override={"dtype": "bfloat16"}, device=ph.dev)
    ph.sync()
    read_s = time.perf_counter() - t0
    bad = _equal_states(torch, {k: v for k, v in src.state_dict().items()},
                        vitb.state_dict())
    check(not bad, f"O2: the ViT-B tokenizer read back differs in {bad[:5]}")
    x = torch.rand(TOKENIZE_B, 224, 224, 3, generator=gen, device=ph.dev)
    tok_b, vitb_launches = _tokenize(ph, vitb, x, "O2 ViT-B tokenizer", list(VITB_TOKENIZE))
    ph.hold("O2 ViT-B tokenize", vitb_launches, VITB_TOKENIZE)
    with torch.no_grad():
        want_tok = src.tokenize(x)
    check(torch.equal(tok_b, want_tok), "O2: the ViT-B tokens differ from the source model's")
    print(f"orbax O2 tokenizers: the fixture's vit_t run ({TOKENIZE_B} images at 32 px) and a "
          f"ViT-B tokenizer (VQ_RGB, 224 px, {cs.VQ_RGB['codebook_size']} cosine codes) written "
          f"as a JAX tokenizer run in {write_s:.3f} s ({_dir_bytes(run)} bytes) and read by "
          f"get_image_tokenizer in {read_s:.3f} s, its state bit for bit, its {TOKENIZE_B} "
          f"images' tokens equal to the source model's; launches "
          f"{json.dumps({k: v for k, v in vitb_launches.items() if v})}; {card}", flush=True)
    del tiny, src, vitb

    # the CLIP-B16 teacher from an OpenAI-layout .safetensors
    W, L, P, n = 768, 12, 16, 14 * 14 + 1
    w = lambda *s: torch.randn(s, generator=gen, device=ph.dev) * 0.02
    one = lambda: 1 + 0.05 * torch.randn(W, generator=gen, device=ph.dev)
    state = {"visual.conv1.weight": w(W, 3, P, P), "visual.class_embedding": w(W),
             "visual.positional_embedding": w(n, W), "visual.ln_pre.weight": one(),
             "visual.ln_pre.bias": w(W), "visual.ln_post.weight": one(),
             "visual.ln_post.bias": w(W), "visual.proj": w(W, 512)}
    for i in range(L):
        b = f"visual.transformer.resblocks.{i}"
        state.update({f"{b}.ln_1.weight": one(), f"{b}.ln_1.bias": w(W),
                      f"{b}.attn.in_proj_weight": w(3 * W, W), f"{b}.attn.in_proj_bias": w(3 * W),
                      f"{b}.attn.out_proj.weight": w(W, W), f"{b}.attn.out_proj.bias": w(W),
                      f"{b}.ln_2.weight": one(), f"{b}.ln_2.bias": w(W),
                      f"{b}.mlp.c_fc.weight": w(4 * W, W), f"{b}.mlp.c_fc.bias": w(4 * W),
                      f"{b}.mlp.c_proj.weight": w(W, 4 * W), f"{b}.mlp.c_proj.bias": w(W)})
    path = os.path.join(tmp, "clip_b16.safetensors")
    save_safetensors(state, path)
    teacher_fn = build_teacher("CLIP-B16", path, 224, 0, ph.dev)
    own = dict(teacher_fn.func.named_parameters())
    check(torch.equal(own["blocks.3.attn.qkv.weight"].float(),
                      state["visual.transformer.resblocks.3.attn.in_proj_weight"]
                      .to(own["blocks.3.attn.qkv.weight"].dtype).float()),
          "O2: the teacher's weights are not the file's")
    from fourm_torch import kernels

    tap = ph.cs.KernelTap(torch, "orbax O2 CLIP-B16 teacher", CLIP_CALL, ph.cpu)
    kernels.reset_launch_counts()
    with tap, torch.no_grad():
        feats = teacher_fn(x)
    ph.sync()
    teacher_launches = kernels.launch_counts()
    ph.hold("O2 CLIP-B16 teacher", teacher_launches, CLIP_CALL)
    tap.report(CLIP_CALL)
    check(tuple(feats.shape) == (TOKENIZE_B, 14, 14, 512) and bool(torch.isfinite(feats).all()),
          f"O2: teacher features {tuple(feats.shape)}")
    print(f"orbax O2 teacher: CLIP-B16 from an OpenAI-layout .safetensors through "
          f"build_teacher (--teacher_ckpt), {TOKENIZE_B} images -> {tuple(feats.shape)}; "
          f"launches {json.dumps({k: v for k, v in teacher_launches.items() if v})}; {card}",
          flush=True)
    return {"orbax_fixture_vq": tiny_launches, "orbax_vitb_vq": vitb_launches,
            "orbax_teacher": teacher_launches}


def o3_part(ph) -> None:
    """O3: the decoder's rate, one host thread: on the fixtures' small zstd
    values (a call each, and as one stream), on the wide leaf's one frame,
    and read_orbax_tree's on the fixture step directories."""
    from fourm_torch.native import decode_zstd
    from fourm_torch.utils.orbax import _Ocdbt, read_orbax_tree

    def rate(fn, nbytes: int, reps: int) -> tuple:
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = (time.perf_counter() - t0) / reps
        return dt * 1e3, nbytes / dt / 1e6

    frames, wide = [], None
    steps = ("fourm_run/weights/step_1", "fourm_run/checkpoints/step_1",
             "vq_run/checkpoints/step_1", WIDE)
    for step in steps:
        store = _Ocdbt(os.path.join(FIXTURES, step))
        for k, v in store.items().items():
            if k.endswith(b".zarray"):
                continue
            value = store.value(v, "").copy()
            if step == WIDE:
                wide = value
            elif value[:4].tobytes() == b"\x28\xb5\x2f\xfd":
                frames.append(value)
        store.close()
    out = sum(decode_zstd(f).size for f in frames)
    reps = 5 if ph.cpu else 40
    each = rate(lambda: [decode_zstd(f) for f in frames], out, reps)
    stream = np.concatenate(frames)  # the same frames as one stream: one call
    ph.check(decode_zstd(stream).size == out, "O3: the concatenated frames decode short")
    joined = rate(lambda: decode_zstd(stream), out, reps)
    wide_out = decode_zstd(wide).size
    ph.check(wide_out == wide_leaf(ph).nbytes, f"O3: the wide frame decodes to {wide_out} bytes")
    one = rate(lambda: decode_zstd(wide), wide_out, reps)
    read = rate(lambda: [read_orbax_tree(os.path.join(FIXTURES, s)) for s in steps],
                out + wide_out, reps)
    print(f"orbax O3: decode_zstd on one host thread, decoded bytes a second (mean of {reps} "
          f"after a warm call): the fixtures' {len(frames)} small zstd chunks "
          f"({sum(f.size for f in frames)} bytes -> {out}) {each[1]:.3f} MB/s a call a chunk "
          f"({each[0]:.3f} ms for all), {joined[1]:.3f} MB/s as one concatenated stream; "
          f"the wide leaf's one frame ({wide.size} bytes -> {wide_out}, float32 with whole "
          f"mantissas, zstd level 1 as orbax writes it) {one[1]:.3f} MB/s ({one[0]:.3f} ms); "
          f"read_orbax_tree of the 4 fixture step directories {read[0]:.3f} ms "
          f"({read[1]:.3f} MB/s; files warm in the page cache); {ph.card}", flush=True)


def orbax_phase(torch, card: str, cpu: bool = False) -> dict:
    """Phase 17; returns {path: launch counts} for the kernels line."""
    ph = Phase(torch, card, cpu)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_orbax_")
    try:
        launches = o1_part(ph, tmp)
        if not cpu:
            torch.cuda.empty_cache()
        fixtures_part(ph)
        launches.update(o2_part(ph, tmp))
        o3_part(ph)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 17: {time.perf_counter() - t0:.3f} s; {card}", flush=True)
    return launches


if __name__ == "__main__":
    import torch

    sys.path.insert(0, ROOT)
    if "--cpu" not in sys.argv:
        sys.exit("run it through `python3 chip_smoke.py --part orbax`, or with --cpu")
    orbax_phase(torch, "CPU rehearsal", cpu=True)
