"""Phase 13 of chip_smoke.py: the tokenizer stage on the card.

    python3 chip_smoke.py --part tokenizer   # this phase alone (after the build)

Runs the port's tokenizer entry points at the full width of the 4M-21
tokenizers, with seeded random weights and seeded data, and gates them:

  T1. cli.train_vqvae's Trainer on the DiVAE of
      cfgs/default/tokenization/divae/rgb/ViTB-UNetP4_16k_224_predx0.yaml
      (ViT-B encoder with post-MLP, UNet-P4 decoder, 16384 cosine codes of
      32, sample prediction, linear betas, model EMA) at B = 64, 6 steps on
      synthetic batches, dead-code expiry live;
  T2. the DiVAE of .../ViTB-UViTB_1k_224_predv_frozenenc.yaml (UViT-B
      decoder, frozen encoder, v-prediction, 1024 codes) at B = 64, 4
      steps; the encoder bit for bit over the steps;
  T3. `train_vqvae.main` on the VQ-VAE of
      cfgs/default/tokenization/vqvae/semseg_coco/ViTB-ViTB_4k_224.yaml
      (4096 codes, cross-entropy over 134 labels) at B = 64, 6 steps from a
      folder of 128 seeded palette PNGs (240-320 px) through SemsegTransform
      and a random crop, its eval and its checkpoint;
  T4. `save_vq_tokens.main` over 64 seeded RGB PNGs (240-320 px), 3 crops
      each, with T1's tokenizer exported and read back through
      get_image_tokenizer; a second run reuses the crop settings and skips
      every file, a third given a corrupt-samples log of 2 ids re-tokenizes
      exactly those. Its tokens equal VQ.tokenize of the same crops in this
      process, and equal across the runs.
Every step's launches are counted and held exactly: per step one
`nearest_code_cosine`, one `fused_adamw`, and `attention_train` forward
and backward per ViT-B / UViT-B block that trains (T2's frozen encoder runs
its 12 forwards without backwards); T3's eval 36 `attn_block` + 36
`ln_mlp` + 2 searches; T4 12 + 12 + 1 per image; nothing else. No loss may
be NaN. Then one T1 and one T3 step at 2 + 2 layers (T1: a 2-block
encoder, the full UNet) at batch 2 on the card in bf16 against the same
step in fp32 (and bf16, to size bf16's own error) on the CPU, phase 4's
gate (2 x the plain bf16 error + 1e-3): the loss, the codebook's embed and
cluster_size after the step, and the updated parameters.

Prints, with the card's name and power limit: samples/s of each training
config (B / the median fenced step), its peak memory, T4's images/s, and
the phase's seconds. Imports nothing of JAX or fourm_tpu.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time

import numpy as np

CONFIGS = {
    "T1": "cfgs/default/tokenization/divae/rgb/ViTB-UNetP4_16k_224_predx0.yaml",
    "T2": "cfgs/default/tokenization/divae/rgb/ViTB-UViTB_1k_224_predv_frozenenc.yaml",
    "T3": "cfgs/default/tokenization/vqvae/semseg_coco/ViTB-ViTB_4k_224.yaml",
}
STEPS = {"T1": 6, "T2": 4, "T3": 6}
BATCH = 64
T3_IMAGES, T4_IMAGES, N_CROPS = 128, 64, 3
ZERO = ("ln_matmul", "flash_mha", "attention", "self_decode", "cross_decode_attn",
        "decode_attention", "decode_attention_int8", "residual_mlp", "mha_short",
        "nearest_code")


def step_launches(fwd: int, bwd: int) -> dict:
    """The exact launches of one training step."""
    return {"nearest_code_cosine": 1, "fused_adamw": 1, "attention_train_fwd": fwd,
            "attention_train_bwd": bwd, "attn_block": 0, "ln_mlp": 0}


EXPECT_STEP = {"T1": step_launches(12, 12), "T2": step_launches(24, 12),
               "T3": step_launches(24, 24)}


def cli_args(name: str, out: str, *extra) -> list:
    return (["--config", CONFIGS[name], "--batch_size", str(BATCH), "--total_steps",
             str(STEPS[name]), "--print_freq", "1", "--output_dir", out] + list(extra))


def parse_args(tcli, argv: list):
    """The train CLI's arguments, its --config read as main() reads it."""
    from fourm_torch.utils.config import parse_args_with_config

    return parse_args_with_config(tcli.get_parser(), argv)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _hold(check, label: str, got: dict, want: dict) -> None:
    for k in ZERO:
        want.setdefault(k, 0)
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    check(not bad, f"{label}: launch counts (got, want) differ: {bad}")


class StepRecorder:
    """Wraps cli.train_vqvae.Trainer.train_step: each step fenced and timed,
    its launch counts and losses kept (instrumentation of this phase; the
    step itself is the CLI's)."""

    def __init__(self, torch, tcli, kernels):
        self.torch, self.tcli, self.kernels = torch, tcli, kernels
        self.times, self.counts, self.losses = [], [], []
        self._orig = tcli.Trainer.train_step

    def __enter__(self):
        rec, orig, torch = self, self._orig, self.torch

        def timed(trainer, batch, draws=None):
            torch.cuda.synchronize()
            before = rec.kernels.launch_counts()
            t0 = time.perf_counter()
            out = orig(trainer, batch, draws)
            torch.cuda.synchronize()
            rec.times.append(time.perf_counter() - t0)
            rec.counts.append(_delta(rec.kernels.launch_counts(), before))
            rec.losses.append({k: float(v) for k, v in out.items()})
            return out

        self.tcli.Trainer.train_step = timed
        return self

    def __exit__(self, *exc):
        self.tcli.Trainer.train_step = self._orig


def _report(torch, check, name: str, rec: StepRecorder, card: str) -> dict:
    for i, (c, loss) in enumerate(zip(rec.counts, rec.losses)):
        _hold(check, f"{name} step {i}", c, dict(EXPECT_STEP[name]))
        check(all(np.isfinite(v) for v in loss.values()), f"{name} step {i}: {loss}")
    med = statistics.median(rec.times[1:])  # the first step builds plans and tables
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"tokenizer {name}: {BATCH / med:.4f} samples/s (median of {len(rec.times) - 1} "
          f"fenced steps after the first, {med * 1e3:.3f} ms a step, first "
          f"{rec.times[0] * 1e3:.1f} ms); peak memory {peak:.3f} GiB; losses "
          f"{[round(l['loss'], 6) for l in rec.losses]}; per-step launches "
          f"{ {k: v for k, v in rec.counts[-1].items() if v} }; {card}", flush=True)
    return {"samples_per_s": BATCH / med, "peak_gib": peak}


def train_synthetic(torch, tcli, kernels, check, name: str, tmp: str, card: str):
    """T1 / T2: the CLI's Trainer on synthetic batches; returns the trainer
    and the step launches summed over the run."""
    torch.cuda.reset_peak_memory_stats()
    args = parse_args(tcli, cli_args(name, os.path.join(tmp, name), "--synthetic_data"))
    trainer = tcli.Trainer(args, torch.device("cuda"))
    source = tcli.SyntheticBatches(args)
    frozen = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
              if n.startswith("encoder.")} if args.freeze_enc else {}
    with StepRecorder(torch, tcli, kernels) as rec:
        for it in range(args.total_steps):
            trainer.train_step(torch.from_numpy(source.batch(it)).cuda())
    stats = _report(torch, check, name, rec, card)
    if frozen:
        same = sum(int(torch.equal(p, frozen[n])) for n, p in trainer.model.named_parameters()
                   if n in frozen)
        check(same == len(frozen), f"T2: the frozen encoder changed in "
                                   f"{len(frozen) - same} of {len(frozen)} leaves")
        print(f"tokenizer T2: the frozen encoder bit for bit over {args.total_steps} steps "
              f"({len(frozen)} leaves)", flush=True)
    cb = trainer.model.quantize._codebook
    dead = int((cb.cluster_size < args.threshold_ema_dead_code).sum())
    print(f"tokenizer {name}: codebook after {args.total_steps} steps: {dead} of "
          f"{cb.cluster_size.numel()} codes below the dead-code threshold (replaced each step)",
          flush=True)
    total = {k: sum(c[k] for c in rec.counts) for k in rec.counts[0]}
    return trainer, total, stats


def write_semseg_folder(image_io, root: str, n: int, seed: int) -> None:
    """n seeded palette PNGs, 240-320 px a side, labels 0..132 (the
    transform's shift by one makes them 1..133 of 134)."""
    rng = np.random.RandomState(seed)
    folder = os.path.join(root, "semseg_coco", "c")
    os.makedirs(folder, exist_ok=True)
    palette = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    for i in range(n):
        h, w = rng.randint(240, 321, 2)
        blocks = rng.randint(0, 133, (h // 16 + 1, w // 16 + 1)).astype(np.uint8)
        idx = np.repeat(np.repeat(blocks, 16, 0), 16, 1)[:h, :w]
        with open(os.path.join(folder, f"{i:04d}.png"), "wb") as f:
            f.write(image_io.write_png(idx, filters=(1, 2, 4), palette=palette))


def write_rgb_folder(image_io, root: str, n: int, seed: int) -> None:
    rng = np.random.RandomState(seed)
    folder = os.path.join(root, "rgb", "c")
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        h, w = rng.randint(240, 321, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        img = np.cumsum(img.astype(np.int64), axis=1).astype(np.uint8)  # some structure
        with open(os.path.join(folder, f"{i:04d}.png"), "wb") as f:
            f.write(image_io.write_png(img, filters=(1, 4)))


def train_semseg(torch, tcli, kernels, check, tmp: str, card: str):
    """T3: train_vqvae.main from the palette folder: 6 steps, one eval, one
    checkpoint."""
    from fourm_torch.data import image_io
    from fourm_torch.utils.checkpoint import latest_checkpoint_steps

    data = os.path.join(tmp, "T3_data")
    write_semseg_folder(image_io, data, T3_IMAGES, 31)
    out = os.path.join(tmp, "T3")
    torch.cuda.reset_peak_memory_stats()
    argv = cli_args("T3", out, "--data_path", data, "--eval_freq", str(STEPS["T3"]),
                    "--save_ckpt_freq", str(STEPS["T3"]), "--device", "cuda")
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    with StepRecorder(torch, tcli, kernels) as rec:
        trainer = tcli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = _delta(kernels.launch_counts(), before)
    stats = _report(torch, check, "T3", rec, card)
    steps = {k: sum(c[k] for c in rec.counts) for k in run}
    _hold(check, "T3 eval", _delta(run, steps),
          {"attn_block": 36, "ln_mlp": 36, "nearest_code_cosine": 2,
           "attention_train_fwd": 0, "attention_train_bwd": 0, "fused_adamw": 0})
    log = [l for l in open(os.path.join(out, "log.txt")).read().splitlines() if "eval_" in l]
    check(len(log) == 1, f"T3: one eval line expected, got {len(log)}")
    check(latest_checkpoint_steps(os.path.join(out, "checkpoints")) == [STEPS["T3"]],
          "T3: one checkpoint at the last step")
    print(f"tokenizer T3: main() {wall:.3f} s for {STEPS['T3']} steps from {T3_IMAGES} PNGs, "
          f"the eval ({log[0]}) and a checkpoint; {card}", flush=True)
    return trainer, run, stats


def tokenize_stage(torch, tcli, kernels, check, t1, tmp: str, card: str):
    """T4: save_vq_tokens.main over 64 RGB PNGs with T1's exported
    tokenizer; three runs (fresh, skipping, corrupt-log)."""
    from fourm_torch.cli import save_vq_tokens as tsave
    from fourm_torch.data import image_io
    from fourm_torch.data.transforms import divae_modality_transforms
    from fourm_torch.vq import get_image_tokenizer

    data = os.path.join(tmp, "T4_data")
    write_rgb_folder(image_io, data, T4_IMAGES, 41)
    path = os.path.join(tmp, "T1_tokenizer.safetensors")
    tcli.export_tokenizer(t1, path)
    out, cs = os.path.join(tmp, "T4_tokens"), os.path.join(tmp, "T4_crops")
    argv = ["--data_root", data, "--domain", "rgb", "--ckpt", path, "--out_dir", out,
            "--n_crops", str(N_CROPS), "--crop_settings_dir", cs, "--input_size", "224"]
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n1 = tsave.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    run = _delta(kernels.launch_counts(), before)
    check(n1 == T4_IMAGES, f"T4: first run wrote {n1} of {T4_IMAGES}")
    _hold(check, "T4", run, {"attn_block": 12 * T4_IMAGES, "ln_mlp": 12 * T4_IMAGES,
                             "nearest_code_cosine": T4_IMAGES, "attention_train_fwd": 0,
                             "attention_train_bwd": 0, "fused_adamw": 0})
    first = {f: np.load(os.path.join(out, "c", f)) for f in sorted(os.listdir(
        os.path.join(out, "c")))}
    # the same crops tokenized in this process by the tokenizer read back
    model, _ = get_image_tokenizer(path, encoder_only=True, verbose=False,
                                   config_override={"dtype": "bfloat16"})
    t = divae_modality_transforms()["rgb"]
    same = 0
    for f, tokens in first.items():
        img = t.preprocess(t.load(os.path.join(data, "rgb", "c", f.replace(".npy", ".png"))))
        settings = np.load(os.path.join(cs, "c", f))
        crops = [t.postprocess(t.image_augment(img, (a, b, c, d), bool(e), img.shape[:2],
                                               (224, 224), None)) for a, b, c, d, e in settings]
        with torch.no_grad():
            want = model.tokenize(torch.from_numpy(np.stack(crops)).cuda()).cpu().numpy()
        same += int(np.array_equal(tokens, want.reshape(N_CROPS, -1).astype(np.int16)))
    check(same == len(first), f"T4: {same} of {len(first)} samples' tokens equal "
                              "VQ.tokenize of the same crops")
    check(tsave.main(argv) == 0, "T4: the second run must skip every file")
    log = os.path.join(tmp, "T4_corrupt.txt")
    ids = sorted(first)[:2]
    with open(log, "w") as fh:
        fh.write("".join(f"c/{i[:-4]}\n" for i in ids))
    for i in ids:
        os.remove(os.path.join(out, "c", i))
    check(tsave.main(argv + ["--corrupt_samples_log", log]) == 2,
          "T4: the corrupt log's 2 ids re-tokenized")
    for f, tokens in first.items():
        check(np.array_equal(np.load(os.path.join(out, "c", f)), tokens),
              f"T4: {f} differs between runs")
    print(f"tokenizer T4: save_vq_tokens {T4_IMAGES / secs:.4f} images/s ({N_CROPS} crops "
          f"each, {secs:.3f} s with PNG decoding and crops on the host); tokens equal to "
          f"VQ.tokenize in this process ({same} of {len(first)}), the skipping run and the "
          f"corrupt-log run (2 ids) equal to the first; {card}", flush=True)
    return run, {"images_per_s": T4_IMAGES / secs}


def parity(torch, tcli, check, name: str, card: str) -> None:
    """One step at 2 + 2 layers, batch 2, card bf16 against CPU fp32 (and
    bf16): loss, codebook embed / cluster_size, updated parameters."""
    from fourm_torch.vq.vit_models import VIT_SIZES

    VIT_SIZES.setdefault("vit_b2", dict(VIT_SIZES["vit_b"], depth=2))
    extra = ["--batch_size", "2", "--enc_type", "vit_b2_enc", "--warmup_steps", "0",
             "--blr", "0.1", "--synthetic_data", "--seed", "3"]
    if name == "T3":
        extra += ["--dec_type", "vit_b2_dec"]
    results = {}
    start = None
    gen = torch.Generator().manual_seed(7)
    batch = draws = None
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32"), ("cpu", "bfloat16")):
        args = parse_args(tcli, cli_args(name, "unused", *extra) + ["--dtype", dtype])
        trainer = tcli.Trainer(args, torch.device(dev))
        m = trainer.model
        if start is None:
            start = {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
            batch = torch.from_numpy(tcli.SyntheticBatches(args).batch(0))
            draws = {"expire_idx": torch.randint(0, 2 * 196, (args.codebook_size,),
                                                 generator=gen)}
            if trainer.diffusion:
                draws.update(noise=torch.randn(batch.shape, generator=gen),
                             timesteps=torch.randint(0, 1000, (2,), generator=gen))
        m.load_state_dict(start)
        metrics = trainer.train_step(batch.to(dev), {k: v.to(dev) for k, v in draws.items()})
        cb = m.quantize._codebook
        results[(dev, dtype)] = {
            "loss": float(metrics["loss"]),
            "embed": cb.embed.float().cpu(), "cluster_size": cb.cluster_size.float().cpu(),
            "params": {n: p.detach().float().cpu() for n, p in m.named_parameters()}}
        del trainer, m
        torch.cuda.empty_cache()
    card_r, f32, b16 = (results[k] for k in (("cuda", "bfloat16"), ("cpu", "float32"),
                                             ("cpu", "bfloat16")))

    def err(a, b):
        if isinstance(a, float):
            return abs(a - b)
        if isinstance(a, dict):
            return max(float((a[k] - b[k]).abs().max()) for k in a)
        return float((a - b).abs().max())

    for what in ("loss", "embed", "cluster_size", "params"):
        e, plain = err(card_r[what], f32[what]), err(b16[what], f32[what])
        tol = 2.0 * plain + 1e-3
        print(f"tokenizer {name} parity (2 + 2 layers, B = 2): {what}: card {e:.6g} from "
              f"fp32 (tol {tol:.6g}; plain bf16 {plain:.6g}); {card}", flush=True)
        check(e <= tol and np.isfinite(e), f"{name} parity: {what} {e} > {tol}")


def tokenizer_phase(torch, card: str, check) -> dict:
    """Phase 13; returns {path: launch counts} for the kernels line."""
    from fourm_torch import kernels
    from fourm_torch.cli import train_vqvae as tcli

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_tokenizer_")
    try:
        kernels.reset_launch_counts()
        t1, t1_runs, s1 = train_synthetic(torch, tcli, kernels, check, "T1", tmp, card)
        t4_runs, s4 = tokenize_stage(torch, tcli, kernels, check, t1, tmp, card)
        del t1
        torch.cuda.empty_cache()
        _t2, t2_runs, s2 = train_synthetic(torch, tcli, kernels, check, "T2", tmp, card)
        del _t2
        torch.cuda.empty_cache()
        _t3, t3_runs, s3 = train_semseg(torch, tcli, kernels, check, tmp, card)
        del _t3
        torch.cuda.empty_cache()
        parity(torch, tcli, check, "T1", card)
        parity(torch, tcli, check, "T3", card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_start
    print(f"tokenizer phase: {secs:.1f} s; T1 {s1['samples_per_s']:.4f} / T2 "
          f"{s2['samples_per_s']:.4f} / T3 {s3['samples_per_s']:.4f} samples/s, peak "
          f"{s1['peak_gib']:.3f} / {s2['peak_gib']:.3f} / {s3['peak_gib']:.3f} GiB, T4 "
          f"{s4['images_per_s']:.4f} images/s; {card}", flush=True)
    return {"tokenizer_T1": t1_runs, "tokenizer_T2": t2_runs, "tokenizer_T3": t3_runs,
            "tokenizer_T4": t4_runs}
