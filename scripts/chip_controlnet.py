"""Phase 16 of chip_smoke.py: the VQControlNet tokenizer on the card.

    python3 chip_smoke.py --part controlnet   # this phase alone (after the build)
    python3 scripts/chip_controlnet.py --cpu  # a rehearsal on the CPU at a tiny size

Runs the port's VQControlNet entry points at the full width of
cfgs/default/tokenization/vqcontrolnet/rgb/ViTB-SD1.5_1k_224-448.yaml,
uncut (ViT-B encoder at 448 px, 28 x 28 tokens of 1024 cosine codes; the
SD-1.5-scale UNet and ControlNet branch over a 56 x 56 x 4 VAE latent;
1,079,657,743 parameters), random weights drawn on the card from seeds:

  C1. VQ.tokenize of 2 seeded 448 px images (the encoder's inference
      kernels: 12 `ln_matmul`, 12 `mha_short`, 12 `ln_mlp`, one
      `nearest_code_cosine`), each launch held to its plain twin on the same
      inputs (chip_smoke.KernelTap); the latents against the encoder's fp32
      and bf16 copies on the CPU and the tokens against the plain search on
      the card's latents (phase 7's latent_gate and token_gate); then
      controlnet_decode_tokens of the 2 grids at 8 DDIM steps, CFG off
      (guidance 0) and on (guidance 2; the unconditional pass skips the
      branch): (2, 448, 448, 3), finite, in
      [-1, 1], no kernel launched by the decoding (it is convolutions,
      GroupNorm and plain attention). ms a call (median of 3 fenced calls
      after a warm one), requests/s, and the busy share (device time under
      the profiler over the unprofiled wall time). Then the same decoder at
      num_res_blocks 1 (widths kept) decoding one grid at 2 steps, CFG off,
      on the card in bf16 against the same weights and noise on the CPU in
      fp32 (and bf16, to size bf16's own error): phase 4's gate.
  C2. cli.train_vqcontrolnet.main --synthetic_data for 6 steps at B = 32
      with one eval at the last step: every step's loss finite; exactly 12
      `ln_matmul`, 12 `mha_short`, 12 `ln_mlp`, one `nearest_code_cosine`
      and one `fused_adamw` a step and nothing else, each launch of step 1
      (B = 32: 25088 encoder rows; AdamW over the branch's 256 leaves, clip
      included) held to its plain twin on the same inputs
      (chip_smoke.KernelTap); the eval's 12 + 12 + 12 + 1; every parameter
      outside decoder.controlnet bit for bit over the run, the branch moved;
      before step 1 the branch's time embedding and encoder equal to the
      UNet's (--init_controlnet_from_unet).
      samples/s (B / the median fenced step after the first), peak memory.
  C3. The run's tokenizer.safetensors read back by get_image_tokenizer
      (a VQControlNet, strict): every tensor equal to the trainer's.

Prints, with the card's name and power limit, the phase's seconds. Imports
nothing of JAX or fourm_tpu.
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

CONFIG = "cfgs/default/tokenization/vqcontrolnet/rgb/ViTB-SD1.5_1k_224-448.yaml"
BATCH, STEPS, DECODE_B, DECODE_STEPS, TIMED = 32, 6, 2, 8, 3
ENCODER = {"ln_matmul": 12, "mha_short": 12, "ln_mlp": 12, "nearest_code_cosine": 1}
# the CPU rehearsal's flags (tests/test_torch_controlnet.py's size)
TINY = ["--input_size", "32", "--patch_size", "4", "--enc_type", "vit_t_enc",
        "--codebook_size", "64", "--latent_dim", "8", "--model_channels", "32",
        "--channel_mult", "1", "2", "--attention_levels", "1", "--num_heads", "2",
        "--context_len", "4", "--context_dim", "16", "--vae_base_channels", "32",
        "--vae_ch_mult", "1", "2", "--dtype", "float32"]


class Run:
    """The phase's device, flags and gates (the card; or the CPU rehearsal,
    where the launch counts are reported and not held)."""

    def __init__(self, torch, card: str, check, latent_gate, token_gate, skip_init,
                 cpu: bool = False):
        self.torch, self.card, self.check, self.latent_gate = torch, card, check, latent_gate
        self.token_gate, self.skip_init = token_gate, skip_init
        self.cpu = cpu
        self.dev = "cpu" if cpu else "cuda"
        self.batch = 2 if cpu else BATCH
        self.extra = TINY if cpu else []

    def args(self, *argv):
        from fourm_torch.cli import train_vqcontrolnet as cli
        from fourm_torch.utils.config import parse_args_with_config

        return parse_args_with_config(cli.get_parser(),
                                      ["--config", CONFIG] + self.extra + list(argv))

    def config(self, **overrides) -> dict:
        from fourm_torch.cli import train_vqcontrolnet as cli

        cfg = {k: v for k, v in cli.model_config(self.args()).items() if k != "domain"}
        return dict(cfg, **overrides)

    def sync(self):
        if not self.cpu:
            self.torch.cuda.synchronize()

    def tap(self, label: str, names):
        import chip_smoke

        return chip_smoke.KernelTap(self.torch, f"controlnet {label}", names, self.cpu)

    def hold(self, label: str, got: dict, want: dict) -> None:
        want = {k: want.get(k, 0) for k in got}
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if self.cpu:
            print(f"  (CPU rehearsal) {label}: launches not held: {bad}", flush=True)
            return
        self.check(not bad, f"{label}: launch counts (got, want) differ: {bad}")


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def busy_share(torch, fn, wall_ms: float) -> float:
    """Device time of fn() under the profiler over its unprofiled wall time.
    The device's activity alone is traced: with the host's ops as well, one
    profiled decode took 35.7 s (a call of thousands of small ops)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev_us / 1e3 / wall_ms


def decode_part(run: Run, kernels) -> dict:
    """C1; returns the launches of the tokenize + decode path."""
    from fourm_torch.vq import VQControlNet, controlnet_decode_tokens, init_vq_weights

    torch, dev = run.torch, run.dev
    t0 = time.perf_counter()
    model = init_vq_weights(VQControlNet(**run.config(), device=dev), 0)
    run.sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"controlnet C1: VQControlNet of {CONFIG} ({n_params} parameters) built on {dev} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    S = model.image_size
    images = torch.rand(DECODE_B, S, S, 3, generator=gen, device=dev) * 2 - 1
    kernels.reset_launch_counts()
    with torch.inference_mode():
        with run.tap("C1 tokenize", ENCODER) as tap:
            tokens = model.tokenize(images)
        run.sync()
        tok = kernels.launch_counts()
        run.hold("C1 tokenize", tok, ENCODER)
        tap.report(ENCODER)
        n = model.latent_size
        noise = torch.randn(DECODE_B, n, n, 4, generator=gen, device=dev)
        for guidance in (0.0, 2.0):
            def call():
                return controlnet_decode_tokens(model, tokens, timesteps=DECODE_STEPS,
                                                guidance_scale=guidance, noise=noise)

            img = call()
            times = []
            for _ in range(1 if run.cpu else TIMED):
                run.sync()
                t1 = time.perf_counter()
                img = call()
                run.sync()
                times.append((time.perf_counter() - t1) * 1e3)
            ms = statistics.median(times)
            run.check(tuple(img.shape) == (DECODE_B, S, S, 3), f"C1: shape {tuple(img.shape)}")
            run.check(bool(torch.isfinite(img).all()), "C1: non-finite pixels")
            lo, hi = float(img.min()), float(img.max())
            run.check(-1.0 <= lo and hi <= 1.0, f"C1: pixels outside [-1, 1]: {lo}, {hi}")
            t1 = time.perf_counter()
            busy = None if run.cpu else busy_share(torch, call, ms)
            prof_s = time.perf_counter() - t1
            print(f"controlnet C1: controlnet_decode_tokens B = {DECODE_B}, {DECODE_STEPS} DDIM "
                  f"steps, guidance {guidance}: {ms:.3f} ms a call (median of {len(times)}; "
                  f"{sorted(round(t, 3) for t in times)}), {DECODE_B / ms * 1e3:.4f} requests/s, "
                  f"busy share {busy if busy is None else round(busy, 4)} (profiled call "
                  f"{prof_s:.1f} s); pixels in "
                  f"[{lo:.4f}, {hi:.4f}], std {float(img.float().std()):.4f}; {run.card}",
                  flush=True)
        run.hold("C1 decode", _delta(kernels.launch_counts(), tok), {})
    launches = kernels.launch_counts()
    del img
    encoder_parity(run, model, images)
    del model, images
    if not run.cpu:
        torch.cuda.empty_cache()
    print(f"controlnet C1: {time.perf_counter() - t0:.1f} s before the parity", flush=True)
    decode_parity(run, tokens[:1])
    return launches


def encoder_parity(run: Run, model, images) -> None:
    """C1's latents (bf16 on the card) against the model's VQ part (encoder,
    quant_proj, codebook) copied to the CPU in fp32 and bf16, and its
    tokens against the plain search on the card's latents: phase 7's
    gates."""
    import inspect

    from fourm_torch.vq import VQ

    torch = run.torch
    t0 = time.perf_counter()
    keys = set(inspect.signature(VQ.__init__).parameters) - {"self", "device"}
    cfg = {k: v for k, v in run.config().items() if k in keys}
    state = {k: v.float().cpu() for k, v in model.state_dict().items()}
    with torch.inference_mode():
        lat = model.latents(images)
        ref, cpu = {}, {}
        for dtype in ("float32", "bfloat16"):
            with run.skip_init():
                cpu[dtype] = VQ(**dict(cfg, dtype=dtype), device="cpu")
            cpu[dtype].load_state_dict({k: state[k] for k in cpu[dtype].state_dict()},
                                       strict=True)
            ref[dtype] = cpu[dtype].latents(images.cpu()).float()
        name = f"C1 encoder latents, B = {images.shape[0]} at {images.shape[1]}"
        tol = run.latent_gate(torch, f"{name} ({time.perf_counter() - t0:.1f} s)",
                              lat.float().cpu(), ref["float32"], ref["bfloat16"],
                              label="controlnet parity")
        run.token_gate(torch, "C1 tokens", model, lat, cpu["float32"], ref["float32"], tol)


def decode_parity(run: Run, tokens) -> None:
    """C1's parity: num_res_blocks 1, one grid, 2 steps, CFG off."""
    from fourm_torch.vq import VQControlNet, controlnet_decode_tokens, init_vq_weights

    torch, dev = run.torch, run.dev
    t0 = time.perf_counter()
    cfg = run.config(num_res_blocks=1)
    model = init_vq_weights(VQControlNet(**cfg, device=dev), 2)
    gen = torch.Generator(device=dev).manual_seed(3)
    n = model.latent_size
    noise = torch.randn(1, n, n, 4, generator=gen, device=dev)
    with torch.inference_mode():
        card = controlnet_decode_tokens(model, tokens, timesteps=2, noise=noise).float().cpu()
    state = {k: v.float().cpu() for k, v in model.state_dict().items()}
    del model
    ref, secs = {}, [f"card {time.perf_counter() - t0:.1f}"]
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        with run.skip_init():
            m = VQControlNet(**dict(cfg, dtype=dtype), device="cpu")
        m.load_state_dict(state, strict=True)
        t1 = time.perf_counter()
        with torch.inference_mode():
            ref[dtype] = controlnet_decode_tokens(m, tokens.cpu(), timesteps=2,
                                                  noise=noise.cpu()).float()
        del m
        secs.append(f"CPU {dtype} build {t1 - t0:.1f} + run {time.perf_counter() - t1:.1f}")
    run.latent_gate(torch, f"C1 decode num_res_blocks 1, B = 1, 2 steps, CFG off "
                    f"(s: {', '.join(secs)})", card, ref["float32"], ref["bfloat16"],
                    label="controlnet parity")


class StepRecorder:
    """Wraps cli.train_vqcontrolnet.Trainer.train_step: each step fenced and
    timed, its launch counts and losses kept; before the first step, the
    branch's copy of the UNet checked and the frozen parameters kept."""

    def __init__(self, run: Run, cli, kernels):
        self.run, self.cli, self.kernels = run, cli, kernels
        self.times, self.counts, self.losses = [], [], []
        self.frozen, self.copied = None, 0
        self._orig = cli.Trainer.train_step

    def first(self, trainer) -> None:
        m = trainer.model
        state = m.state_dict()
        for key in ("time_embed", "encoder"):
            for name, t in getattr(m.decoder.unet, key).state_dict().items():
                other = state[f"decoder.controlnet.{key}.{name}"]
                self.run.check(self.run.torch.equal(t, other),
                               f"C2: the branch's {key}.{name} is not the UNet's before step 1")
                self.copied += 1
        self.frozen = {n: p.detach().clone() for n, p in m.named_parameters()
                       if not n.startswith("decoder.controlnet.")}

    def __enter__(self):
        rec, orig = self, self._orig

        def timed(trainer, batch, draws=None):
            first = rec.frozen is None
            if first:
                rec.first(trainer)
            rec.run.sync()
            before = rec.kernels.launch_counts()
            t0 = time.perf_counter()
            if first:  # the first step's launches held to the twins (its time left out)
                with rec.run.tap("C2 step 0", dict(ENCODER, fused_adamw=1)) as tap:
                    out = orig(trainer, batch, draws)
                tap.report(dict(ENCODER, fused_adamw=1))
            else:
                out = orig(trainer, batch, draws)
            rec.run.sync()
            rec.times.append(time.perf_counter() - t0)
            rec.counts.append(_delta(rec.kernels.launch_counts(), before))
            rec.losses.append({k: float(v) for k, v in out.items()})
            return out

        self.cli.Trainer.train_step = timed
        return self

    def __exit__(self, *exc):
        self.cli.Trainer.train_step = self._orig


def train_part(run: Run, kernels, tmp: str):
    """C2; returns (trainer, output dir, run launches, stats)."""
    from fourm_torch.cli import train_vqcontrolnet as cli

    torch = run.torch
    out = os.path.join(tmp, "C2")
    argv = (["--config", CONFIG] + run.extra
            + ["--synthetic_data", "--batch_size", str(run.batch), "--total_steps", str(STEPS),
               "--print_freq", "1", "--eval_freq", str(STEPS), "--save_ckpt_freq", "1000",
               "--output_dir", out] + (["--device", "cpu"] if run.cpu else []))
    if not run.cpu:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with StepRecorder(run, cli, kernels) as rec:
        trainer = cli.main(argv)
    run.sync()
    wall = time.perf_counter() - t0
    total = kernels.launch_counts()
    for i, (c, loss) in enumerate(zip(rec.counts, rec.losses)):
        run.hold(f"C2 step {i}", c, dict(ENCODER, fused_adamw=1))
        run.check(all(np.isfinite(v) for v in loss.values()), f"C2 step {i}: {loss}")
    steps = {k: sum(c[k] for c in rec.counts) for k in total}
    run.hold("C2 eval", _delta(total, steps), ENCODER)
    m = trainer.model
    same = sum(int(torch.equal(p, rec.frozen[n])) for n, p in m.named_parameters()
               if n in rec.frozen)
    run.check(same == len(rec.frozen), f"C2: {len(rec.frozen) - same} of {len(rec.frozen)} "
                                       "parameters outside decoder.controlnet changed")
    branch = {n for n, _ in m.named_parameters() if n.startswith("decoder.controlnet.")}
    run.check({n for n, _ in trainer.opt.named_params()} == branch,
              "C2: the optimizer must step exactly the branch")
    state = m.state_dict()
    moved = sum(int(not torch.equal(t, state[f"decoder.controlnet.{key}.{name}"]))
                for key in ("time_embed", "encoder")
                for name, t in getattr(m.decoder.unet, key).state_dict().items())
    run.check(moved > 0, "C2: the branch did not move from the UNet's copy")
    log = [line for line in open(os.path.join(out, "log.txt")).read().splitlines()
           if "eval_mse" in line]
    run.check(len(log) == 1, f"C2: one eval line expected, got {len(log)}")
    med = statistics.median(rec.times[1:])
    peak = 0.0 if run.cpu else torch.cuda.max_memory_allocated() / 2**30
    print(f"controlnet C2: train_vqcontrolnet.main {STEPS} steps at B = {run.batch}: "
          f"{run.batch / med:.4f} samples/s (median of {len(rec.times) - 1} fenced steps after "
          f"the first, {med * 1e3:.3f} ms a step; first {rec.times[0] * 1e3:.1f} ms); peak "
          f"memory {peak:.3f} GiB; losses {[round(l['rec'], 6) for l in rec.losses]}; "
          f"per-step launches { {k: v for k, v in rec.counts[-1].items() if v} }; the eval "
          f"{log[0]}; {same} frozen leaves bit for bit; {rec.copied} branch leaves equal to the "
          f"UNet's before step 1, {moved} moved from them; main() {wall:.3f} s with the "
          f"checkpoint; {run.card}", flush=True)
    return trainer, out, total, {"samples_per_s": run.batch / med, "peak_gib": peak}


def load_part(run: Run, trainer, out: str) -> None:
    """C3: the run's tokenizer.safetensors through get_image_tokenizer."""
    from fourm_torch.vq import VQControlNet, get_image_tokenizer

    torch = run.torch
    path = os.path.join(out, "tokenizer.safetensors")
    run.sync()
    t0 = time.perf_counter()
    model, _ = get_image_tokenizer(path, verbose=False, config_override={"dtype": "float32"},
                                   device=run.dev)
    run.sync()
    secs = time.perf_counter() - t0
    run.check(isinstance(model, VQControlNet), f"C3: loaded a {type(model).__name__}")
    want = trainer.model.state_dict()
    got = model.state_dict()
    run.check(set(got) == set(want), "C3: the loaded state's keys differ")
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    run.check(not bad, f"C3: {len(bad)} tensors differ from the trainer's: {bad[:5]}")
    print(f"controlnet C3: {os.path.getsize(path)} byte tokenizer.safetensors read back by "
          f"get_image_tokenizer in {secs:.3f} s, a VQControlNet, {len(want)} tensors equal to "
          f"the trainer's; {run.card}", flush=True)


def controlnet_phase(torch, card: str, check, latent_gate, token_gate, skip_init,
                     cpu: bool = False) -> dict:
    """Phase 16; returns {path: launch counts} for the kernels line
    (check, the gates and skip_init: chip_smoke's)."""
    from fourm_torch import kernels

    run = Run(torch, card, check, latent_gate, token_gate, skip_init, cpu)
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_controlnet_")
    try:
        c1 = decode_part(run, kernels)
        t1 = time.perf_counter()
        trainer, out, c2, stats = train_part(run, kernels, tmp)
        t2 = time.perf_counter()
        load_part(run, trainer, out)
        print(f"phase 16 seconds: C1 {t1 - t_start:.1f}, C2 {t2 - t1:.1f}, C3 "
              f"{time.perf_counter() - t2:.1f}", flush=True)
        del trainer
        if not cpu:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 16: {time.perf_counter() - t_start:.1f} s; C2 {stats['samples_per_s']:.4f} "
          f"samples/s, peak {stats['peak_gib']:.3f} GiB; {card}", flush=True)
    return {"controlnet_C1": c1, "controlnet_C2": c2}


if __name__ == "__main__":
    # the CPU rehearsal: the phase's Python at the tests' tiny size
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    if "--cpu" not in sys.argv:
        sys.exit("run `python3 chip_smoke.py --part controlnet` on the card, or --cpu here")
    controlnet_phase(torch, "CPU rehearsal", chip_smoke.check, chip_smoke.latent_gate,
                     chip_smoke.token_gate, chip_smoke.skip_init, cpu=True)
