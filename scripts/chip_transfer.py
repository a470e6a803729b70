"""Phase 14 of chip_smoke.py: transfer learning from real image files on the card.

    python3 chip_smoke.py --part transfer   # this phase alone (after the build)

  J. The committed JPEG fixtures (tests/jpeg_fixtures, written by Pillow
     12.1.0 through scripts/make_jpeg_fixtures.py) decoded by the native
     library built from this checkout: each file's pixels must hash to the
     SHA-256 of Pillow's recorded beside it. Prints the decode rate on one
     host thread of the 500 x 375 4:2:0 q90 files (images/s and MB/s of
     pixels), beside `read_png` of the same pixels written as PNG here.
  X1. Transfer fine-tuning of 4M-21 B (fm_base_12e_12d_swiglu_qknorm_nobias)
     at full width and depth: input rgb@224 (196 tokens), target
     tok_depth@224 (196 tokens). Data: the fixtures of a class as
     rgb/<class>/*.jpg beside seeded tok_depth/<class>/*.npy and
     crop_settings/<class>/*.npy (3 crops each), read through
     data/transfer.py:build_transfer_loader (build_fm_transfer_dataset, the
     pre-training transforms, TransferMasking, RepeatedDatasetWrapper to 512
     samples, 4 spawn workers). B = 64, 6 steps of
     parallel.build_train_step: exactly 36 + 36 `attention_train` launches
     and one `fused_adamw` a step, nothing else; finite losses. samples/s by
     the median fenced step (the wait for the batch, its copy, the step, the
     loss read) against the same step on synthetic batches of the same
     shapes and masks already on the card; peak memory. Then one step at 2 +
     2 layers (full width) on 2 of the samples, card bf16 against the CPU in
     fp32 (and bf16): loss and gradient within phase 4's rule (2 x the plain
     bf16 error + 1e-3).
  X2. FourMViT-B warm-started from X1's model by params_from_fourm, a
     1000-way head, B = 64 at 224 px in bf16: exactly 12 `ln_matmul`, 12
     `flash_mha` and 12 `ln_mlp` a forward (QK-norm: no attn_block), ms per
     forward; batch-2 logits against an fp32 CPU run (phase 4's gate). A
     rank-8 LoRA (random up) fused in place after the warm forward: the next
     forward equals, bit for bit, a twin module holding the fused weights,
     and the warm (pre-fusion) logits, what a stale copy of a weight would
     give, lie beyond two bf16 ulps of them (the planted fault, caught).
     One backward through apply_lora (train path: 12 + 12 `attention_train`)
     puts .grad on the LoRA leaves and on no model parameter.

Prints, with the card's name and power limit, the phase's seconds. Imports
nothing of JAX or fourm_tpu.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import statistics
import tempfile
import time

import numpy as np

MODEL = "fm_base_12e_12d_swiglu_qknorm_nobias"
IN_MOD, OUT_MOD = "rgb@224", "tok_depth@224"
TOKENS = 196
BATCH, STEPS, SYNTH_STEPS, WORKERS, SAMPLES = 64, 6, 10, 4, 512
N_CROPS = 3
LORA_RANK = 8
PER_STEP = {"attention_train_fwd": 36, "attention_train_bwd": 36, "fused_adamw": 1}
PER_VIT_FORWARD = {"ln_matmul": 12, "flash_mha": 12, "ln_mlp": 12}
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                        "jpeg_fixtures")


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _hold(check, label: str, got: dict, want: dict) -> None:
    bad = {k: (v, want.get(k, 0)) for k, v in got.items() if v != want.get(k, 0)}
    check(not bad, f"{label}: launch counts (got, want) differ: {bad}")


def jpeg_part(check, card: str) -> None:
    """J: the fixtures' hashes and the host decode rate."""
    from fourm_torch.data import image_io
    from fourm_torch.native import decode_jpeg, native_available

    check(native_available(), "J: the native library did not build")
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        meta = json.load(f)
    blobs = {}
    for name, rec in sorted(meta["files"].items()):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            blobs[name] = f.read()
        px, mode = decode_jpeg(blobs[name], name)
        check(mode == rec["mode"] and list(px.shape) == rec["shape"]
              and hashlib.sha256(px.tobytes()).hexdigest() == rec["sha256"],
              f"J: {name} differs from Pillow {meta['pillow']}'s pixels")
    timed = [n for n in blobs if n.startswith("c0_500x375_q90_420")]
    check(len(timed) == 4, f"J: the 500 x 375 4:2:0 q90 fixtures: {timed}")
    pngs = [image_io.write_png(decode_jpeg(blobs[n])[0]) for n in timed]
    reps = 50

    def rate(fn, items):
        fn(items[0])
        t0 = time.perf_counter()
        for _ in range(reps):
            for it in items:
                fn(it)
        return reps * len(items) / (time.perf_counter() - t0)

    jpg_rate = rate(decode_jpeg, [blobs[n] for n in timed])
    png_rate = rate(image_io.read_png, pngs)
    mpix = 500 * 375 * 3 / 1e6
    print(f"transfer J: {len(blobs)} fixtures decoded equal to Pillow {meta['pillow']} "
          f"(libjpeg-turbo {meta['libjpeg']}) by SHA-256; 500 x 375 4:2:0 q90 on one host "
          f"thread: decode_jpeg {jpg_rate:.2f} images/s ({jpg_rate * mpix:.1f} MB/s of pixels, "
          f"{statistics.mean(len(blobs[n]) for n in timed) / 1e3:.1f} KB a file), read_png of "
          f"the same pixels {png_rate:.2f} images/s ({statistics.mean(map(len, pngs)) / 1e3:.1f} "
          f"KB a file); {card}", flush=True)


def write_transfer_folder(root: str, seed: int = 0) -> int:
    """The fixtures that name a class as root/rgb/<class>/<name>.jpg, with
    seeded root/tok_depth/<class>/<name>.npy (N_CROPS x 196 ids) and
    root/crop_settings/<class>/<name>.npy (N_CROPS rows of top, left, h, w,
    flip inside the image). Returns the number of images."""
    from fourm_torch.data.modality_info import MODALITY_INFO

    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        files = json.load(f)["files"]
    rng = np.random.RandomState(seed)
    vocab = MODALITY_INFO[OUT_MOD].vocab_size
    n = 0
    for name, rec in sorted(files.items()):
        if rec["class"] is None:
            continue
        stem, cls = name[:-4], rec["class"]
        for sub in ("rgb", "tok_depth", "crop_settings"):
            os.makedirs(os.path.join(root, sub, cls), exist_ok=True)
        shutil.copyfile(os.path.join(FIXTURES, name), os.path.join(root, "rgb", cls, name))
        np.save(os.path.join(root, "tok_depth", cls, stem + ".npy"),
                rng.randint(0, vocab, (N_CROPS, TOKENS)))
        h, w = rec["shape"][:2]
        crops = []
        for _ in range(N_CROPS):
            ch, cw = rng.randint(h // 2, h + 1), rng.randint(w // 2, w + 1)
            crops.append((rng.randint(0, h - ch + 1), rng.randint(0, w - cw + 1), ch, cw,
                          rng.randint(0, 2)))
        np.save(os.path.join(root, "crop_settings", cls, stem + ".npy"), np.asarray(crops))
        n += 1
    return n


def fourm(torch, device: str, dtype: str = "bfloat16", seed=0, **overrides):
    from fourm_torch.models import FourM, create_fourm_config, init_weights

    cfg = create_fourm_config(MODEL, (IN_MOD,), (OUT_MOD,), dtype=dtype, **overrides)
    with torch.device(device):
        model = FourM(cfg)
    return model if seed is None else init_weights(model, seed)


def train_part(torch, kernels, check, root: str, card: str):
    """X1: the fine-tune from the folder; returns (model, a batch on the
    card, the launches of its steps)."""
    from fourm_torch.data.transfer import build_transfer_loader
    from fourm_torch.parallel import build_train_step, init_train_state
    from fourm_torch.utils.optim import constant_schedule, create_optimizer
    from fourm_torch.utils.synthetic import to_torch

    model = fourm(torch, "cuda")
    tx = create_optimizer(model, constant_schedule(1e-4), weight_decay=0.05, betas=(0.9, 0.95))
    state = init_train_state(model, tx)
    step = build_train_step(model, tx, TOKENS, TOKENS)
    n_images = write_transfer_folder(root)
    repeats = SAMPLES // n_images
    check(repeats * n_images == SAMPLES, f"X1: {n_images} images do not divide {SAMPLES}")
    loader = build_transfer_loader(root, [IN_MOD], [OUT_MOD], BATCH, num_workers=WORKERS,
                                   seed=0, num_repeats=repeats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, counts, first = [], [], [], None
    t_start = time.perf_counter()
    it = iter(loader)
    t_first = None
    for i in range(STEPS):
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        batch = to_torch(next(it), "cuda")
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
        counts.append(_delta(kernels.launch_counts(), before))
        if first is None:
            first, t_first = batch, time.perf_counter() - t_start
    del it
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, c in enumerate(counts):
        _hold(check, f"X1 step {i}", c, PER_STEP)
    check(all(np.isfinite(losses)), f"X1: non-finite loss in {losses}")
    med = statistics.median(times[1:])
    for mod, d in first.items():
        check(tuple(d["tensor"].shape[:2]) == ((BATCH, 224) if mod == IN_MOD else (BATCH, TOKENS)),
              f"X1: {mod} batch of shape {tuple(d['tensor'].shape)}")
    check(not first[IN_MOD]["input_mask"].any() and first[OUT_MOD]["input_mask"].all()
          and not first[OUT_MOD]["target_mask"].any(), "X1: the transfer split of the masks")

    # the same step on synthetic batches of the same shapes and masks on the card
    gen = torch.Generator(device="cuda").manual_seed(1)
    synth = []
    for s in range(3):
        b = {m: {k: v.clone() for k, v in d.items()} for m, d in first.items()}
        b[IN_MOD]["tensor"].normal_(generator=gen)
        b[OUT_MOD]["tensor"].random_(0, 8192, generator=gen)
        synth.append(b)
    stimes = []
    for i in range(2 + SYNTH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, synth[i % 3])
        float(metrics["loss"])
        stimes.append(time.perf_counter() - t0)
    smed = statistics.median(stimes[2:])
    print(f"transfer X1: {MODEL} ({sum(p.numel() for p in tx.params())} fp32 parameters), "
          f"{IN_MOD} -> {OUT_MOD}, B={BATCH}, {TOKENS} + {TOKENS} tokens, {WORKERS} loader "
          f"workers over {n_images} JPEG fixtures x {repeats} ({SAMPLES} samples): from files "
          f"{BATCH / med:.4f} samples/s (median of {STEPS - 1} fenced steps after the first, "
          f"{med * 1e3:.3f} ms; first batch and step {t_first:.3f} s with the workers' start); "
          f"synthetic batches on the card {BATCH / smed:.4f} samples/s ({smed * 1e3:.3f} ms, "
          f"median of {SYNTH_STEPS} after 2); ratio {smed / med:.4f}; peak memory {peak:.3f} GiB; "
          f"losses {', '.join('%.4f' % x for x in losses)}; per-step launches "
          f"{ {k: v for k, v in counts[-1].items() if v} }; {card}", flush=True)
    total = {k: sum(c[k] for c in counts) for k in counts[0]}
    del state, tx, step, synth
    return model, first, total


def train_parity(torch, check, batch, card: str) -> None:
    """X1 at 2 + 2 layers, one build_train_step step on 2 of the samples:
    the card's loss and gradient against the CPU's in fp32 (and bf16)."""
    from fourm_torch.parallel import build_train_step, init_train_state
    from fourm_torch.utils.optim import constant_schedule, create_optimizer

    small = {m: {k: v[:2] for k, v in d.items()} for m, d in batch.items()}
    model = fourm(torch, "cuda", seed=2, encoder_depth=2, decoder_depth=2)
    start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    tx = create_optimizer(model, constant_schedule(1e-4), weight_decay=0.05, betas=(0.9, 0.95))
    state = init_train_state(model, tx)
    names = [n for n, _ in model.named_parameters()]
    state, metrics = build_train_step(model, tx, TOKENS, TOKENS)(state, small)
    card_loss = float(metrics["loss"])
    card_g = [torch.zeros(p.shape) if p.grad is None else p.grad.float().cpu()
              for p in model.parameters()]
    del state, tx, model
    ref = {}
    for dtype in ("float32", "bfloat16"):
        cm = fourm(torch, "cpu", dtype=dtype, seed=None, encoder_depth=2, decoder_depth=2)
        cm.load_state_dict(start)
        loss, _ = cm({m: {k: v.cpu() for k, v in d.items()} for m, d in small.items()},
                     TOKENS, TOKENS)
        loss.backward()
        ref[dtype] = (loss.item(), [torch.zeros(p.shape) if p.grad is None else p.grad.float()
                                    for p in cm.parameters()])
        del cm

    def grad_err(gs):
        g32 = ref["float32"][1]
        num = sum(float((g - r).square().sum()) for g, r in zip(gs, g32))
        return (num / sum(float(r.square().sum()) for r in g32)) ** 0.5

    loss32 = ref["float32"][0]
    for what, e, plain in (("loss", abs(card_loss - loss32), abs(ref["bfloat16"][0] - loss32)),
                           ("gradient, relative norm error", grad_err(card_g),
                            grad_err(ref["bfloat16"][1]))):
        tol = 2.0 * plain + 1e-3
        print(f"transfer X1 parity (2 + 2 layers, B = 2, {len(names)} leaves): {what}: card "
              f"{e:.6g} from fp32 (tol {tol:.6g}; plain bf16 {plain:.6g}); fp32 loss "
              f"{loss32:.6g}; {card}", flush=True)
        check(np.isfinite(e) and e <= tol, f"X1 parity: {what} {e} > {tol}")


def vit_models(torch, state: dict, device: str, dtype: str):
    from fourm_torch.models.fm_vit import FourMViT, vit_config_from_registry

    cfg = vit_config_from_registry(MODEL, num_classes=1000, dtype=dtype)
    with torch.device(device):
        vit = FourMViT(cfg)
    missing, unexpected = vit.load_state_dict(state, strict=False)
    return vit.to(device=device, dtype=getattr(torch, dtype)).eval(), missing, unexpected


def vit_part(torch, kernels, check, gate, time_ms, fourm_model, batch, card: str) -> dict:
    """X2: FourMViT-B from X1's encoder; returns the launches of the part."""
    from fourm_torch.models import lora as lo
    from fourm_torch.models.fm_vit import params_from_fourm

    warm = params_from_fourm({k: v.detach().float() for k, v in
                              fourm_model.state_dict().items()})
    gen = torch.Generator(device="cuda").manual_seed(4)
    warm["head.weight"] = torch.randn(1000, 768, generator=gen, device="cuda") * 0.02
    warm["head.bias"] = torch.zeros(1000, device="cuda")
    vit, missing, unexpected = vit_models(torch, warm, "cuda", "bfloat16")
    check(not missing and not unexpected, f"X2: warm start keys {missing} {unexpected}")
    x = batch[IN_MOD]["tensor"]
    kernels.reset_launch_counts()
    with torch.no_grad():
        logits = vit(x)
    torch.cuda.synchronize()
    _hold(check, "X2 forward", kernels.launch_counts(), PER_VIT_FORWARD)
    check(tuple(logits.shape) == (BATCH, 1000) and bool(torch.isfinite(logits).all()),
          f"X2: logits {tuple(logits.shape)}")
    with torch.no_grad():
        ms = time_ms(torch, lambda: vit(x), 20)
    print(f"transfer X2: FourMViT-B ({MODEL} encoder + 1000-way head, "
          f"{sum(p.numel() for p in vit.parameters())} bf16 parameters) warm-started by "
          f"params_from_fourm, B={BATCH} at 224 px: {ms:.4f} ms a forward "
          f"({BATCH / ms * 1e3:.2f} images/s); launches a forward {PER_VIT_FORWARD}; {card}",
          flush=True)

    # batch-2 logits against the CPU
    state = {k: v.float().cpu() for k, v in vit.state_dict().items()}
    x2 = x[:2]
    with torch.no_grad():
        card2 = vit(x2).float().cpu()
    refs = {}
    for dtype in ("float32", "bfloat16"):
        cm, _, _ = vit_models(torch, state, "cpu", dtype)
        with torch.no_grad():
            refs[dtype] = cm(x2.cpu()).float()
        del cm
    gate(torch, "transfer X2", card2, refs["float32"], refs["bfloat16"], "batch-2 logits")

    # LoRA fused in place after the warm forward, against a twin holding the fused weights
    lg = torch.Generator().manual_seed(5)
    lora = lo.init_lora_params(vit, rank=LORA_RANK, generator=lg)
    for v in lora.values():
        v["up"] = (torch.randn(v["up"].shape, generator=lg) * 0.05).cuda()
        v["down"] = v["down"].cuda()
    fused = lo.fused_weights(vit, lora)
    twin, _, _ = vit_models(torch, state, "cuda", "bfloat16")
    with torch.no_grad():
        for n, p in twin.named_parameters():
            if n in fused:
                p.copy_(fused[n])
        stale = vit(x2).float()  # the warm forward: the weights before fusion
        lo.fuse_lora(vit, lora)
        after = vit(x2).float()
        want = twin(x2).float()
    del twin
    peak = float(want.abs().max())
    tol = 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)  # two bf16 ulps of the largest
    err, fault = float((after - want).abs().max()), float((stale - want).abs().max())
    print(f"transfer X2 LoRA: rank {LORA_RANK} on {len(lora)} weights "
          f"({lo.lora_param_count(lora)} parameters), fused in place after the warm forward: "
          f"the next forward {err:.6g} from the twin holding the fused weights (bit for bit: "
          f"{err == 0.0}); the stale weights' logits {fault:.6g} from it (tol {tol:.6g}, "
          f"{'caught' if fault > tol else 'missed'}); {card}", flush=True)
    check(err == 0.0, f"X2 LoRA: the fused forward is {err} from the twin's")
    check(fault > tol, f"X2 LoRA: a stale weight ({fault}) would pass the tolerance {tol}")

    # one backward through apply_lora: gradients on the LoRA leaves alone
    before = kernels.launch_counts()
    for v in lora.values():
        v["down"].requires_grad_(True)
        v["up"].requires_grad_(True)
    out = lo.apply_lora(vit, lora, x2, train=True)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    _hold(check, "X2 LoRA backward", _delta(kernels.launch_counts(), before),
          {"attention_train_fwd": 12, "attention_train_bwd": 12})
    leaf_ok = all(v[k].grad is not None and bool(torch.isfinite(v[k].grad).all())
                  and float(v[k].grad.abs().max()) > 0 for v in lora.values() for k in v)
    stray = [n for n, p in vit.named_parameters() if p.grad is not None]
    print(f"transfer X2 LoRA backward: .grad on all {2 * len(lora)} LoRA leaves "
          f"({leaf_ok}), on {len(stray)} model parameters; {card}", flush=True)
    check(leaf_ok and not stray, f"X2 LoRA: gradients beyond the LoRA leaves: {stray[:5]}")
    return kernels.launch_counts()


def transfer_phase(torch, card: str, check, gate, time_ms) -> dict:
    """Phase 14; returns {path: launch counts} for the kernels line."""
    from fourm_torch import kernels

    t0 = time.perf_counter()
    jpeg_part(check, card)
    tmp = tempfile.mkdtemp(prefix="chip_transfer_")
    try:
        kernels.reset_launch_counts()
        model, batch, x1 = train_part(torch, kernels, check, tmp, card)
        train_parity(torch, check, batch, card)
        torch.cuda.empty_cache()
        x2 = vit_part(torch, kernels, check, gate, time_ms, model, batch, card)
        del model, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 14: {time.perf_counter() - t0:.3f} s; {card}", flush=True)
    return {"transfer_X1": x1, "transfer_X2": x2}
