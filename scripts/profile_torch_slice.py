#!/usr/bin/env python3
"""Where the time goes in the port on the card, under torch.profiler.

    python3 scripts/profile_torch_slice.py
        [--part all|chain|xl|train|vq|decode|sr|decode448|pretrain|tokenizer]
        [--out out/chain_trace.json]

The chain: RGB -> all 14 targets for 8 requests (8 image-token targets by
ROAR with CFG, batch 16; 6 sequence targets decoded autoregressively,
batch 8), 4M-21 B at full width, random bf16 weights -- the run of
chip_smoke.py's phase 3. `--part xl`: the same chain at 4M-21 XL
(fm_xlarge_24e_24d_swiglu_qknorm_nobias, full width and depth) for 4
requests -- chip_smoke.py's phase 3b. Two profiled windows: the whole chain, and its
sequence part alone (the 6 AR targets, conditioned on the image targets the
first window decoded). For each it prints the device time by kernel name
and by kernel group, the device busy share (summed kernel time over the
wall time of the same window run without the profiler, which slows the
host's launches; the share over the profiled wall time is printed beside
it), and the host operators with the most self CPU time.

`--part vq`: VQ paths A and A-Euclidean, chip_smoke.py's phase 6 -- one
tokenize call of the RGB tokenizer (VQ 224/16, vit_b_enc, 16384 codes,
cosine; then its Euclidean codebook) on 64 images, random bf16 weights --
each profiled once after a warm-up, with the same breakdown; the busy share
is over the median wall time of 5 calls without the profiler. `--root DIR`
profiles the fourm_torch of another checkout (a parent unpacked by `git
archive`) with this script, so that two trees compare in one call.

The train step: chip_smoke.py's phase 9 (4M-B mod-7, B = 32, 128 + 128
tokens, bf16 compute over fp32 master weights, one fused AdamW launch).
One step's work (build_train_step's, one microbatch) is profiled in three
windows fenced by synchronizations -- forward, backward, optimizer -- and
its device time is given by kernel group: attention_train forward and
backward, fused_adamw, cuBLAS GEMMs of each window, and the other ops of
each window (plain LayerNorm, cross-entropy, casts of the fp32 masters to
bf16, residual adds, the global norm), and the sum of attention_train's
two groups. The busy share is the summed kernel
time over the median wall time of 5 unfenced steps run without the
profiler.

`--part decode`: chip_smoke.py's phase 10 -- FourMSampler.decode of the
4M-B chain's output for 8 requests (rgb@224 and 14 targets; the 4M-21
tokenizers' decoders at full width, random bf16 weights, 25 diffusion
steps, 12 for the edges), then the UViT-B DiVAE decoding 8 token grids at
25 steps. Each is profiled once after a warm-up with every decoder call
and scheduler step fenced by synchronizations and named (record_function
windows: ViT decoders, UNet, UViT, scheduler); the device time is given by
kernel group: the port's kernels (attn_block, ln_mlp, attention),
convolutions (cuDNN, with its layout transposes), the scheduler, and of
each window its cuBLAS GEMMs (in the UNet: the ADM attention products and
its dense layers) and its GroupNorm and elementwise kernels. The busy
share is the summed kernel time over the median wall time of 3 unfenced
calls without the profiler.

`--part sr`: chip_smoke.py's phase 3c -- the SR-448 chain (4M-L at full
width, random bf16 weights, 4 requests from rgb@224 and tok_rgb@224, the 5
@448 targets by 8 MaskGIT steps with CFG 2.0, 8 rows). After a warm-up, one
run times every call of the block layer's kernel wrappers (ln_matmul,
flash_mha, mha_short, attention, ln_mlp, attn_block) by CUDA events around
it, so that the calls sharing attention.cu's kernel are told apart by
their wrapper; one run under the profiler gives the kernels' total and
names. The device time is given by wrapper, the rest of the kernels' time
as "other ops" (the plain LayerNorms, the cuBLAS GEMMs of the
cross-attention and of the projections, the embeddings, the logits,
sampling and ranking), and the busy share is the profiled kernel time over
the median wall time of 2 runs without the profiler. `--part decode448`: chip_smoke.py's phase 10b -- decode_dict of
4 random grids of each of tok_clip@448, tok_depth@448, tok_normal@448 and
tok_semseg@448 (their tokenizers' vocabularies) at 448, then the UViT-B
decoding 4 grids of 28 x 28 at 448, both at 25 steps, broken down as
`--part decode`.

`--part pretrain`: chip_smoke.py's phase 12 -- the 4M-21 B pre-training
step (fm_base_12e_12d_swiglu_nobias at full width and depth, B = 64, 256 +
256 tokens, layer decay 0.75) fed from that phase's tar shards by the
data pipeline with 4 spawn workers and the CLI's prefetch thread, as
cli/train_4m.py runs it. After 3 warm-up steps, 8 steps run without the
profiler (wall time a step: the wait for the batch, its copy to the card,
the step, the loss read); then 3 steps under the profiler, each in three
windows fenced by synchronizations: data (the wait for the next batch),
h2d (its copy to the card) and step. The device time is given by kernel
group as `--part train` (attention_train forward and backward, fused_adamw,
cuBLAS GEMMs, other ops); the busy share is device time a step over the
unprofiled median wall time; the host's share waiting for data is the
data window over the step's wall time. Then the loader inline for 2
batches with its host time split by stage (tar reading and decoding, the
transforms, the masking, the collation): where a worker's time goes.

`--part tokenizer`: chip_smoke.py's phase 13 -- one training step of each
tokenizer config (T1 UNet-P4 DiVAE, T2 frozen-encoder UViT-B DiVAE, T3
semseg ViT-B VQ-VAE; B = 64, synthetic batches, cli.train_vqvae's
Trainer) after 2 warm-up steps: the median wall time of 3 steps without
the profiler, the device time of one profiled step by kernel group
(attention_train forward / backward, the codebook search, fused_adamw,
cuBLAS GEMMs, cuDNN convolutions and their transposes, GroupNorm, other
ops) and the busy share.

The last line is one JSON object with the numbers. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in sys.argv[:-1]:  # before the imports below: the checkout to profile
    ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the chain's configuration and model builder)
from fourm_torch.api import FourMSampler  # noqa: E402
from fourm_torch.kernels import _build  # noqa: E402

# kernel name (substring) -> the wrapper that launches it: ln_matmul's LN
# prologue and GEMM (gemm_sm90.cuh's kernels, told apart by their template
# arguments), ln_mlp's LN prologue and its two GEMMs (the zero-padded copy of
# a ragged W2 runs as a PyTorch copy kernel, in "other"); the attention
# kernel and its QK-norm pre-pass over K; attn_block's LN rows, heads kernel and
# projection GEMM; self_decode's projection (gemv_sm90.cuh's kernel with its
# SelfDecodeQkv operation) and attention over the cache; cross_decode_attn's q
# product (gemv_sm90.cuh's kernel with its CrossQ operation) and the split-K
# attention kernel of decode_attn.cu (int8: its <signed char, ...> variants;
# listed first, as its name holds "attn_kernel"); residual_mlp's three
# products (gemv_sm90.cuh's kernel with ResidualProj, ResidualHidden,
# ResidualOut: a ragged W2 is read in place from the modules' zero-padded
# storage); the codebook search's norms prologue and its screen-and-rescore
# kernel (vq_codebook.cu)
WRAPPER_KERNELS = {"decode_attn_kernel<signed char": "decode_attention_int8",
                   "decode_attn_kernel": "decode_attention",
                   "ln_rows_kernel<0>": "ln_matmul", "BiasEpi": "ln_matmul",
                   "ln_rows_kernel<1>": "ln_mlp", "ActEpi": "ln_mlp", "ResidualEpi": "ln_mlp",
                   "attn_kernel": "flash_mha + attention",
                   "k_norm_kernel": "flash_mha + attention",
                   "ln_rows_kernel<2>": "attn_block", "attn_heads_kernel": "attn_block",
                   "AttnOutEpi": "attn_block",
                   "nearest_kernel": "nearest_code", "code_norms_kernel": "nearest_code",
                   "nearest_code": "nearest_code", "SelfDecodeQkv": "self_decode",
                   "self_decode_cache_kernel": "self_decode",
                   "CrossQ": "cross_decode_attn (q product)",
                   "ResidualProj": "residual_mlp", "ResidualHidden": "residual_mlp",
                   "ResidualOut": "residual_mlp"}
# the train step's kernels (substring) -> group; cuBLAS GEMMs by name marks.
# attention_train's forward is attention.cu's kernel (its STATS variant; the
# train forward runs no other attention), its backward attention_train.cu's
# kernel and, past 128 keys, the pass that sums the dq partials
TRAIN_KERNELS = {"attn_kernel": "attention_train forward",
                 "attn_train_bwd_kernel": "attention_train backward",
                 "dq_reduce_kernel": "attention_train backward",
                 "adamw_kernel": "fused_adamw"}
GEMM_MARKS = ("gemm", "cutlass", "nvjet", "xmma", "cublas")
# cuDNN's convolution kernels and the layout transposes around them
CONV_MARKS = ("conv", "fprop", "implicit", "winograd", "nchwtonhwc", "nhwctonchw")


def profile(run, label: str, trace: str | None, wall_plain_ms: float):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
    dev_rows, host_rows = [], []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0) or 0
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            dev_rows.append((dev_us / 1e3, evt.count, evt.key))
        elif evt.self_cpu_time_total > 0:
            host_rows.append((evt.self_cpu_time_total / 1e3, evt.count, evt.key))
    dev_rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    device_ms = sum(r[0] for r in dev_rows)
    groups = {}
    for ms, _count, key in dev_rows:
        group = next((g for k, g in WRAPPER_KERNELS.items() if k in key), "other")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"[{label}] {torch.cuda.get_device_name(0)}; device busy {device_ms:.3f} ms: "
          f"{device_ms / wall_plain_ms:.4f} of the {wall_plain_ms:.3f} ms wall time without the "
          f"profiler ({device_ms / (wall * 1e3):.4f} of {wall * 1e3:.3f} ms under it)")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {group}: {ms:.3f} ms ({ms / device_ms:.4f})")
    for ms, count, key in dev_rows[:20]:
        print(f"  device {ms:10.3f} ms {count:7d}x  {key[:100]}")
    for ms, count, key in host_rows[:15]:
        print(f"  host   {ms:10.3f} ms {count:7d}x  {key[:100]}")
    return {"wall_ms_unprofiled": wall_plain_ms, "wall_ms_profiled": wall * 1e3,
            "device_ms": device_ms, "busy_share": device_ms / wall_plain_ms,
            "busy_share_profiled": device_ms / (wall * 1e3),
            "by_group_ms": groups,
            "top_device": [{"ms": ms, "count": c, "name": k[:200]} for ms, c, k in dev_rows[:20]],
            "top_host": [{"ms": ms, "count": c, "name": k[:200]} for ms, c, k in host_rows[:15]]}


def by_window(events, prefix: str, group_of):
    """Device time of the profiled kernels by group_of(name, window), by
    window (the fenced record_function ranges named `prefix` + window that
    a kernel started in), and by kernel name ((count, ms))."""
    from torch.autograd import DeviceType

    spans = [(e.name[len(prefix):], e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith(prefix) and e.device_type == DeviceType.CPU]
    groups, windows, names = {}, {}, {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith(prefix):
            continue
        t = e.time_range.start
        window = next((w for w, a, b in spans if a <= t <= b), "outside the windows")
        ms = e.time_range.elapsed_us() / 1e3
        group = group_of(e.name, window)
        groups[group] = groups.get(group, 0.0) + ms
        windows[window] = windows.get(window, 0.0) + ms
        count, total = names.get(e.name, (0, 0.0))
        names[e.name] = (count + 1, total + ms)
    return groups, windows, names


def train_group(name: str, window: str) -> str:
    for mark, group in TRAIN_KERNELS.items():
        if mark in name:
            return group
    if any(m in name.lower() for m in GEMM_MARKS):
        return f"cuBLAS GEMM, {window}"
    return f"other ops, {window}"


def train_profile() -> dict:
    """The train step's device time by kernel group and window."""
    from torch.profiler import ProfilerActivity, record_function

    from fourm_torch.parallel import build_train_step, init_train_state
    from fourm_torch.utils.optim import constant_schedule, create_optimizer

    T = chip_smoke.TRAIN_TOKENS
    model = chip_smoke.train_model(torch, "cuda")
    tx = create_optimizer(model, constant_schedule(1e-3), weight_decay=0.05, betas=(0.9, 0.95))
    state = init_train_state(model, tx)
    step = build_train_step(model, tx, T, T)
    batch = chip_smoke.train_batch(torch, chip_smoke.TRAIN_BATCH, 0, "cuda")

    def run():
        step(state, batch)
        torch.cuda.synchronize()

    walls = []
    for i in range(8):  # 3 warm-up steps, then 5 timed
        t0 = time.perf_counter()
        run()
        if i >= 3:
            walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))

    def fenced():
        """build_train_step's work for one microbatch, each part fenced."""
        for p in tx.params():
            p.grad = None
        with record_function("train/forward"):
            loss, _ = model(batch, T, T)
            torch.cuda.synchronize()
        with record_function("train/backward"):
            loss.backward()
            torch.cuda.synchronize()
        with record_function("train/optimizer"):
            grads = [p.grad for p in tx.params() if p.grad is not None]
            tx.step(torch.nn.utils.get_total_norm(grads))
            torch.cuda.synchronize()

    fenced()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fenced()
        wall_fenced = (time.perf_counter() - t0) * 1e3
    groups, windows, names = by_window(prof.events(), "train/", train_group)
    device_ms = sum(groups.values())
    print(f"[train step] {torch.cuda.get_device_name(0)}; B={chip_smoke.TRAIN_BATCH}, {T}+{T} "
          f"tokens; device busy {device_ms:.3f} ms: {device_ms / wall_ms:.4f} of the "
          f"{wall_ms:.3f} ms median step without the profiler (steps "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms; the fenced step under the profiler "
          f"{wall_fenced:.3f} ms)")
    for w, ms in windows.items():
        print(f"  window {w}: {ms:.3f} ms ({ms / device_ms:.4f})")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {group}: {ms:.3f} ms ({ms / device_ms:.4f})")
    attn_ms = sum(ms for g, ms in groups.items() if g.startswith("attention_train"))
    print(f"  attention_train (forward + backward): {attn_ms:.3f} ms ({attn_ms / device_ms:.4f})")
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:20]
    for name, (count, ms) in top:
        print(f"  device {ms:10.3f} ms {count:7d}x  {name[:100]}")
    return {"wall_ms_unprofiled": wall_ms, "wall_ms_steps": walls,
            "wall_ms_fenced_profiled": wall_fenced, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "by_window_ms": windows, "by_group_ms": groups,
            "attention_train_ms": attn_ms,
            "top_device": [{"ms": ms, "count": c, "name": n[:200]} for n, (c, ms) in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=["all", "chain", "xl", "train", "vq", "decode", "sr",
                                       "decode448", "pretrain", "tokenizer"],
                    default="all", help="all: chain and train (the others only when asked)")
    ap.add_argument("--out", default=None, help="also write a chrome trace of the chain here")
    ap.add_argument("--root", default=ROOT, help="the checkout whose fourm_torch to profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    res = {}
    if args.part in ("all", "chain"):
        res.update(chain_profile(args.out))
    if args.part == "xl":
        res["xl"] = chain_profile(args.out, chip_smoke.XL_MODEL, chip_smoke.XL_REQUESTS)
    if args.part in ("all", "train"):
        torch.cuda.empty_cache()
        res["train_step"] = train_profile()
    if args.part == "vq":
        res["root"] = ROOT
        res["vq_a"] = vq_profile()
        res["vq_a_euclid"] = vq_profile(euclid=True)
    if args.part == "decode":
        res.update(decode_profile())
    if args.part == "sr":
        res["sr"] = sr_profile()
    if args.part == "decode448":
        res.update(decode448_profile())
    if args.part == "pretrain":
        res["pretrain"] = pretrain_profile()
    if args.part == "tokenizer":
        res["tokenizer"] = tokenizer_profile()
    print(json.dumps(res))
    return 0


def vq_profile(euclid: bool = False) -> dict:
    """One tokenize call of VQ path A (64 images), or of its Euclidean
    variant (chip_smoke.py's vq_a_euclid), under the profiler."""
    from fourm_torch.vq import VQ, init_vq_weights

    label = "VQ path A" + ("-Euclidean" if euclid else "")
    vq = init_vq_weights(VQ(**dict(chip_smoke.VQ_RGB, norm_codes=not euclid)), int(euclid))
    x = torch.from_numpy(np.random.RandomState(0).rand(chip_smoke.VQ_BATCH, 224, 224, 3)
                         .astype(np.float32)).cuda()

    def run():
        vq.tokenize(x)
        torch.cuda.synchronize()

    walls = []
    for i in range(7):  # 2 warm-up calls, then 5 timed
        t0 = time.perf_counter()
        run()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    print(f"wall without the profiler: {label} {wall_ms:.3f} ms per call of "
          f"{chip_smoke.VQ_BATCH} images (calls {', '.join(f'{w:.3f}' for w in walls)} ms)")
    return profile(run, f"{label}, 64 images", None, wall_ms)


def chain_profile(trace, name: str = chip_smoke.MODEL, requests: int = chip_smoke.REQUESTS) -> dict:
    """The chain and its sequence part, for `requests` requests to `name`."""
    model = chip_smoke.build_model(torch, "bfloat16", "cuda", name=name)
    sampler = FourMSampler(model, chip_smoke.StandInTokenizer())
    rgb = np.random.RandomState(0).rand(requests, 224, 224, 3).astype(np.float32)
    targets = chip_smoke.TARGETS
    schedule = sampler.build_schedule(["rgb@224"], targets)
    n_img = len(chip_smoke.ROAR_TARGETS)
    out = {}

    def chain():
        md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], targets,
                                    batch_size=requests)
        out.update(sampler.generate(md, schedule, seed=0))
        torch.cuda.synchronize()

    def ar_part():
        md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], targets,
                                    batch_size=requests)
        for t in chip_smoke.ROAR_TARGETS:  # the image targets as the chain left them
            md[t] = {k: v.cpu().numpy() for k, v in out[t].items()}
        sampler.generate(md, schedule[n_img:], seed=0)
        torch.cuda.synchronize()

    def wall_ms(run):
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3

    chain()  # warm-up
    chain_ms = wall_ms(chain)
    tokens = dict(sampler.sampler._ar_tokens)
    ar_ms = wall_ms(ar_part)
    res = {"model": name, "requests": requests, "tokens": tokens,
           "chain": profile(chain, f"chain, {name}", trace, chain_ms),
           "ar_part": profile(ar_part, f"sequence targets, {name}", None, ar_ms)}
    print(f"wall without the profiler: chain {chain_ms:.3f} ms, sequence targets "
          f"{ar_ms:.3f} ms; decoded tokens {json.dumps(tokens)}")
    return res


def decode_group(name: str, window: str) -> str:
    for mark, group in WRAPPER_KERNELS.items():
        if mark in name:
            return group
    low = name.lower()
    if any(m in low for m in CONV_MARKS):
        return "convolutions"
    if window == "scheduler":
        return "scheduler"
    if any(m in low for m in GEMM_MARKS):
        return f"cuBLAS GEMM, {window}"
    return f"GroupNorm and elementwise, {window}"


def fenced_profile(run, label: str, wall_ms: float) -> dict:
    """run() under the profiler with the decoders' calls and the scheduler's
    steps fenced and named; device time by decode_group and by window."""
    from torch.profiler import ProfilerActivity, record_function

    from fourm_torch.vq import scheduling
    from fourm_torch.vq.vqvae import VQVAE, DiVAE

    def fenced(window, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            with record_function(f"decode/{window}"):
                res = fn(*a, **kw)
                torch.cuda.synchronize()
            return res
        return call

    def window_of(model):
        return "UViT" if "uvit" in type(model.decoder).__name__.lower() else "UNet"

    patches = [(scheduling.DiffusionScheduler, "step", lambda f: fenced("scheduler", f)),
               (VQVAE, "decode_tokens", lambda f: fenced("ViT decoders", f)),
               (DiVAE, "denoise_step",
                lambda f: lambda self, *a, **kw: fenced(window_of(self), f)(self, *a, **kw))]
    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in patches]
    for cls, name, wrap in patches:
        setattr(cls, name, wrap(getattr(cls, name)))
    try:
        run()  # warm-up of the fenced form
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_fenced = (time.perf_counter() - t0) * 1e3
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)
    groups, windows, names = by_window(prof.events(), "decode/", decode_group)
    device_ms = sum(groups.values())
    print(f"[{label}] {torch.cuda.get_device_name(0)}; device busy {device_ms:.3f} ms: "
          f"{device_ms / wall_ms:.4f} of the {wall_ms:.3f} ms median call without the profiler "
          f"(the fenced call under the profiler {wall_fenced:.3f} ms)")
    for w, ms in sorted(windows.items(), key=lambda kv: -kv[1]):
        print(f"  window {w}: {ms:.3f} ms ({ms / device_ms:.4f})")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {group}: {ms:.3f} ms ({ms / device_ms:.4f})")
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:20]
    for name, (count, ms) in top:
        print(f"  device {ms:10.3f} ms {count:7d}x  {name[:100]}")
    return {"wall_ms_unprofiled": wall_ms, "wall_ms_fenced_profiled": wall_fenced,
            "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "by_window_ms": windows, "by_group_ms": groups,
            "top_device": [{"ms": ms, "count": c, "name": n[:200]} for n, (c, ms) in top]}


def decode_profile() -> dict:
    """Phase 10's decode of the 4M-B chain's output and its UViT-B decode."""
    from fourm_torch.vq import DiVAE, divae_decode_tokens, init_vq_weights

    model = chip_smoke.build_model(torch, "bfloat16", "cuda")
    requests, targets = chip_smoke.REQUESTS, chip_smoke.TARGETS
    bundles = chip_smoke.build_tokenizers(torch)
    sampler = FourMSampler(model, chip_smoke.StandInTokenizer(), tokenizers=bundles)
    rgb = np.random.RandomState(0).rand(requests, 224, 224, 3).astype(np.float32)
    md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], targets, batch_size=requests)
    out = sampler.generate(md, sampler.build_schedule(["rgb@224"], targets), seed=0)

    def decode():
        sampler.decode(out, decoding_steps=chip_smoke.DECODE_STEPS, seed=0)
        torch.cuda.synchronize()

    divae = init_vq_weights(DiVAE(**chip_smoke.DIVAE_UVITB, device="cuda"), 110, spread=0.1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 1024, (requests, 14, 14), generator=gen, device="cuda")

    def uvit():
        with torch.inference_mode():
            divae_decode_tokens(divae, tokens, gen, timesteps=chip_smoke.DECODE_STEPS)
        torch.cuda.synchronize()

    res = {}
    for label, run in ((f"decode, {requests} requests x {len(targets)} targets", decode),
                       (f"UViT-B decode, {requests} grids", uvit)):
        walls = []
        for i in range(4):  # a warm-up call, then 3 timed
            t0 = time.perf_counter()
            run()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = float(np.median(walls))
        print(f"wall without the profiler: {label} {wall_ms:.3f} ms per call (calls "
              f"{', '.join(f'{w:.3f}' for w in walls)} ms)")
        res["decode" if run is decode else "uvit_decode"] = fenced_profile(run, label, wall_ms)
    return res


# the block layer's kernel wrappers (fourm_torch/ops/transformer.py's names)
SR_WRAPPERS = ("ln_matmul", "flash_mha", "mha_short", "attention", "ln_mlp", "attn_block")


def sr_profile() -> dict:
    """Phase 3c's SR-448 chain: its device time by the wrapper that
    launched it, from CUDA events around each wrapper call; the kernels'
    total and names under the profiler."""
    from torch.profiler import ProfilerActivity

    from fourm_torch.ops import transformer

    cs = chip_smoke
    model = cs.build_model(torch, "bfloat16", "cuda", name=cs.SR_MODEL, mods=cs.SR_MODS)
    sampler = FourMSampler(model, cs.StandInTokenizer())
    rng = np.random.RandomState(0)
    sample = {"rgb@224": rng.rand(cs.SR_REQUESTS, 224, 224, 3).astype(np.float32),
              "tok_rgb@224": rng.randint(0, 16384, (cs.SR_REQUESTS, 196)).astype(np.int32)}
    schedule = sampler.build_schedule(cs.SR_CONDS, cs.SR_TARGETS)

    def run():
        md = sampler.prepare_sample(sample, cs.SR_CONDS, cs.SR_TARGETS,
                                    batch_size=cs.SR_REQUESTS)
        sampler.generate(md, schedule, seed=0)
        torch.cuda.synchronize()

    walls = []
    for i in range(3):  # a warm-up run, then 2 timed
        t0 = time.perf_counter()
        run()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))

    spans = {w: [] for w in SR_WRAPPERS}

    def timed(name, fn):
        def call(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn(*a, **kw)
            end.record()
            spans[name].append((start, end))
            return res
        return call

    saved = {w: getattr(transformer, w) for w in SR_WRAPPERS}
    for w, fn in saved.items():
        setattr(transformer, w, timed(w, fn))
    try:
        run()
    finally:
        for w, fn in saved.items():
            setattr(transformer, w, fn)
    groups = {w: sum(s.elapsed_time(e) for s, e in ev) for w, ev in spans.items() if ev}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    dev_rows = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and getattr(e, "self_device_time_total", 0) > 0), reverse=True)
    device_ms = sum(r[0] for r in dev_rows)
    groups["other ops"] = device_ms - sum(groups.values())
    print(f"[SR-448 chain, {cs.SR_MODEL}, {cs.SR_REQUESTS} requests] "
          f"{torch.cuda.get_device_name(0)}; device busy {device_ms:.3f} ms: "
          f"{device_ms / wall_ms:.4f} of the {wall_ms:.3f} ms median run without the profiler "
          f"(runs {', '.join(f'{w:.3f}' for w in walls)} ms); by wrapper (CUDA events around "
          f"each call; other ops: the rest of the kernels' time)")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {group}: {ms:.3f} ms ({ms / device_ms:.4f})"
              + (f", {len(spans[group])} calls" if group in spans else ""))
    for ms, count, key in dev_rows[:20]:
        print(f"  device {ms:10.3f} ms {count:7d}x  {key[:100]}")
    return {"wall_ms_unprofiled": wall_ms, "wall_ms_runs": walls, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "by_group_ms": groups,
            "calls": {w: len(ev) for w, ev in spans.items()},
            "top_device": [{"ms": ms, "count": c, "name": k[:200]} for ms, c, k in dev_rows[:20]]}


def decode448_profile() -> dict:
    """Phase 10b's decoding at 448 (random grids of each target's
    vocabulary) and its UViT-B decode at 448."""
    from fourm_torch.data.modality_info import MODALITY_INFO
    from fourm_torch.utils.decoding import decode_dict
    from fourm_torch.vq import DiVAE, divae_decode_tokens, init_vq_weights

    cs = chip_smoke
    B, grid = cs.SR_REQUESTS, cs.SR_GRID
    bundles = cs.build_tokenizers(torch)
    toks = {k: bundles[k] for k in ("tok_clip", "tok_semseg", "tok_depth", "tok_normal")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {t: {"tensor": torch.randint(0, MODALITY_INFO[t].vocab_size, (B, grid), generator=gen,
                                       device="cuda")} for t in cs.DECODE448_TARGETS}
    divae = init_vq_weights(DiVAE(**cs.DIVAE_UVITB, device="cuda"), 110, spread=0.1)
    grids = torch.randint(0, 1024, (B, 28, 28), generator=gen, device="cuda")

    def decode():
        decode_dict(out, toks, cs.StandInTokenizer(), decoding_steps=cs.DECODE_STEPS, seed=0)
        torch.cuda.synchronize()

    def uvit():
        with torch.inference_mode():
            divae_decode_tokens(divae, grids, gen, timesteps=cs.DECODE_STEPS, image_size=448)
        torch.cuda.synchronize()

    res = {}
    for key, label, run in (("decode448", f"decode at 448, {B} requests x "
                                          f"{len(cs.DECODE448_TARGETS)} targets", decode),
                            ("uvit_decode448", f"UViT-B decode at 448, {B} grids", uvit)):
        walls = []
        for i in range(4):  # a warm-up call, then 3 timed
            t0 = time.perf_counter()
            run()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = float(np.median(walls))
        print(f"wall without the profiler: {label} {wall_ms:.3f} ms per call (calls "
              f"{', '.join(f'{w:.3f}' for w in walls)} ms)")
        res[key] = fenced_profile(run, label, wall_ms)
    return res


def loader_stages(files: dict, batches: int = 2) -> dict:
    """Host seconds of one inline loader's stages over `batches` batches:
    each stage's function timed where the pipeline calls it."""
    from fourm_torch.data import datasets, masking, transforms
    from fourm_torch.data.pretrain_utils import build_parallel_train_loader
    from fourm_torch.utils.config import load_yaml

    spent = {}

    def timed(owner, attr, stage):
        fn = getattr(owner, attr)

        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[stage] = spent.get(stage, 0.0) + time.perf_counter() - t0
        setattr(owner, attr, wrapper)
        return fn

    patches = [(datasets, "decode_sample", "tar read + decode"),
               (transforms.UnifiedDataTransform, "__call__", "transforms"),
               (masking.UnifiedMasking, "__call__", "masking"),
               (datasets, "batch_mod_dicts", "collation")]
    saved = [(owner, attr, timed(owner, attr, stage)) for owner, attr, stage in patches]
    try:
        ds = load_yaml(files["data"])["train"]["datasets"]
        it = build_parallel_train_loader(
            ds, files["domains"], chip_smoke.PRETRAIN_BATCH, 224, chip_smoke.PRETRAIN_TOKENS,
            chip_smoke.PRETRAIN_TOKENS, text_tokenizer_path=files["tokenizer"], seed=0)
        next(it)
        spent.clear()
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        total = time.perf_counter() - t0
        it.close()
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    # the tar reading sits inside the shuffle buffer's iteration: what the
    # stages leave of the total is the reading, the buffer and the mixture
    stages = dict(spent)
    stages["tar read, buffers, mixture (the rest)"] = total - sum(spent.values())
    return {"seconds_per_batch": total / batches,
            "share": {k: v / total for k, v in stages.items()}}


def pretrain_profile() -> dict:
    """Phase 12's step fed by the data pipeline: busy share, device time by
    group, the host's wait for data, the loader's stages."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, record_function

    from fourm_torch.data.datasets import prefetch_iterator
    from fourm_torch.data.pretrain_utils import build_parallel_train_loader
    from fourm_torch.models import FourM, init_weights
    from fourm_torch.parallel import build_train_step, init_train_state
    from fourm_torch.utils.config import load_yaml
    from fourm_torch.utils.optim import constant_schedule, create_optimizer
    from fourm_torch.utils.synthetic import to_torch

    card = torch.cuda.get_device_name(0)
    tmp = tempfile.mkdtemp(prefix="fourm_pretrain_profile_")
    try:
        files = chip_smoke.write_pretrain_data(tmp, card)
        T, B = chip_smoke.PRETRAIN_TOKENS, chip_smoke.PRETRAIN_BATCH
        cfg, _, _ = chip_smoke.pretrain_config()
        model = init_weights(FourM(cfg), 0)
        tx = create_optimizer(model, constant_schedule(2.5e-5), layer_decay=0.75, clip_grad=1.0)
        state = init_train_state(model, tx)
        step = build_train_step(model, tx, T, T)
        gen = torch.Generator(device="cuda").manual_seed(1)
        ds = load_yaml(files["data"])["train"]["datasets"]
        loader = prefetch_iterator(build_parallel_train_loader(
            ds, files["domains"], B, 224, T, T, text_tokenizer_path=files["tokenizer"], seed=0,
            num_workers=chip_smoke.PRETRAIN_WORKERS), prefetch=4)

        def one(fence: bool):
            with record_function("pretrain/data"):
                batch = next(loader)
            with record_function("pretrain/h2d"):
                batch = to_torch(batch, "cuda")
                if fence:
                    torch.cuda.synchronize()
            with record_function("pretrain/step"):
                _, metrics = step(state, batch, gen)
                float(metrics["loss"])

        walls = []
        for i in range(11):  # 3 warm-up steps, then 8 timed
            t0 = time.perf_counter()
            one(False)
            if i >= 3:
                walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = float(np.median(walls))
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                one(True)
            wall_profiled = (time.perf_counter() - t0) * 1e3 / 3
        loader.close()
        from torch.autograd import DeviceType

        host = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name.startswith("pretrain/"):
                w = e.name[len("pretrain/"):]
                host[w] = host.get(w, 0.0) + e.time_range.elapsed_us() / 1e3 / 3
        groups, windows, names = by_window(prof.events(), "pretrain/", train_group)
        groups = {g: ms / 3 for g, ms in groups.items()}
        device_ms = sum(groups.values())
        del state, model, tx, step
        stages = loader_stages(files)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[pretrain step] {card}; B={B}, {T}+{T} tokens, 4M-21 B, fed from shards by "
          f"{chip_smoke.PRETRAIN_WORKERS} workers; device busy {device_ms:.3f} ms a step: "
          f"{device_ms / wall_ms:.4f} of the {wall_ms:.3f} ms median step without the profiler "
          f"(steps {', '.join(f'{w:.3f}' for w in walls)} ms; {wall_profiled:.3f} ms a fenced "
          f"step under the profiler)")
    for w, ms in host.items():
        print(f"  host window {w}: {ms:.3f} ms a step ({ms / wall_profiled:.4f} of the fenced "
              f"step)")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {group}: {ms:.3f} ms ({ms / device_ms:.4f})")
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (count, ms) in top:
        print(f"  device {ms / 3:10.3f} ms {count // 3:7d}x  {name[:100]}")
    print(f"  loader inline: {stages['seconds_per_batch']:.3f} s a batch; " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(stages["share"].items(), key=lambda kv: -kv[1])))
    return {"wall_ms_unprofiled": wall_ms, "wall_ms_steps": walls,
            "wall_ms_fenced_profiled": wall_profiled, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "host_window_ms": host,
            "by_group_ms": groups, "loader_inline": stages,
            "top_device": [{"ms": ms / 3, "count": c // 3, "name": n[:200]}
                           for n, (c, ms) in top]}




TOKENIZER_KERNELS = {"attn_kernel": "attention_train forward",
                     "attn_train_bwd_kernel": "attention_train backward",
                     "dq_reduce_kernel": "attention_train backward",
                     "nearest_kernel": "codebook search", "code_norms_kernel": "codebook search",
                     "adamw_kernel": "fused_adamw"}
GROUP_NORM_MARKS = ("groupnorm", "group_norm", "rowwisemoments", "computefusedparams",
                    "computegroupnorm", "computeinternalgradients")


def tokenizer_group(name: str, _window: str) -> str:
    for mark, group in TOKENIZER_KERNELS.items():
        if mark in name:
            return group
    low = name.lower()
    if any(m in low for m in GROUP_NORM_MARKS):
        return "GroupNorm"
    if any(m in low for m in CONV_MARKS) or "cudnn" in low:
        return "cuDNN convolutions and transposes"
    if any(m in low for m in GEMM_MARKS):
        return "cuBLAS GEMM"
    return "other ops"


def tokenizer_profile() -> dict:
    """One train step of each phase-13 config by kernel group."""
    from torch.profiler import ProfilerActivity

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_tokenizer as ct
    from fourm_torch.cli import train_vqvae as tcli

    out = {}
    for name in ("T1", "T2", "T3"):
        torch.cuda.empty_cache()
        args = ct.parse_args(tcli, ct.cli_args(name, "unused", "--synthetic_data"))
        trainer = tcli.Trainer(args, torch.device("cuda"))
        source = tcli.SyntheticBatches(args)
        batch = torch.from_numpy(source.batch(0)).cuda()

        def run():
            trainer.train_step(batch)
            torch.cuda.synchronize()

        walls = []
        for i in range(5):  # 2 warm-up steps, then 3 timed
            t0 = time.perf_counter()
            run()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = float(np.median(walls))
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            run()
        groups, _windows, names = by_window(prof.events(), "tok/", tokenizer_group)
        device_ms = sum(groups.values())
        print(f"[tokenizer {name}] {torch.cuda.get_device_name(0)}; B={args.batch_size}; "
              f"device busy {device_ms:.3f} ms: {device_ms / wall_ms:.4f} of the "
              f"{wall_ms:.3f} ms median step without the profiler (steps "
              f"{', '.join(f'{w:.3f}' for w in walls)} ms)")
        for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  group {group}: {ms:.3f} ms ({ms / device_ms:.4f})")
        top = sorted(names.items(), key=lambda kv: -kv[1][1])[:15]
        for kname, (count, ms) in top:
            print(f"  device {ms:10.3f} ms {count:7d}x  {kname[:100]}")
        out[name] = {"wall_ms_unprofiled": wall_ms, "wall_ms_steps": walls,
                     "device_ms": device_ms, "busy_share": device_ms / wall_ms,
                     "by_group_ms": groups,
                     "top_device": [{"ms": ms, "count": c, "name": n[:200]}
                                    for n, (c, ms) in top]}
        del trainer, batch
    return out

if __name__ == "__main__":
    sys.exit(main())
