#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourm_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; imports
nothing of JAX or fourm_tpu. Phases, each printing its lines:
  1. the card (nvidia-smi name and power limit) and the kernel build, from
     fourm_torch/kernels/csrc, timed;
  2. every kernel of the slice against its plain PyTorch twin on the card, in
     bf16 at the slice's shapes: max abs error against the stated tolerance,
     kernel ms, twin ms, a PyTorch library yardstick (never used by the port)
     and the least time the card could take (bound);
  3. the slice at full 4M-21 B width (fm_base_12e_12d_swiglu_qknorm_nobias on
     the 4M-21 modality sets, random bf16 weights from a seeded generator):
     FourMSampler decodes RGB -> 8 image-token targets (DEFAULTS_RGB2X:
     ROAR, one step, CFG 2.0) for 8 requests; the launch counters are reset
     just before and read just after;
  4. one forward_generation_img of that model at batch 2 on the card
     (kernels, bf16) against the same weights on the CPU in fp32 (plain
     twins) and in bf16.
The second-to-last line is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Any failed check raises: the exit code is then
not 0 and no result line is printed. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
MODEL = "fm_base_12e_12d_swiglu_qknorm_nobias"
# the 4M-21 modality sets (reference cfgs/default/4m/models/main/4m-b_mod21_*.yaml)
MOD21 = ("rgb@224", "tok_rgb@224", "tok_depth@224", "tok_normal@224", "tok_semseg@224",
         "tok_clip@224", "caption", "det", "t5_caption", "metadata", "human_poses",
         "color_palette", "sam_instance", "tok_canny_edge@224", "tok_sam_edge@224",
         "tok_dinov2@224", "tok_imagebind@224", "tok_dinov2_global", "tok_imagebind_global")
MOD21_DEC = tuple(m for m in MOD21 if m not in ("rgb@224", "t5_caption"))
TARGETS = ["tok_clip@224", "tok_dinov2@224", "tok_imagebind@224", "tok_depth@224",
           "tok_normal@224", "tok_semseg@224", "tok_canny_edge@224", "tok_sam_edge@224"]
REQUESTS = 8
# launches of each wrapper in one forward_generation_img of a 12+12 model
PER_STEP = {"ln_matmul": 24, "ln_mlp": 24, "flash_mha": 24, "attention": 12}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn over `iters` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(torch):
    """Phase 2: each kernel against its twin at the slice's shapes."""
    import torch.nn.functional as F

    from fourm_torch.kernels import attention as at
    from fourm_torch.kernels import fused_mlp as fm

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    neg = torch.finfo(torch.float32).min

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(bf)

    def key_bias(B, M, frac=0.3, full_rows=0):
        bias = torch.where(torch.rand(B, M, generator=gen, device=dev) < frac, neg, 0.0)
        bias[:full_rows] = neg
        return bias

    rows, D, H, Dh = 16 * 2048, 768, 12, 64
    x = rn(rows, D)
    gamma = torch.rand(D, generator=gen, device=dev) + 0.5
    w_qkv = rn(3 * D, D, std=D ** -0.5)
    w1, w3 = rn(2048, D, std=D ** -0.5), rn(2048, D, std=D ** -0.5)
    w2 = rn(D, 2048, std=2048 ** -0.5)
    g64 = [torch.rand(64, generator=gen, device=dev) + 0.5,
           torch.randn(64, generator=gen, device=dev) * 0.1] * 2

    def ln(t):
        return F.layer_norm(t, (D,), gamma.to(bf), None, 1e-6)

    def mlp_library(h):
        return x + F.linear(F.silu(F.linear(h, w1)) * F.linear(h, w3), w2)

    def flash_case(B, N):
        qkv = rn(B, N, 3 * D)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        bias = key_bias(B, N, full_rows=1)
        args = (q, k, v, H, bias, *g64)
        qn = F.layer_norm(q.reshape(B, N, H, Dh).float(), (Dh,), g64[0], g64[1], 1e-6)
        kn = F.layer_norm(k.reshape(B, N, H, Dh).float(), (Dh,), g64[2], g64[3], 1e-6)
        qn, kn = qn.to(bf).transpose(1, 2), kn.to(bf).transpose(1, 2)
        vh, mask = v.reshape(B, N, H, Dh).transpose(1, 2), bias[:, None, None, :].to(bf)
        return dict(
            run=lambda: at.flash_mha(*args), plain=lambda: at.flash_mha_plain(*args),
            library=lambda: F.scaled_dot_product_attention(qn, kn, vh, attn_mask=mask),
            flops=4 * B * H * N * N * Dh, bytes=4 * B * N * D * 2 + B * N * 4,
            shape=f"q,k,v (B={B}, N=M={N}, C=768) slices of QKV, 12 heads, QK-norm, key bias")

    def attn_case(B, N, M, full_rows=0):
        q, k, v = rn(B, H, N, Dh), rn(B, H, M, Dh), rn(B, H, M, Dh)
        bias = key_bias(B, M, full_rows=full_rows)[:, None, None, :]
        return dict(
            run=lambda: at.attention(q, k, v, bias),
            plain=lambda: at.attention_plain(q, k, v, bias),
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(bf)),
            flops=4 * B * H * N * M * Dh,
            bytes=(2 * B * H * N * Dh + 2 * B * H * M * Dh) * 2 + B * M * 4,
            shape=f"q (B={B}, 12, N={N}, 64), k/v M={M}, (B, 1, 1, M) bias"
                  + (f", {full_rows} batch rows fully masked" if full_rows else ""))

    fa = "fourm_torch/kernels/csrc/attention.cu"
    cases = [
        ("ln_matmul", "fourm_tpu/kernels/fused_mlp.py:181", "fourm_torch/kernels/csrc/ln_matmul.cu",
         dict(run=lambda: fm.ln_matmul(x, gamma, None, w_qkv),
              plain=lambda: fm.ln_matmul_plain(x, gamma, None, w_qkv),
              library=lambda: torch.matmul(ln(x), w_qkv.t()),
              flops=2 * rows * D * 3 * D, bytes=(rows * D + 3 * D * D + rows * 3 * D) * 2 + D * 4,
              shape="x (16*2048, 768) -> (16*2048, 2304), no biases")),
        ("ln_mlp", "fourm_tpu/kernels/fused_mlp.py:244", "fourm_torch/kernels/csrc/ln_mlp.cu",
         dict(run=lambda: fm.ln_mlp(x, gamma, None, w1, None, w2, None, w3, None, gated=True),
              plain=lambda: fm.ln_mlp_plain(x, gamma, None, w1, None, w2, None, w3, None,
                                            gated=True),
              library=lambda: mlp_library(ln(x)),
              flops=3 * 2 * rows * D * 2048, bytes=(2 * rows * D + 3 * D * 2048) * 2 + D * 4,
              shape="SwiGLU, x (16*2048, 768), hidden 2048, no biases")),
        ("flash_mha", "fourm_tpu/kernels/attention.py:587", fa, flash_case(16, 2048)),
        ("flash_mha@N196", "fourm_tpu/kernels/attention.py:587", fa, flash_case(16, 196)),
        ("attention", "fourm_tpu/kernels/attention.py:325", fa, attn_case(16, 256, 2048)),
        ("attention@masked_rows", "fourm_tpu/kernels/attention.py:325", fa,
         attn_case(16, 196, 512, full_rows=8)),
        ("attention@SR448", "fourm_tpu/kernels/attention.py:127", fa, attn_case(16, 784, 1536)),
    ]
    def held(name, run, plain):
        out = run()
        ref = plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # two bf16 ulps of the largest output: kernel and twin round the same
        # fp32 sums to bf16, summed in different orders
        tol = 2.0 ** -6 * ref.float().abs().max().item()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(err <= tol, f"{name}: max abs error {err} > tolerance {tol}")
        return err, tol

    results = []
    for name, replaces, source, c in cases:
        err, tol = held(name, c["run"], c["plain"])
        ms = time_ms(torch, c["run"], 10)
        plain_ms = time_ms(torch, c["plain"], 3)
        library_ms = time_ms(torch, c["library"], 10)
        bound_ms = max(c["flops"] / PEAK_BF16_FLOPS, c["bytes"] / PEAK_BYTES) * 1e3
        bound_by = "operations" if c["flops"] / PEAK_BF16_FLOPS >= c["bytes"] / PEAK_BYTES \
            else "bytes"
        print(f"kernel {name}: {c['shape']}: max_abs_err {err:.6g} (tol {tol:.6g}), "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        results.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "wrapper": name.split("@")[0], "max_abs_err": err, "tolerance": tol,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms, "shape": c["shape"]})

    # options the main path does not take (biases, GELU, no QK-norm, softmax1,
    # a per-head query-dependent bias, ragged row counts): correctness only
    xr = x[:1000]
    beta, b_qkv = torch.randn(D, generator=gen, device=dev), torch.randn(3 * D, generator=gen,
                                                                          device=dev)
    wg1, wg2 = rn(3072, D, std=D ** -0.5), rn(D, 3072, std=3072 ** -0.5)
    bg1, bg2 = torch.randn(3072, generator=gen, device=dev), torch.randn(D, generator=gen,
                                                                         device=dev)
    qkv = rn(3, 300, 3 * D)
    mha = (qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], H, key_bias(3, 300, full_rows=1))
    q, k, v = rn(2, H, 100, Dh), rn(2, H, 333, Dh), rn(2, H, 333, Dh)
    full = torch.randn(2, H, 100, 333, generator=gen, device=dev)
    tiny = (rn(2, 5, 3 * D)[..., :D], rn(2, 7, 3 * D)[..., D:2 * D], rn(2, 7, 3 * D)[..., 2 * D:],
            H, key_bias(2, 7), *g64)
    variants = [
        ("ln_matmul, LN bias + bias, 1000 rows",
         lambda: fm.ln_matmul(xr, gamma, beta, w_qkv, b_qkv),
         lambda: fm.ln_matmul_plain(xr, gamma, beta, w_qkv, b_qkv)),
        ("ln_mlp, exact GELU + biases, hidden 3072, 1000 rows",
         lambda: fm.ln_mlp(xr, gamma, beta, wg1, bg1, wg2, bg2),
         lambda: fm.ln_mlp_plain(xr, gamma, beta, wg1, bg1, wg2, bg2)),
        ("flash_mha, no QK-norm, softmax1, N=M=300",
         lambda: at.flash_mha(*mha, allow_zero_attn=True),
         lambda: at.flash_mha_plain(*mha, allow_zero_attn=True)),
        ("attention, (B, H, N, M) bias, softmax1, N=100, M=333",
         lambda: at.attention(q, k, v, full, True),
         lambda: at.attention_plain(q, k, v, full, True)),
        ("flash_mha, QK-norm, N=5, M=7", lambda: at.flash_mha(*tiny),
         lambda: at.flash_mha_plain(*tiny)),
        ("ln_matmul, 3 rows", lambda: fm.ln_matmul(x[:3], gamma, None, w_qkv),
         lambda: fm.ln_matmul_plain(x[:3], gamma, None, w_qkv)),
    ]
    for name, run, plain in variants:
        err, tol = held(name, run, plain)
        print(f"variant {name}: max_abs_err {err:.6g} (tol {tol:.6g})", flush=True)
    return results


def build_model(torch, dtype: str, device: str, seed: int = 0):
    from fourm_torch.models import FourM, create_fourm_config, init_weights

    cfg = create_fourm_config(MODEL, MOD21, MOD21_DEC, dtype=dtype)
    with torch.device(device):
        model = FourM(cfg)
    model = model.to(device=device, dtype=cfg.compute_dtype)
    return init_weights(model, seed).eval()


def slice_phase(torch, model, card: str):
    """Phase 3: 8 requests, RGB -> 8 image-token targets, at full width."""
    from fourm_torch import kernels
    from fourm_torch.api import FourMSampler
    from fourm_torch.data.modality_info import MODALITY_INFO

    sampler = FourMSampler(model)  # the card, by default
    rgb = np.random.RandomState(0).rand(REQUESTS, 224, 224, 3).astype(np.float32)
    schedule = sampler.build_schedule(["rgb@224"], TARGETS)
    check(len(schedule) == len(TARGETS) and all(
        s["scheme"] == "roar" and s["cfg_scale"] == 2.0 and s["temperature"] == 0.01
        for s in schedule), "schedule is not DEFAULTS_RGB2X's one-step ROAR with CFG 2.0")

    def run():
        md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], TARGETS,
                                    batch_size=REQUESTS)
        out = sampler.generate(md, schedule, seed=0)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: cuBLAS handles, allocator
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()

    for t in TARGETS:
        d = out[t]
        check(bool(d["target_mask"].all()) and not bool(d["input_mask"].any()),
              f"{t}: not fully decoded")
        tok = d["tensor"]
        check(tok.shape == (REQUESTS, MODALITY_INFO[t].resolved_max_tokens()), f"{t}: shape")
        check(int(tok.min()) >= 0 and int(tok.max()) < MODALITY_INFO[t].vocab_size,
              f"{t}: token outside [0, vocab)")
    expected = {k: v * len(TARGETS) for k, v in PER_STEP.items()}
    check(launches == expected, f"launch counts {launches} != {expected}")
    print(f"slice: {REQUESTS} requests x {len(TARGETS)} targets (batch {2 * REQUESTS} with "
          f"CFG): {seconds:.4f} s, {seconds / len(TARGETS):.4f} s/target, "
          f"{REQUESTS / seconds:.4f} samples/s; launches {json.dumps(launches)}; {card}",
          flush=True)
    return out, launches, seconds


def parity_phase(torch, model, out):
    """Phase 4: one forward_generation_img at batch 2, card bf16 kernels against
    the CPU plain twins in fp32 (and in bf16, to size bf16's own error)."""
    from fourm_torch.api import FourMSampler

    target = "tok_clip@224"
    md = {m: {k: v[:2] for k, v in d.items()} for m, d in out.items()}
    md[target] = dict(md[target], input_mask=torch.ones_like(md[target]["input_mask"]),
                      target_mask=torch.zeros_like(md[target]["target_mask"]))
    sampler = FourMSampler(model)
    budget = sampler.sampler._encoder_budget(sampler.sampler._init_valid_counts(md), md)
    sa = torch.ones(2, 196, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        gpu = model.forward_generation_img(md, target, sa, budget).float().cpu()
    state = {k: v.float().cpu() for k, v in model.state_dict().items()}
    md_cpu = {m: {k: v.cpu() for k, v in d.items()} for m, d in md.items()}
    logits = {}
    for dtype in ("float32", "bfloat16"):
        cpu_model = build_model(torch, dtype, "cpu")
        cpu_model.load_state_dict(state)
        with torch.inference_mode():
            logits[dtype] = cpu_model.forward_generation_img(
                md_cpu, target, sa.cpu(), budget).float()
        del cpu_model
    ref, ref_bf16 = logits["float32"], logits["bfloat16"]
    err = (gpu - ref).abs().max().item()
    err_plain = (ref_bf16 - ref).abs().max().item()
    # bf16 carries 8 significant bits through 24 blocks: the card's bf16 path
    # may be as far from fp32 as the plain bf16 path is, not much further
    tol = 2.0 * err_plain + 1e-3
    agree = (gpu.argmax(-1) == ref.argmax(-1)).float().mean().item()
    agree_plain = (ref_bf16.argmax(-1) == ref.argmax(-1)).float().mean().item()
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol  # a bf16 error cannot flip these
    agree_decided = (gpu.argmax(-1) == ref.argmax(-1))[decided].float().mean().item()
    print(f"parity: forward_generation_img B=2 {target}, encoder budget {budget}: logits "
          f"max abs err {err:.6g} vs fp32 (tol {tol:.6g}; plain bf16 {err_plain:.6g}; "
          f"logit std {ref.std().item():.6g}); argmax agreement {agree:.6f} (plain bf16 "
          f"{agree_plain:.6f}), {agree_decided:.6f} on the {decided.float().mean().item():.4f}"
          f" of positions whose fp32 top-2 margin exceeds 2*tol", flush=True)
    check(bool(torch.isfinite(gpu).all()), "parity: non-finite logits")
    check(err <= tol, f"parity: logits error {err} > {tol}")
    check(agree_decided >= 0.99, f"parity: argmax agreement {agree_decided} < 0.99")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from fourm_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(f"build: {_build.build_all():.2f} s for {len(_build.SOURCES)} sources "
          f"({', '.join(_build.SOURCES)})", flush=True)

    results = kernel_phase(torch)
    model = build_model(torch, "bfloat16", "cuda")
    out, launches, _ = slice_phase(torch, model, card)
    for r in results:
        r["launches"] = launches[r.pop("wrapper")]
        check(r["launches"] > 0, f"{r['name']}: no launch on the main path")
    parity_phase(torch, model, out)

    print(f"total {time.perf_counter() - t_start:.1f} s; card: {card}", flush=True)
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
