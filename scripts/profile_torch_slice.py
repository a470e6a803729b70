#!/usr/bin/env python3
"""Where the time goes in the port's headline chain on the card: RGB -> all
14 targets for 8 requests (8 image-token targets by ROAR with CFG, batch 16;
6 sequence targets decoded autoregressively, batch 8), 4M-21 B at full
width, random bf16 weights -- the run of chip_smoke.py's phase 3, under
torch.profiler.

    python3 scripts/profile_torch_slice.py [--out out/chain_trace.json]

Two profiled windows: the whole chain, and its sequence part alone (the 6
AR targets, conditioned on the image targets the first window decoded).
For each it prints the device time by kernel name and by kernel group, the
device busy share (summed kernel time over the wall time of the same window
run without the profiler, which slows the host's launches; the share over
the profiled wall time is printed beside it), and the host operators with
the most self CPU time; the last line is one JSON object with the same
numbers. Needs one CUDA card and nvcc.
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
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the chain's configuration and model builder)
from fourm_torch.api import FourMSampler  # noqa: E402
from fourm_torch.kernels import _build  # noqa: E402

# kernel name (substring) -> the wrapper that launches it
WRAPPER_KERNELS = {"ln_matmul_kernel": "ln_matmul", "ln_mlp_kernel": "ln_mlp",
                   "attn_kernel": "flash_mha + attention", "self_decode_kernel": "self_decode",
                   "cross_q_kernel": "cross_decode_attn (q prologue)",
                   "decode_partial_kernel": "decode_attention",
                   "decode_combine_kernel": "decode_attention",
                   "proj_residual_kernel": "residual_mlp", "hidden_kernel": "residual_mlp",
                   "out_residual_kernel": "residual_mlp"}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write a chrome trace of the chain here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    model = chip_smoke.build_model(torch, "bfloat16", "cuda")
    sampler = FourMSampler(model, chip_smoke.StandInTokenizer())
    rgb = np.random.RandomState(0).rand(chip_smoke.REQUESTS, 224, 224, 3).astype(np.float32)
    targets = chip_smoke.TARGETS
    schedule = sampler.build_schedule(["rgb@224"], targets)
    n_img = len(chip_smoke.ROAR_TARGETS)
    out = {}

    def chain():
        md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], targets,
                                    batch_size=chip_smoke.REQUESTS)
        out.update(sampler.generate(md, schedule, seed=0))
        torch.cuda.synchronize()

    def ar_part():
        md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], targets,
                                    batch_size=chip_smoke.REQUESTS)
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
    res = {"tokens": tokens,
           "chain": profile(chain, "chain", args.out, chain_ms),
           "ar_part": profile(ar_part, "sequence targets", None, ar_ms)}
    print(f"wall without the profiler: chain {chain_ms:.3f} ms, sequence targets "
          f"{ar_ms:.3f} ms; decoded tokens {json.dumps(tokens)}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
