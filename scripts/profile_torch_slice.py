#!/usr/bin/env python3
"""Where the time goes in the port's slice on the card: RGB -> 8 image-token
targets for 8 requests (batch 16 with CFG), 4M-21 B at full width, random
bf16 weights — the run of chip_smoke.py's phase 3, under torch.profiler.

    python3 scripts/profile_torch_slice.py [--out chiprun_out/slice_trace.json]

Prints the device time by kernel name (sum over the run), the device busy
share (summed kernel time over the wall time of the run) and, as the last
line, one JSON object with the same numbers. Needs one CUDA card and nvcc.
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

import chip_smoke  # noqa: E402  (the slice's configuration and model builder)
from fourm_torch.api import FourMSampler  # noqa: E402
from fourm_torch.kernels import _build  # noqa: E402

WRAPPER_KERNELS = {"ln_matmul_kernel": "ln_matmul", "ln_mlp_kernel": "ln_mlp",
                   "attn_kernel": "flash_mha + attention"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    model = chip_smoke.build_model(torch, "bfloat16", "cuda")
    sampler = FourMSampler(model)
    rgb = np.random.RandomState(0).rand(chip_smoke.REQUESTS, 224, 224, 3).astype(np.float32)
    schedule = sampler.build_schedule(["rgb@224"], chip_smoke.TARGETS)

    def run():
        md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], chip_smoke.TARGETS,
                                    batch_size=chip_smoke.REQUESTS)
        sampler.generate(md, schedule, seed=0)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_plain = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        prof.export_chrome_trace(args.out)

    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0) or 0
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    print(f"{torch.cuda.get_device_name(0)}; run wall {wall * 1e3:.3f} ms under the profiler, "
          f"{wall_plain * 1e3:.3f} ms without; device busy {device_ms:.3f} ms "
          f"({device_ms / (wall * 1e3):.4f} of the wall time)")
    groups = {}
    for ms, count, key in rows:
        group = next((g for k, g in WRAPPER_KERNELS.items() if k in key), "other")
        groups[group] = groups.get(group, 0.0) + ms
    for ms, count, key in rows[:25]:
        print(f"{ms:10.3f} ms {count:6d}x  {key[:110]}")
    print(json.dumps({"wall_ms": wall * 1e3, "wall_ms_unprofiled": wall_plain * 1e3,
                      "device_ms": device_ms, "busy_share": device_ms / (wall * 1e3),
                      "by_group_ms": groups,
                      "top": [{"ms": ms, "count": c, "name": k[:200]} for ms, c, k in rows[:25]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
