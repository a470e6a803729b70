#!/usr/bin/env python3
"""Time the kernel rows of chip_smoke.py's kernel phases for one checkout, so
that two checkouts compare on one card in one process each.

    python3 scripts/kernel_rows.py [--root DIR] [--phases 2,2b,2d,5,8]

Imports chip_smoke and fourm_torch from DIR (default: this checkout), builds
its kernels and runs the chosen kernel phases of its chip_smoke.py (2: the
chain's kernels, 2b: the XL widths, 2c: the narrow widths, 2d: the SR-448
chain's and the decoding at 448's shapes, 5: VQ, 8: the train step); each
phase holds every kernel to its twin and times it, kernel, plain twin and
library yardstick (cold too, where the checkout's chip_smoke.py times it),
and reckons its bound, as chip_smoke.py does. A phase the checkout's
chip_smoke.py does not have is skipped. The last line is one JSON object:
the card, and {row name: {"ms", "plain_ms", "library_ms", "bound_ms",
"bound_by"[, "cold_ms", "cold_library_ms"]}}. To compare versions,
run parent, change, change, parent one after another on the same card (a
`git archive` of the parent unpacked in a directory .gitignore lists).
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = {"2": "kernel_phase", "2b": "xl_kernel_phase", "2c": "narrow_kernel_phase",
          "2d": "sr_kernel_phase", "5": "vq_kernel_phase", "8": "train_kernel_phase"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--phases", default="2,2b,2d,5,8")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_rows: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from fourm_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"{root}: {card}; build {_build.build_all():.2f} s", flush=True)
    rows = {}
    for phase in args.phases.split(","):
        if not hasattr(chip_smoke, PHASES[phase]):
            print(f"{root}: no phase {phase}", flush=True)
            continue
        for r in getattr(chip_smoke, PHASES[phase])(torch, card):
            rows[r["name"]] = {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "cold_ms", "cold_library_ms")
                               if k in r}
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
