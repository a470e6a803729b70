"""Phase 3's 4M-21 B chain and phase 3b's 4M-21 XL bf16 chain of chip_smoke.py,
for several checkouts on one card, so that two commits compare within one
machine:

    python3 scripts/compare_chains.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (its own chip_smoke.py and fourm_torch,
its kernels built from its own sources into its own build directory). The
roots run in the order given, each in a process of its own: give the parent
and the change as parent, change, change, parent. Each run prints its
root's chain_phase lines (samples/s from the public entry, each sequence
target's seconds and ms/token) and the card's name and power limit. Imports
nothing of JAX or fourm_tpu.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


def one(root: str) -> None:
    """The two chains of the chip_smoke.py at `root`, in this process."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from fourm_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"root {root}: {card}; build {_build.build_all():.2f} s", flush=True)
    model = cs.build_model(torch, "bfloat16", "cuda")
    cs.chain_phase(torch, model, card)
    del model
    torch.cuda.empty_cache()
    model = cs.build_model(torch, "bfloat16", "cuda", name=cs.XL_MODEL)
    cs.chain_phase(torch, model, card, cs.XL_REQUESTS, cs.XL_DEPTH, label="xl_chain")


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(os.path.abspath(sys.argv[2]))
        return 0
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots:
        sys.exit(__doc__)
    for i, root in enumerate(roots):
        t0 = time.perf_counter()
        print(f"=== run {i + 1} of {len(roots)}: {root}", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)
        print(f"=== run {i + 1}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
