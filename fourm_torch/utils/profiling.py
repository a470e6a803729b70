"""Seeding and profiling helpers, PyTorch port (fourm_tpu/utils/profiling.py).

Seeds: reference fourm/utils/seeds.py (per-worker deterministic seeds).
Profiling: the reference has none; `profile_trace` is a torch.profiler
scope (CPU and CUDA activities) that writes a Chrome trace, and
`step_timer` a wall-clock scope.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import random
import time
from typing import Optional

import numpy as np
import torch


def seed_everything(seed: int):
    """Seed Python's, numpy's and torch's global generators (the JAX package
    seeds Python and numpy; JAX itself takes explicit keys)."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)


def worker_seed(base_seed: int, worker_id: int, host_id: int = 0) -> int:
    """Deterministic per-worker seed: the JAX package's sha256 digest of
    "base-host-worker", modulo 2**31."""
    digest = hashlib.sha256(f"{base_seed}-{host_id}-{worker_id}".encode()).hexdigest()
    return int(digest, 16) % (2**31)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """A torch.profiler scope whose Chrome trace lands in
    log_dir/trace.json (viewable in Perfetto); yields the profiler, or None
    when log_dir is None (no profiling)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def step_timer(name: str, results: Optional[dict] = None):
    """Wall-clock seconds of the scope, stored as results[name]. Work queued
    on the card is not waited for: synchronize inside the scope to count it."""
    t0 = time.perf_counter()
    yield
    if results is not None:
        results[name] = time.perf_counter() - t0
