"""Torch's CPU threads in pytest-xdist workers: an equal share of the cores.

The tier-1 command runs the suite in 6 xdist workers. Torch gives each
process a thread per core, so 6 workers ran 6 x cores threads on the cores,
and the port's tests waited on each other: six of the port's test files took
192 s under `-n 6 --dist loadfile` with torch's default and 70 s with one
thread a worker (8 cores). Importing this module sets the share for the
whole worker process (every worker imports every test file when it
collects). Outside xdist torch keeps its default. The thread count changes
only the order of torch's CPU reductions; every comparison keeps its
tolerance."""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
