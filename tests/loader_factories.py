"""Item factories for MultiprocessLoader's tests, in a module of their own so
that a spawn worker imports only this (not a test module and its JAX
imports)."""

import numpy as np


def two_workers_one_fails(worker_id, num_workers):
    """Three items per worker: the worker's id and the item's index, an
    int32 array read through a reversed view, a bool array and a string;
    worker 1 raises after two."""
    for i in range(3):
        yield {"worker": worker_id, "i": i,
               "arrays": {"a": np.arange(6, dtype=np.int32).reshape(2, 3)[:, ::-1] + i,
                          "m": np.array([True, False, bool(i)]), "name": f"w{worker_id}"}}
        if worker_id == 1 and i == 1:
            raise ValueError("boom")
