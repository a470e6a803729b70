"""Multiprocess sample loading: the port's counterpart of fourm_tpu/data/
loader.py (the reference uses num_workers > 0 DataLoaders,
unified_datasets.py:385-395).

The Dirichlet / span masking and the transforms are host-side Python, so
they run in worker processes. `MultiprocessLoader` is a torch DataLoader
over an IterableDataset whose `spawn` workers each build their own item
iterator through a picklable factory with their own seed (the reference's
per-worker independent shard resampling, unified_datasets.py:371-373).
The DataLoader takes the workers' items in turn (worker 0, 1, ...), so two
runs from one seed yield the same items in the same order; a worker's
exception is raised to the consumer. Workers import the data modules and
torch, never CUDA.

How an item travels: a worker packs its numeric arrays into one uint8
tensor (`_Packed`), which reaches the consumer as one shared-memory
segment, is copied into pinned memory when there is a card (so that its
copy to the card does not wait), and is unpacked there into tensor views.
A 4M-21 batch holds about a hundred arrays; sent as a tensor each (a
shared-memory segment and a file descriptor passed between the processes
each), the loader fell below the train step's rate.
"""

from __future__ import annotations

import atexit
import os
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader, IterableDataset, get_worker_info

_ALIGN = 64  # bytes: each array's offset in the packed buffer


class _Slot:
    """Where a packed array lies: its byte offset, numpy dtype and shape."""

    def __init__(self, offset: int, dtype: np.dtype, shape: tuple):
        self.offset, self.dtype, self.shape = offset, dtype, shape


class _Packed:
    """An item with its numeric arrays moved into one uint8 tensor `buf`;
    `layout` is the item with each of them replaced by its _Slot."""

    def __init__(self, buf: torch.Tensor, layout):
        self.buf, self.layout = buf, layout

    def pin_memory(self, device=None) -> "_Packed":  # the DataLoader's pinning thread
        return _Packed(self.buf.pin_memory(), self.layout)

    def unpack(self):
        """The item, each array a tensor view of `buf`."""
        def walk(x):
            if isinstance(x, dict):
                return {k: walk(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(walk(v) for v in x)
            if isinstance(x, _Slot):
                dt = torch.from_numpy(np.empty(0, x.dtype)).dtype
                n = int(np.prod(x.shape, dtype=np.int64)) * x.dtype.itemsize
                return self.buf[x.offset:x.offset + n].view(dt).view(x.shape)
            return x
        return walk(self.layout)


def _pack(item) -> _Packed:
    """The DataLoader's collate, run in the worker."""
    arrays, size = [], 0

    def walk(x):
        nonlocal size
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, np.ndarray) and x.dtype.kind in "biuf":
            arrays.append((size, x))
            slot = _Slot(size, x.dtype, x.shape)
            size += -(-x.nbytes // _ALIGN) * _ALIGN
            return slot
        return x

    layout = walk(item)
    # filled in shared memory: sending it then passes its file descriptor,
    # not a copy of it
    buf = torch.empty(size, dtype=torch.uint8).share_memory_()
    view = buf.numpy()
    for offset, a in arrays:
        view[offset:offset + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return _Packed(buf, layout)


def _exit_at_once(worker_id: int) -> None:
    """A worker's init: end the process without the interpreter's teardown.
    A spawn worker stopped while it was still producing (the train loop
    ends an endless stream) could abort in the teardown of torch's C++
    state, which the consumer reads as a worker killed by a signal; the
    worker has nothing left to flush (its queue is abandoned, its prints
    flush)."""
    atexit.register(os._exit, 0)


class _FactoryStream(IterableDataset):
    """factory(worker_id, num_workers)'s items."""

    def __init__(self, factory):
        self.factory = factory

    def __iter__(self):
        info = get_worker_info()
        return self.factory(0, 1) if info is None else self.factory(info.id, info.num_workers)


class MultiprocessLoader:
    """Iterate items produced by `factory(worker_id, num_workers)` across
    `num_workers` spawn processes, taken in turn; their numeric numpy arrays
    arrive as CPU tensors, views of one buffer an item (pinned when CUDA is
    available). factory must be picklable (a module-level function or a
    functools.partial of one) and should derive its RNG from worker_id.
    num_workers=0 runs the factory inline and yields its items as they
    are."""

    def __init__(self, factory: Callable[[int, int], Iterator[Any]], num_workers: int = 4):
        self.factory = factory
        self.num_workers = num_workers

    def __iter__(self):
        if self.num_workers == 0:
            yield from self.factory(0, 1)
            return
        # a generator of its own, so that the workers' seeds do not draw from
        # (and advance) torch's global generator
        it = iter(DataLoader(_FactoryStream(self.factory), batch_size=None, collate_fn=_pack,
                             num_workers=self.num_workers, multiprocessing_context="spawn",
                             pin_memory=torch.cuda.is_available(), worker_init_fn=_exit_at_once,
                             generator=torch.Generator()))
        try:
            for packed in it:
                yield packed.unpack()
        finally:
            del it  # its last reference: the DataLoader iterator stops its workers
