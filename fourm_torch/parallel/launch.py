"""Starting the processes of a run over several cards (the counterpart of
fourm_tpu/parallel/launch.py; reference fourm/utils/dist.py:31-100).

Every process runs the same program, started by torchrun
(`python -m torch.distributed.run --nproc_per_node N ...`), which sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. Call
`initialize_multihost()` first: it starts the process group (NCCL on the
card, gloo on the CPU) and gives rank r the card `cuda:LOCAL_RANK`. In a
single process (no WORLD_SIZE, or 1) it does nothing. Where the group cannot
form at a world size above 1, it raises: the run never goes on as one
process.

Data side: each rank's loader reads its own part of the data, as the
reference resamples shards per worker (unified_datasets.py:371-373); the
train CLI passes the rank's index in the (data, fsdp) group to the
dataset builders (parallel/mesh.py:batch_coordinates).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

_initialized = False


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device: Optional[str] = None,
                         timeout_s: float = 600.0) -> None:
    """Start the default process group from torchrun's environment or the
    arguments (coordinator_address "host:port" or a URL such as
    "tcp://localhost:29500" or "file:///tmp/x"; num_processes the world
    size; process_id the rank). device "cpu" takes gloo, anything else
    NCCL, after setting this rank's card to LOCAL_RANK. A world of one
    process does nothing; a second call does nothing; a world above one
    whose group fails to start raises (after timeout_s)."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if world in (None, 1):
        return
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise RuntimeError(f"a world of {world} processes needs this process's rank: "
                           "RANK is not set and no process_id was given")
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} of {world}: NCCL needs a CUDA device and none "
                               "is available; pass device='cpu' for gloo")
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(rank % torch.cuda.device_count() if local is None else local)
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise RuntimeError(f"rank {rank} of {world}: no coordinator: set MASTER_ADDR / "
                               "MASTER_PORT (torchrun does) or pass coordinator_address")
        init_method = f"tcp://{addr}:{port}"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    try:
        dist.init_process_group("gloo" if cpu else "nccl", init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(f"rank {rank} of {world}: the process group did not start at "
                           f"{init_method}: {e}") from e
    _initialized = True


def shutdown() -> None:
    """Tear the default process group down (after a barrier), if one runs."""
    global _initialized
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _initialized = False


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """The rank-0 gate of logs, prints and checkpoints (reference dist.py:
    31-43 patches print; the port gates explicitly)."""
    return process_index() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
