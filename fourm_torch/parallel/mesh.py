"""The (data, fsdp, tensor) mesh over the ranks of a run, and the sharding
rules (the counterpart of fourm_tpu/parallel/mesh.py).

  data   - data parallelism: every rank holds the whole state, gradients are
           summed over the ranks;
  fsdp   - data parallelism with the parameters, their gradients and both
           AdamW moments sharded, as the JAX package shards the whole
           TrainState (reference run_training_4m_fsdp.py:516-555; ZeRO-3's
           memory): 1 / fsdp of each a rank, a unit (a block, an embedding
           module, the root) all-gathered whole only while it computes, its
           gradients reduce-scattered in the backward (parallel/shard.py);
  tensor - Megatron tensor parallelism of the blocks: column-parallel qkv /
           q / kv / fc1 / fc3, row-parallel proj / fc2, one all-reduce after
           each row-parallel product.

The rules are pure functions of a parameter's name and shape, written for
the port's names and layouts: nn.Linear.weight is (out, in) where flax's
`kernel` is (in, out), so the JAX package's column axis 1 is the port's dim
0 and its row axis 0 the port's dim 1. The fused qkv weight (3C, C) and the
cross-attention kv weight (2C, C) are split per head: rank r takes its heads'
rows of q, of k and of v (JAX's contiguous split of the 3C columns is a
layout that XLA reshards; a contiguous block of the port's weight would mix
q, k and v). An attention is therefore split only where the tensor size
divides its head count, and an MLP only where it divides the true hidden
width (XL's SwiGLU hidden is 5461: replicated at tensor 4, as in JAX, whatever
storage the port pads it to). The embeddings, norms, the decoder context
projection and the mask token stay whole on every tensor rank.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

MESH_AXES = ("data", "fsdp", "tensor")


def mesh_shape(world: int, data: int = -1, fsdp: int = 1, tensor: int = 1) -> Tuple[int, int, int]:
    """The (data, fsdp, tensor) sizes over `world` ranks; data=-1 takes the
    rest. Raises as the JAX make_mesh does when they do not match."""
    if data == -1:
        if world % (fsdp * tensor) != 0:
            raise ValueError(f"{world} devices not divisible by fsdp*tensor={fsdp * tensor}")
        data = world // (fsdp * tensor)
    if data * fsdp * tensor != world:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {world} devices")
    return data, fsdp, tensor


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1, device_type: Optional[str] = None):
    """A DeviceMesh with the axes ("data", "fsdp", "tensor") over the ranks of
    the default process group (launch.initialize_multihost starts it; a
    single process starts a world-1 group itself). A shape that does not
    match the world raises, as does a missing group. device_type: "cuda"
    under NCCL, "cpu" under gloo (default: the group's backend)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape(world, data, fsdp, tensor)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "fourm_torch.parallel.launch.initialize_multihost (torchrun), or "
                           "start a world-1 group")
    if device_type is None:
        device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def mesh_sizes(mesh) -> Tuple[int, int, int]:
    return tuple(int(mesh[a].size()) for a in MESH_AXES)


def batch_coordinates(mesh) -> Tuple[int, int]:
    """(index, count) of this rank in the batch-sharded (data, fsdp) group:
    rank index of that group takes rows [index * b, (index + 1) * b) of the
    global batch; the ranks of a tensor group share their samples."""
    d, f, _ = mesh.get_coordinate()
    ds, fs, _ = mesh_sizes(mesh)
    return d * fs + f, ds * fs


# ------------------------------------------------------------------ rules

def fsdp_dim(shape: Sequence[int], fsdp: int, skip: Optional[int] = None,
             transposed: bool = False) -> Optional[int]:
    """The fsdp rule (mesh.py:fsdp_sharding_for): the largest dim that fsdp
    divides and that is at least 2 * fsdp, of equal ones the first in the
    JAX layout (the last of the port's for a transposed nn.Linear weight);
    None (replicated) for fsdp 1, a scalar or no such dim. `skip` excludes
    the tensor-parallel dim (tensor_sharding_for's combined rule)."""
    if fsdp == 1 or len(shape) == 0:
        return None
    n = len(shape)
    for axis in sorted(range(n), key=lambda i: (-shape[i], n - i if transposed else i)):
        if axis != skip and shape[axis] % fsdp == 0 and shape[axis] >= 2 * fsdp:
            return axis
    return None


# the port's tensor rules: (name pattern, kind). "qkv" / "kv" are split per
# head on dim 0, "col" on dim 0, "row" on dim 1 (bias whole, added once after
# the all-reduce). The kind of a block's module decides together: an
# attention splits where tensor divides its heads, an MLP where it divides
# its hidden width.
TENSOR_RULES = [
    (re.compile(r".*\.(attn|self_attn)\.qkv\.(weight|bias)$"), "qkv"),
    (re.compile(r".*\.cross_attn\.kv\.(weight|bias)$"), "kv"),
    (re.compile(r".*\.cross_attn\.q\.(weight|bias)$"), "col"),
    (re.compile(r".*\.(attn|self_attn|cross_attn)\.proj\.weight$"), "row"),
    (re.compile(r".*\.mlp\.(fc1|fc3)\.(weight|bias)$"), "col"),
    (re.compile(r".*\.mlp\.fc2\.weight$"), "row"),
]
BLOCK_PREFIXES = ("encoder.", "decoder.")


def tensor_kind(name: str) -> Optional[str]:
    """The tensor rule a block parameter falls under, or None (whole)."""
    if not name.startswith(BLOCK_PREFIXES):
        return None
    for pat, kind in TENSOR_RULES:
        if pat.match(name):
            return kind
    return None


def tensor_dim(name: str, tensor: int, num_heads: int, hidden: int) -> Optional[int]:
    """The port's tensor-parallel dim of a parameter (0: column-parallel,
    q / k / v per head; 1: row-parallel), or None: an attention's
    parameters split where tensor divides num_heads, an MLP's where it
    divides the true hidden width. The fsdp dim of a split parameter is the
    fsdp rule's on its whole shape with this dim skipped
    (tensor_sharding_for)."""
    kind = tensor_kind(name)
    if kind is None or tensor == 1:
        return None
    if (hidden if ".mlp." in name else num_heads) % tensor:
        return None
    return 1 if kind == "row" else 0


def head_rows(rows: int, parts: int, tensor: int, rank: int) -> torch.Tensor:
    """The row indices rank takes of a weight whose rows are `parts` blocks
    (q | k | v, or k | v) of `rows / parts` rows each: its 1 / tensor of every
    block, in order."""
    per = rows // parts
    size = per // tensor
    return torch.cat([torch.arange(p * per + rank * size, p * per + (rank + 1) * size)
                      for p in range(parts)])
