"""A FourM's state over a (data, fsdp, tensor) mesh: the tensor-parallel
split of its blocks, the rank's fp32 master shards, and the collectives of
a train step (the counterpart of what XLA derives from the JAX package's
shardings, fourm_tpu/parallel/mesh.py:model_shardings and train.py:34-58).

  * tensor: `shard_tensor_parallel` replaces each split parameter by this
    rank's slice (mesh.py:head_rows for q / k / v) and gives the module its
    TensorGroup; the model then holds and trains only those slices.
  * fsdp: each parameter that the fsdp rule shards keeps its fp32 master,
    and so both AdamW moments, as this rank's 1 / fsdp chunk along the rule's
    dim (flattened, in one buffer). Before a step's forward the chunks are
    all-gathered into the model's parameters; after its backward the
    gradients are reduce-scattered into the chunks. A parameter the rule
    replicates is its own master, its gradient all-reduced. Buckets of at
    most BUCKET_BYTES bound the temporary buffers.
  * data: gradients summed over the data ranks too.

The model's parameters hold the whole tensors (of the rank's tensor slice)
between steps, the only full fp32 copy on the rank, and the backward builds
whole fp32 gradients before their reduce-scatter: 8 bytes a parameter a
rank whatever the fsdp size. Only the masters and moments are 1 / fsdp of
it (ZeRO-1's memory; gathering block by block, as FSDP proper does, is not
done). `full_state` gathers whole tensors for a checkpoint, `load_full`
takes them back at any mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..ops.tensor_parallel import TensorGroup
from ..ops.transformer import Attention, CrossAttention, GatedMlp, Mlp
from .mesh import (MESH_AXES, batch_coordinates, fsdp_dim, head_rows, mesh_sizes, tensor_dim,
                   tensor_kind)

BUCKET_BYTES = 1 << 28


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def _sum_into(tensors: List[torch.Tensor], reduce) -> None:
    """tensors replaced in place by reduce(their concatenation), in one
    collective."""
    flat = reduce(torch.cat([t.reshape(-1) for t in tensors]))
    torch._foreach_copy_(tensors, [c.view_as(t) for c, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


def leaf_norms(grads: List[torch.Tensor]) -> torch.Tensor:
    """Each gradient's 2-norm, its squares summed in fp64 (fp32 sums of a
    million-row embedding's gradient drift by 1e-4 on the CPU)."""
    return torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64))


# ----------------------------------------------------------- tensor parallel

def _block_hidden(model: nn.Module, name: str) -> int:
    """The true hidden width of the MLP a parameter belongs to (0 if none)."""
    if ".mlp." not in name:
        return 0
    return model.get_submodule(name.split(".mlp.")[0] + ".mlp.fc1").weight.shape[0]


def tp_slice(kind: str, full: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    """This rank's slice of a tensor-split parameter of the given rule kind."""
    if kind in ("qkv", "kv"):
        return full[head_rows(full.shape[0], 3 if kind == "qkv" else 2, size, rank)]
    dim = 1 if kind == "row" else 0
    return full.chunk(size, dim=dim)[rank]


def tp_join(kind: str, parts: List[torch.Tensor]) -> torch.Tensor:
    """The whole parameter from every rank's slice (tp_slice's inverse)."""
    if kind in ("qkv", "kv"):
        n = 3 if kind == "qkv" else 2
        per = parts[0].shape[0] // n
        return torch.cat([p[i * per:(i + 1) * per] for i in range(n) for p in parts])
    return torch.cat(parts, dim=1 if kind == "row" else 0)


def shard_tensor_parallel(model: nn.Module, tp: TensorGroup) -> Dict[str, str]:
    """Split the blocks of `model` over the tensor group in place: each
    attention whose head count tp.size divides, each MLP whose hidden width
    it divides, keeps this rank's slice of its column- and row-parallel
    weights and gets `tp`. -> {parameter name: rule kind} of the split
    parameters, and "partial" for the QK-norm weights of a split attention:
    whole on every rank, but each rank's gradient covers its heads only."""
    cfg = model.config
    split: Dict[str, str] = {}
    named = list(model.named_parameters())
    hidden = {name: _block_hidden(model, name) for name, _ in named}  # before any split
    with torch.no_grad():
        for name, p in named:
            kind = tensor_kind(name)
            if tensor_dim(name, tp.size, cfg.num_heads, hidden[name]) is None:
                continue
            owner_name, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(owner_name)
            setattr(owner, leaf, nn.Parameter(tp_slice(kind, p.detach(), tp.size,
                                                       tp.rank).clone()))
            split[name] = kind
        for name, m in model.named_modules():
            first = {Attention: "qkv", CrossAttention: "q"}.get(type(m))
            if first is not None and f"{name}.{first}.weight" in split:
                m.num_heads //= tp.size  # this rank's heads
                m.tp = tp
            elif isinstance(m, (Mlp, GatedMlp)) and f"{name}.fc1.weight" in split:
                m.tp = tp
        for name, m in model.named_modules():
            if isinstance(m, (Attention, CrossAttention)) and m.tp is not None and m.qk_norm:
                for norm in ("q_norm", "k_norm"):
                    for pname, _ in getattr(m, norm).named_parameters():
                        split[f"{name}.{norm}.{pname}"] = "partial"
    return split


# --------------------------------------------------------------- the plan

@dataclass
class Leaf:
    name: str
    param: nn.Parameter       # the model's (this rank's tensor slice, whole along fsdp)
    tkind: Optional[str]      # tensor rule kind, None = whole on every tensor rank
    fdim: Optional[int]       # fsdp dim of the parameter, None = replicated
    off: int = 0              # offset of its chunk in the master buffer
    n: int = 0                # numel of its chunk
    moved: Tuple[int, ...] = ()  # the parameter's shape with fdim first


class ParallelPlan:
    """The mesh, its groups and coordinates, and every parameter's
    placement; the collectives of a train step. shard: keep fsdp-ruled
    masters in chunks (default: fsdp > 1); at fsdp 1 with shard=True every
    parameter of ndim >= 1 takes the path with one chunk (the collectives of
    size 1), which a single card can exercise."""

    def __init__(self, model: nn.Module, mesh, shard: Optional[bool] = None):
        self.model, self.mesh = model, mesh
        self.data, self.fsdp, self.tensor = mesh_sizes(mesh)
        _, self.fsdp_rank, self.tensor_rank = mesh.get_coordinate()
        self.groups = {a: mesh.get_group(a) for a in MESH_AXES}
        self.batch_index, self.batch_count = batch_coordinates(mesh)
        self.shard = self.fsdp > 1 if shard is None else shard
        self.tp = TensorGroup(self.groups["tensor"], self.tensor_rank, self.tensor)
        split = shard_tensor_parallel(model, self.tp) if self.tensor > 1 else {}
        self.leaves: List[Leaf] = []
        self.partial: List[nn.Parameter] = []  # gradients summed over the tensor ranks first
        off = 0
        for name, p in model.named_parameters():
            full = list(p.shape)
            kind = split.get(name)
            if kind == "partial":
                self.partial.append(p)
                kind = None
            tdim = None if kind is None else (1 if kind == "row" else 0)
            if tdim is not None:
                full[tdim] *= self.tensor
            linear = "." in name and isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                                                nn.Linear)
            fdim = fsdp_dim(full, self.fsdp, skip=tdim, transposed=linear and p.ndim == 2)
            if self.shard and self.fsdp == 1 and p.ndim >= 1:
                fdim = max(range(p.ndim), key=lambda i: p.shape[i])
            leaf = Leaf(name, p, kind, fdim)
            if fdim is not None:
                leaf.moved = tuple(p.movedim(fdim, 0).shape)
                leaf.n = p.numel() // self.fsdp
                leaf.off = off
                off += leaf.n
            self.leaves.append(leaf)
        dev = model.mask_token.device
        self.masters = torch.empty(off, dtype=torch.float32, device=dev)
        self.master_grads = torch.zeros(off, dtype=torch.float32, device=dev)
        sharded = [leaf for leaf in self.leaves if leaf.fdim is not None]
        with torch.no_grad():
            for leaf in sharded:
                self.masters[leaf.off:leaf.off + leaf.n].copy_(self._chunk(leaf.param, leaf))
        # the whole parameters' bytes bound a bucket of either kind
        self.buckets = self._bucketize(sharded)
        self.whole_buckets = self._bucketize([leaf for leaf in self.leaves if leaf.fdim is None])

    # -------------------------------------------------------- placement

    def _chunk(self, t: torch.Tensor, leaf: Leaf) -> torch.Tensor:
        """This rank's flattened fsdp chunk of a tensor of leaf's local shape."""
        return t.detach().movedim(leaf.fdim, 0).reshape(self.fsdp, -1)[self.fsdp_rank]

    @staticmethod
    def _bucketize(leaves: List[Leaf]) -> List[List[Leaf]]:
        """Consecutive runs of leaves of at most BUCKET_BYTES of fp32 whole
        parameters each (a leaf larger alone makes its own)."""
        out, cur, size = [], [], 0
        for leaf in leaves:
            nbytes = leaf.param.numel() * 4
            if cur and size + nbytes > BUCKET_BYTES:
                out.append(cur)
                cur, size = [], 0
            cur.append(leaf)
            size += nbytes
        return out + ([cur] if cur else [])

    def master(self, leaf: Leaf) -> torch.Tensor:
        if leaf.fdim is None:
            return leaf.param.detach()
        return self.masters[leaf.off:leaf.off + leaf.n]

    def named_masters(self) -> List[Tuple[str, torch.Tensor]]:
        """The optimizer's leaves: (name, fp32 master) in parameter order."""
        return [(l.name, self.master(l)) for l in self.leaves]

    # ------------------------------------------------------ collectives

    def _reduce(self, t: torch.Tensor, axes=("fsdp", "data")) -> torch.Tensor:
        """t summed in place over the given mesh axes (size-1 axes skipped)."""
        sizes = dict(zip(MESH_AXES, (self.data, self.fsdp, self.tensor)))
        for a in axes:
            if sizes[a] > 1:
                dist.all_reduce(t, group=self.groups[a])
        return t

    def reduce_batch(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the batch-sharded (data, fsdp) ranks (a copy)."""
        return self._reduce(t.clone())

    def gather_params(self) -> None:
        """The masters' chunks all-gathered into the model's parameters."""
        with torch.no_grad():
            for bucket in self.buckets:
                start = bucket[0].off
                n = bucket[-1].off + bucket[-1].n - start
                inp = self.masters[start:start + n]
                if self.fsdp > 1:
                    out = torch.empty(self.fsdp * n, dtype=inp.dtype, device=inp.device)
                    _all_gather(out, inp, self.groups["fsdp"])
                else:
                    out = inp
                out = out.view(self.fsdp, n)
                for leaf in bucket:
                    b = leaf.off - start
                    whole = out[:, b:b + leaf.n].reshape(leaf.moved)
                    leaf.param.copy_(whole.movedim(0, leaf.fdim))

    def reduce_grads(self) -> List[Optional[torch.Tensor]]:
        """The gradients of the step (the model's `.grad`, this rank's
        batch) summed over the batch ranks into each master's layout: a
        chunk of master_grads (reduce-scatter over fsdp, then all-reduce
        over data) or the parameter's whole gradient (all-reduce). ->
        one gradient per leaf, in the optimizer's order."""
        with torch.no_grad():
            part = [p.grad for p in self.partial if p.grad is not None]
            if part:
                _sum_into(part, lambda flat: self._reduce(flat, ("tensor",)))
            for bucket in self.buckets:
                start = bucket[0].off
                n = bucket[-1].off + bucket[-1].n - start
                inp = torch.empty((self.fsdp, n), dtype=torch.float32,
                                  device=self.masters.device)
                for leaf in bucket:
                    b = leaf.off - start
                    g = leaf.param.grad
                    if g is None:
                        inp[:, b:b + leaf.n].zero_()
                    else:
                        inp[:, b:b + leaf.n].copy_(
                            g.movedim(leaf.fdim, 0).reshape(self.fsdp, leaf.n))
                    leaf.param.grad = None
                out = self.master_grads[start:start + n]
                if self.fsdp > 1:
                    _reduce_scatter(out, inp.view(-1), self.groups["fsdp"])
                else:
                    out.copy_(inp[0])
            self._reduce(self.master_grads, ("data",))
            for bucket in self.whole_buckets:
                for leaf in bucket:
                    if leaf.param.grad is None:
                        leaf.param.grad = torch.zeros_like(leaf.param)
                _sum_into([leaf.param.grad for leaf in bucket], self._reduce)
        return [self.master_grads[leaf.off:leaf.off + leaf.n] if leaf.fdim is not None
                else leaf.param.grad for leaf in self.leaves]

    def grad_norm(self, grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """The global norm of the reduced gradients, each element counted
        once: a chunk's squares summed over the fsdp ranks, a tensor slice's
        over the tensor ranks, a replicated leaf's once. Equal on every
        rank."""
        pairs = [(g, 2 * (l.fdim is not None) + (l.tkind is not None))
                 for g, l in zip(grads, self.leaves) if g is not None]
        norms = leaf_norms([g for g, _ in pairs])
        idx = torch.tensor([c for _, c in pairs], device=norms.device)
        sums = torch.zeros(4, dtype=torch.float64, device=norms.device).index_add_(
            0, idx, norms.square())
        if self.fsdp > 1:
            fs = sums[2:4].clone()
            dist.all_reduce(fs, group=self.groups["fsdp"])
            sums[2:4] = fs
        if self.tensor > 1:
            ts = sums[1::2].clone()
            dist.all_reduce(ts, group=self.groups["tensor"])
            sums[1::2] = ts
        return sums.sum().sqrt().float()

    # ----------------------------------------------------- checkpoints

    def _gather_leaf(self, leaf: Leaf, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The whole parameter-shaped tensor of a leaf from every rank's
        master-layout piece `t` (a chunk or the slice), a copy on the CPU
        that the next step leaves as it is; on rank 0 only (None
        elsewhere). Every rank must call it."""
        if leaf.fdim is not None:
            out = torch.empty(self.fsdp * leaf.n, dtype=t.dtype, device=t.device)
            if self.fsdp > 1:
                _all_gather(out, t.contiguous(), self.groups["fsdp"])
            else:
                out.copy_(t)
            t = out.view(leaf.moved).movedim(0, leaf.fdim)
        if leaf.tkind is not None:
            parts = [torch.empty_like(t) for _ in range(self.tensor)]
            dist.all_gather(parts, t.contiguous(), group=self.groups["tensor"])
            t = tp_join(leaf.tkind, parts)
        return t.to("cpu", copy=True) if dist.get_rank() == 0 else None

    def full_state(self, optimizer) -> Tuple[Optional[dict], Optional[dict]]:
        """(model state dict, optimizer state dict) of whole tensors on rank
        0 (None, None elsewhere): what a single card's checkpoint holds."""
        params, mu, nu = {}, {}, {}
        for leaf in self.leaves:
            params[leaf.name] = self._gather_leaf(leaf, self.master(leaf))
            mu[leaf.name] = self._gather_leaf(leaf, optimizer.mu[leaf.name])
            nu[leaf.name] = self._gather_leaf(leaf, optimizer.nu[leaf.name])
        count = optimizer.count
        if dist.get_rank() != 0:
            return None, None
        by_id = {id(l.param): l.name for l in self.leaves}
        state = {}
        for name, p in self.model.named_parameters(remove_duplicate=False):
            state[name] = params[by_id[id(p)]]
        for name, b in self.model.named_buffers():
            state[name] = b.detach().cpu()
        ordered = {k: state[k] for k in self.model.state_dict()}
        return ordered, {"count": count, "mu": mu, "nu": nu}

    def load_full(self, model_state: dict, optimizer=None, opt_state: Optional[dict] = None
                  ) -> None:
        """Copy whole tensors (a checkpoint's, any mesh's) into this rank's
        parameters, masters and moments."""
        with torch.no_grad():
            for name, b in self.model.named_buffers():
                if name in model_state:
                    b.copy_(model_state[name])
            for leaf in self.leaves:
                for src, dst in ((model_state, None), (opt_state and opt_state["mu"], "mu"),
                                 (opt_state and opt_state["nu"], "nu")):
                    if src is None:
                        continue
                    t = src[leaf.name].to(leaf.param.device, torch.float32)
                    if leaf.tkind is not None:
                        t = tp_slice(leaf.tkind, t, self.tensor, self.tensor_rank)
                    if dst is None:
                        leaf.param.copy_(t)
                        if leaf.fdim is not None:
                            self.master(leaf).copy_(self._chunk(t, leaf))
                        continue
                    target = getattr(optimizer, dst)[leaf.name]
                    target.copy_(self._chunk(t, leaf) if leaf.fdim is not None else t)
        if optimizer is not None and opt_state is not None:
            count = int(opt_state["count"])
            optimizer._count.fill_(count)
            optimizer._calls, optimizer._bound = 0, count

    def param_bytes(self) -> Dict[str, int]:
        """This rank's bytes of parameters (the model's), of fp32 masters and
        of the masters' share of the two moments."""
        model = sum(p.numel() * p.element_size() for p in self.model.parameters())
        masters = sum(self.master(l).numel() * 4 for l in self.leaves)
        return {"parameters": model, "masters": masters, "moments": 2 * masters}

