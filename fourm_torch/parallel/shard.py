"""A FourM's state over a (data, fsdp, tensor) mesh: the tensor-parallel
split of its blocks, the rank's fp32 shards of its parameters, and the
collectives of a train step (the counterpart of what XLA derives from the
JAX package's shardings, fourm_tpu/parallel/mesh.py:model_shardings and
train.py:34-61).

  * tensor: `shard_tensor_parallel` replaces each split parameter by this
    rank's slice (mesh.py:head_rows for q / k / v) and gives the module its
    TensorGroup; the model then holds and trains only those slices.
  * fsdp: each parameter that the fsdp rule shards is held as this rank's
    1 / fsdp chunk along the rule's dim (moved first, flattened, in one fp32
    buffer: the masters), and so are its gradient and both AdamW moments,
    as JAX holds the whole TrainState. Between calls the parameter keeps its
    shape over an empty storage. The parameters are grouped into units:
    each block of the encoder and of the decoder, each encoder and decoder
    embedding module (its logits included), and the root (the norms, the
    decoder context projection, the mask and register tokens and every
    `mod_emb`, which FourM reads outside its embedding modules, shared
    ones included). A unit's chunks are one range of the buffer: before its
    forward they are all-gathered into whole fp32 tensors, which are freed
    after it; the backward gathers the unit again (the next one's gather
    prefetched on a side stream on the card) and, once each of its
    parameters has its whole gradient (a tied parameter after its last
    use), reduce-scatters the gradients into its chunks of `master_grads`
    and frees them and the parameters. A remat recomputation runs inside
    that gather. The root is gathered for the whole of FourM.forward and
    its backward. A parameter the rule replicates is whole on every rank,
    its gradient all-reduced after the backward. Buckets of at most
    BUCKET_BYTES bound the temporary buffers.
  * data: gradients summed over the data ranks too, after the fsdp sum.

Only `forward` (and an embedding module's `embed` and `logits`) gathers a
unit; any other public method of a unit called while its parameters are
chunks raises ShardedUnitError. A model built under `meta_params()` is born
sharded: each leaf is drawn whole as init_weights draws it, one at a time,
and only the rank's chunk kept. `full_state` gathers whole tensors for a
checkpoint from the chunks, `load_full` takes them back at any mesh.
"""

from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.fourm import init_value
from ..ops.tensor_parallel import TensorGroup
from ..ops.transformer import Attention, CrossAttention, GatedMlp, Mlp
from .mesh import (MESH_AXES, batch_coordinates, fsdp_dim, head_rows, mesh_sizes, tensor_dim,
                   tensor_kind)

BUCKET_BYTES = 1 << 28
# FourM's containers whose items are units, in the order the forward uses them
UNIT_CONTAINERS = ("encoder_embeddings", "encoder", "decoder_embeddings", "decoder")
# the methods that gather a unit; its module's other public methods raise
# while the unit is in chunks
ENTRY_METHODS = ("forward", "embed", "logits")


class ShardedUnitError(RuntimeError):
    """A method of a sharded unit other than its entry methods was called
    while the unit's parameters are 1 / fsdp chunks."""


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


@contextlib.contextmanager
def meta_params() -> Iterator[None]:
    """Build modules with their parameters on the meta device (no storage)
    and their buffers where they are made: a FourM built so is born sharded
    by init_train_state(..., seed=). A parameter already on meta (a tied
    one, assigned a second time) is kept as it is."""
    register = nn.Module.register_parameter

    def on_meta(module, name, param):
        if param is not None and param.device.type != "meta":
            param = nn.Parameter(param.detach().to("meta"), param.requires_grad)
        register(module, name, param)

    nn.Module.register_parameter = on_meta
    try:
        yield
    finally:
        nn.Module.register_parameter = register


def _parameter_slots(model: nn.Module) -> Dict[int, list]:
    """{id(parameter): [(module, attribute)]}: every place that holds it
    (two for a tied one)."""
    slots: Dict[int, list] = {}
    for m in model.modules():
        for k, p in m._parameters.items():
            if p is not None:
                slots.setdefault(id(p), []).append((m, k))
    return slots


def _replace_parameter(slots: Dict[int, list], old: nn.Parameter,
                       value: torch.Tensor) -> nn.Parameter:
    """A new parameter over `value` in every slot of `old` (a meta one,
    whose device `.data` cannot change)."""
    new = nn.Parameter(value, old.requires_grad)
    places = slots.pop(id(old))
    for m, k in places:
        m._parameters[k] = new
    slots[id(new)] = places
    return new


def _empty_whole(shape, device) -> torch.Tensor:
    """An fp32 tensor of the shape over a storage of 0 bytes."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.untyped_storage().resize_(0)
    return t


def _needing_grad(tree) -> List[torch.Tensor]:
    """The tensors of `tree` (tuples, lists and dicts of them) that need a
    gradient."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.requires_grad else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _needing_grad(v)]
    return []


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

@dataclass(eq=False)
class Leaf:
    name: str
    param: nn.Parameter       # the model's (this rank's tensor slice)
    tkind: Optional[str]      # tensor rule kind, None = whole on every tensor rank
    fdim: Optional[int]       # fsdp dim of the parameter, None = replicated
    full: Tuple[int, ...] = ()  # its shape before the tensor split
    partial: bool = False     # gradient summed over the tensor ranks first
    off: int = 0              # offset of its chunk in the master buffer
    n: int = 0                # numel of its chunk
    moved: Tuple[int, ...] = ()  # the parameter's shape with fdim first
    acc: Optional[object] = None  # its gradient accumulator (autograd node)


@dataclass(eq=False)
class Unit:
    """Parameters gathered together: a block, an embedding module or the
    root. `leaves`: its sharded ones, their chunks one range of the master
    buffer."""
    name: str
    module: nn.Module
    leaves: List[Leaf] = field(default_factory=list)
    buckets: List[List[Leaf]] = field(default_factory=list)
    whole: bool = False       # its leaves hold their whole tensors
    ready: Optional[object] = None  # the CUDA event of a gather in flight
    depth: int = 0            # entry calls in progress
    due: set = field(default_factory=set)  # leaves whose gradient this backward awaits
    written: bool = False     # master_grads holds this step's sum of its chunks


class ParallelPlan:
    """The mesh, its groups and coordinates, and every parameter's
    placement; the units and the collectives of a train step. shard: hold
    the fsdp-ruled parameters in chunks (default: fsdp > 1); at fsdp 1 with
    shard=True every parameter of ndim >= 1 takes the path with one chunk
    (the collectives of size 1), which a single card can exercise; with
    shard=False every parameter is whole and its gradient all-reduced.
    device: where the state lives (default: the parameters'). A parameter on
    the meta device is drawn as init_weights(model, seed) draws it, on
    `device`, then chunked. One graph at a time: a forward's backward runs
    before the next forward (a new FourM.forward releases what an earlier
    graph left whole)."""

    def __init__(self, model: nn.Module, mesh, shard: Optional[bool] = None,
                 device=None, seed: Optional[int] = None):
        self.model, self.mesh = model, mesh
        self.data, self.fsdp, self.tensor = mesh_sizes(mesh)
        _, self.fsdp_rank, self.tensor_rank = mesh.get_coordinate()
        self.groups = {a: mesh.get_group(a) for a in MESH_AXES}
        self.batch_index, self.batch_count = batch_coordinates(mesh)
        self.shard = self.fsdp > 1 if shard is None else shard
        self.tp = TensorGroup(self.groups["tensor"], self.tensor_rank, self.tensor)
        dev = torch.device(device) if device is not None else next(model.parameters()).device
        if dev.type == "meta":
            raise ValueError("ParallelPlan: give the device of a model built on the meta device")
        split = shard_tensor_parallel(model, self.tp) if self.tensor > 1 else {}
        self.leaves: List[Leaf] = []
        for name, p in model.named_parameters():
            full = list(p.shape)
            kind = split.get(name)
            partial = kind == "partial"
            if partial:
                kind = None
            tdim = None if kind is None else (1 if kind == "row" else 0)
            if tdim is not None:
                full[tdim] *= self.tensor
            linear = "." in name and isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                                                nn.Linear)
            fdim = fsdp_dim(full, self.fsdp, skip=tdim, transposed=linear and p.ndim == 2)
            if self.shard and self.fsdp == 1 and p.ndim >= 1:
                fdim = max(range(p.ndim), key=lambda i: p.shape[i])
            if not self.shard:
                fdim = None
            leaf = Leaf(name, p, kind, fdim, tuple(full), partial)
            if fdim is not None:
                leaf.moved = tuple(p.movedim(fdim, 0).shape)
                leaf.n = p.numel() // self.fsdp
            self.leaves.append(leaf)
        self.root = Unit("", model)
        self.units: List[Unit] = self._make_units() if self.shard else []
        off = 0
        for unit in self.units:
            for leaf in unit.leaves:
                leaf.off = off
                off += leaf.n
            unit.buckets = self._bucketize(unit.leaves)
        self.masters = torch.empty(off, dtype=torch.float32, device=dev)
        self.master_grads = torch.zeros(off, dtype=torch.float32, device=dev)
        self._place(dev, seed)
        # the replicated leaves' gradients, all-reduced after the backward
        self.whole_buckets = self._bucketize([leaf for leaf in self.leaves if leaf.fdim is None])
        self.peak_whole = 0   # the most units whole at once (reset_peak)
        self._uses: List[Unit] = []  # this graph's forward uses, in order
        self._nodes: list = []       # each use's outputs' autograd nodes
        self._live: List[bool] = []  # whether the backward reaches them
        self._entered: set = set()   # the uses whose backward began
        self._seq: List[Unit] = []   # the forward's units, for the next forward's prefetch
        self._seq_prev: List[Unit] = []
        self._task = None
        self._stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        for unit in self.units:
            self._hook(unit)

    # -------------------------------------------------------- placement

    def _make_units(self) -> List[Unit]:
        """The root, then each item of FourM's containers; every sharded
        leaf in the unit of its module (a `mod_emb` in the root)."""
        units = {}
        for c in UNIT_CONTAINERS:
            mods = getattr(self.model, c, None)
            if isinstance(mods, (nn.ModuleDict, nn.ModuleList)):
                for key, m in (mods.items() if isinstance(mods, nn.ModuleDict)
                               else enumerate(mods)):
                    units[f"{c}.{key}"] = Unit(f"{c}.{key}", m)
        for leaf in self.leaves:
            if leaf.fdim is None:
                continue
            key = ".".join(leaf.name.split(".")[:2])
            unit = self.root if leaf.name.endswith(".mod_emb") else units.get(key, self.root)
            unit.leaves.append(leaf)
        return [self.root] + [u for u in units.values() if u.leaves]

    def _place(self, dev: torch.device, seed: Optional[int]) -> None:
        """Each leaf's chunk into the masters (a meta leaf drawn whole first,
        in parameter order, the rank's tensor slice taken); a sharded
        parameter keeps its shape over an empty storage, a replicated one
        its whole tensor."""
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        slots = _parameter_slots(self.model)
        with torch.no_grad():
            for leaf in self.leaves:
                p = leaf.param
                if p.is_meta:
                    if gen is None:
                        raise ValueError(f"{leaf.name} is on the meta device: give the seed of "
                                         "its init_weights draws")
                    owner_name, attr = (leaf.name.rsplit(".", 1) if "." in leaf.name
                                        else ("", leaf.name))
                    t = init_value(self.model.get_submodule(owner_name), attr, leaf.full, gen,
                                   dev)
                    if leaf.tkind is not None:
                        t = tp_slice(leaf.tkind, t, self.tensor, self.tensor_rank)
                else:
                    t = p.detach()
                if leaf.fdim is None:
                    if p.is_meta:
                        leaf.param = _replace_parameter(slots, p, t.contiguous())
                    continue
                self.master(leaf).copy_(self._chunk(t, leaf))
                del t
                if p.is_meta:
                    leaf.param = _replace_parameter(slots, p, _empty_whole(p.shape, dev))
                else:
                    p.data = _empty_whole(p.shape, dev)

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

    # ---------------------------------------------------------- units

    def _hook(self, unit: Unit) -> None:
        """The unit's gradient hooks, and its module's methods wrapped:
        the entry methods gather, the others raise while it is in chunks."""
        with torch.enable_grad():
            for leaf in unit.leaves:
                if leaf.param.requires_grad:
                    leaf.acc = leaf.param.view_as(leaf.param).grad_fn.next_functions[0][0]
                    leaf.param.register_post_accumulate_grad_hook(
                        lambda _p, unit=unit, leaf=leaf: self._accumulated(unit, leaf))
        m = unit.module
        for cls in type(m).__mro__:
            if cls is nn.Module:
                break
            for name, fn in vars(cls).items():
                if name.startswith("_") or not inspect.isfunction(fn) or name in m.__dict__:
                    continue
                bound = getattr(m, name)
                m.__dict__[name] = (self._entry(unit, bound) if name in ENTRY_METHODS
                                    else self._guard(unit, name, bound))

    def _guard(self, unit: Unit, name: str, fn):
        def call(*a, **k):
            if not unit.whole or unit.ready is not None:
                raise ShardedUnitError(
                    f"{type(unit.module).__name__}.{name} ({unit.name or 'the root'}): its "
                    f"parameters are 1 / {self.fsdp} chunks between calls of its "
                    f"{', '.join(n for n in ENTRY_METHODS if hasattr(unit.module, n))}, "
                    "which alone gather them (parallel/shard.py)")
            return fn(*a, **k)
        return call

    def _entry(self, unit: Unit, fn):
        def call(*a, **k):
            if torch._C._current_graph_task_id() != -1:
                self._need(unit)  # a remat recomputation, inside the backward's gather
                return fn(*a, **k)
            if unit.depth:
                return fn(*a, **k)
            if unit is self.root:
                return self._root_call(fn, a, k)
            grad = torch.is_grad_enabled()
            self._need(unit)
            self._forward_use(unit)
            if grad:
                i = len(self._uses)
                self._uses.append(unit)
                self._nodes.append([])
                ins = _needing_grad((a, k))
                if ins:  # its gradient made: the use's backward is done
                    ins[0].register_hook(lambda _g: self._post_backward(i))
            unit.depth += 1
            try:
                out = fn(*a, **k)
            finally:
                unit.depth -= 1
                self._free(unit)
            if grad:  # before the backward of its outputs: gather
                nodes = {id(t.grad_fn): t.grad_fn for t in _needing_grad(out)
                         if t.grad_fn is not None}
                for node in nodes.values():
                    node.register_prehook(lambda _g: self._pre_backward(i))
                self._nodes[i] = list(nodes.values())
            return out
        return call

    def _root_call(self, fn, a, k):
        """FourM.forward: the root whole for it and, when a graph follows,
        for its backward."""
        self._release_all()  # what a graph never backpropagated left whole
        self._seq_prev, self._seq = self._seq or self._seq_prev, []
        self._need(self.root)
        self.root.depth += 1
        try:
            out = fn(*a, **k)
        except BaseException:
            self.root.depth -= 1
            self._release_all()
            raise
        self.root.depth -= 1
        if not _needing_grad(out):
            self._release_all()
        return out

    def _forward_use(self, unit: Unit) -> None:
        """Record the use; prefetch the unit the last forward used next."""
        pos = len(self._seq)
        self._seq.append(unit)
        prev = self._seq_prev
        if pos + 1 < len(prev) and prev[pos] is unit:
            self._prefetch(prev[pos + 1])

    def _gather(self, unit: Unit, side: bool) -> None:
        """The unit's chunks all-gathered into its whole parameters (on the
        side stream when `side`, its event then in unit.ready)."""
        for leaf in unit.leaves:
            leaf.param.untyped_storage().resize_(leaf.param.numel() * 4)
        if side and self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                self._fill(unit)
                unit.ready = torch.cuda.Event()
                unit.ready.record()
        else:
            self._fill(unit)
        unit.whole = True
        self.peak_whole = max(self.peak_whole, sum(u.whole for u in self.units))

    def _fill(self, unit: Unit) -> None:
        with torch.no_grad():
            for bucket in unit.buckets:
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
                    # .data: the saved tensors' version counter stays
                    leaf.param.data.copy_(whole.movedim(0, leaf.fdim))

    def _need(self, unit: Unit) -> None:
        """The unit whole and its gather done, for the current stream."""
        if not unit.whole:
            self._gather(unit, side=False)
        if unit.ready is not None:
            torch.cuda.current_stream().wait_event(unit.ready)
            unit.ready = None

    def _prefetch(self, unit: Unit) -> None:
        if not unit.whole and unit.leaves:
            self._gather(unit, side=True)

    def _free(self, unit: Unit) -> None:
        if not unit.whole:
            return
        if unit.ready is not None:
            torch.cuda.current_stream().wait_event(unit.ready)
            unit.ready = None
        for leaf in unit.leaves:
            leaf.param.untyped_storage().resize_(0)
        unit.whole = False

    def _release_all(self) -> None:
        for unit in self.units:
            self._free(unit)
            unit.due = set()
        self._uses, self._nodes, self._live, self._task = [], [], [], None

    def reset_peak(self) -> None:
        self.peak_whole = sum(u.whole for u in self.units)

    # ------------------------------------------------- the backward

    def _in_backward(self) -> None:
        """At a graph's first hook: which leaves it will give a gradient,
        and the callback at its end."""
        task = torch._C._current_graph_task_id()
        if task == self._task:
            return
        self._task = task
        will = torch._C._will_engine_execute_node
        for unit in self.units:
            unit.due = {id(l) for l in unit.leaves if l.acc is not None and will(l.acc)}
        self._live = [any(map(will, nodes)) for nodes in self._nodes]
        self._entered = set()
        torch.autograd.Variable._execution_engine.queue_callback(self._end_backward)

    def _pre_backward(self, i: int) -> None:
        """Before the backward of use i: its unit whole; the gather of the
        unit whose backward comes next started."""
        self._in_backward()
        if i in self._entered:
            return
        self._entered.add(i)
        unit = self._uses[i]
        self._need(unit)
        for j in range(i - 1, -1, -1):
            if self._live[j] and self._uses[j] is not unit:
                self._prefetch(self._uses[j])
                break

    def _post_backward(self, i: int) -> None:
        """After the backward of use i (its first input's gradient made,
        before the nodes that made that input run: the engine's order; hooks
        leave its graph as it is): its unit's parameters freed (a tied
        one's gradient may still wait)."""
        self._in_backward()
        unit = self._uses[i]
        if unit.depth == 0:
            self._free(unit)

    def _accumulated(self, unit: Unit, leaf: Leaf) -> None:
        self._in_backward()
        unit.due.discard(id(leaf))
        if not unit.due:
            self._reduce_unit(unit)

    def _end_backward(self) -> None:
        for unit in self.units:
            if unit.due:  # a gradient the engine never gave: zero
                self._reduce_unit(unit)
            self._free(unit)
        self._uses, self._nodes, self._live, self._task = [], [], [], None

    def _reduce_unit(self, unit: Unit) -> None:
        """The unit's whole gradients (this rank's batch) summed over the
        fsdp ranks into its chunks of master_grads (added to them after the
        step's first microbatch); the gradients and parameters freed."""
        with torch.no_grad():
            part = [l.param.grad for l in unit.leaves if l.partial and l.param.grad is not None]
            if part:
                _sum_into(part, lambda flat: self._reduce(flat, ("tensor",)))
            for bucket in unit.buckets:
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
                dst = torch.empty_like(out) if unit.written else out
                if self.fsdp > 1:
                    _reduce_scatter(dst, inp.view(-1), self.groups["fsdp"])
                else:
                    dst.copy_(inp[0])
                if unit.written:
                    out.add_(dst)
        unit.written, unit.due = True, set()
        self._free(unit)

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

    def reduce_grads(self) -> List[Optional[torch.Tensor]]:
        """After the step's backward(s): the sharded leaves' chunks of
        master_grads (reduce-scattered by the backward) summed over the data
        ranks, the replicated leaves' gradients (the model's `.grad`) over
        every batch rank. -> one gradient per leaf, in the optimizer's
        order."""
        with torch.no_grad():
            for unit in self.units:
                if unit.leaves and not unit.written:  # no gradient this step
                    self.master_grads[unit.leaves[0].off:
                                      unit.leaves[-1].off + unit.leaves[-1].n].zero_()
                unit.written = False
            part = [l.param.grad for l in self.leaves
                    if l.partial and l.fdim is None and l.param.grad is not None]
            if part:
                _sum_into(part, lambda flat: self._reduce(flat, ("tensor",)))
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
        0 (None, None elsewhere): what a single card's checkpoint holds,
        gathered from the chunks."""
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

    def load_full(self, model_state: dict, optimizer=None, opt_state: Optional[dict] = None,
                  strict: bool = True) -> None:
        """Copy whole tensors (a checkpoint's, any mesh's) into this rank's
        masters (a replicated leaf's parameter) and moments. strict=False
        (a warm start) leaves the parameters the state lacks as they are."""
        with torch.no_grad():
            for name, b in self.model.named_buffers():
                if name in model_state:
                    b.copy_(model_state[name])
            for leaf in self.leaves:
                if leaf.name not in model_state and not strict:
                    continue
                for src, dst in ((model_state, None), (opt_state and opt_state["mu"], "mu"),
                                 (opt_state and opt_state["nu"], "nu")):
                    if src is None:
                        continue
                    t = src[leaf.name].to(self.masters.device, torch.float32)
                    if leaf.tkind is not None:
                        t = tp_slice(leaf.tkind, t, self.tensor, self.tensor_rank)
                    if dst is None:
                        self.master(leaf).copy_(t if leaf.fdim is None else self._chunk(t, leaf))
                        continue
                    target = getattr(optimizer, dst)[leaf.name]
                    target.copy_(self._chunk(t, leaf) if leaf.fdim is not None else t)
        if optimizer is not None and opt_state is not None:
            count = int(opt_state["count"])
            optimizer._count.fill_(count)
            optimizer._calls, optimizer._bound = 0, count

    def param_bytes(self) -> Dict[str, int]:
        """This rank's bytes of parameters (the storages the model's
        parameters hold now: none for a sharded one between steps), of fp32
        masters and of the masters' share of the two moments."""
        storages = {}
        for p in self.model.parameters():
            s = p.untyped_storage()
            storages[s.data_ptr()] = max(storages.get(s.data_ptr(), 0), s.nbytes())
        masters = sum(self.master(l).numel() * 4 for l in self.leaves)
        return {"parameters": sum(storages.values()), "masters": masters,
                "moments": 2 * masters}
