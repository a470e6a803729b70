"""Transformer primitives of the PyTorch port (inference and training).

Counterparts of fourm_tpu/ops/transformer.py: pre-LN blocks, bias-optional
LayerNorm, SwiGLU gated MLP, attention with boolean masks (True = masked
out), optional QK-norm and softmax-off-by-one. Submodule names follow the
reference torch tree (qkv/proj/fc1/fc2/fc3/norm1/query_norm/...), so a
reference state dict loads with `load_state_dict`.

The pre-norm halves of every block always go through the kernel wrappers
(fourm_torch/kernels). The attention half of a short sequence (N <= 1024)
without QK-norm under a key-only mask is one `attn_block`, or, where that
kernel's shared memory cannot hold the sequence, `ln_matmul` + `mha_short`;
otherwise LN -> QKV is `ln_matmul` and self-attention is `flash_mha` (QK-norm
in the kernel). Cross-attention is `attention`, the MLP half is `ln_mlp`.
`Attention.forward` (a block without the pre-norm fusion, e.g. the VQ
teachers) takes `mha_short` on the same short, unnormed, key-masked cases.
A KV-cached decode step (`DecoderBlock.step`) goes through `self_decode`,
`cross_decode_attn` (bf16 or int8 cross K/V) and `residual_mlp`. On CUDA tensors those launch the
hand-written kernels; on CPU tensors they compute their plain twins, which
equal the XLA path of the JAX package up to summation order. The kernels
take bf16 alone: a model that computes in another dtype calls the plain
twins on the card too (`_kernels`), and a wrapper raises on any call its
kernel does not take. Parameters may be held in any float
dtype; like the JAX modules, each product casts them to the compute dtype.

The training forward (`train=True`, the counterpart of JAX's
`deterministic=False`, passed down explicitly: nn.Module.training is not
read) is differentiable end to end: LayerNorms as plain fp32 ops, products
as `_dense`, the MLPs as `Mlp` / `GatedMlp`, every attention core through
`attention_train` (forward and backward kernels) unless its gate (bf16,
the bias layout, the head dim) refuses the problem, and each branch
through `DropPath` before its residual add (transformer.py:821-824,
:878-885). The inference kernels have no
backward and never run in a train step.

Tensor parallelism (parallel/shard.py:shard_tensor_parallel): a split
Attention / CrossAttention / MLP holds its rank's heads or hidden features
and a `tp` group (ops/tensor_parallel.py); its input passes f and its
row-parallel product g, whose bias is added once after the all-reduce. The
kernels take the rank's local tensors: `ln_matmul` the head-aligned qkv
rows, `flash_mha` / `mha_short` / `attention` / `attention_train` the
rank's heads. `attn_block` and `ln_mlp` add the residual inside the kernel,
before the all-reduce could sum the partial products: a split attention
takes `ln_matmul` + the attention kernel instead of `attn_block`, and a
split MLP the plain products (`_mlp_fuses`). Under data parallelism the
stochastic-depth masks are drawn for the global batch and each rank takes
its rows (`RankDraws`), so that N ranks draw what one would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import (attention, attention_plain, attn_block, attn_block_plain,
                                 attn_block_takes, flash_mha, flash_mha_plain, mha_short,
                                 mha_short_plain)
from ..kernels.attention import softmax1  # noqa: F401  (re-exported, as in fourm_tpu)
from ..kernels.attention_train import (attention_train, attention_train_fwd_plain,
                                       attention_train_takes)
from ..kernels.decode_step import (cross_decode_attn, cross_decode_attn_plain, residual_mlp,
                                   residual_mlp_plain, self_decode, self_decode_plain)
from ..kernels.fused_mlp import layer_norm_fp32, ln_matmul, ln_matmul_plain, ln_mlp, ln_mlp_plain
from .tensor_parallel import copy_to_group, reduce_from_group

# Finite fill for masked logits (reference masked_fill(-finfo.max), fm_utils.py:168):
# a fully masked row gets uniform weights instead of NaN.
MASK_FILL_VALUE = torch.finfo(torch.float32).min


def mask_to_bias(mask: Optional[torch.Tensor], num_query: int) -> Optional[torch.Tensor]:
    """Boolean mask (B, K), (B, 1, K) or (B, Q, K), True = masked out, to an
    fp32 additive bias (B, 1, Q or 1, K), broadcastable over heads."""
    if mask is None:
        return None
    if mask.ndim == 2:
        mask = mask[:, None, :]
    if mask.ndim != 3:
        raise ValueError(f"mask must be 2D or 3D, got shape {tuple(mask.shape)}")
    bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    bias = bias.masked_fill(mask, MASK_FILL_VALUE)
    return bias[:, None, :, :]


def _key_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, M) fp32 key bias from a (B, M) or (B, 1, M) mask."""
    if mask is None:
        return None
    m2 = mask if mask.ndim == 2 else mask[:, 0]
    return torch.where(m2, MASK_FILL_VALUE, 0.0).to(torch.float32)


def _kernels(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """The block layer's one route, the counterpart of the JAX package's
    _fused_eligible -> XLA (ops/transformer.py:732-754): a block that
    computes in bf16 calls the kernel wrappers (on the card their CUDA
    kernels, which raise on a call they do not take; on the CPU their plain
    twins). A block that computes in another dtype, such as a float32
    model, calls the plain twins itself on the card: the kernels are built
    for bf16 alone."""
    return dtype == torch.bfloat16 or x.device.type == "cpu"


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          allow_zero_attn: bool = False, train: bool = False) -> torch.Tensor:
    """Attention core. q, k, v: (B, H, N|M, Dh); bias fp32 (B, 1|H, N|1, M).
    Inference goes through the `attention` kernel (its plain twin on the
    CPU, or for a compute dtype other than bf16). `train` makes it
    differentiable: `attention_train` where its gate takes the problem (bf16
    on the card), else the plain autograd ops (as JAX falls back to XLA,
    ops/transformer.py:256-264)."""
    if not train:
        return (attention if _kernels(q, q.dtype) else attention_plain)(
            q, k, v, bias, allow_zero_attn)
    if attention_train_takes(q, k, bias):
        return attention_train(q, k, v, bias, allow_zero_attn)
    return attention_train_fwd_plain(q, k, v, bias, allow_zero_attn)


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """nn.Dense(dtype=dtype) semantics: input, weight and bias cast to the
    compute dtype, then one product."""
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


def _tp_in(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of a split module's column-parallel products (f)."""
    return x if tp is None else copy_to_group(x, tp)


def _row_dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype, tp) -> torch.Tensor:
    """_dense of a row-parallel product: the ranks' partial products summed
    (g), then the bias, once."""
    if tp is None:
        return _dense(x, lin, dtype)
    y = reduce_from_group(F.linear(x.to(dtype), lin.weight.to(dtype)), tp)
    return y if lin.bias is None else y + lin.bias.to(dtype)


class LayerNorm(nn.Module):
    """LayerNorm with an optional bias (reference fm_utils.py:93-112); fp32
    statistics, output in the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_fp32(x.float(), self.weight, self.bias, self.eps).to(self.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


ACTIVATIONS = {"gelu": gelu_exact, "tanh": torch.tanh}


def rows_padded(w: torch.Tensor) -> torch.Tensor:
    """w (C, HID) as the (C, HID) view of zero-padded (C, HID rounded up to
    8) storage: each row starts a multiple of 16 bytes in, so TMA
    reads the weight in place (kernels/decode_step.py:_w2_for_tma)."""
    C, HID = w.shape
    buf = torch.zeros((C, -(-HID // 8) * 8), dtype=w.dtype, device=w.device)
    buf[:, :HID].copy_(w)
    return buf[:, :HID]


class _PaddedFc2(nn.Module):
    """Keeps a bf16 fc2 weight whose hidden width is not a multiple of 8
    (SwiGLU at 4M-L / 4M-XL: 2730, 5461) in zero-padded storage after every
    conversion (`.to()`, `.cuda()`, `.bfloat16()`), so the decode step's
    residual_mlp kernel reads the weight itself, never a copy that an
    in-place update (load_state_dict, `.data.copy_`, inference mode) could
    leave stale. Updates in place keep the storage."""

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        w = self.fc2.weight
        if w.dtype == torch.bfloat16 and w.shape[1] % 8 and w.stride(0) % 8:
            with torch.no_grad():
                w.data = rows_padded(w.data)
        return self


class Mlp(_PaddedFc2):
    """Two-layer MLP (reference fm_utils.py:114-126); `act` names the
    activation: exact-erf GELU, or tanh for the VQ encoders' post-MLP."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: Optional[int] = None,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32, act: str = "gelu"):
        super().__init__()
        self.dtype = dtype
        self.act = ACTIVATIONS[act]
        self.fc1 = nn.Linear(dim, hidden_dim, bias=use_bias)
        self.fc2 = nn.Linear(hidden_dim, out_dim or dim, bias=use_bias)

    tp = None  # a TensorGroup once split (hidden features over the ranks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _tp_in(x, self.tp)
        return _row_dense(self.act(_dense(x, self.fc1, self.dtype)), self.fc2, self.dtype,
                          self.tp)


class GatedMlp(_PaddedFc2):
    """SwiGLU MLP (reference fm_utils.py:128-144). `hidden_dim` is the
    ungated width; the actual width is int(2 * hidden_dim / 3)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: Optional[int] = None,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        hidden = int(2 * hidden_dim / 3)
        self.fc1 = nn.Linear(dim, hidden, bias=use_bias)
        self.fc2 = nn.Linear(hidden, out_dim or dim, bias=use_bias)
        self.fc3 = nn.Linear(dim, hidden, bias=use_bias)

    tp = None  # a TensorGroup once split (hidden features over the ranks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _tp_in(x, self.tp)
        g = _dense(x, self.fc1, self.dtype)
        u = _dense(x, self.fc3, self.dtype)
        return _row_dense(F.silu(g) * u, self.fc2, self.dtype, self.tp)


class Attention(nn.Module):
    """Multi-head self-attention with optional QK-norm (reference Attention /
    NormAttention, fm_utils.py:147-262). Masks are boolean, True = masked."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_bias: bool = True, qk_norm: bool = False,
                 allow_zero_attn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.qk_norm, self.allow_zero_attn, self.dtype = qk_norm, allow_zero_attn, dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=proj_bias)
        if qk_norm:
            self.q_norm = LayerNorm(self.head_dim, dtype=dtype)
            self.k_norm = LayerNorm(self.head_dim, dtype=dtype)

    tp = None  # a TensorGroup once split (num_heads is then this rank's)

    def _split_qkv(self, x):
        B, N, _ = x.shape
        qkv = _dense(x, self.qkv, self.dtype).reshape(B, N, 3, self.num_heads, self.head_dim)
        q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]  # (B, H, N, Dh)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        return q, k, v

    def _short(self, N: int, mask: Optional[torch.Tensor]) -> bool:
        """The cases the JAX package sends to pallas_mha_short / attn_block:
        no QK-norm, N <= 1024, no mask or a key-only one (B, M) / (B, 1, M)."""
        return (not self.qk_norm and N <= 1024
                and (mask is None or mask.ndim == 2 or (mask.ndim == 3 and mask.shape[1] == 1)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        B, N, _ = x.shape
        x = _tp_in(x, self.tp)
        if train:
            q, k, v = self._split_qkv(x)
            out = dot_product_attention(q, k, v, mask_to_bias(mask, N), self.allow_zero_attn,
                                        train=True)
            return _row_dense(out.transpose(1, 2).reshape(B, N, -1), self.proj, self.dtype,
                              self.tp)
        if self._short(N, mask):
            out = (mha_short if _kernels(x, self.dtype) else mha_short_plain)(
                _dense(x, self.qkv, self.dtype), self.num_heads, _key_bias(mask),
                self.allow_zero_attn)
            return _row_dense(out, self.proj, self.dtype, self.tp)
        q, k, v = self._split_qkv(x)
        out = dot_product_attention(q, k, v, mask_to_bias(mask, N), self.allow_zero_attn)
        return _row_dense(out.transpose(1, 2).reshape(B, N, -1), self.proj, self.dtype, self.tp)

    def fused_prenorm(self, x: torch.Tensor, norm: LayerNorm,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pre-norm attention half, residual included: x + proj(MHA(qkv(LN x))).
        A short unnormed sequence is one `attn_block` (transformer.py:469-490),
        or `ln_matmul` + `mha_short` past what that kernel holds on the card
        (attn_block_takes). Otherwise LN ->
        QKV is one `ln_matmul`; `flash_mha` reads q/k/v as column slices of
        its output and applies the QK-norm itself. A query-dependent
        (B, N, N) mask, which a key bias cannot express, takes the generic
        path through `attention`. Split over a tensor group, the rank's heads
        take `ln_matmul` + `mha_short` / `flash_mha` and the row-parallel
        projection (attn_block adds the residual before the all-reduce)."""
        B, N, C = x.shape
        if mask is not None and mask.ndim == 3 and mask.shape[1] != 1:
            return x + self.forward(norm(x), mask)
        w = self.qkv.weight.to(self.dtype)
        kern = _kernels(x, self.dtype)
        if self.tp is None and self._short(N, mask) and (
                not kern or attn_block_takes(N, C, x.device, self.num_heads)):
            return (attn_block if kern else attn_block_plain)(
                x, norm.weight, norm.bias, w, self.qkv.bias, self.proj.weight.to(self.dtype),
                self.proj.bias, self.num_heads, _key_bias(mask), eps=norm.eps,
                allow_zero_attn=self.allow_zero_attn)
        qkv = (ln_matmul if kern else ln_matmul_plain)(x, norm.weight, norm.bias, w,
                                                       self.qkv.bias, eps=norm.eps)
        if self._short(N, mask):
            out = (mha_short if kern else mha_short_plain)(qkv, self.num_heads, _key_bias(mask),
                                                           self.allow_zero_attn)
            return x + _row_dense(out, self.proj, self.dtype, self.tp)
        if self.qk_norm:
            qn = (self.q_norm.weight, self.q_norm.bias, self.k_norm.weight, self.k_norm.bias)
        else:
            qn = (None, None, None, None)
        Cl = self.num_heads * self.head_dim  # this rank's heads
        out = (flash_mha if kern else flash_mha_plain)(
            qkv[:, :, :Cl], qkv[:, :, Cl:2 * Cl], qkv[:, :, 2 * Cl:], self.num_heads,
            _key_bias(mask), *qn, eps=norm.eps, allow_zero_attn=self.allow_zero_attn)
        return x + _row_dense(out, self.proj, self.dtype, self.tp)


class CrossAttention(nn.Module):
    """Multi-head cross-attention with optional QK-norm (reference
    CrossAttention / NormCrossAttention, fm_utils.py:182-307)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_bias: bool = True, qk_norm: bool = False,
                 allow_zero_attn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.qk_norm, self.allow_zero_attn, self.dtype = qk_norm, allow_zero_attn, dtype
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=proj_bias)
        if qk_norm:
            self.q_norm = LayerNorm(self.head_dim, dtype=dtype)
            self.k_norm = LayerNorm(self.head_dim, dtype=dtype)

    tp = None  # a TensorGroup once split (num_heads is then this rank's)

    def project_kv(self, context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, M, _ = context.shape
        kv = _dense(context, self.kv, self.dtype).reshape(B, M, 2, self.num_heads, self.head_dim)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        if self.qk_norm:
            k = self.k_norm(k)
        return k, v

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        q = _dense(x, self.q, self.dtype).reshape(B, N, self.num_heads, self.head_dim)
        q = q.transpose(1, 2)
        return self.q_norm(q) if self.qk_norm else q

    def attend(self, x, k, v, mask=None, train: bool = False):
        B, N, _ = x.shape
        q = self.project_q(x)
        out = dot_product_attention(q, k, v, mask_to_bias(mask, N), self.allow_zero_attn,
                                    train=train)
        return _row_dense(out.transpose(1, 2).reshape(B, N, -1), self.proj, self.dtype, self.tp)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        k, v = self.project_kv(_tp_in(context, self.tp))
        return self.attend(_tp_in(x, self.tp), k, v, mask, train)


@dataclass(frozen=True)
class RankDraws:
    """The stochastic-depth draws of a data-parallel rank: `generator` (the
    default one if None) draws each mask for the global batch of count * B
    rows, shared by the ranks, and the rank's batch of B is rows [index * B,
    (index + 1) * B) of it. Passed where a generator goes (FourM.forward's
    `generator`), so that N ranks draw what one would."""

    generator: Optional[torch.Generator]
    index: int
    count: int


def draw_keep(x: torch.Tensor, drop_prob: float,
              generator: Optional[torch.Generator | RankDraws] = None) -> torch.Tensor:
    """The per-sample keep mask of drop_path, (B, 1, ...) bool, drawn from
    `generator` (the default one if None); for a RankDraws the global
    batch's, of which the rank's rows."""
    B = x.shape[0]
    index, count = 0, 1
    if isinstance(generator, RankDraws):
        index, count, generator = generator.index, generator.count, generator.generator
    shape = (B * count,) + (1,) * (x.ndim - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - drop_prob
    return keep[index * B:(index + 1) * B] if count > 1 else keep


def drop_path(x: torch.Tensor, drop_prob: float, train: bool,
              generator: Optional[torch.Generator] = None,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic depth per sample (reference fm_utils.py:66-90;
    fourm_tpu/ops/transformer.py:703-712): in training, each sample's branch
    is kept with probability 1 - drop_prob and scaled by its inverse, or
    zeroed. The keep mask is `keep` when given (drawn beforehand by
    draw_keep, as a recomputed block must reuse it), else drawn here."""
    if drop_prob == 0.0 or not train:
        return x
    keep_prob = 1.0 - drop_prob
    if keep is None:
        keep = draw_keep(x, drop_prob, generator)
    return torch.where(keep, x / keep_prob, 0.0).to(x.dtype)


class DropPath(nn.Module):
    """drop_path with a fixed rate (transformer.py:715-722)."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        return drop_path(x, self.drop_prob, train, generator, keep)

    def draw_keeps(self, x: torch.Tensor, n: int,
                   generator: Optional[torch.Generator] = None) -> tuple:
        """The keep masks of a block's n branches in the order its forward
        draws them (None each at rate 0, where nothing is drawn)."""
        if self.drop_prob == 0.0:
            return (None,) * n
        return tuple(draw_keep(x, self.drop_prob, generator) for _ in range(n))


def _make_mlp(gated_mlp: bool, act: str, dim: int, mlp_ratio: float, mlp_bias: bool, dtype):
    # the ln_mlp kernel computes the two MLPs of the 4M registry flavours
    if (gated_mlp, act) not in ((True, "silu"), (False, "gelu")):
        raise ValueError(f"unsupported MLP: gated={gated_mlp} act={act!r} "
                         "(the port serves gated SiLU and plain exact GELU)")
    cls = GatedMlp if gated_mlp else Mlp
    return cls(dim, int(dim * mlp_ratio), use_bias=mlp_bias, dtype=dtype)


def _mlp_fuses(mlp: nn.Module) -> bool:
    """Whether the MLP half goes through `ln_mlp`: not for an MLP split over
    a tensor group, whose fc2 gives a partial sum that the kernel would add
    to the residual before the all-reduce; that one takes the plain
    products and the all-reduce."""
    return mlp.tp is None


def _fused_ln_mlp(norm: LayerNorm, mlp: nn.Module, x: torch.Tensor, gated: bool):
    """x + mlp(norm(x)) through the `ln_mlp` kernel (split: _mlp_fuses)."""
    if not _mlp_fuses(mlp):
        return x + mlp(norm(x))
    dt = mlp.dtype
    w3 = mlp.fc3.weight.to(dt) if gated else None
    b3 = mlp.fc3.bias if gated else None
    return (ln_mlp if _kernels(x, dt) else ln_mlp_plain)(
        x, norm.weight, norm.bias, mlp.fc1.weight.to(dt), mlp.fc1.bias, mlp.fc2.weight.to(dt),
        mlp.fc2.bias, w3, b3, eps=norm.eps, gated=gated)


class Block(nn.Module):
    """Pre-LN encoder block (reference fm_utils.py:310-334)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True, mlp_bias: bool = True,
                 act: str = "gelu", gated_mlp: bool = False, qk_norm: bool = False,
                 allow_zero_attn: bool = False, norm_bias: bool = True,
                 dtype: torch.dtype = torch.float32, drop_path_rate: float = 0.0):
        super().__init__()
        self.gated_mlp = gated_mlp
        self.attn = Attention(dim, num_heads, qkv_bias, proj_bias, qk_norm,
                              allow_zero_attn, dtype)
        self.norm1 = LayerNorm(dim, use_bias=norm_bias, dtype=dtype)
        self.norm2 = LayerNorm(dim, use_bias=norm_bias, dtype=dtype)
        self.mlp = _make_mlp(gated_mlp, act, dim, mlp_ratio, mlp_bias, dtype)
        self.drop_path = DropPath(drop_path_rate)

    BRANCHES = 2  # drop-path draws of one training forward

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                keeps: Optional[tuple] = None) -> torch.Tensor:
        if train:
            dp = self.drop_path
            k = keeps or (None,) * self.BRANCHES
            x = x + dp(self.attn(self.norm1(x), mask, train=True), True, generator, k[0])
            return x + dp(self.mlp(self.norm2(x)), True, generator, k[1])
        x = self.attn.fused_prenorm(x, self.norm1, mask)
        return _fused_ln_mlp(self.norm2, self.mlp, x, self.gated_mlp)


class CrossAttentionBlock(nn.Module):
    """Cross-attention + MLP block (reference fm_utils.py:369-388;
    fourm_tpu/ops/transformer.py:1016), with the JAX module's fields. In
    bf16 the cross half is the `attention` kernel and the MLP half
    `ln_mlp`, as DecoderBlock's are."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path_rate: float = 0.0, act: str = "gelu",
                 gated_mlp: bool = False, allow_zero_attn: bool = False,
                 norm_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gated_mlp = gated_mlp
        self.cross_attn = CrossAttention(dim, num_heads, qkv_bias,
                                         allow_zero_attn=allow_zero_attn, dtype=dtype)
        self.query_norm = LayerNorm(dim, use_bias=norm_bias, dtype=dtype)
        self.context_norm = LayerNorm(dim, use_bias=norm_bias, dtype=dtype)
        self.norm2 = LayerNorm(dim, use_bias=norm_bias, dtype=dtype)
        self.mlp = _make_mlp(gated_mlp, act, dim, mlp_ratio, True, dtype)
        self.drop_path = DropPath(drop_path_rate)

    BRANCHES = 2  # drop-path draws of one training forward

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                xa_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                keeps: Optional[tuple] = None) -> torch.Tensor:
        xa = self.cross_attn(self.query_norm(x), self.context_norm(context), xa_mask,
                             train=train)
        if train:
            k = keeps or (None,) * self.BRANCHES
            x = x + self.drop_path(xa, True, generator, k[0])
            return x + self.drop_path(self.mlp(self.norm2(x)), True, generator, k[1])
        return _fused_ln_mlp(self.norm2, self.mlp, x + xa, self.gated_mlp)


class DecoderBlock(nn.Module):
    """Pre-LN decoder block: self-attention, cross-attention, MLP (reference
    fm_utils.py:337-366) over a full query grid, and its KV-cached decode
    step."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True, mlp_bias: bool = True,
                 act: str = "gelu", gated_mlp: bool = False, qk_norm: bool = False,
                 allow_zero_attn: bool = False, norm_bias: bool = True,
                 dtype: torch.dtype = torch.float32, drop_path_rate: float = 0.0):
        super().__init__()
        self.gated_mlp = gated_mlp
        common = (dim, num_heads, qkv_bias, proj_bias, qk_norm, allow_zero_attn, dtype)
        self.self_attn = Attention(*common)
        self.cross_attn = CrossAttention(*common)
        self.norm1 = LayerNorm(dim, use_bias=norm_bias, dtype=dtype)
        self.query_norm = LayerNorm(dim, use_bias=norm_bias, dtype=dtype)
        self.context_norm = LayerNorm(dim, use_bias=norm_bias, dtype=dtype)
        self.norm2 = LayerNorm(dim, use_bias=norm_bias, dtype=dtype)
        self.mlp = _make_mlp(gated_mlp, act, dim, mlp_ratio, mlp_bias, dtype)
        self.drop_path = DropPath(drop_path_rate)

    BRANCHES = 3  # drop-path draws of one training forward

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                sa_mask: Optional[torch.Tensor] = None,
                xa_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                keeps: Optional[tuple] = None) -> torch.Tensor:
        if train:
            dp = self.drop_path
            k = keeps or (None,) * self.BRANCHES
            x = x + dp(self.self_attn(self.norm1(x), sa_mask, train=True), True, generator, k[0])
            x = x + dp(self.cross_attn(self.query_norm(x), self.context_norm(context), xa_mask,
                                       train=True), True, generator, k[1])
            return x + dp(self.mlp(self.norm2(x)), True, generator, k[2])
        x = self.self_attn.fused_prenorm(x, self.norm1, sa_mask)
        x = x + self.cross_attn(self.query_norm(x), self.context_norm(context), xa_mask)
        return _fused_ln_mlp(self.norm2, self.mlp, x, self.gated_mlp)

    def cross_kv(self, context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """This block's cross-attention K/V for decoding, (B, H, M, Dh) head
        views of one KV projection (fourm_tpu transformer.py:888-891; the
        port keeps project_kv's layout, the decode kernels read it through
        its strides)."""
        return self.cross_attn.project_kv(self.context_norm(context))

    def step(self, x_t: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
             cross_k, cross_v, xa_bias: Optional[torch.Tensor], step_idx: torch.Tensor):
        """One KV-cached decode step: the composition of the JAX package's
        DecoderBlock._fused_step with every kernel on (transformer.py:940-1013).
        x_t (B, 1, C); caches (B, H, L, Dh), updated in place at step_idx (a
        one-element int32 tensor); cross K/V (B, H, M, Dh) from `cross_kv`,
        or int8 (values, fp32 (B, H, Dh) scale) tuples from
        `quantize_kv_decode` (the int8 mode, transformer.py:987-993);
        xa_bias the fp32 (B, M) key bias of the encoder mask (`_key_bias`).
        Returns (x_t, cache_k, cache_v)."""
        if any(m.tp is not None for m in (self.self_attn, self.cross_attn, self.mlp)):
            raise NotImplementedError("the KV-cached decode step does not run tensor-parallel: "
                                      "its kernels add the residual before an all-reduce could "
                                      "sum the ranks' products")
        k_scale = v_scale = None
        if isinstance(cross_k, tuple):
            (cross_k, k_scale), (cross_v, v_scale) = cross_k, cross_v
        sa, xa, mlp = self.self_attn, self.cross_attn, self.mlp
        dt = sa.dtype
        x2 = x_t[:, 0]
        kern = _kernels(x2, dt)
        qk = ((sa.q_norm.weight, sa.q_norm.bias, sa.k_norm.weight, sa.k_norm.bias)
              if sa.qk_norm else (None,) * 4)
        attn = (self_decode if kern else self_decode_plain)(
            x2, self.norm1.weight, self.norm1.bias, sa.qkv.weight.to(dt), sa.qkv.bias, *qk,
            cache_k, cache_v, step_idx, sa.num_heads, eps=self.norm1.eps,
            allow_zero_attn=sa.allow_zero_attn)
        x2 = x2 + _dense(attn, sa.proj, dt)
        cq = (xa.q_norm.weight, xa.q_norm.bias) if xa.qk_norm else (None, None)
        attn_x = (cross_decode_attn if kern else cross_decode_attn_plain)(
            x2, self.query_norm.weight, self.query_norm.bias, xa.q.weight.to(dt), xa.q.bias,
            *cq, cross_k, cross_v, xa_bias, xa.num_heads, eps=self.query_norm.eps,
            allow_zero_attn=xa.allow_zero_attn, k_scale=k_scale, v_scale=v_scale)
        gated = self.gated_mlp
        out = (residual_mlp if kern else residual_mlp_plain)(
            x2, attn_x, xa.proj.weight.to(dt), xa.proj.bias, self.norm2.weight, self.norm2.bias,
            mlp.fc1.weight.to(dt), mlp.fc1.bias, mlp.fc2.weight.to(dt), mlp.fc2.bias,
            mlp.fc3.weight.to(dt) if gated else None, mlp.fc3.bias if gated else None,
            eps=self.norm2.eps, gated=gated)
        return out[:, None, :], cache_k, cache_v
