"""Decode-step kernels: one token through a decoder block, KV-cached.

Counterparts of fourm_tpu/kernels/decode_step.py, the composition of
DecoderBlock._fused_step with every kernel on (transformer.py:940-1013):
  * `self_decode` is pallas_self_decode: LN1 -> QKV -> per-head QK-norm ->
    softmax over the cache's earlier positions plus the new token, the new
    K/V written into the cache at `step_idx`;
  * `decode_attention` is pallas_decode_attention: single-query attention
    over (B, H, M, Dh) K/V with an fp32 (B|1, 1|H, M) bias;
  * `cross_decode_attn` is pallas_cross_decode_attn: query_norm -> Q
    projection -> per-head Q-norm, then the `decode_attention` kernel over
    bf16 cross K/V, or, in its int8 mode (K/V from `quantize_kv_decode`,
    with their per-channel scales), the `decode_attention_int8` kernel;
  * `residual_mlp` is pallas_residual_mlp: x' = x + attn Wp (+b), then
    x' + MLP(LN2 x').
`quantize_kv_decode` is the JAX package's function of that name (plain
jnp there, plain torch here). Each wrapper launches its CUDA kernels
(csrc/self_decode.cu, csrc/decode_attn.cu, csrc/residual_mlp.cu) for CUDA
tensors, counting launches in `<wrapper>.launches`, and raises on a call its
predicate (`<wrapper>_takes`) refuses; it computes its plain PyTorch twin
for CPU tensors. `self_decode`, `residual_mlp` and the q product of
`cross_decode_attn` stream their weights on the core of csrc/gemv_sm90.cuh;
`decode_attention` (and its int8 mode) streams K/V through a TMA ring, split
over a thread-block cluster. Their plans (`gemv_plan`, `self_decode_plan`,
`residual_mlp_plan`, `decode_attention_plan`) are made here and passed to
the kernels as plain ints.

Layout: the port keeps caches and cross K/V as (B, H, L|M, Dh), each key one
128-byte row, not the TPU's (B, H, Dh, L) lane layout. Weights use the
nn.Linear layout (out_features, in_features).

The twins follow the TPU kernels' arithmetic: LN statistics in fp32 with
one rounding to the compute dtype, products summed in fp32, per-head
QK-norm on the fp32 projection before its rounding, logits scaled after the
sum, softmax in fp32. Probabilities meet V in fp32 in `self_decode` and
`cross_decode_attn`, and cast to V's dtype first in `decode_attention` (as
XLA's decode_attention and pallas_decode_attention do): `cast_probs`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._checks import (aligned, all_bf16, f32, ptr, require, require_cuda, require_takes,
                      small_params, stream)
from .attention import softmax1
from .fused_mlp import _mm, layer_norm_fp32, ln_mlp_plain

_NEG = torch.finfo(torch.float32).min


# ------------------------------------------------- the weight-streaming plans

# csrc/gemv_sm90.cuh: 64-row weight tiles, 64-column K blocks, a ring of up
# to 8 weight boxes, token N tiles of 8 to 64, sums of 64 rows of nt + 2
# floats; its smem_bytes() is gemv_smem() below
GEMV_TM = 64
GEMV_TK = 64
GEMV_RING = 8  # weight boxes in the ring: up to 8 stages, or 4 of two (a dual product)
GEMV_N_TILES = (8, 16, 32, 64)
GEMV_MAX_SPLIT = 16  # CTAs of a split-K cluster (past 8: a non-portable cluster)
# K blocks a CTA takes at least (where K has them): a split past that sends
# more partials through the cluster than streaming the blocks costs
GEMV_MIN_KPB = 4
MAX_SMEM = 232448 - 1024  # dynamic shared memory of a block on an H100, beside static
SM_SMEM = 233472   # shared memory of an SM (each resident block also takes 1 KB)
GEMV_CTAS_PER_SM = 2  # the kernel's launch bound: its registers allow two
SMS = 132  # the H100's SMs: the plans fill at least one wave of them where they can
# csrc/self_decode.cu kernel 2: a warp per 32-position chunk of the cache,
# at most CACHE_MAX_WARPS warps to a (batch row, head)
CACHE_CHUNK = 32
CACHE_MAX_WARPS = 16


def gemv_smem(nt: int, kpb: int, dual: bool, ln: bool, split: int) -> int:
    """Dynamic shared memory of gemv_sm90.cuh's kernel (its smem_bytes()):
    the work area (the ring, sized for the CTA's K blocks, the tokens and the
    LN parameters; rank 0's full sums at the end), then rank 0's gather
    buffer of the other ranks' partials."""
    nw = 2 if dual else 1
    ring = min(kpb, GEMV_RING // nw) * nw  # weight boxes
    work = ring * GEMV_TM * GEMV_TK * 2 + kpb * nt * 128 + ln * kpb * GEMV_TK * 2 * 4
    part = nw * GEMV_TM * (nt + 2) * 4  # one rank's partial sums
    return 1024 + max(work, part) + (split - 1) * part


def gemv_plan(rows: int, K: int, B: int, dual: bool = False, sms: int = SMS,
              ln: bool = False):
    """The tile plan of out^T = W (rows, K) act^T for B token rows on
    csrc/gemv_sm90.cuh (`ln`: its tokens are LayerNormed): the N tile `nt`
    (B rounded up to 8, 16, 32 or 64, or a smaller tile where no split of
    that one fits in shared memory) and the `passes` over B; the 64-row
    weight `tiles`; K in `nkb` blocks of 64, `kpb` to a CTA, over a cluster
    of `split` CTAs. Of the splits whose staged tokens and gathered
    partials fit in shared memory, it takes the smallest that fills `sms`
    SMs (tiles * split * passes >= sms) in one wave (the grid resident at
    once, two CTAs an SM at most), else the largest in one wave, else the
    largest. Returns a dict, or None when nothing fits."""
    tiles = -(-rows // GEMV_TM)
    nkb = -(-K // GEMV_TK)
    covering = next(n for n in GEMV_N_TILES if n >= min(B, GEMV_N_TILES[-1]))
    for nt in sorted((n for n in GEMV_N_TILES if n <= covering), reverse=True):
        passes = -(-B // nt)
        fits = []  # (split, kpb, whether the grid is resident at once)
        for split in range(1, max(1, min(nkb // GEMV_MIN_KPB, GEMV_MAX_SPLIT)) + 1):
            kpb = -(-nkb // split)
            smem = gemv_smem(nt, kpb, dual, ln, split)
            if -(-nkb // kpb) < split or smem > MAX_SMEM:
                continue  # a rank without K blocks, or too much to hold
            per_sm = min(GEMV_CTAS_PER_SM, SM_SMEM // (smem + 1024))
            fits.append((split, kpb, tiles * split * passes <= sms * per_sm))
        if fits:
            full = [f for f in fits if f[2] and tiles * f[0] * passes >= sms]
            one_wave = [f for f in fits if f[2]]
            split, kpb, _ = full[0] if full else one_wave[-1] if one_wave else fits[-1]
            return dict(nt=nt, passes=passes, tiles=tiles, nkb=nkb, split=split, kpb=kpb)
    return None


# csrc/decode_attn.cu: 64-key tiles of K and V (and the tile's fp32 key
# bias) through a ring of up to 8 stages, about DECODE_RING bytes; a (batch
# row, head) split over a cluster of up to 16 CTAs, each sending rank 0 its
# 64 + 2 fp32 partials; up to four CTAs an SM (its launch bound); its
# smem_bytes() is decode_attention_smem() below
DECODE_TILE = 64
DECODE_MAX_STAGES = 8
DECODE_MAX_SPLIT = 16
DECODE_CTAS_PER_SM = 4
DECODE_STATIC_SMEM = 1280  # its barriers and the four warps' softmax states
DECODE_RING = 100 * 1024  # a CTA's ring: what cross_decode_attn buffers during its q product
DECODE_TARGET_CTAS = {False: 1.0, True: 1.5}  # CTAs an SM the plan aims at: bf16, int8


def decode_attention_smem(stages: int, split: int, int8: bool) -> int:
    """Dynamic shared memory of csrc/decode_attn.cu's kernel: alignment
    slack, the ring (a stage: a K and a V tile of 64 keys, 8 KB each in
    bf16, 4 KB in int8, and 256 bytes of key bias), then rank 0's gather
    buffer of the other ranks' partials."""
    stage = 2 * DECODE_TILE * 64 * (1 if int8 else 2) + DECODE_TILE * 4
    return 1024 + stages * stage + (split - 1) * (64 + 2) * 4


def decode_attention_plan(B: int, H: int, M: int, int8: bool = False, sms: int = SMS):
    """The split plan of csrc/decode_attn.cu for B x H single queries over M
    keys: each (batch row, head) takes `split` CTAs (a cluster of at most
    16), rank r holding keys [r * keys, min((r + 1) * keys, M)), `keys` a
    multiple of the 64-key tile (the last rank ragged, none empty), and a
    ring of `stages` stages, about DECODE_RING bytes (6 in bf16, 8 in int8):
    on the decode step the ring is what a CTA streams while the q product
    runs, and a deeper ring measured faster there (PERF.md, PR 10). A CTA's
    consumers take about the same time for a tile of either width, so a CTA
    streams about half the bytes a second in int8: the split is the
    smallest whose grid B * H * split reaches DECODE_TARGET_CTAS CTAs an SM
    (1 in bf16, 1.5 in int8), within one wave at the CTAs an SM that the
    shared memory allows (`per_sm`, at most DECODE_CTAS_PER_SM); larger
    grids measured slower. One split where B * H alone reach it. `tiles`:
    the 64-key tiles of M."""
    tiles = -(-max(M, 1) // DECODE_TILE)
    stage = decode_attention_smem(1, 1, int8) - 1024
    ring = min(DECODE_MAX_STAGES, DECODE_RING // stage)

    def per_sm(split, stages):  # 1 KB of each CTA's shared memory is the system's
        smem = decode_attention_smem(stages, split, int8) + DECODE_STATIC_SMEM + 1024
        return min(DECODE_CTAS_PER_SM, SM_SMEM // smem)

    target = DECODE_TARGET_CTAS[bool(int8)] * sms
    split = 1
    while (split < min(DECODE_MAX_SPLIT, tiles) and B * H * split < target
           and B * H * (split + 1) <= sms * per_sm(split + 1, ring)):
        split += 1
    tps = -(-tiles // split)
    split = -(-tiles // tps)  # no rank without keys
    stages = min(tps, ring)
    return dict(split=split, keys=tps * DECODE_TILE, stages=stages, tiles=tiles,
                per_sm=per_sm(split, stages))


def _plan_ints(*plans):
    return [v for p in plans for v in (p["nt"], p["passes"], p["split"], p["kpb"])]


# the plans as the kernels take them, one computation per shape: a decode
# step calls each wrapper once per layer and token, and the plan search is
# Python
@functools.lru_cache(maxsize=256)
def _self_decode_ints(B: int, C: int, L: int, sms: int) -> tuple:
    plan = self_decode_plan(B, C, L, sms)
    return (*_plan_ints(plan["qkv"]), plan["warps"])


@functools.lru_cache(maxsize=256)
def _decode_attention_ints(B: int, H: int, M: int, int8: bool, sms: int) -> tuple:
    plan = decode_attention_plan(B, H, M, int8, sms)
    return plan["split"], plan["keys"], plan["stages"]


@functools.lru_cache(maxsize=256)
def _cross_q_ints(B: int, C: int, sms: int) -> tuple:
    return tuple(_plan_ints(gemv_plan(C, C, B, sms=sms, ln=True)))


@functools.lru_cache(maxsize=256)
def _residual_mlp_ints(B: int, C: int, HID: int, gated: bool, sms: int) -> tuple:
    plan = residual_mlp_plan(B, C, HID, gated, sms)
    return tuple(_plan_ints(plan["proj"], plan["hidden"], plan["out"]))


def self_decode_plan(B: int, C: int, L: int, sms: int = SMS):
    """self_decode's plan: `qkv`, the projection's gemv_plan over Wqkv (3C
    rows, LN1 tokens); `warps`, the attention's warps per (batch row, head),
    one per 32-position chunk of the cache up to 16 (warp w takes chunks w,
    w + warps, ...)."""
    qkv = gemv_plan(3 * C, C, B, sms=sms, ln=True)
    warps = min(CACHE_MAX_WARPS, -(-L // CACHE_CHUNK))
    return None if qkv is None else dict(qkv=qkv, warps=warps)


def residual_mlp_plan(B: int, C: int, HID: int, gated: bool, sms: int = SMS):
    """residual_mlp's plans of its three products: `proj` Wp (C, C), `hidden`
    W1 [and W3] (HID, C), `out` W2 (C, HIDS) with HIDS = HID rounded up to
    8; None when one does not fit."""
    hids = -(-HID // 8) * 8
    plans = dict(proj=gemv_plan(C, C, B, sms=sms), hidden=gemv_plan(HID, C, B, gated, sms, True),
                 out=gemv_plan(C, hids, B, sms=sms))
    return None if None in plans.values() else plans


def _params16(*tensors):
    """small_params, 16-byte aligned: the weight-streaming kernels read LN
    parameters 8 at a time. A vector that is not aligned (a view into a
    larger tensor) goes, with the others, to fp32 copies."""
    ps, pbf = small_params(*tensors)
    if all(t is None or aligned(t, 16) for t in ps):
        return ps, pbf
    return [f32(t) for t in tensors], 0


def _ints(*vals):
    return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    """The SMs of a card, for the tile plans."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ---------------------------------------------------------------- self_decode

def self_decode_plain(x, gamma1, beta1, w_qkv, b_qkv, qn_gamma, qn_beta, kn_gamma,
                      kn_beta, cache_k, cache_v, step_idx, num_heads: int,
                      eps: float = 1e-6, allow_zero_attn: bool = False) -> torch.Tensor:
    B, C = x.shape
    H = num_heads
    Dh = C // H
    L = cache_k.shape[2]
    dt = w_qkv.dtype
    h = layer_norm_fp32(x.float(), gamma1, beta1, eps).to(dt)
    q, k, v = _mm(h, w_qkv, b_qkv).reshape(B, 3, H, Dh).unbind(1)  # fp32 (B, H, Dh)
    if qn_gamma is not None:
        q = layer_norm_fp32(q, qn_gamma, qn_beta, eps)
        k = layer_norm_fp32(k, kn_gamma, kn_beta, eps)
    q, k, v = (t.to(cache_k.dtype).float() for t in (q, k, v))
    step = step_idx.reshape(())
    pos = torch.arange(L, device=x.device)
    valid = pos < step  # earlier tokens; the new one comes from registers
    scale = Dh ** -0.5
    s = torch.einsum("bhd,bhld->bhl", q, cache_k.float()) * scale
    s = s.masked_fill(~valid, _NEG)
    s_n = (q * k).sum(-1, keepdim=True) * scale
    m = torch.maximum(s.amax(-1, keepdim=True), s_n)
    if allow_zero_attn:
        m = m.clamp_min(0.0)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    p_n = torch.exp(s_n - m)
    denom = p.sum(-1, keepdim=True) + p_n
    if allow_zero_attn:  # softmax1: the implicit zero logit
        denom = denom + torch.exp(-m)
    out = (torch.einsum("bhl,bhld->bhd", p, cache_v.float()) + p_n * v) / denom
    here = (pos == step)[None, None, :, None]
    cache_k.copy_(torch.where(here, k[:, :, None, :].to(cache_k.dtype), cache_k))
    cache_v.copy_(torch.where(here, v[:, :, None, :].to(cache_v.dtype), cache_v))
    return out.reshape(B, C).to(x.dtype)


def self_decode_takes(x: torch.Tensor, w_qkv: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, num_heads: int) -> bool:
    """Whether csrc/self_decode.cu takes the step, from dtypes and shapes
    alone: bf16 x, w_qkv and caches, heads of 64, C <= 2048 and a multiple
    of 8, contiguous 16-byte aligned tensors (TMA reads Wqkv and the
    caches), a cache of at most 8192 positions."""
    C, L = x.shape[-1], cache_k.shape[2]
    ts = (x, w_qkv, cache_k, cache_v)
    return (all_bf16(*ts) and C == 64 * num_heads and C % 8 == 0 and C <= 2048
            and all(t.is_contiguous() and aligned(t, 16) for t in ts)
            and 0 < L <= 8192 and cache_k.numel() < 2**31)


def self_decode(x: torch.Tensor, gamma1, beta1, w_qkv: torch.Tensor, b_qkv, qn_gamma,
                qn_beta, kn_gamma, kn_beta, cache_k: torch.Tensor, cache_v: torch.Tensor,
                step_idx: torch.Tensor, num_heads: int, eps: float = 1e-6,
                allow_zero_attn: bool = False) -> torch.Tensor:
    """Self-attention core of one decode step. x (B, C) is the token's hidden
    state; w_qkv (3C, C); caches (B, H, L, Dh); step_idx a one-element int32
    tensor (read on the device, so no per-token value comes from the host).
    Returns the raw heads-concatenated attention (B, C); the out-projection
    stays outside, as in the JAX package.

    The caches are updated IN PLACE (the TPU kernel aliases them): the new
    token's K/V (after QK-norm) is written at position step_idx. Only
    positions < step_idx are read from the cache; the new token's K/V is
    taken from registers, so the write races with no reader. A step_idx at
    or past L writes nothing. At step_idx 0 the output is the new V."""
    if x.device.type == "cpu":
        return self_decode_plain(x, gamma1, beta1, w_qkv, b_qkv, qn_gamma, qn_beta, kn_gamma,
                                 kn_beta, cache_k, cache_v, step_idx, num_heads, eps,
                                 allow_zero_attn)
    name = "self_decode"
    dev = require_cuda(name, x, w_qkv, cache_k, cache_v, step_idx, gamma1, beta1, b_qkv,
                       qn_gamma, qn_beta, kn_gamma, kn_beta)
    B, C = x.shape
    H = num_heads
    Dh = C // H
    L = cache_k.shape[2]
    require(Dh * H == C, lambda: f"{name}: C={C} over {H} heads")
    require(tuple(w_qkv.shape) == (3 * C, C), lambda: f"{name}: w_qkv must be ({3 * C}, {C})")
    require(tuple(cache_k.shape) == (B, H, L, Dh) and tuple(cache_v.shape) == (B, H, L, Dh),
            lambda: f"{name}: caches must be ({B}, {H}, L, {Dh})")
    require(step_idx.dtype == torch.int32 and step_idx.numel() == 1,
            lambda: f"{name}: step_idx must be a one-element int32 tensor")
    require(qn_gamma is None or kn_gamma is not None,
            lambda: f"{name}: QK-norm needs both gammas")
    require_takes(name, self_decode_takes(x, w_qkv, cache_k, cache_v, num_heads),
                  x, w_qkv, cache_k, cache_v)
    ps, pbf = _params16(gamma1, beta1, b_qkv, qn_gamma, qn_beta, kn_gamma, kn_beta)
    qkv = torch.empty((B, 3, H, Dh), dtype=torch.bfloat16, device=dev)  # q, k, v of the token
    out = torch.empty((B, C), dtype=torch.bfloat16, device=dev)
    from . import _build

    code = _build.entry(name)(
        ptr(x), *[ptr(t) for t in ps], pbf, ptr(w_qkv), ptr(cache_k), ptr(cache_v),
        ptr(step_idx), ptr(qkv), ptr(out), B, H, L, C, float(eps), int(allow_zero_attn),
        _ints(*_self_decode_ints(B, C, L, _sms(dev))), stream(dev))
    _build.check(name, code)
    self_decode.launches += 1
    return out


self_decode.launches = 0


# ----------------------------------------------------------- decode_attention

def decode_attention_plain(q, k, v, bias=None, allow_zero_attn: bool = False,
                           cast_probs: bool = True) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale  # (B, H, 1, M)
    if bias is not None:
        logits = logits + bias.float()[:, :, None, :]
    probs = softmax1(logits) if allow_zero_attn else torch.softmax(logits, dim=-1)
    if cast_probs:
        probs = probs.to(v.dtype).float()
    return torch.matmul(probs, v.float()).to(q.dtype)


def _row_strides_ok(t: torch.Tensor) -> bool:
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def decode_attention_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           int8: bool = False) -> bool:
    """Whether the split-K kernel of csrc/decode_attn.cu takes the call, from
    dtypes and shapes alone: bf16 q, bf16 K/V (int8 in the int8 mode), head
    dim 64, K/V rows contiguous with strides that are multiples of 8 and
    16-byte aligned (TMA reads them; int8 strides that are not multiples of
    16 bytes are read from a contiguous copy), at least one key."""
    kv_dtype = torch.int8 if int8 else torch.bfloat16
    return (all_bf16(q) and k.dtype == kv_dtype and v.dtype == kv_dtype and q.shape[-1] == 64
            and q.stride(-1) == 1 and _row_strides_ok(k) and _row_strides_ok(v)
            and k.shape[2] > 0
            and max(t.storage_offset() + sum((d - 1) * s for d, s in zip(t.shape, t.stride()))
                    for t in (k, v)) < 2**31)


def _decode_checks(name: str, q, k, v, bias, int8: bool, k_scale=None, v_scale=None):
    """Checks of the split-K decode kernel (decode_attention_takes, matching
    shapes, an fp32 (B|1, 1|H, M) bias, in the int8 mode contiguous fp32
    (B, H, 64) scales); returns the device."""
    dev = require_cuda(name, q, k, v, bias, k_scale, v_scale)
    require(not int8 or k.dtype == v.dtype == torch.int8,
            lambda: f"{name}: K/V must be int8, got {k.dtype}/{v.dtype}")
    require_takes(name, decode_attention_takes(q, k, v, int8), q, *(() if int8 else (k, v)))
    B, H, N, Dh = q.shape
    M = k.shape[2]
    require(N == 1, lambda: f"{name}: q must be (B, H, 1, Dh), got {tuple(q.shape)}")
    require(tuple(k.shape) == (B, H, M, Dh) and tuple(v.shape) == (B, H, M, Dh),
            lambda: f"{name}: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q")
    require(bias is None or (bias.dtype == torch.float32 and bias.ndim == 3
                             and bias.shape[-1] == M and bias.shape[0] in (1, B)
                             and bias.shape[1] in (1, H)),
            lambda: f"{name}: bias {tuple(bias.shape)} not fp32 (B|1, 1|H, {M})")
    if int8:
        require(all(t.dtype == torch.float32 and tuple(t.shape) == (B, H, Dh)
                    and t.is_contiguous() for t in (k_scale, v_scale)),
                lambda: f"{name}: scales must be contiguous fp32 ({B}, {H}, {Dh}) on {dev}")
    return dev


def _tma_inputs(k, v, bias, int8: bool):
    """K, V and the fp32 (B|1, 1|H, M) key bias as the kernel's TMA maps
    read them, with the bias's batch and head strides (0 where it
    broadcasts) and a pitch (a multiple of 4 elements, at least M). Each is
    read in place where TMA can (every tensor of the chain); else from a
    copy: int8 K/V whose strides are not multiples of 16 bytes contiguous, a
    bias whose keys are not contiguous, whose base is not 16-byte aligned or
    whose strides are not multiples of 4, zero-padded to (B|1, 1|H, M
    rounded up to 4). The copies are made before any of the call's kernels
    launches: the K/V stream of cross_decode_attn starts before its wait."""
    if int8:
        k, v = (t if all(s % 16 == 0 for s in t.stride()[:-1]) else t.contiguous()
                for t in (k, v))
    if bias is None:
        return k, v, None, (0, 0), 0
    M = bias.shape[-1]
    pitch = -(-M // 4) * 4
    bs = [0 if bias.shape[i] == 1 else bias.stride(i) for i in range(2)]
    if not ((bias.stride(-1) == 1 or M == 1) and aligned(bias, 16)
            and all(s % 4 == 0 for s in bs)):
        padded = torch.zeros((*bias.shape[:2], pitch), dtype=torch.float32, device=bias.device)
        padded[..., :M].copy_(bias)
        bias = padded
        bs = [0 if bias.shape[i] == 1 else bias.stride(i) for i in range(2)]
    return k, v, bias, bs, pitch


def _launch_decode(name: str, q, k_scale, v_scale, inputs, allow_zero_attn: bool,
                   cast_probs: bool, early: bool, dev) -> torch.Tensor:
    """Launch csrc/decode_attn.cu's kernel (under PDL) on a call
    _decode_checks passed, over `inputs` from _tma_inputs. `early`: the
    launch of cross_decode_attn right after its q product, whose producer
    streams K/V and the bias before its wait (the q product writes only q);
    a standalone call's producer waits first."""
    k, v, bias, bs, pitch = inputs
    int8 = k_scale is not None
    B, H, _, Dh = q.shape
    M = k.shape[2]
    out = torch.empty((B, H, 1, Dh), dtype=q.dtype, device=dev)
    from . import _build

    code = _build.entry("decode_attention")(
        ptr(q), q.stride(0), q.stride(1), ptr(k), ptr(v), *k.stride()[:3], *v.stride()[:3],
        ptr(k_scale), ptr(v_scale), int(int8), ptr(bias), *bs, pitch, ptr(out), B, H, M,
        float(Dh) ** -0.5, int(allow_zero_attn), int(cast_probs), int(early),
        _ints(*_decode_attention_ints(B, H, M, int8, _sms(dev))), stream(dev))
    _build.check(name, code)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, allow_zero_attn: bool = False,
                     cast_probs: bool = True) -> torch.Tensor:
    """Single-query attention. q (B, H, 1, Dh); k, v (B, H, M, Dh), read
    through their strides (e.g. head views of a fused KV projection); bias
    fp32 (B|1, 1|H, M). Returns (B, H, 1, Dh) in q.dtype.

    cast_probs: probabilities are cast to v's dtype before the product with
    V (pallas_decode_attention and XLA's decode_attention); False keeps
    them in fp32 (pallas_cross_decode_attn). A row whose keys all carry the
    finfo(f32).min bias gets uniform weights, never NaN. On CUDA the kernel
    launches under PDL but reads nothing before its wait on the kernel
    before it, which may have written K/V or the bias (only
    cross_decode_attn's launch streams K/V before that wait)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, bias, allow_zero_attn, cast_probs)
    name = "decode_attention"
    dev = _decode_checks(name, q, k, v, bias, False)
    out = _launch_decode(name, q, None, None, _tma_inputs(k, v, bias, False), allow_zero_attn,
                         cast_probs, False, dev)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ------------------------------------------------------ the int8 K/V mode

def quantize_kv_decode(k: torch.Tensor, v: torch.Tensor):
    """Per-(B, H, Dh)-channel symmetric int8 quantization of cross K/V
    (B, H, M, Dh), as fourm_tpu decode_step.py:quantize_kv_decode on its
    (B, H, Dh, M) layout: scale = max(absmax over all M, 1e-12) / 127, fp32
    (B, H, Dh); values clamp(round(a / scale), -127, 127) as int8, with a
    true division and round-half-to-even. Scales and int8 values equal
    JAX's, and the card's equal the CPU's. Returns (k_i8, k_scale, v_i8,
    v_scale); the int8 tensors are contiguous. Plain torch on any device
    (plain jnp in the JAX package)."""
    def q(a):
        a32 = a.float()
        absmax = a32.abs().amax(dim=2).clamp_min(1e-12)
        # XLA folds JAX's `/ 127.0` into a multiply by the fp32 reciprocal:
        # the same product here, on the CPU and on the card alike
        s = absmax * (1.0 / 127.0)
        i8 = torch.round(a32 / s[:, :, None, :]).clamp(-127, 127).to(torch.int8)
        return i8.contiguous(), s.contiguous()

    k_i8, ks = q(k)
    v_i8, vs = q(v)
    return k_i8, ks, v_i8, vs


def decode_attention_int8_plain(q, k, v, k_scale, v_scale, bias=None,
                                allow_zero_attn: bool = False) -> torch.Tensor:
    """The fold order of the TPU kernel's int8 mode: the K scale multiplies
    q before the logits, the V scale the fp32 accumulator p V after it and
    before the division by the softmax sum; probabilities stay fp32."""
    scale = q.shape[-1] ** -0.5
    qk = q.float() * k_scale.float()[:, :, None, :]
    s = torch.matmul(qk, k.float().transpose(-1, -2)) * scale  # (B, H, 1, M)
    if bias is not None:
        s = s + bias.float()[:, :, None, :]
    m = s.amax(-1, keepdim=True)
    if allow_zero_attn:
        m = m.clamp_min(0.0)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    if allow_zero_attn:  # softmax1: the implicit zero logit
        denom = denom + torch.exp(-m)
    acc = torch.matmul(p, v.float()) * v_scale.float()[:, :, None, :]
    return (acc / denom).to(q.dtype)


def decode_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          allow_zero_attn: bool = False) -> torch.Tensor:
    """Single-query attention over int8 K/V (B, H, M, Dh) with fp32
    per-channel scales (B, H, Dh) from `quantize_kv_decode`: the int8 mode
    of pallas_cross_decode_attn's attention core, fp32 probabilities. No
    dequantized K/V is ever written: the K scale is folded into q, the V
    scale into the accumulator. bias and the launch as in
    `decode_attention`."""
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k, v, k_scale, v_scale, bias, allow_zero_attn)
    name = "decode_attention_int8"
    dev = _decode_checks(name, q, k, v, bias, True, k_scale, v_scale)
    out = _launch_decode(name, q, k_scale, v_scale, _tma_inputs(k, v, bias, True),
                         allow_zero_attn, False, False, dev)
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0


# ----------------------------------------------------------- cross_decode_attn

def _cross_q_plain(x, qn_gamma, qn_beta, w_q, b_q, cqn_gamma, cqn_beta, num_heads, eps):
    B, C = x.shape
    dt = w_q.dtype
    h = layer_norm_fp32(x.float(), qn_gamma, qn_beta, eps).to(dt)
    q = _mm(h, w_q, b_q).reshape(B, num_heads, 1, C // num_heads)
    if cqn_gamma is not None:
        q = layer_norm_fp32(q, cqn_gamma, cqn_beta, eps)
    return q.to(dt)


def cross_decode_attn_plain(x, qn_gamma, qn_beta, w_q, b_q, cqn_gamma, cqn_beta, k, v,
                            bias, num_heads: int, eps: float = 1e-6,
                            allow_zero_attn: bool = False, k_scale=None,
                            v_scale=None) -> torch.Tensor:
    q = _cross_q_plain(x, qn_gamma, qn_beta, w_q, b_q, cqn_gamma, cqn_beta, num_heads, eps)
    b3 = None if bias is None else bias[:, None, :]
    if k_scale is not None:
        out = decode_attention_int8_plain(q, k, v, k_scale, v_scale, b3, allow_zero_attn)
    else:
        out = decode_attention_plain(q, k, v, b3, allow_zero_attn, cast_probs=False)
    return out.reshape(x.shape).to(x.dtype)


def cross_decode_attn_takes(x: torch.Tensor, w_q: torch.Tensor, num_heads: int) -> bool:
    """Whether the q product of csrc/decode_attn.cu (on gemv_sm90.cuh) takes
    the step, from dtypes and shapes alone: bf16 x and w_q, heads of 64, C
    <= 2048 and a multiple of 8, contiguous 16-byte aligned x and w_q (TMA
    reads Wq, 16-byte loads x). The attention core then checks
    decode_attention_takes."""
    C = x.shape[-1]
    return (all_bf16(x, w_q) and C == 64 * num_heads and C % 8 == 0 and C <= 2048
            and all(t.is_contiguous() and aligned(t, 16) for t in (x, w_q)))


def cross_decode_attn(x: torch.Tensor, qn_gamma, qn_beta, w_q: torch.Tensor, b_q,
                      cqn_gamma, cqn_beta, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor], num_heads: int, eps: float = 1e-6,
                      allow_zero_attn: bool = False, k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-attention core of one decode step: per-head attention of
    q_norm(LN_q(x) Wq^T (+b)) over the cross K/V (B, H, M, Dh) with an fp32
    (B, M) key bias. Returns the raw heads-concatenated output (B, C); the
    out-projection runs in `residual_mlp`. On CUDA the q product runs on the
    weight-streaming core (csrc/gemv_sm90.cuh, plan `gemv_plan(C, C, B)`),
    then the `decode_attention` kernel (fp32 probabilities), launched under
    PDL: it streams K/V and the bias while the q product runs, and reads q
    after its wait. int8 mode: k, v int8 with their fp32 (B, H, Dh) scales
    k_scale, v_scale (`quantize_kv_decode`), read by the
    `decode_attention_int8` kernel. Counts one launch of cross_decode_attn
    and one of decode_attention (or decode_attention_int8)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("cross_decode_attn: the int8 mode needs both k_scale and v_scale")
    if x.device.type == "cpu":
        return cross_decode_attn_plain(x, qn_gamma, qn_beta, w_q, b_q, cqn_gamma, cqn_beta,
                                       k, v, bias, num_heads, eps, allow_zero_attn, k_scale,
                                       v_scale)
    name = "cross_decode_attn"
    dev = require_cuda(name, x, w_q, k, v, bias, qn_gamma, qn_beta, b_q, cqn_gamma, cqn_beta,
                       k_scale, v_scale)
    B, C = x.shape
    H = num_heads
    Dh = C // H
    require(Dh * H == C, lambda: f"{name}: C={C} over {H} heads")
    require(tuple(w_q.shape) == (C, C), lambda: f"{name}: w_q must be ({C}, {C})")
    require(bias is None or bias.ndim == 2, lambda: f"{name}: bias must be (B, M)")
    require_takes(name, cross_decode_attn_takes(x, w_q, num_heads), x, w_q)
    int8 = k_scale is not None
    attn_name = "decode_attention_int8" if int8 else "decode_attention"
    b3 = None if bias is None else bias[:, None, :]
    q = torch.empty((B, H, 1, Dh), dtype=torch.bfloat16, device=dev)
    _decode_checks(attn_name, q, k, v, b3, int8, k_scale, v_scale)
    inputs = _tma_inputs(k, v, b3, int8)  # any copy before the q product
    ps, pbf = _params16(qn_gamma, qn_beta, b_q, cqn_gamma, cqn_beta)
    from . import _build

    code = _build.entry("cross_decode_q")(
        ptr(x), *[ptr(t) for t in ps], pbf, ptr(w_q), ptr(q), B, C, float(eps),
        _ints(*_cross_q_ints(B, C, _sms(dev))), stream(dev))
    _build.check(name, code)
    cross_decode_attn.launches += 1
    out = _launch_decode(attn_name, q, k_scale, v_scale, inputs, allow_zero_attn, False, True,
                         dev)
    (decode_attention_int8 if int8 else decode_attention).launches += 1
    return out.reshape(B, C)


cross_decode_attn.launches = 0


# ---------------------------------------------------------------- residual_mlp

def residual_mlp_plain(x, attn, w_proj, b_proj, gamma2, beta2, w1, b1, w2, b2, w3=None,
                       b3=None, eps: float = 1e-6, gated: bool = False) -> torch.Tensor:
    x1 = x + _mm(attn.to(w_proj.dtype), w_proj, b_proj).to(x.dtype)
    return ln_mlp_plain(x1, gamma2, beta2, w1, b1, w2, b2, w3, b3, eps, gated)


def residual_mlp_takes(x: torch.Tensor, attn: torch.Tensor, w_proj: torch.Tensor,
                       w1: torch.Tensor, w2: torch.Tensor,
                       w3: Optional[torch.Tensor] = None) -> bool:
    """Whether csrc/residual_mlp.cu takes the step, from dtypes and shapes
    alone: bf16 tensors, C <= 2048 and a multiple of 8, any hidden width up
    to 8192, contiguous 16-byte aligned tensors; W2 may instead have rows a
    multiple of 8 elements apart (the zero-padded storage of a ragged fc2
    weight, `_w2_for_tma`)."""
    C, HID = x.shape[-1], w1.shape[0]
    ts = [t for t in (x, attn, w_proj, w1, w3) if t is not None]
    return (all_bf16(*ts, w2) and C % 8 == 0 and 0 < C <= 2048 and 0 < HID <= 8192
            and all(t.is_contiguous() and aligned(t, 16) for t in ts)
            and (w2.is_contiguous() or _rows_in_place(w2)) and aligned(w2, 16))


def _rows_in_place(w2: torch.Tensor) -> bool:
    """W2's rows as TMA reads them in place: unit column stride, rows a
    multiple of 8 elements (16 bytes) apart."""
    return w2.ndim == 2 and w2.stride(1) == 1 and w2.stride(0) % 8 == 0 \
        and w2.stride(0) >= w2.shape[1]


def _w2_for_tma(w2: torch.Tensor) -> torch.Tensor:
    """fc2's weight (C, HID) as residual_mlp's W2 stream reads it: the
    weight itself where its rows lie a multiple of 8 elements apart (HID %
    8 == 0, or the (C, HID) view of zero-padded (C, HID rounded up to 8)
    storage that the MLP modules keep a ragged bf16 fc2 weight in,
    ops/transformer.py), else a zero-padded copy made on this call. The
    kernel reads HID columns with the returned tensor's row stride, so it
    always reads the weight as it is now: no copy outlives the call."""
    if _rows_in_place(w2):
        return w2
    C, HID = w2.shape
    with torch.no_grad():
        padded = torch.zeros((C, -(-HID // 8) * 8), dtype=w2.dtype, device=w2.device)
        padded[:, :HID].copy_(w2)
    return padded


def residual_mlp(x: torch.Tensor, attn: torch.Tensor, w_proj: torch.Tensor, b_proj,
                 gamma2, beta2, w1: torch.Tensor, b1, w2: torch.Tensor, b2,
                 w3: Optional[torch.Tensor] = None, b3=None, eps: float = 1e-6,
                 gated: bool = False) -> torch.Tensor:
    """The tail of a decode step: x' = x + attn Wp^T (+bp), returns
    x' + fc2(act(fc1(LN2 x'))), act = silu(fc1) * fc3 when gated, else exact
    GELU. x, attn (B, C); w_proj (C, C); w1, w3 (HID, C); w2 (C, HID), any
    HID (2730 and 5461 at 4M-L/XL: W2 read in place from the MLP modules'
    padded storage, `_w2_for_tma`)."""
    if x.device.type == "cpu":
        return residual_mlp_plain(x, attn, w_proj, b_proj, gamma2, beta2, w1, b1, w2, b2,
                                  w3, b3, eps, gated)
    name = "residual_mlp"
    dev = require_cuda(name, x, attn, w_proj, w1, w2, w3, b_proj, gamma2, beta2, b1, b2, b3)
    B, C = x.shape
    HID = w1.shape[0]
    require(tuple(attn.shape) == (B, C) and tuple(w_proj.shape) == (C, C)
            and tuple(w1.shape) == (HID, C) and tuple(w2.shape) == (C, HID),
            lambda: f"{name}: shapes attn {tuple(attn.shape)}, w_proj {tuple(w_proj.shape)}, "
            f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    require(not gated or (w3 is not None and tuple(w3.shape) == (HID, C)),
            lambda: f"{name}: gated needs w3 of shape ({HID}, {C})")
    require_takes(name, residual_mlp_takes(x, attn, w_proj, w1, w2, w3 if gated else None),
                  x, attn, w_proj, w1, w2, w3 if gated else None)
    ps, pbf = _params16(b_proj, gamma2, beta2, b1, b3 if gated else None, b2)
    hids = -(-HID // 8) * 8
    w2k = _w2_for_tma(w2)
    x1 = torch.empty_like(x)
    hid = torch.empty((B, hids), dtype=torch.bfloat16, device=dev)  # rows of 16 B
    out = torch.empty_like(x)
    from . import _build

    code = _build.entry(name)(
        ptr(x), ptr(attn), ptr(w_proj), ptr(w1), ptr(w3 if gated else None),
        ptr(w2k), *[ptr(t) for t in ps], pbf, ptr(x1), ptr(hid), ptr(out), B, C,
        HID, hids, w2k.stride(0), int(gated), float(eps),
        _ints(*_residual_mlp_ints(B, C, HID, bool(gated), _sms(dev))), stream(dev))
    _build.check(name, code)
    residual_mlp.launches += 1
    return out


residual_mlp.launches = 0
