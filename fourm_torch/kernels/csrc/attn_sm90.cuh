// The Hopper attention core of attention.cu (flash_mha, mha_short,
// attention, attention_train's forward) and attn_block.cu: one consumer
// warpgroup attends a block of 64 query rows (head dim 64) to key tiles of
// KT = 64 or 128 keys held in shared memory in the 128-byte swizzle, with
// an online softmax; optionally it leaves each row's statistics (the max
// in log2 units, 1 / sum) for attention_train.cu's backward, which builds
// on the same primitives and the fp32 bias maps (make_bias_map) here.
//
//   * S = Q K^T: wgmma m64nKTk16 with Q and the K tile both K-major shared
//     memory operands (4 steps over the 64 head dims). S stays in
//     registers: the accumulator register 4j + 2r + c holds query row
//     16 * warp + lane / 4 + 8r and key 8j + 2 (lane % 4) + c, so a row's
//     max and sum take two shuffles across the 4 lanes that share it.
//   * O += P V: P (rounded to bf16) is the register A operand of wgmma
//     m64n64k16, since the m64nNk16 accumulator layout is the A fragment
//     layout (register i of P packs S registers 2i, 2i + 1); V is the B
//     operand straight from its key-major tile, MN-major (trans-b).
//   * One product in flight behind the softmax: S of tile t and P V of tile
//     t - 1 are issued together; the softmax of tile t runs while P V of
//     t - 1 finishes; then O is rescaled and P replaced.
//
// Semantics (the plain twins' and attention.py's): logits = q.k * scale,
// then + the fp32 bias; a running max that starts finite (-FLT_MAX, or 0 for
// softmax1, whose implicit zero logit is added to the sum at the end); keys
// >= M take exactly zero weight. The softmax runs in log2 units: logit *
// log2(e) = q.k * (scale * log2(e)) + bias * log2(e), one FMA, and p =
// exp2(that - max), so exp(logit - max) costs one subtraction and one ex2.
// The bias is clamped to BIAS_FLOOR = -1e30 before the fold: finfo.min *
// log2(e) would overflow to -inf, and a row whose keys are all masked would
// then give -inf - -inf. Clamping changes no result: a masked logit (q.k *
// scale + finfo.min, which rounds to finfo.min) and a clamped one are both
// so far below every unmasked logit that exp of their difference is 0 in
// fp32, and a row whose keys are all masked sees equal logits either way
// (every one rounds to the floor) and gets uniform weights, never NaN.
#pragma once

#include <float.h>

#include "gemm_sm90.cuh"

namespace fourm {
namespace sm90 {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The box of an attention operand map (make_rows_map) at (row, head,
// batch), its coordinates placed by the map's slot order `ord`.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, uint64_t* bar, int ord,
                                         int row, int h, int b) {
  const int sr = ord & 3, sh = (ord >> 2) & 3;
  const int c1 = sr == 1 ? row : sh == 1 ? h : b;
  const int c2 = sr == 2 ? row : sh == 2 ? h : b;
  const int c3 = sr == 3 ? row : sh == 3 ? h : b;
  tma_load_4d(dst, map, bar, 0, c1, c2, c3);
}

// The map of an fp32 additive bias (batch, heads, rows, keys) whose keys are
// contiguous, read through element strides sbb, sbh, sbn (0 on a broadcast
// batch or head axis; sbn not 0) in boxes of 32 keys x box_rows rows in the
// 128-byte swizzle (bias_at reads them): keys past M and rows past N read as
// zero. *flags gets bit 0 when the head coordinate indexes the map, bit 1
// for the batch's (a broadcast axis is a dimension of size 1, coordinate 0).
// Fails (not 0) unless TMA takes it: a 16-byte aligned base, strides that
// are multiples of 4 elements.
inline int make_bias_map(CUtensorMap* map, const void* base, int B, int H, int N, int M,
                         long long sbb, long long sbh, long long sbn, int box_rows, int* flags) {
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0 || sbn <= 0 || sbn % 4 != 0 ||
      sbh % 4 != 0 || sbb % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)M, (cuuint64_t)N, (cuuint64_t)(sbh != 0 ? H : 1),
                              (cuuint64_t)(sbb != 0 ? B : 1)};
  cuuint64_t strides[3];
  strides[0] = (cuuint64_t)sbn * 4;
  strides[1] = sbh != 0 ? (cuuint64_t)sbh * 4 : strides[0] * dims[1];
  strides[2] = sbb != 0 ? (cuuint64_t)sbb * 4 : strides[1] * dims[2];
  const cuuint32_t box[4] = {32, (cuuint32_t)box_rows, 1, 1};
  *flags = (sbh != 0 ? 1 : 0) | (sbb != 0 ? 2 : 0);
  return encode_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The bias box at (key, row) of (head h, batch b) of a make_bias_map map.
__device__ __forceinline__ void tma_bias(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int flags, int key, int row, int h, int b) {
  tma_load_4d(dst, map, bar, key, row, (flags & 1) ? h : 0, (flags & 2) ? b : 0);
}

// The bias of (row, key) in a tile of make_bias_map boxes laid side by side
// (box j holds keys 32j .. 32j + 31 of `rows` rows, 128 bytes a row): 16-byte
// chunk c of row r at chunk c ^ (r % 8). With key even, key + 1 is the
// next float (bias_at2 reads both).
__device__ __forceinline__ const float* bias_at(const unsigned char* tile, int rows, int row,
                                                int key) {
  return reinterpret_cast<const float*>(tile + (key >> 5) * rows * 128 + row * 128 +
                                        ((((key & 31) >> 2) ^ (row & 7)) << 4) + ((key & 3) << 2));
}

// The fp32 additive bias of the thread's two query rows: row[r] points at
// the bias of row r (key 0), keys `sbm` apart. BIAS: 0 none, 1 the same for
// every query row (a key bias: row[1] is not read), 2 per row, 3 per row,
// staged per tile in shared memory by TMA (make_bias_map boxes).
struct BiasRows {
  const float* row[2];
  int sbm;
};

// Per thread: the running max and (partial, this lane's keys) sum of its
// two rows, and O's 64 x 64 accumulator block.
struct RowState {
  float m[2], l[2];
  float o[32];
};

template <int KT>
__device__ __forceinline__ void qk_tile(float (&s)[KT / 2], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (KT == 128)
      wgmma_m64n128k16(s, dq + 2 * k, dk + 2 * k, k);
    else
      wgmma_m64n64k16(s, dq + 2 * k, dk + 2 * k, k);
  }
}

template <int KT>
__device__ __forceinline__ void pv_tile(float (&o)[32], uint32_t (&p)[KT / 4], uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_m64n64k16_rs_mn(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                          dv + kk * (2048 >> 4));
}

constexpr float BIAS_FLOOR = -1e30f;

// A key bias in the form the softmax reads it from shared memory: clamped
// to BIAS_FLOOR, in log2 units.
__device__ __forceinline__ float key_bias_log2(float b) { return fmaxf(b, BIAS_FLOOR) * LOG2E; }

__device__ __forceinline__ float2 lds_f2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(smem_u32(p)));
  return v;
}

__device__ __forceinline__ float4 lds_f4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

// Logits of one tile (keys key0 + [0, KT)) in log2 units from the raw
// products in s (scale2 = scale * log2(e)), the new running max, and s
// turned into p = exp2(logit - max) (0 past M); alpha[r] rescales row r's
// earlier sums. BIAS 1 takes the tile's key bias from shared memory (kbs:
// KT values, key_bias_log2 of each), BIAS 2 reads each row's from bias,
// BIAS 3 from the tile's staged rows (kbs: the bias_at tile of the
// warpgroup's 64 rows, raw values).
template <int KT, int BIAS, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[KT / 2], RowState& st, float (&alpha)[2],
                                             const float* kbs, const BiasRows& bias, int key0,
                                             int M, float scale2) {
  const int quad = threadIdx.x % 4;
  const int row0 = (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4;  // BIAS 3
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    float2 kb = make_float2(0.f, 0.f), rb[2];
    if (BIAS == 1) kb = lds_f2(kbs + 8 * j + 2 * quad);
    if (BIAS == 3) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rb[r] = lds_f2(bias_at(reinterpret_cast<const unsigned char*>(kbs), 64, row0 + 8 * r,
                               8 * j + 2 * quad));
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = key0 + 8 * j + 2 * quad + c;
      const bool in = !MASK || key < M;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float b = 0.f;
        if (BIAS == 1) b = c ? kb.y : kb.x;
        if (BIAS == 2 && in) b = key_bias_log2(__ldg(bias.row[r] + (size_t)key * bias.sbm));
        if (BIAS == 3) b = key_bias_log2(c ? rb[r].y : rb[r].x);
        float v = fmaf(s[4 * j + 2 * r + c], scale2, b);
        if (!in) v = neg_inf;
        s[4 * j + 2 * r + c] = v;
        mx[r] = fmaxf(mx[r], v);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(st.m[r], mx[r]);  // finite: st.m starts finite
    alpha[r] = ex2(st.m[r] - m_new);
    st.m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(s[i] - st.m[r]);
    s[i] = p;
    sum[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + sum[r];
}

template <int KT>
__device__ __forceinline__ void pack_p(const float (&s)[KT / 2], uint32_t (&p)[KT / 4]) {
#pragma unroll
  for (int i = 0; i < KT / 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// One warpgroup attends its 64 query rows (descriptor dq) to n_tiles key
// tiles of KT keys, M keys in all. src.wait(t, dk, dv) blocks until tile t
// is in shared memory and gives its K descriptor (K-major) and V descriptor
// (MN-major); src.key_bias(t) points at its key bias in shared memory
// (BIAS 1), src.row_bias(t) at its rows' bias tile (BIAS 3);
// src.release(t) hands tile t's buffers back once P V of tile t is done.
// The running max in st.m is in log2 units.
template <int KT, int BIAS, class Src>
__device__ __forceinline__ void attend(Src& src, uint64_t dq, int n_tiles, int M, float scale,
                                       const BiasRows& bias, int zero_attn, RowState& st) {
  const float scale2 = scale * LOG2E;
  float s[KT / 2];
  uint32_t p[KT / 4];
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) st.o[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = zero_attn ? 0.f : -FLT_MAX;
    st.l[r] = 0.f;
  }
  auto softmax = [&](int t) {
    const float* kbs = nullptr;
    if constexpr (BIAS == 1) kbs = src.key_bias(t);
    if constexpr (BIAS == 3) kbs = src.row_bias(t);
    if (t * KT + KT <= M)
      softmax_tile<KT, BIAS, false>(s, st, alpha, kbs, bias, t * KT, M, scale2);
    else
      softmax_tile<KT, BIAS, true>(s, st, alpha, kbs, bias, t * KT, M, scale2);
  };
  uint64_t dk, dv, dv_prev;
  src.wait(0, dk, dv);
  wgmma_fence();
  qk_tile<KT>(s, dq, dk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  softmax(0);
  pack_p<KT>(s, p);
  dv_prev = dv;
  for (int t = 1; t < n_tiles; ++t) {
    src.wait(t, dk, dv);
    fence_acc(s);
    fence_acc(st.o);
    fence_regs(p);
    wgmma_fence();
    qk_tile<KT>(s, dq, dk);
    wgmma_commit();
    pv_tile<KT>(st.o, p, dv_prev);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile t is done; P V of tile t - 1 may run on
    fence_acc(s);
    softmax(t);
    wgmma_wait<0>();
    fence_acc(st.o);
    fence_regs(p);
    src.release(t - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) st.o[i] *= alpha[(i >> 1) & 1];
    pack_p<KT>(s, p);
    dv_prev = dv;
  }
  fence_acc(st.o);
  fence_regs(p);
  wgmma_fence();
  pv_tile<KT>(st.o, p, dv_prev);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(st.o);
  fence_regs(p);
  src.release(n_tiles - 1);
}

// O / l of the thread's two rows, as bf16, into dst[r] (64 columns of
// row r; null: a row past the sequence, not written), and where stats[r]
// is not null the row's statistics there: (max, 1 / l), the max in log2
// units (the logit's, times log2(e)). Softmax1 adds its implicit zero
// logit, exp(-max), to the sum.
__device__ __forceinline__ void store_rows(const RowState& st, int zero_attn, bf16* const (&dst)[2],
                                           float2* const (&stats)[2]) {
  const int quad = threadIdx.x % 4;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r] + __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (zero_attn) l += ex2(-st.m[r]);  // st.m in log2 units
    inv[r] = 1.f / l;
    if (stats[r] != nullptr && quad == 0) *stats[r] = make_float2(st.m[r], inv[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (dst[r] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst[r] + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(st.o[4 * j + 2 * r] * inv[r], st.o[4 * j + 2 * r + 1] * inv[r]);
  }
}

__device__ __forceinline__ void store_rows(const RowState& st, int zero_attn, bf16* const (&dst)[2]) {
  float2* const none[2] = {nullptr, nullptr};
  store_rows(st, zero_attn, dst, none);
}

}  // namespace sm90
}  // namespace fourm
