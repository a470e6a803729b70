// Attention with a blocked online softmax on Hopper, read through strides.
// One kernel body serves three wrappers:
//   flash_mha  -- replaces fourm_tpu/kernels/attention.py:pallas_flash_mha:
//                 q/k/v are the (B, N, C) heads-concatenated slices of the
//                 fused QKV output, per-head QK-norm, a (B, M) additive key
//                 bias.
//   mha_short  -- replaces fourm_tpu/kernels/attention.py:pallas_mha_short:
//                 the same on the three column slices of a (B, N, 3C) QKV
//                 output, no QK-norm.
//   attention  -- replaces fourm_tpu/kernels/attention.py:pallas_attention
//                 and, having no size split, its blocked hand-off
//                 flash_attention: (B, H, N, Dh) operands, an fp32 bias
//                 (B, 1|H, N|1, M) read with stride 0 on broadcast axes.
//   attention_train_fwd (attention_train.py) -- replaces
//                 fourm_tpu/kernels/attention_bwd.py:_train_fwd_call: the
//                 same as attention, and each row's statistics (its max
//                 logit in log2 units and 1 / its softmax sum) into a (B, H,
//                 N, 2) fp32 output, the backward's residual (a compile-time
//                 variant of the kernel, STATS).
//
// What bounds it on an H100: operations. 4*N*M*Dh FLOP per (batch, head)
// against (2N + 2M)*Dh*2 bytes: at N = M = 2048 that is ~1000 FLOP/byte. At
// Dh = 64 the exponentials weigh as much as the products: one ex2 per logit
// on the SM's 16 MUFU lanes per clock takes about as long as the logit's
// 256 tensor-core FLOP.
//
// Design (attn_sm90.cuh has the attention core):
//   * a CTA owns one (batch, head, query tile): a producer warpgroup, one
//     thread of which issues every TMA load, and consumer warpgroups of 64
//     query rows each (setmaxnreg: 40 registers for the producer). Two
//     shapes: past N = 1024, 128-query tiles (two consumers) and 128-key
//     tiles at one CTA per SM; up to it, 64-query tiles and 64-key tiles at
//     two CTAs per SM;
//   * the producer loads the Q tile once, then streams K and V tiles of KT
//     keys x 64 through a STAGES-deep ring (cp.async.bulk.tensor.4d into the
//     128-byte swizzle, `full` and `empty` mbarriers). Every operand is a
//     4-D tensor map (make_rows_map) over (batch, head, rows, Dh) with the
//     caller's strides, so a box never reads the next image's rows (TMA
//     zero-fills rows past N or M) and q/k/v may be column slices of one
//     QKV buffer or (B, H, N, Dh) views;
//   * heads of 32 (the vit_t tokenizers, narrow 4M models) run the same
//     tiles: every box is 64 head dims wide, and TMA zero-fills the 32 past
//     the map's Dh, so the shared-memory layout, the swizzle and the wgmma
//     shapes are those of Dh = 64. The zero columns add nothing to Q K^T
//     and give O zero columns, which are not stored; QK-norm takes its
//     statistics over the Dh real columns and leaves the rest zero. Half of
//     each product is spent on zeros;
//   * the consumers run the core: S = Q K^T by wgmma from shared memory,
//     the softmax on the accumulators in registers, P V by wgmma with P
//     from registers, one product in flight behind the softmax;
//   * a key bias (stride 0 over the query rows) is staged per tile in
//     shared memory by the producer warpgroup's other threads, clamped and
//     in log2 units, one key each, beside the K/V stage it belongs to; a
//     per-row bias of the short shape whose strides TMA takes (keys
//     contiguous, 16-byte rows) comes beside its K/V stage too, as the
//     tile's 64 rows x 64 keys by TMA (two fp32 boxes of 32 keys, the
//     128-byte swizzle; a three-stage ring, so that two CTAs still fit on
//     an SM): the consumers read it from shared memory instead of waiting
//     on device memory in the softmax; any other per-row bias is read by
//     the consumers from device memory;
//   * QK-norm, LayerNorm in fp32 over Dh (eps from the block norm), cast to
//     bf16 -- the order of attention.py:531-560: a pre-pass (k_norm_kernel)
//     writes LN(k) of every (batch, head) once into a bf16 scratch that the
//     wrapper allocates and the K map then reads, so K is normalised once
//     per (batch, head), not once per query tile; each consumer warpgroup
//     normalises its 64 rows of the Q tile in shared memory, which it
//     reads once anyway, two threads a row (the producer's 40-register
//     threads doing it one row each measured slower: the LN sat on every
//     CTA's critical path). The pre-pass lets the attention kernel start
//     its prologue before it ends (programmatic dependent launch).
// Dh = 64 (every 4M size) or 32. Output rows past N are not written.
#include "attn_sm90.cuh"

namespace fourm {

// A kernel shape: CONS consumer warpgroups of 64 query rows each, key tiles
// of KT keys, a STAGES-deep K/V ring, CTAS CTAs resident per SM (their
// registers split the SM's 65536: setmaxnreg gives the producer warpgroup
// 40 a thread and the consumers what is left); ROWB: each stage also holds
// the tile's per-row bias (BQ rows x KT keys, fp32, by TMA).
template <int CONS_, int KT_, int STAGES_, bool ROWB_ = false>
struct AttnShape {
  static constexpr int CONS = CONS_, KT = KT_, STAGES = STAGES_;
  static constexpr bool ROWB = ROWB_;
  static constexpr int BQ = 64 * CONS;  // query rows per CTA
  static constexpr int THREADS = 128 * (CONS + 1);
  static constexpr int CTAS = CONS == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = CONS == 1 ? 216 : 232;
  static constexpr int Q_BYTES = BQ * 128, KV_BYTES = KT * 128;  // bf16 rows of 64
  static constexpr int ROW_BYTES = ROWB ? BQ * KT * 4 : 0;
  // Q tile, STAGES x (K tile, V tile), STAGES x the rows' bias tile,
  // STAGES x the key bias of a tile, then the barriers; 1 KB for the
  // alignment of the dynamic base
  static constexpr size_t SMEM = 1024 + Q_BYTES + (size_t)STAGES * (2 * KV_BYTES + ROW_BYTES) +
                                 (size_t)STAGES * KT * sizeof(float) +
                                 (1 + 2 * STAGES) * sizeof(uint64_t);
};
// long sequences: 128-query CTAs of two consumer warpgroups, 128-key tiles
using LongShape = AttnShape<2, 128, 4>;
// short ones: 64-query CTAs, 64-key tiles, two CTAs per SM, so that one
// CTA's start (its Q and first K/V loads) overlaps another's products, and
// a sequence of 196 wastes no half tile of query rows. Measured on one H100
// at every chip_smoke.py row: 8-15% faster up to N = 784, even or slower at
// N = 2048 / 2304.
using ShortShape = AttnShape<1, 64, 4>;
// the short shape with a per-row bias staged by TMA: three stages of K, V
// and the rows' bias (16 KB a stage), 106 KB, still two CTAs per SM
using ShortRowShape = AttnShape<1, 64, 3, true>;
constexpr int SHORT_N = 1024;  // the longest query sequence ShortShape takes

struct AttnArgs {
  bf16* o; int sob, soh, son;
  const float* bias; int sbb, sbh, sbn, sbm;
  const float* qg; const float* qb;  // QK-norm's q LN parameters, or null
  float2* stats;  // STATS: (B, H, N) x (max in log2 units, 1 / sum)
  int N, M, D; float scale, eps; int zero_attn;  // D: head dims, 64 or 32
  int ord_q, ord_k, ord_v;  // coordinate slots of each map (make_rows_map)
  int bias_flags;           // make_bias_map's flags (BIAS 3)
};

// QK-norm of a consumer warpgroup's 64 query rows of the Q tile (128-byte
// swizzle: 16-byte chunk j of row r at chunk j ^ (r % 8)), in place, two
// threads a row, 32 values each: fp32 mean, fp32 mean of squared
// deviations over the D head dims, (x - mean) * rsqrt(var + eps) * g (+ b),
// one rounding to bf16. g and b (this thread's 32 columns) are read before
// the tile lands. At D = 32 the second thread of a row holds the
// zero-filled columns: it adds nothing to the statistics and writes nothing.
struct QNorm {
  float4 g[8], b[8];
  bool live;  // this thread's 32 columns are head dims
  __device__ __forceinline__ void load(const float* qg, const float* qb, int D) {
    const int half = threadIdx.x % 2;
    live = half * 32 < D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      g[i] = live ? __ldg(reinterpret_cast<const float4*>(qg + half * 32) + i)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      b[i] = live && qb != nullptr ? __ldg(reinterpret_cast<const float4*>(qb + half * 32) + i)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void apply(unsigned char* rows64, float eps, int D) const {
    const int t = threadIdx.x % 128, r = t / 2, half = t % 2;
    unsigned char* base = rows64 + r * 128;
    float f[32];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      unpack8(*reinterpret_cast<const uint4*>(base + (((half * 4 + c) ^ (r & 7)) << 4)),
              f + 8 * c);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s += f[i];
    const float mean = (s + __shfl_xor_sync(0xffffffffu, s, 1)) / (float)D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) q += (f[i] - mean) * (f[i] - mean);
    if (!live) q = 0.f;
    const float rstd = rsqrtf((q + __shfl_xor_sync(0xffffffffu, q, 1)) / (float)D + eps);
    if (!live) return;
    const float* gs = reinterpret_cast<const float*>(g);
    const float* bs = reinterpret_cast<const float*>(b);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint4 u;
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16((f[8 * c + i] - mean) * rstd * gs[8 * c + i] + bs[8 * c + i]);
      *reinterpret_cast<uint4*>(base + (((half * 4 + c) ^ (r & 7)) << 4)) = u;
    }
  }
};

// Ring of K/V stages, as attend() reads it.
template <class S>
struct KVRing {
  unsigned char* stages;
  const unsigned char* rbias;
  const float* kbias;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ void wait(int t, uint64_t& dk, uint64_t& dv) {
    const int s = t % S::STAGES;
    sm90::mbar_wait(&full[s], (t / S::STAGES) & 1);
    dk = sm90::desc_sw128(stages + s * 2 * S::KV_BYTES);
    dv = sm90::desc_sw128_mn(stages + s * 2 * S::KV_BYTES + S::KV_BYTES);
  }
  __device__ __forceinline__ const float* key_bias(int t) const {
    return kbias + (t % S::STAGES) * S::KT;
  }
  __device__ __forceinline__ const float* row_bias(int t) const {
    return reinterpret_cast<const float*>(rbias + (t % S::STAGES) * S::ROW_BYTES);
  }
  __device__ __forceinline__ void release(int t) { sm90::mbar_arrive(&empty[t % S::STAGES]); }
};

// BIAS: 0 none, 1 a key bias, 2 a per-row bias read from device memory, 3
// a per-row bias staged by TMA (S::ROWB). STATS: write the row statistics.
template <class S, int BIAS, bool STATS>
__global__ void __launch_bounds__(S::THREADS, S::CTAS)
attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
            AttnArgs p) {
  static_assert(BIAS != 3 || (S::ROWB && S::CONS == 1), "a staged row bias needs ROWB, BQ 64");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* stages = smem + S::Q_BYTES;
  unsigned char* rbias = stages + S::STAGES * 2 * S::KV_BYTES;  // S::ROWB
  float* kbias = reinterpret_cast<float*>(rbias + S::STAGES * S::ROW_BYTES);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kbias + S::STAGES * S::KT);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S::STAGES;

  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * S::BQ;
  const int n_tiles = (p.M + S::KT - 1) / S::KT;
  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      // a key bias adds one arrival from each staging thread (its key's value)
      sm90::mbar_init(&full[s], BIAS == 1 ? 1 + S::KT : 1);
      sm90::mbar_init(&empty[s], 128 * S::CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  sm90::wait_prerequisites();  // the K pre-pass's scratch

  const int wg = threadIdx.x / 128;
  if (wg == S::CONS) {
    // ---- producer warpgroup: one thread issues every TMA load; with a key
    // bias KT threads also stage one key's bias of every tile each, clamped
    // and in log2 units, then arrive on the tile's `full` barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int i = threadIdx.x - 128 * S::CONS;
    const float* brow = BIAS == 1 ? p.bias + (size_t)b * p.sbb + (size_t)h * p.sbh : nullptr;
    if (i == 0) {
      sm90::mbar_expect_tx(qbar, S::Q_BYTES);
      sm90::tma_rows(qs, &tq, qbar, p.ord_q, n0, h, b);
    }
    if (i == 0 || (BIAS == 1 && i < S::KT)) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S::STAGES;
        sm90::mbar_wait(&empty[s], ((t / S::STAGES) & 1) ^ 1);  // the first round passes
        if (i == 0) {
          unsigned char* st = stages + s * 2 * S::KV_BYTES;
          sm90::mbar_expect_tx(&full[s], 2 * S::KV_BYTES + (BIAS == 3 ? S::ROW_BYTES : 0));
          sm90::tma_rows(st, &tk, &full[s], p.ord_k, t * S::KT, h, b);
          sm90::tma_rows(st + S::KV_BYTES, &tv, &full[s], p.ord_v, t * S::KT, h, b);
          if (BIAS == 3)
            for (int j = 0; j < S::KT / 32; ++j)
              sm90::tma_bias(rbias + s * S::ROW_BYTES + j * S::BQ * 128, &tb, &full[s],
                             p.bias_flags, t * S::KT + 32 * j, n0, h, b);
        }
        if (BIAS == 1) {
          const int key = t * S::KT + i;
          kbias[s * S::KT + i] =
              key < p.M ? sm90::key_bias_log2(__ldg(brow + (size_t)key * p.sbm)) : 0.f;
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: query rows n0 + 64 wg .. + 64
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(S::CONSUMER_REGS));
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = n0 + wg * 64 + warp * 16 + lane / 4;
    sm90::BiasRows bias{{nullptr, nullptr}, p.sbm};
    if (BIAS == 1 || BIAS == 2) {
      const float* bh = p.bias + (size_t)b * p.sbb + (size_t)h * p.sbh;
#pragma unroll
      for (int r = 0; r < 2; ++r) bias.row[r] = bh + (size_t)min(row0 + 8 * r, p.N - 1) * p.sbn;
    }
    KVRing<S> ring{stages, rbias, kbias, full, empty};
    sm90::RowState st;
    if (p.qg != nullptr) {
      QNorm qn;
      qn.load(p.qg, p.qb, p.D);
      sm90::mbar_wait(qbar, 0);
      qn.apply(qs + wg * 64 * 128, p.eps, p.D);
      // the generic-proxy stores, seen by the warpgroup's wgmma (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    } else {
      sm90::mbar_wait(qbar, 0);
    }
    sm90::attend<S::KT, BIAS>(ring, sm90::desc_sw128(qs + wg * 64 * 128), n_tiles, p.M, p.scale,
                              bias, p.zero_attn, st);
    bf16* dst[2];
    float2* stats[2] = {nullptr, nullptr};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = row0 + 8 * r;
      dst[r] = n < p.N ? p.o + (size_t)b * p.sob + (size_t)h * p.soh + (size_t)n * p.son
                       : nullptr;
      if (STATS && n < p.N) stats[r] = p.stats + ((size_t)b * gridDim.y + h) * p.N + n;
    }
    sm90::store_rows(st, p.zero_attn, dst, stats, p.D);
  }
}

// Maps and launch of shape S with bias kind BIAS (tb: its map, BIAS 3).
template <class S, int BIAS>
int launch_attn(const void* q, const void* k, const void* v, const long long (&qs)[3],
                const long long (&ks)[3], const long long (&vs)[3], int B, int H, AttnArgs p,
                const CUtensorMap& tb, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = sm90::make_rows_map(&tq, q, B, H, p.N, qs[0], qs[1], qs[2], S::BQ, &p.ord_q, false,
                                sw, p.D);
  if (err == 0)
    err = sm90::make_rows_map(&tk, k, B, H, p.M, ks[0], ks[1], ks[2], S::KT, &p.ord_k, false, sw,
                              p.D);
  if (err == 0)
    err = sm90::make_rows_map(&tv, v, B, H, p.M, vs[0], vs[1], vs[2], S::KT, &p.ord_v, false, sw,
                              p.D);
  if (err != 0) return err;
  auto kern = p.stats != nullptr ? attn_kernel<S, BIAS, true> : attn_kernel<S, BIAS, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (e != cudaSuccess) return (int)e;
  return sm90::launch_dependent(kern, dim3((p.N + S::BQ - 1) / S::BQ, H, B), dim3(S::THREADS),
                                S::SMEM, st, tq, tk, tv, tb, p);
}

// The shape and bias kind: 0 no bias; 1 one bias row for every query
// (stride 0 over N); a per-row bias staged by TMA (3) in the short shape
// where make_bias_map takes it, else read from device memory (2).
int launch_attention(const void* q, const void* k, const void* v, const long long (&qs)[3],
                     const long long (&ks)[3], const long long (&vs)[3], int B, int H, AttnArgs p,
                     cudaStream_t st) {
  CUtensorMap tb{};
  const bool short_ = p.N <= SHORT_N;
  if (p.bias == nullptr)
    return short_ ? launch_attn<ShortShape, 0>(q, k, v, qs, ks, vs, B, H, p, tb, st)
                  : launch_attn<LongShape, 0>(q, k, v, qs, ks, vs, B, H, p, tb, st);
  if (p.sbn == 0 || p.N == 1)
    return short_ ? launch_attn<ShortShape, 1>(q, k, v, qs, ks, vs, B, H, p, tb, st)
                  : launch_attn<LongShape, 1>(q, k, v, qs, ks, vs, B, H, p, tb, st);
  if (short_ && p.sbm == 1 &&
      sm90::make_bias_map(&tb, p.bias, B, H, p.N, p.M, p.sbb, p.sbh, p.sbn, ShortRowShape::BQ,
                          &p.bias_flags) == 0)
    return launch_attn<ShortRowShape, 3>(q, k, v, qs, ks, vs, B, H, p, tb, st);
  return short_ ? launch_attn<ShortShape, 2>(q, k, v, qs, ks, vs, B, H, p, tb, st)
                : launch_attn<LongShape, 2>(q, k, v, qs, ks, vs, B, H, p, tb, st);
}

struct KNormArgs {
  const bf16* k; bf16* out;
  int skb, skh, skn;
  const float* kg; const float* kb;
  int B, H, M, D; float eps;
};

// LN over the D head dims (64 or 32) of every row of k (B, H, M), read
// through strides, into out (B, M, H, D), contiguous -- the order of a
// heads-concatenated (B, M, C) buffer, so that reads and writes both walk
// whole token rows. 8 lanes per row, 8 values each (at D = 32 the last four
// lanes hold none), KN_ROWS rows per lane group (their loads in flight
// together); fp32 mean, fp32 mean of squared deviations, (x - mean) *
// rsqrt(var + eps) * g (+ b), one rounding to bf16.
constexpr int KN_ROWS = 2;

__global__ void __launch_bounds__(256) k_norm_kernel(KNormArgs a) {
  sm90::allow_dependents();  // the attention kernel's prologue may start
  const int total = a.B * a.M * a.H;
  const int vi = threadIdx.x % 8;
  const bool live = vi * 8 < a.D;  // this lane's 8 values are head dims
  const int first = (blockIdx.x * 32 + threadIdx.x / 8) * KN_ROWS;
  uint4 u[KN_ROWS];
#pragma unroll
  for (int i = 0; i < KN_ROWS; ++i) {
    const int row = first + i;
    u[i] = make_uint4(0, 0, 0, 0);
    if (row >= total || !live) continue;
    const int h = row % a.H, bm = row / a.H;
    const int m = bm % a.M, b = bm / a.M;
    u[i] = *reinterpret_cast<const uint4*>(a.k + (size_t)b * a.skb + (size_t)h * a.skh +
                                           (size_t)m * a.skn + vi * 8);
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* g4 = reinterpret_cast<const float4*>(a.kg + vi * 8);
  const float4 g[2] = {live ? g4[0] : zero, live ? g4[1] : zero};
  float4 bv[2] = {zero, zero};
  if (a.kb != nullptr && live) {
    bv[0] = reinterpret_cast<const float4*>(a.kb + vi * 8)[0];
    bv[1] = reinterpret_cast<const float4*>(a.kb + vi * 8)[1];
  }
  const float gg[8] = {g[0].x, g[0].y, g[0].z, g[0].w, g[1].x, g[1].y, g[1].z, g[1].w};
  const float bb[8] = {bv[0].x, bv[0].y, bv[0].z, bv[0].w, bv[1].x, bv[1].y, bv[1].z, bv[1].w};
#pragma unroll
  for (int i = 0; i < KN_ROWS; ++i) {
    const int row = first + i;
    bf16* e = reinterpret_cast<bf16*>(&u[i]);
    float f[8];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      f[j] = __bfloat162float(e[j]);
      s += f[j];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / (float)a.D;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = f[j] - mean;
      q += d * d;
    }
    if (!live) q = 0.f;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rstd = rsqrtf(q / (float)a.D + a.eps);
    if (row >= total || !live) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y = (f[j] - mean) * rstd * gg[j];
      if (a.kb != nullptr) y += bb[j];
      e[j] = __float2bfloat16(y);
    }
    *reinterpret_cast<uint4*>(a.out + (size_t)row * a.D + vi * 8) = u[i];
  }
}

}  // namespace fourm

// q (B, H, N, Dh), k and v (B, H, M, Dh), Dh 64 or 32, bf16 read through element strides
// (s*b, s*h, s*n: multiples of 8, the last dim contiguous, 16-byte aligned
// bases); o written through its strides. bias: fp32 through (sbb, sbh,
// sbn, sbm), 0 on broadcast axes, or null. qg, qb, kg, kb: QK-norm's fp32
// LN parameters, 16-byte aligned (qg null: no QK-norm; qb, kb may be null);
// qk_scratch: bf16 (B * M * H, Dh), LN(k), when qg is given. stats: null,
// or fp32 (B, H, N, 2), contiguous, for each row its max logit in log2
// units and 1 / its softmax sum.
extern "C" int fourm_attention(
    const void* q, const void* k, const void* v, void* o,
    int sqb, int sqh, int sqn, int skb, int skh, int skn,
    int svb, int svh, int svn, int sob, int soh, int son,
    const void* bias, int sbb, int sbh, int sbn, int sbm,
    const void* qg, const void* qb, const void* kg, const void* kb, void* qk_scratch,
    int B, int H, int N, int M, int Dh, float scale, float eps, int zero_attn, void* stats,
    void* stream) {
  using namespace fourm;
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || M < 1 || (Dh != 64 && Dh != 32)) return (int)cudaErrorInvalidValue;
  const long long qs[3] = {sqb, sqh, sqn};
  long long ks[3] = {skb, skh, skn};
  if (qg != nullptr) {
    if (qk_scratch == nullptr) return (int)cudaErrorInvalidValue;
    KNormArgs a;
    a.k = (const bf16*)k; a.out = (bf16*)qk_scratch;
    a.skb = skb; a.skh = skh; a.skn = skn;
    a.kg = (const float*)kg; a.kb = (const float*)kb;
    a.B = B; a.H = H; a.M = M; a.D = Dh; a.eps = eps;
    const long long rows = (long long)B * H * M;
    if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const long long per_block = 32 * KN_ROWS;
    k_norm_kernel<<<(unsigned)((rows + per_block - 1) / per_block), 256, 0, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k = qk_scratch;
    ks[0] = (long long)M * H * Dh; ks[1] = Dh; ks[2] = (long long)H * Dh;
  }
  AttnArgs p;
  p.o = (bf16*)o; p.sob = sob; p.soh = soh; p.son = son;
  p.bias = (const float*)bias; p.sbb = sbb; p.sbh = sbh; p.sbn = sbn; p.sbm = sbm;
  p.qg = (const float*)qg; p.qb = (const float*)qb;
  p.stats = (float2*)stats;
  p.N = N; p.M = M; p.D = Dh; p.scale = scale; p.eps = eps; p.zero_attn = zero_attn;
  p.bias_flags = 0;
  const long long vs[3] = {svb, svh, svn};
  return launch_attention(q, k, v, qs, ks, vs, B, H, p, st);
}
