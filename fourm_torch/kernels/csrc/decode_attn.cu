// Single-query (decode) attention, and the query product of the decode
// step's cross-attention, for Hopper.
//   decode_attention -- replaces fourm_tpu/kernels/decode_step.py:
//       pallas_decode_attention, and is the attention core of
//       pallas_cross_decode_attn: out = softmax(q k^T * Dh^-0.5 + bias) v
//       for one query per (batch, head) over M keys, fp32 logits and
//       softmax. cast_p: probabilities rounded to bf16 before p V (the
//       decode_attention semantics); 0 keeps them fp32 (the cross kernel's).
//       Its int8 mode (K/V int8 with fp32 per-(b, h, channel) scales, from
//       quantize_kv_decode) is the quant branch of the TPU kernel's
//       _cross_attn_kernel (decode_step.py:292-375), in the same fold
//       order: the K scale multiplies the fp32 q before the logits, the V
//       scale the combined fp32 accumulator before the division by the
//       softmax sum. No dequantized K/V is written; probabilities stay fp32.
//   CrossQ -- the prologue of pallas_cross_decode_attn: q = q_norm(
//       LN_q(x) Wq^T (+b)) per head, fp32 statistics, rounded to bf16, as an
//       operation of the weight-streaming core (gemv_sm90.cuh).
//
// What bounds them on an H100: bytes. decode_attention reads K and V once,
// 2*B*H*M*64*2 bytes: 151 MB at 4M-21 XL (B = 8, H = 32, M = 2304), 45 us
// at 3.35 TB/s, with 4 FLOP per 2 bytes read. The int8 mode reads half. The
// q product reads Wq (C*C bf16, 8.4 MB at XL, 2.5 us).
// No tensor cores: there is one query per (batch, head) and K/V are not
// shared across rows, so a 64-row wgmma tile would do 1/64 useful work; at
// the HBM rate the kernel needs about 10% of the CUDA cores' fp32 rate, so
// the logits and p V are fp32 FMAs from shared memory.
//
// Design of decode_attention: split-K flash decoding fed by TMA.
//   * The plan (decode_step.py:decode_attention_plan, plain ints): each
//     (batch row, head) takes `split` CTAs, one thread-block cluster, rank r
//     holding keys [r * kps, min((r + 1) * kps, M)), kps a multiple of the
//     64-key tile; grid (split, H, B), resident in one wave, about one CTA
//     an SM in bf16 and 1.5 in int8 (a CTA streams some 20 GB/s, its
//     consumers' latency per tile bounds it; larger grids measured slower);
//     a ring of `stages` stages, about 100 KB: what a CTA of
//     cross_decode_attn buffers while the q product runs.
//   * A producer warp, whose lane 0 streams the rank's keys as 64-key tiles
//     of K and of V (8 KB each in bf16, 4 KB in int8) and the tile's fp32
//     key bias (256 bytes) by TMA into the ring (make_rows_map over the
//     callers' strides: K and V may be head views of one (B, M, 2, H, 64)
//     projection; rows past M read as zero), K and V of a tile on one
//     mbarrier, as far ahead as the ring allows, so the bytes in flight
//     never wait on the softmax.
//   * Four consumer warps take 16 keys of each tile each (8 lanes a row,
//     16 bytes of bf16 or 8 of int8 a lane, keys g, g + 4, g + 8, g + 12 of
//     the warp's 16 for lane group g): one pass, an online softmax per warp
//     (running max, sum and p V in fp32 registers), the stage released once
//     it is read; the four warps' states meet in shared memory in order.
//     Logits are q.k * scale + bias, never folded, so a finfo(f32).min bias
//     stays finite and a row whose keys are all masked gets uniform
//     weights; the max starts at -FLT_MAX, or 0 for softmax1, whose
//     implicit zero logit adds exp(-max) to the sum.
//   * The ranks of a cluster combine in shared memory: each rank but 0
//     sends its (p V, max, sum) to rank 0 by st.async, completing the
//     transaction count of an mbarrier of rank 0, and exits; rank 0 combines
//     them in rank order (no atomics: two runs are bit-identical), applies
//     the V scale and the division, and writes the row. No second launch,
//     no scratch in device memory.
//   * Programmatic dependent launch: cross_decode_attn launches this kernel
//     right after its q product with `early` set: the producer issues the
//     K/V and bias tiles from its first instruction, since the kernel before
//     (the q product, which let this one launch only after its own wait on
//     every kernel before it) writes nothing but q; the consumers read q
//     after griddepcontrol.wait, so streaming K/V overlaps the Wq product. A
//     standalone decode_attention / decode_attention_int8 call launches
//     under PDL too, but its producer waits before its first load (the
//     kernel before it may have written K/V or the bias): only the launch
//     and the set-up overlap that kernel's tail. The kernel lets its
//     dependent launch once its consumers run: on the decode step that is
//     residual_mlp's Wp product, which reads only its weights before its
//     own wait, never this kernel's output.
#include <float.h>

#include "attn_sm90.cuh"
#include "gemv_sm90.cuh"

namespace fourm {
namespace da {

namespace cg = cooperative_groups;

constexpr int DH = 64;
constexpr int TILE = 64;                        // keys per ring stage
constexpr int CONSUMERS = 4;                    // warps, 16 keys of a tile each
constexpr int THREADS = 32 * (CONSUMERS + 1);   // + the producer warp
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLIT = 16;
constexpr int CTAS_PER_SM = 4;                  // the launch bound
constexpr int PART = DH + 2;                    // floats a rank sends rank 0: p V, max, sum
__host__ __device__ constexpr int kv_tile_bytes(bool int8) { return TILE * DH * (int8 ? 1 : 2); }
// a stage: the K tile, the V tile, the tile's fp32 key bias
__host__ __device__ constexpr int stage_bytes(bool int8) {
  return 2 * kv_tile_bytes(int8) + TILE * 4;
}
// dynamic shared memory (decode_step.py:decode_attention_smem): 1024-byte
// alignment slack, the ring, then rank 0's gather buffer of the other
// ranks' partials; the barriers and the warps' states are static
__host__ __device__ constexpr size_t smem_bytes(int stages, int split, bool int8) {
  return 1024 + (size_t)stages * stage_bytes(int8) + (size_t)(split - 1) * PART * 4;
}

// 8 values of a key or value row, as one load: bf16 (16 bytes) or int8 (8)
template <typename T>
struct Row8;
template <>
struct Row8<bf16> {
  using Vec = uint4;
  static __device__ __forceinline__ void unpack(const Vec& u, float* f) { unpack8(u, f); }
};
template <>
struct Row8<int8_t> {
  using Vec = uint2;
  static __device__ __forceinline__ void unpack(const Vec& u, float* f) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)e[i];
  }
};

struct Args {
  const bf16* q;
  int sqb, sqh;                   // q's element strides (its 64 dims contiguous)
  const float* ks;                // int8 mode: (B, H, 64) scales; else null
  const float* vs;
  bf16* out;                      // (B, H, 1, 64)
  int H, M, kps, stages;
  int kord, vord, bias_flags;     // the maps' coordinate slots (make_rows_map, key_bias_map)
  float scale;
  int zero_attn, cast_p, early;
};

// Barrier 1 among the consumer warps.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * CONSUMERS) : "memory");
}

template <typename T, bool BIAS>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
decode_attn_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tb, Args a) {
  using Vec = typename Row8<T>::Vec;
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int KVT = kv_tile_bytes(INT8), ST = stage_bytes(INT8), ROW = DH * (int)sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* gather = reinterpret_cast<float*>(ring + (size_t)a.stages * ST);
  __shared__ uint64_t full[MAX_STAGES], empty[MAX_STAGES], gathered;
  __shared__ float wm[CONSUMERS], wl[CONSUMERS], wacc[CONSUMERS][DH];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int key0 = rank * a.kps;
  const int n = min(a.kps, a.M - key0);  // at least one: the plan leaves no rank empty
  const int ntiles = (n + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = a.stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::mbar_init(&gathered, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  gemv::cluster_arrive_relaxed();

  if (warp == CONSUMERS) {  // the producer
    if (lane == 0) {
      if (!a.early) sm90::wait_prerequisites();
      int s = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        sm90::mbar_wait(&empty[s], phase ^ 1);  // the first round passes at once
        unsigned char* st = ring + s * ST;
        const int row = key0 + t * TILE;
        sm90::mbar_expect_tx(&full[s], BIAS ? ST : 2 * KVT);
        sm90::tma_rows(st, &tk, &full[s], a.kord, row, h, b);
        sm90::tma_rows(st + KVT, &tv, &full[s], a.vord, row, h, b);
        if (BIAS)
          sm90::tma_load_3d(st + 2 * KVT, &tb, &full[s], row, (a.bias_flags & 1) ? h : 0,
                            (a.bias_flags & 2) ? b : 0);
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    gemv::cluster_wait();
    return;
  }

  // the consumers: q is the kernel before's output under PDL
  sm90::wait_prerequisites();
  sm90::allow_dependents();
  const int g = lane / 8, vi = lane % 8;
  float qf[8];
  {
    const bf16* qr = a.q + (size_t)b * a.sqb + (size_t)h * a.sqh + vi * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[e] = __bfloat162float(qr[e]);
    if (a.ks != nullptr) {  // the K scale into q
      const float* kr = a.ks + ((size_t)b * a.H + h) * DH + vi * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[e] *= kr[e];
    }
  }
  const float neg_inf = __int_as_float(0xff800000);
  float m = a.zero_attn ? 0.f : -FLT_MAX, l = 0.f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int s = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    sm90::mbar_wait(&full[s], phase);
    const unsigned char* st = ring + s * ST;
    Vec ku[4], vu[4];
    float kb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + g + 4 * i;
      ku[i] = *reinterpret_cast<const Vec*>(st + r * ROW + vi * (int)sizeof(Vec));
      vu[i] = *reinterpret_cast<const Vec*>(st + KVT + r * ROW + vi * (int)sizeof(Vec));
      if (BIAS) kb[i] = reinterpret_cast<const float*>(st + 2 * KVT)[r];
    }
    // logits of the warp's 16 keys (8 lanes a key), their max
    float sv[4], mx = neg_inf;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[8];
      Row8<T>::unpack(ku[i], f);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d += qf[e] * f[e];
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d *= a.scale;
      if (BIAS) d += kb[i];
      sv[i] = t * TILE + warp * 16 + g + 4 * i < n ? d : neg_inf;  // past the rank's keys: none
      mx = fmaxf(mx, sv[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float mn = fmaxf(m, mx), corr = expf(m - mn);  // m finite: never -inf - -inf
    m = mn;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= corr;
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(sv[i] - m);
      ps += p;
      const float pv = a.cast_p ? bf16_round(p) : p;
      float f[8];
      Row8<T>::unpack(vu[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += pv * f[e];
    }
    l = l * corr + ps;  // the sum of lane group g's keys
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
  // the warp's state: sums over its 4 lane groups
  l += __shfl_xor_sync(0xffffffffu, l, 8);
  l += __shfl_xor_sync(0xffffffffu, l, 16);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 8);
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
  }
  if (g == 0)
#pragma unroll
    for (int e = 0; e < 8; ++e) wacc[warp][vi * 8 + e] = acc[e];
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  consumers_sync();
  if (warp != 0) {
    gemv::cluster_wait();
    return;
  }
  // warp 0: the CTA's state from its warps in order, dims lane and lane + 32
  float mc = wm[0];
#pragma unroll
  for (int w = 1; w < CONSUMERS; ++w) mc = fmaxf(mc, wm[w]);
  float lc = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
  for (int w = 0; w < CONSUMERS; ++w) {
    const float wt = expf(wm[w] - mc);
    lc += wl[w] * wt;
    o0 += wacc[w][lane] * wt;
    o1 += wacc[w][lane + 32] * wt;
  }
  gemv::cluster_wait();  // rank 0's barrier is initialised
  if (rank > 0) {        // to rank 0's slot rank - 1: (dim d, d + 32) pairs, then max, sum
    const uint32_t dst = gemv::cluster_addr(gather + (rank - 1) * PART, 0);
    const uint32_t bar = gemv::cluster_addr(&gathered, 0);
    gemv::st_async(dst + 8 * lane, o0, o1, bar);
    if (lane == 0) gemv::st_async(dst + 4 * DH, mc, lc, bar);
    return;
  }
  if (split > 1) {
    if (lane == 0) sm90::mbar_expect_tx(&gathered, (split - 1) * PART * 4);
    gemv::mbar_wait_cluster(&gathered, 0);
  }
  float mx = mc;
  for (int r = 1; r < split; ++r) mx = fmaxf(mx, gather[(r - 1) * PART + DH]);
  const float w0 = expf(mc - mx);
  float L = lc * w0, O0 = o0 * w0, O1 = o1 * w0;
  for (int r = 1; r < split; ++r) {  // in rank order
    const float* p = gather + (r - 1) * PART;
    const float wt = expf(p[DH] - mx);
    L += p[DH + 1] * wt;
    O0 += p[2 * lane] * wt;
    O1 += p[2 * lane + 1] * wt;
  }
  if (a.zero_attn) L += expf(-mx);  // softmax1: the implicit zero logit
  const size_t row = ((size_t)b * a.H + h) * DH;
  if (a.vs != nullptr) {  // the V scale, before / L
    O0 *= a.vs[row + lane];
    O1 *= a.vs[row + lane + 32];
  }
  a.out[row + lane] = __float2bfloat16(O0 / L);
  a.out[row + lane + 32] = __float2bfloat16(O1 / L);
}

// The map of an fp32 key bias (B|1, 1|H, M), keys contiguous, batch and
// head strides sbb, sbh (0 on a broadcast axis, else multiples of 4), read
// unswizzled in boxes of the 64 keys of a tile; `pitch` (a multiple of 4,
// at least M) stands for the stride of a broadcast axis. Keys past M read
// as zero. *flags: bit 0 the head coordinate indexes the map, bit 1 the
// batch's.
inline int key_bias_map(CUtensorMap* map, const void* base, int B, int H, int M, long long sbb,
                        long long sbh, long long pitch, int* flags) {
  if (pitch < M || pitch % 4 != 0 || sbh % 4 != 0 || sbb % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)M, (cuuint64_t)(sbh != 0 ? H : 1),
                              (cuuint64_t)(sbb != 0 ? B : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)(sbh != 0 ? sbh : pitch) * 4,
                                 (cuuint64_t)(sbb != 0 ? sbb : pitch * (long long)dims[1]) * 4};
  const cuuint32_t box[3] = {TILE, 1, 1};
  *flags = (sbh != 0 ? 1 : 0) | (sbb != 0 ? 2 : 0);
  return sm90::encode_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace da

// The q product's operation on gemv_sm90.cuh: tokens LN_q(x) (the
// query_norm parameters read before the wait); Wq's 64-row tiles are one
// head each, so the epilogue adds the head's bias, applies the per-head
// q-norm in fp32 and writes q rounded to bf16 as (B, H, 1, 64).
struct CrossQ {
  const bf16* x;
  const void *g, *be, *bq, *qng, *qnb;
  int pbf;
  bf16* q;
  int B, C;
  float eps;

  static constexpr bool LN = true;
  __device__ void prologue(float* lnp, int kb0, int nkb, int, int, int) const {
    gemv::ln_prologue(lnp, kb0, nkb, C, g, be, pbf);
  }
  __device__ void stage(unsigned char* act, const float* lnp, int kb0, int nkb, int nt,
                        int n0) const {
    gemv::stage_ln(act, lnp, kb0, nkb, nt, n0, x, B, C, eps);
  }
  // a warp per token: lane holds head dims lane and lane + 32
  __device__ void epilogue(const float* sum, const float*, int m0, int n0, int nt) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < nt; c += gemv::THREADS / 32) {
      const int b = n0 + c;
      if (b >= B) break;
      float a0 = sum[lane * gemv::cs(nt) + c], a1 = sum[(lane + 32) * gemv::cs(nt) + c];
      if (bq != nullptr) {
        a0 += ld_param(bq, m0 + lane, pbf);
        a1 += ld_param(bq, m0 + lane + 32, pbf);
      }
      if (qng != nullptr) gemv::head_norm(a0, a1, qng, qnb, pbf, eps);
      bf16* dst = q + (size_t)b * C + m0;
      dst[lane] = __float2bfloat16(a0);
      dst[lane + 32] = __float2bfloat16(a1);
    }
  }
};

}  // namespace fourm

// int8: k, v are int8 and ks, vs their fp32 (B, H, 64) scales; else bf16
// with null scales. bias: fp32 (B|1, 1|H, M) with strides sbb, sbh (0 where
// it broadcasts), keys contiguous, or null. plan: split, keys per split,
// ring stages (decode_step.py:decode_attention_plan). Launched under PDL; early: right
// after the q product, the K/V stream started before the wait.
extern "C" int fourm_decode_attention(const void* q, int sqb, int sqh, const void* k,
                                      const void* v, int skb, int skh, int skm, int svb,
                                      int svh, int svm, const void* ks, const void* vs,
                                      int int8, const void* bias, int sbb, int sbh, int pitch,
                                      void* out, int B, int H, int M, float scale, int zero_attn,
                                      int cast_p, int early, const int* plan, void* stream) {
  using namespace fourm;
  const int split = plan[0], kps = plan[1], stages = plan[2];
  const size_t smem = da::smem_bytes(stages, split, int8 != 0);
  if (split < 1 || split > da::MAX_SPLIT || kps < 1 || kps % da::TILE != 0 ||
      (long long)split * kps < M || (long long)(split - 1) * kps >= M || stages < 1 ||
      stages > da::MAX_STAGES || smem > (size_t)gemv::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv, tb;
  da::Args a;
  int err = sm90::make_rows_map(&tk, k, B, H, M, skb, skh, skm, da::TILE, &a.kord, int8 != 0,
                                CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0)
    err = sm90::make_rows_map(&tv, v, B, H, M, svb, svh, svm, da::TILE, &a.vord, int8 != 0,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  a.bias_flags = 0;
  if (err == 0 && bias != nullptr)
    err = da::key_bias_map(&tb, bias, B, H, M, sbb, sbh, pitch, &a.bias_flags);
  if (err != 0) return err;
  if (bias == nullptr) tb = tk;  // not read
  a.q = (const bf16*)q;
  a.sqb = sqb;
  a.sqh = sqh;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.out = (bf16*)out;
  a.H = H;
  a.M = M;
  a.kps = kps;
  a.stages = stages;
  a.scale = scale;
  a.zero_attn = zero_attn;
  a.cast_p = cast_p;
  a.early = early;
  const dim3 grid(split, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  auto kern = int8 ? (bias != nullptr ? da::decode_attn_kernel<int8_t, true>
                                      : da::decode_attn_kernel<int8_t, false>)
                   : (bias != nullptr ? da::decode_attn_kernel<bf16, true>
                                      : da::decode_attn_kernel<bf16, false>);
  return gemv::launch_cluster(kern, grid, da::THREADS, split, smem, s, tk, tv, tb, a);
}

// plan: the q product's N tile, passes over B, split and K blocks per CTA
// (decode_step.py:gemv_plan(C, C, B, ln=True)).
extern "C" int fourm_cross_q(const void* x, const void* g, const void* be, const void* bq,
                             const void* qng, const void* qnb, int pbf, const void* w, void* q,
                             int B, int C, float eps, const int* plan, void* stream) {
  using namespace fourm;
  const gemv::Plan p{plan[0], plan[1], plan[2], plan[3]};
  return gemv::launch_gemv<CrossQ, false>(
      w, nullptr, C, C, p, CrossQ{(const bf16*)x, g, be, bq, qng, qnb, pbf, (bf16*)q, B, C, eps},
      (cudaStream_t)stream);
}
