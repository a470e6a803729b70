// Single-query (decode) attention, and the query prologue of the decode
// step's cross-attention.
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
//       scale the combined fp32 accumulator after the chunks are reduced
//       and before the division by the softmax sum. No dequantized K/V is
//       written; probabilities stay fp32.
//   cross_q -- the prologue of pallas_cross_decode_attn: q = q_norm(
//       LN_q(x) Wq^T (+b)) per head, fp32 statistics, rounded to bf16.
//
// What bounds them on an H100: bytes. decode_attention reads K and V once,
// 2*B*H*M*64*2 bytes: 50.3 MB at B = 8, H = 12, M = 2048, 15.0 us at
// 3.35 TB/s, with 4 FLOP per 2 bytes read. The int8 mode reads half:
// 2*B*H*M*64 bytes plus 2*B*H*64 fp32 scales. cross_q reads Wq (C*C bf16,
// 1.2 MB, 0.35 us).
//
// Design of decode_attention: split-K flash-decoding. The TPU kernel walks M
// in order inside one grid cell per head group, carrying the running max and
// sum in scratch; on Hopper blocks run in parallel in no order, so a block
// takes one (chunk of `chunk` keys, head, batch row): 768 blocks at B = 8,
// M = 2048, chunk 256. 128 threads; 8 lanes per key or value row (8 values
// each: a 16-byte slice of a bf16 row, an 8-byte slice of an int8 one; so
// a warp reads four rows at once, through
// the caller's strides: K/V may be head views of a fused KV projection),
// with the loads of 4 such passes in flight together; the chunk's max m_c,
// its sum l_c of exp(s - m_c) and its unnormalised p V go to an fp32
// scratch. A second kernel per (head, batch row) combines the chunks in
// chunk order with weights exp(m_c - m): a fixed order, no atomics. The bias is scaled-logit + bias, never folded,
// so a finfo(f32).min bias stays finite: a row whose keys are all masked gets
// uniform weights. softmax1 starts the max at 0 and adds exp(-m).
// Design of cross_q: one block per (head, batch row), the LN of the row
// recomputed per block, the head's 64 columns as warp GEMVs over Wq rows.
// A first version: no cp.async/TMA pipelining.
#include <float.h>

#include "common.cuh"

namespace fourm {

constexpr int DA_THREADS = 128;
constexpr int DA_DH = 64;
constexpr int DA_U = 4;  // passes of key / value rows whose loads are issued together

struct DecodeArgs {
  const bf16* q; int sqb, sqh;
  const void* k; const void* v; int skb, skh, skm, svb, svh, svm;  // strides in elements
  const float* ks; const float* vs;  // int8 mode: (B, H, 64) scales; else null
  const float* bias; int sbb, sbh, sbm;
  float* part;  // per (b, h, chunk): 64 p V sums, then m_c, l_c
  bf16* out;    // (B, H, 1, 64)
  int H, M, chunk, nchunk; float scale; int zero_attn, cast_p;
};

// 8 values of a key or value row, as one load: bf16 (16 bytes) or int8 (8)
template <typename T> struct Row8;
template <> struct Row8<bf16> {
  using Vec = uint4;
  static __device__ __forceinline__ void unpack(const Vec& u, float* f) { unpack8(u, f); }
};
template <> struct Row8<int8_t> {
  using Vec = uint2;
  static __device__ __forceinline__ void unpack(const Vec& u, float* f) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)e[i];
  }
};

template <typename T>
__global__ void __launch_bounds__(DA_THREADS) decode_partial_kernel(DecodeArgs a) {
  using Vec = typename Row8<T>::Vec;
  extern __shared__ float ps[];  // chunk: logits, then p
  __shared__ float qs[DA_DH];
  __shared__ float red[DA_THREADS / 32];
  __shared__ float pvp[4][DA_DH];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = c * a.chunk;
  const int n = min(a.chunk, a.M - m0);
  if (tid < DA_DH) {
    float qv = __bfloat162float(a.q[(size_t)b * a.sqb + (size_t)h * a.sqh + tid]);
    if (a.ks != nullptr) qv *= a.ks[((size_t)b * a.H + h) * DA_DH + tid];  // K scale into q
    qs[tid] = qv;
  }
  __syncthreads();

  const T* kb = static_cast<const T*>(a.k) + (size_t)b * a.skb + (size_t)h * a.skh +
                (size_t)m0 * a.skm;
  const T* vb = static_cast<const T*>(a.v) + (size_t)b * a.svb + (size_t)h * a.svh +
                (size_t)m0 * a.svm;
  const float* bb = a.bias == nullptr ? nullptr
                                      : a.bias + (size_t)b * a.sbb + (size_t)h * a.sbh +
                                            (size_t)m0 * a.sbm;
  // logits: 8 lanes per key row (8 values each), 4 keys per warp, 16
  // per pass; the loads of DA_U passes are issued together
  const int kq = lane / 8, vi = lane % 8;
  float qf[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) qf[i] = qs[vi * 8 + i];
  float lmax = -FLT_MAX;
  for (int j0 = 0; j0 < n; j0 += 16 * DA_U) {
    Vec ku[DA_U];
#pragma unroll
    for (int u = 0; u < DA_U; ++u) {
      const int j = j0 + 16 * u + warp * 4 + kq;
      ku[u] = j < n ? *reinterpret_cast<const Vec*>(kb + (size_t)j * a.skm + vi * 8) : Vec{};
    }
#pragma unroll
    for (int u = 0; u < DA_U; ++u) {
      const int j = j0 + 16 * u + warp * 4 + kq;
      float f[8];
      Row8<T>::unpack(ku[u], f);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += qf[i] * f[i];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (j < n) {
        s *= a.scale;
        if (bb != nullptr) s += bb[(size_t)j * a.sbm];
        if (vi == 0) ps[j] = s;
        lmax = fmaxf(lmax, s);
      }
    }
  }
  const float mc = block_max(lmax, red);  // syncs: ps holds the logits
  float lsum = 0.f;
  for (int j = tid; j < n; j += DA_THREADS) {
    const float p = expf(ps[j] - mc);
    lsum += p;
    ps[j] = a.cast_p ? bf16_round(p) : p;
  }
  const float lc = block_sum(lsum, red);  // syncs: ps holds p

  // p V: the same 8 lanes per value row; the 4 row groups of a warp and the
  // 4 warps are then summed in a fixed order
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < n; j0 += 16 * DA_U) {
    Vec vu[DA_U];
    float pj[DA_U];
#pragma unroll
    for (int u = 0; u < DA_U; ++u) {
      const int j = j0 + 16 * u + warp * 4 + kq;
      vu[u] = j < n ? *reinterpret_cast<const Vec*>(vb + (size_t)j * a.svm + vi * 8) : Vec{};
      pj[u] = j < n ? ps[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < DA_U; ++u) {
      float f[8];
      Row8<T>::unpack(vu[u], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += pj[u] * f[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 8);
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
  }
  if (kq == 0)
#pragma unroll
    for (int e = 0; e < 8; ++e) pvp[warp][vi * 8 + e] = acc[e];
  __syncthreads();
  float* dst = a.part + (((size_t)b * a.H + h) * a.nchunk + c) * (DA_DH + 2);
  if (tid < DA_DH) dst[tid] = pvp[0][tid] + pvp[1][tid] + pvp[2][tid] + pvp[3][tid];
  if (tid == 0) {
    dst[DA_DH] = mc;
    dst[DA_DH + 1] = lc;
  }
}

__global__ void __launch_bounds__(DA_DH) decode_combine_kernel(DecodeArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const float* src = a.part + ((size_t)b * a.H + h) * a.nchunk * (DA_DH + 2);
  float m = a.zero_attn ? 0.f : -FLT_MAX;
  for (int c = 0; c < a.nchunk; ++c) m = fmaxf(m, src[c * (DA_DH + 2) + DA_DH]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < a.nchunk; ++c) {
    const float* pc = src + c * (DA_DH + 2);
    const float w = expf(pc[DA_DH] - m);
    l += w * pc[DA_DH + 1];
    o += w * pc[d];
  }
  if (a.zero_attn) l += expf(-m);  // softmax1: the implicit zero logit
  if (a.vs != nullptr) o *= a.vs[((size_t)b * a.H + h) * DA_DH + d];  // V scale, before / l
  a.out[((size_t)b * a.H + h) * DA_DH + d] = __float2bfloat16(o / l);
}

constexpr int CQ_THREADS = 256;

__global__ void __launch_bounds__(CQ_THREADS)
cross_q_kernel(const bf16* __restrict__ x, const void* g, const void* bt, const void* bq,
               const void* qng, const void* qnb, int pbf, const bf16* __restrict__ w,
               bf16* __restrict__ q, int H, int C, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);  // C: LN_q(x)
  __shared__ float qv[DA_DH];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (warp == 0) warp_ln_row(x + (size_t)b * C, C, g, bt, pbf, eps, hs);
  __syncthreads();
  {  // 8 columns per warp: Wq rows h * 64 + warp * 8 + i
    const int r0 = h * DA_DH + warp * 8;
    const bf16* wr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) wr[i] = w + (size_t)(r0 + i) * C;
    float acc[8][1];
    warp_gemv<1, 8, 2>(hs, C, wr, C, acc);
    float y = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane == i) y = acc[i][0];
    if (lane < 8) qv[warp * 8 + lane] = y + (bq != nullptr ? ld_param(bq, r0 + lane, pbf) : 0.f);
  }
  __syncthreads();
  if (qng != nullptr && warp == 0) warp_head_norm64(qv, qng, qnb, pbf, eps);
  __syncthreads();
  if (tid < DA_DH) q[((size_t)b * H + h) * DA_DH + tid] = __float2bfloat16(qv[tid]);
}

}  // namespace fourm

// int8: k, v are int8 and ks, vs their fp32 (B, H, 64) scales; else bf16
// with null scales.
extern "C" int fourm_decode_attention(const void* q, int sqb, int sqh, const void* k,
                                      const void* v, int skb, int skh, int skm, int svb,
                                      int svh, int svm, const void* ks, const void* vs,
                                      int int8, const void* bias, int sbb, int sbh,
                                      int sbm, void* part, void* out, int B, int H, int M,
                                      int chunk, float scale, int zero_attn, int cast_p,
                                      void* stream) {
  using namespace fourm;
  DecodeArgs a;
  a.q = (const bf16*)q; a.sqb = sqb; a.sqh = sqh;
  a.k = k; a.v = v;
  a.ks = (const float*)ks; a.vs = (const float*)vs;
  a.skb = skb; a.skh = skh; a.skm = skm; a.svb = svb; a.svh = svh; a.svm = svm;
  a.bias = (const float*)bias; a.sbb = sbb; a.sbh = sbh; a.sbm = sbm;
  a.part = (float*)part; a.out = (bf16*)out;
  a.H = H; a.M = M; a.chunk = chunk; a.nchunk = (M + chunk - 1) / chunk;
  a.scale = scale; a.zero_attn = zero_attn; a.cast_p = cast_p;
  const size_t smem = (size_t)chunk * sizeof(float);
  auto kern = int8 ? decode_partial_kernel<int8_t> : decode_partial_kernel<bf16>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  kern<<<dim3(a.nchunk, H, B), DA_THREADS, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<dim3(H, B), DA_DH, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int fourm_cross_q(const void* x, const void* g, const void* bt, const void* bq,
                             const void* qng, const void* qnb, int pbf, const void* w,
                             void* q, int B, int H, int C, float eps, void* stream) {
  using namespace fourm;
  const size_t smem = (size_t)C * sizeof(bf16);
  cross_q_kernel<<<dim3(H, B), CQ_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, g, bt, bq, qng, qnb, pbf, (const bf16*)w, (bf16*)q, H, C, eps);
  return (int)cudaGetLastError();
}
