// Attention with a blocked online softmax, read and written through strides.
// One kernel body serves two wrappers:
//   flash_mha  -- replaces fourm_tpu/kernels/attention.py:pallas_flash_mha:
//                 q/k/v are the (B, N, C) heads-concatenated slices of the
//                 fused QKV output, per-head QK-norm applied in-kernel, a
//                 (B, M) additive key bias.
//   attention  -- replaces fourm_tpu/kernels/attention.py:pallas_attention
//                 and, having no size split, its blocked hand-off
//                 flash_attention: (B, H, N, Dh) operands, an fp32 bias
//                 (B, 1|H, N|1, M) read with stride 0 on broadcast axes.
//
// What bounds it on an H100: operations. 4*N*M*Dh FLOP per (batch, head)
// against (2N + 2M)*Dh*2 bytes: at N = M = 2048 that is ~1000 FLOP/byte.
//
// Design: a block takes one (batch, head, 64-query tile); 4 warps own 16
// query rows each. The block walks the keys in tiles of 64: K and V tiles
// go to shared memory (K normalised on load when QK-norm is on: LayerNorm
// in fp32 over Dh, eps from the block norm, cast to bf16 before the
// product, the order of attention.py:531-560), S = Q K^T runs on WMMA
// fragments, and each thread then owns half a row of S: scale first, then
// add the bias (never log2(e)-folded, so a finfo.min bias stays finite),
// a running max that starts finite (finfo.min, or 0 for softmax1), the
// rescale of its 32 fp32 accumulators, and P cast to bf16 for P V on WMMA.
// A row whose keys are all masked sees equal logits and gets uniform
// weights, as the one-shot TPU kernel gives. Key positions past M take no
// weight at all. Dh = 64 only (every 4M size).
// A first version: no TMA, no wgmma, no pipelining of K/V loads.
#include <float.h>

#include "common.cuh"

namespace fourm {

constexpr int AT_DH = 64;
constexpr int AT_BQ = 64;
constexpr int AT_BK = 64;
constexpr int AT_THREADS = 128;
constexpr int AT_LD = AT_DH + 8;   // bf16 tile row stride
constexpr int AT_LDS = AT_BK + 4;  // fp32 score row stride

struct AttnArgs {
  const bf16* q; const bf16* k; const bf16* v; bf16* o;
  int sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son;
  const float* bias; int sbb, sbh, sbn, sbm;
  const float* qg; const float* qb; const float* kg; const float* kb;
  int N, M; float scale, eps; int zero_attn;
};

// Load a 64 x 64 bf16 tile (rows past `rows` are zero) into shared memory,
// optionally LayerNorm-ing each row over Dh. 8 consecutive lanes share a row.
template <bool NORM>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int stride,
                                          int rows, bf16* dst, const float* g,
                                          const float* bt, float eps) {
#pragma unroll
  for (int pass = 0; pass < AT_BQ * 8 / AT_THREADS; ++pass) {
    const int idx = pass * AT_THREADS + threadIdx.x;
    const int r = idx / 8, vi = idx % 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < rows) u = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + vi * 8);
    if (NORM) {
      bf16* e = reinterpret_cast<bf16*>(&u);
      float f[8];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) { f[i] = __bfloat162float(e[i]); s += f[i]; }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mean = s / (float)AT_DH;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) { const float d = f[i] - mean; q += d * d; }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      const float rstd = rsqrtf(q / (float)AT_DH + eps);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float y = (f[i] - mean) * rstd * g[vi * 8 + i];
        if (bt != nullptr) y += bt[vi * 8 + i];
        e[i] = __float2bfloat16(y);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * AT_LD + vi * 8) = u;
  }
}

template <bool QKNORM>
__global__ void __launch_bounds__(AT_THREADS) attn_kernel(AttnArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + AT_BQ * AT_LD;
  bf16* vs = ks + AT_BK * AT_LD;
  bf16* ps = vs + AT_BK * AT_LD;  // 4 warps x 16 x AT_LD
  float* ss = reinterpret_cast<float*>(ps + AT_BQ * AT_LD);  // 4 x 16 x AT_LDS

  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * AT_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qsrc = p.q + (size_t)b * p.sqb + (size_t)h * p.sqh + (size_t)n0 * p.sqn;
  const bf16* kbase = p.k + (size_t)b * p.skb + (size_t)h * p.skh;
  const bf16* vbase = p.v + (size_t)b * p.svb + (size_t)h * p.svh;

  load_tile<QKNORM>(qsrc, p.sqn, min(AT_BQ, p.N - n0), qs, p.qg, p.qb, p.eps);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[AT_DH / 16];
#pragma unroll
  for (int kk = 0; kk < AT_DH / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], qs + (warp * 16) * AT_LD + kk * 16, AT_LD);

  bf16* pw = ps + warp * 16 * AT_LD;
  float* sw = ss + warp * 16 * AT_LDS;
  const int r = lane / 2, c0 = (lane % 2) * 32;
  const int n = n0 + warp * 16 + r;
  const float* brow = nullptr;
  if (p.bias != nullptr)
    brow = p.bias + (size_t)b * p.sbb + (size_t)h * p.sbh + (size_t)min(n, p.N - 1) * p.sbn;

  float m_run = p.zero_attn ? 0.f : -FLT_MAX;  // finite start: never -inf - -inf
  float l_run = 0.f;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int m0 = 0; m0 < p.M; m0 += AT_BK) {
    const int kr = min(AT_BK, p.M - m0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<QKNORM>(kbase + (size_t)m0 * p.skn, p.skn, kr, ks, p.kg, p.kb, p.eps);
    load_tile<false>(vbase + (size_t)m0 * p.svn, p.svn, kr, vs, nullptr, nullptr, 0.f);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < AT_BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < AT_DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, ks + (j * 16) * AT_LD + kk * 16, AT_LD);
        wmma::mma_sync(s, qa[kk], kf, s);
      }
      wmma::store_matrix_sync(sw + j * 16, s, AT_LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this thread's half row
    float sv[32];
    float mx = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = m0 + c0 + i;
      float s = sw[r * AT_LDS + c0 + i] * p.scale;
      if (brow != nullptr && key < p.M) s += brow[(size_t)key * p.sbm];
      sv[i] = s;
      if (key < p.M) mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = m0 + c0 + i;
      const float pv = key < p.M ? expf(sv[i] - m_new) : 0.f;
      lsum += pv;
      pw[r * AT_LD + c0 + i] = __float2bfloat16(pv);
    }
    l_run = l_run * alpha + lsum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha;
    __syncwarp();

    // acc += P V
#pragma unroll
    for (int j = 0; j < AT_DH / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int kk = 0; kk < AT_BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, pw + kk * 16, AT_LD);
        wmma::load_matrix_sync(vf, vs + (kk * 16) * AT_LD + j * 16, AT_LD);
        wmma::mma_sync(o, pa, vf, o);
      }
      wmma::store_matrix_sync(sw + j * 16, o, AT_LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += sw[r * AT_LDS + c0 + i];
    __syncwarp();
  }

  float l_tot = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
  if (p.zero_attn) l_tot += expf(-m_run);  // softmax1: the implicit zero logit
  const float inv = 1.f / l_tot;
  if (n < p.N) {
    bf16* dst = p.o + (size_t)b * p.sob + (size_t)h * p.soh + (size_t)n * p.son + c0;
#pragma unroll
    for (int v8 = 0; v8 < 4; ++v8) {
      uint4 u;
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(acc[v8 * 8 + i] * inv);
      reinterpret_cast<uint4*>(dst)[v8] = u;
    }
  }
}

}  // namespace fourm

extern "C" int fourm_attention(
    const void* q, const void* k, const void* v, void* o,
    int sqb, int sqh, int sqn, int skb, int skh, int skn,
    int svb, int svh, int svn, int sob, int soh, int son,
    const void* bias, int sbb, int sbh, int sbn, int sbm,
    const void* qg, const void* qb, const void* kg, const void* kb,
    int B, int H, int N, int M, float scale, float eps, int zero_attn,
    void* stream) {
  using namespace fourm;
  AttnArgs a;
  a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v; a.o = (bf16*)o;
  a.sqb = sqb; a.sqh = sqh; a.sqn = sqn; a.skb = skb; a.skh = skh; a.skn = skn;
  a.svb = svb; a.svh = svh; a.svn = svn; a.sob = sob; a.soh = soh; a.son = son;
  a.bias = (const float*)bias; a.sbb = sbb; a.sbh = sbh; a.sbn = sbn; a.sbm = sbm;
  a.qg = (const float*)qg; a.qb = (const float*)qb;
  a.kg = (const float*)kg; a.kb = (const float*)kb;
  a.N = N; a.M = M; a.scale = scale; a.eps = eps; a.zero_attn = zero_attn;
  const size_t smem = (size_t)(AT_BQ + 2 * AT_BK + AT_BQ) * AT_LD * sizeof(bf16) +
                      (size_t)AT_BQ * AT_LDS * sizeof(float);
  const bool norm = qg != nullptr;
  auto kern = norm ? attn_kernel<true> : attn_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + AT_BQ - 1) / AT_BQ, H, B);
  kern<<<grid, AT_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
