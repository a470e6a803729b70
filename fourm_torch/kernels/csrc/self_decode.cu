// self_decode: the self-attention core of one KV-cached decode step.
//   h = LN1(x) (fp32 statistics, rounded to bf16); qkv = h Wqkv^T (+b) in
//   fp32; per-head QK-norm on the fp32 q and k (eps as LN1), then q, k, v
//   rounded to bf16; softmax over the cache's positions < step plus the new
//   token (softmax1 adds exp(-m) to the denominator); out = p V in fp32,
//   rounded to bf16. The new token's k, v are written into the caches at
//   position `step` (read from device memory: no per-token host value).
//
// Replaces: fourm_tpu/kernels/decode_step.py:pallas_self_decode.
//
// What bounds it on an H100: bytes. It must read Wqkv (3*C*C bf16: 3.54 MB
// at C = 768) and the live part of the caches (2 * B*H*step*64 bf16: up to
// 6.3 MB at B = 8, step = 256), 1-3 us at 3.35 TB/s; its ~60 MFLOP are
// nothing.
//
// Design: one block per (head, batch row), 256 threads; 96 blocks at B = 8,
// H = 12, so 96 of 132 SMs work (the TPU kernel's head-group grid would give
// 12). Each block recomputes the LN of its row (C values, cheap, as the TPU
// kernel does per grid cell), then its 8 warps make the head's 192 q/k/v
// columns as warp GEMVs over Wqkv rows, 8 rows per warp with their 16-byte
// loads in flight together (the B blocks of one head share those rows
// through L2). Logits: one thread per cache position reads its 128-byte key
// row. p V: 8 lanes per 128-byte value row, the partial sums combined in a
// fixed order. Only positions < step are read from the caches and the new token's
// k, v come from shared memory, so the in-place write at `step` races with
// no reader; step >= L writes nothing and attends to all L positions.
// A first version: no cp.async/TMA pipelining of the key rows.
#include <float.h>

#include "common.cuh"

namespace fourm {

constexpr int SD_THREADS = 256;
constexpr int SD_DH = 64;
constexpr int SD_U = 4;  // passes of value rows whose loads are issued together

__global__ void __launch_bounds__(SD_THREADS)
self_decode_kernel(const bf16* __restrict__ x, const void* g1, const void* b1,
                   const void* bqkv, const void* qng, const void* qnb, const void* kng,
                   const void* knb, int pbf, const bf16* __restrict__ w,
                   bf16* __restrict__ ck, bf16* __restrict__ cv,
                   const int* __restrict__ step_ptr, bf16* __restrict__ out, int H, int L,
                   int C, float eps, int zero_attn) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);                  // C: LN1(x)
  float* ss = reinterpret_cast<float*>(hs + C);              // L: logits, then p
  __shared__ float qkv[3 * SD_DH];
  __shared__ float red[SD_THREADS / 32];
  __shared__ float pvp[SD_THREADS / 32][SD_DH];
  __shared__ float snew;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int step = *step_ptr;
  const int n = min(max(step, 0), L);  // cache positions attended
  const size_t row0 = ((size_t)b * H + h) * L;  // (b, h) in the (B, H, L, 64) caches

  if (warp == 0) warp_ln_row(x + (size_t)b * C, C, g1, b1, pbf, eps, hs);
  __syncthreads();
  // the head's q, k, v columns (Wqkv rows part * C + h * 64 + d), 8 per
  // warp at a time
  for (int c0 = warp * 8; c0 < 3 * SD_DH; c0 += SD_THREADS / 32 * 8) {
    const bf16* wr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wr[i] = w + (size_t)(((c0 + i) / SD_DH) * C + h * SD_DH + (c0 + i) % SD_DH) * C;
    float acc[8][1];
    warp_gemv<1, 8, 2>(hs, C, wr, C, acc);
    float y = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane == i) y = acc[i][0];
    if (lane < 8) {
      const int col = c0 + lane;
      const int wrow = (col / SD_DH) * C + h * SD_DH + col % SD_DH;
      qkv[col] = y + (bqkv != nullptr ? ld_param(bqkv, wrow, pbf) : 0.f);
    }
  }
  __syncthreads();
  if (qng != nullptr && warp < 2)
    warp_head_norm64(qkv + warp * SD_DH, warp == 0 ? qng : kng, warp == 0 ? qnb : knb,
                     pbf, eps);
  __syncthreads();
  if (tid < 3 * SD_DH) qkv[tid] = bf16_round(qkv[tid]);
  __syncthreads();
  const float* q = qkv;
  const float* kn = qkv + SD_DH;
  const float* vn = qkv + 2 * SD_DH;
  const float scale = rsqrtf((float)SD_DH);

  if (tid < SD_DH && step >= 0 && step < L) {
    ck[(row0 + step) * SD_DH + tid] = __float2bfloat16(kn[tid]);
    cv[(row0 + step) * SD_DH + tid] = __float2bfloat16(vn[tid]);
  }
  if (warp == 0) {
    const float s = warp_sum(q[lane] * kn[lane] + q[lane + 32] * kn[lane + 32]) * scale;
    if (lane == 0) snew = s;
  }
  // logits over the earlier positions: one thread per key row
  float lmax = -FLT_MAX;
  for (int j = tid; j < n; j += SD_THREADS) {
    const uint4* kr = reinterpret_cast<const uint4*>(ck + (row0 + j) * SD_DH);
    float s = 0.f;
#pragma unroll
    for (int v8 = 0; v8 < SD_DH / 8; ++v8) {
      float f[8];
      unpack8(kr[v8], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += q[v8 * 8 + i] * f[i];
    }
    s *= scale;
    ss[j] = s;
    lmax = fmaxf(lmax, s);
  }
  __syncthreads();  // snew
  float m = fmaxf(block_max(lmax, red), snew);
  if (zero_attn) m = fmaxf(m, 0.f);
  float lsum = 0.f;
  for (int j = tid; j < n; j += SD_THREADS) {
    const float p = expf(ss[j] - m);
    ss[j] = p;
    lsum += p;
  }
  const float pn = expf(snew - m);
  float denom = block_sum(lsum, red) + pn;  // syncs: ss holds p
  if (zero_attn) denom += expf(-m);

  // p V: 8 lanes per value row (16 bytes each), 4 rows per warp, 32 per
  // pass, the loads of SD_U passes issued together; then the 4 row groups of
  // a warp and the 8 warps are summed in a fixed order
  const int kq = lane / 8, vi = lane % 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < n; j0 += 32 * SD_U) {
    uint4 vu[SD_U];
    float pj[SD_U];
#pragma unroll
    for (int u = 0; u < SD_U; ++u) {
      const int j = j0 + 32 * u + warp * 4 + kq;
      vu[u] = j < n ? *reinterpret_cast<const uint4*>(cv + (row0 + j) * SD_DH + vi * 8)
                    : make_uint4(0, 0, 0, 0);
      pj[u] = j < n ? ss[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SD_U; ++u) {
      float f[8];
      unpack8(vu[u], f);
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
  if (tid < SD_DH) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < SD_THREADS / 32; ++i) o += pvp[i][tid];
    out[(size_t)b * C + h * SD_DH + tid] = __float2bfloat16((o + pn * vn[tid]) / denom);
  }
}

}  // namespace fourm

extern "C" int fourm_self_decode(const void* x, const void* g1, const void* b1,
                                 const void* bqkv, const void* qng, const void* qnb,
                                 const void* kng, const void* knb, int pbf, const void* w,
                                 void* ck, void* cv, const void* step, void* out, int B,
                                 int H, int L, int C, float eps, int zero_attn,
                                 void* stream) {
  using namespace fourm;
  const size_t smem = (size_t)C * sizeof(bf16) + (size_t)L * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(self_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  self_decode_kernel<<<grid, SD_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, g1, b1, bqkv, qng, qnb, kng, knb, pbf, (const bf16*)w, (bf16*)ck,
      (bf16*)cv, (const int*)step, (bf16*)out, H, L, C, eps, zero_attn);
  return (int)cudaGetLastError();
}
