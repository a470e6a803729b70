// ln_mlp: out = x + fc2(act(fc1(LN(x)))), act = SwiGLU silu(g) * u with
// u = fc3(LN x), or exact-erf GELU. bf16 in and out, fp32 LN statistics,
// fp32 accumulation, bf16 hidden activation.
//
// Replaces: fourm_tpu/kernels/fused_mlp.py:pallas_ln_mlp (the MLP half of
// every encoder and decoder block).
//
// What bounds it on an H100: operations. SwiGLU at M = 16*2048 rows,
// D = 768, HID = 2048 does 3*2*M*D*HID = 309 GFLOP against
// (2*M*D + 3*D*HID)*2 = 110 MB, far above the ~295 FLOP/byte ridge.
//
// Design: one kernel. A block owns 32 rows. Their LayerNorm goes once into
// shared memory as bf16 (48 KB at D = 768). The hidden dimension is walked
// in chunks of 64: the 8 warps compute the 32 x 64 chunk of fc1 (and fc3)
// with WMMA, apply bias and activation through a per-warp fp32 staging
// tile, and write the bf16 chunk to shared memory; then every warp adds
// that chunk's contribution to its 32 x D/8 slice of fc2, which stays in
// WMMA accumulators (registers) for the whole walk. So neither the LN
// output nor the hidden activation touches device memory. Weight fragments
// are read straight from W1/W3 (HID, D) and W2 (D, HID), nn.Linear layout,
// which stay L2 resident (9.4 MB at 4M-B). The epilogue adds b2, rounds the
// branch to bf16 and adds the residual, as the TPU kernel does.
// A first version: no TMA, no wgmma, no pipelining; each block re-reads
// the weights from L2.
#include "common.cuh"

namespace fourm {

constexpr int MLP_BM = 32;
constexpr int MLP_HC = 64;               // hidden chunk
constexpr int MLP_THREADS = 256;         // 8 warps
constexpr int MLP_LDH = MLP_HC + 8;      // bf16 hidden chunk row stride

template <int NCB, bool GATED>
__global__ void __launch_bounds__(MLP_THREADS, 1)
ln_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w3,
              const float* __restrict__ b3, const bf16* __restrict__ w2,
              const float* __restrict__ b2, bf16* __restrict__ out, int M,
              int HID, float eps) {
  constexpr int D = NCB * 128;  // each warp owns D/8 = 16*NCB output columns
  constexpr int LDX = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + (size_t)MLP_BM * LDX;
  float* stage = reinterpret_cast<float*>(hs + (size_t)MLP_BM * MLP_LDH);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* gst = stage + warp * 2 * 256;  // this warp's two 16x16 fp32 tiles
  float* ust = gst + 256;
  const int row0 = blockIdx.x * MLP_BM;

  ln_rows_to_smem(x, M, D, row0, MLP_BM, gamma, beta, eps, xs, LDX);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NCB];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NCB; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int rb = warp / 4;  // fc1 row block of this warp
  const int hb = warp % 4;  // fc1 hidden block of this warp
  const int sr = lane / 2, sc = (lane % 2) * 8;  // staging element slice

  for (int j0 = 0; j0 < HID; j0 += MLP_HC) {
    // ---- fc1 (and fc3): the 16x16 block (rb, hb) of the 32 x 64 chunk
    const int hj = j0 + hb * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> g, u;
    wmma::fill_fragment(g, 0.f);
    if (GATED) wmma::fill_fragment(u, 0.f);
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a, xs + (size_t)(rb * 16) * LDX + k, LDX);
      wmma::load_matrix_sync(bw, w1 + (size_t)hj * D + k, D);
      wmma::mma_sync(g, a, bw, g);
      if (GATED) {
        wmma::load_matrix_sync(bw, w3 + (size_t)hj * D + k, D);
        wmma::mma_sync(u, a, bw, u);
      }
    }
    wmma::store_matrix_sync(gst, g, 16, wmma::mem_row_major);
    if (GATED) wmma::store_matrix_sync(ust, u, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = sc + i;
      float gv = gst[sr * 16 + c];
      if (b1 != nullptr) gv += b1[hj + c];
      float h;
      if (GATED) {
        float uv = ust[sr * 16 + c];
        if (b3 != nullptr) uv += b3[hj + c];
        h = gv * (1.f / (1.f + expf(-gv))) * uv;  // silu(g) * u
      } else {
        h = 0.5f * gv * (1.f + erff(gv * 0.70710678118654752f));  // exact GELU
      }
      hs[(size_t)(rb * 16 + sr) * MLP_LDH + hb * 16 + c] = __float2bfloat16(h);
    }
    __syncthreads();

    // ---- fc2: acc[:, cols of this warp] += h_chunk @ W2[cols, chunk]^T
#pragma unroll
    for (int kk = 0; kk < MLP_HC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], hs + (size_t)(i * 16) * MLP_LDH + kk, MLP_LDH);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        const int o0 = warp * (D / 8) + cb * 16;
        wmma::load_matrix_sync(bw, w2 + (size_t)o0 * HID + j0 + kk, HID);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][cb], a[i], bw, acc[i][cb]);
      }
    }
    __syncthreads();  // hs is rewritten by the next chunk
  }

  // ---- epilogue: out = x + bf16(acc + b2)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      wmma::store_matrix_sync(gst, acc[i][cb], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = row0 + i * 16 + sr;
      const int col = warp * (D / 8) + cb * 16 + sc;
      if (row < M) {
        const uint4 xu = *reinterpret_cast<const uint4*>(x + (size_t)row * D + col);
        const bf16* xe = reinterpret_cast<const bf16*>(&xu);
        uint4 ou;
        bf16* oe = reinterpret_cast<bf16*>(&ou);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float y = gst[sr * 16 + sc + e];
          if (b2 != nullptr) y += b2[col + e];
          const float branch = __bfloat162float(__float2bfloat16(y));
          oe[e] = __float2bfloat16(__bfloat162float(xe[e]) + branch);
        }
        *reinterpret_cast<uint4*>(out + (size_t)row * D + col) = ou;
      }
      __syncwarp();
    }
  }
}

template <int NCB, bool GATED>
int launch_ln_mlp(const void* x, const void* gamma, const void* beta, const void* w1,
                  const void* b1, const void* w3, const void* b3, const void* w2,
                  const void* b2, void* out, int M, int HID, float eps,
                  cudaStream_t stream) {
  constexpr int D = NCB * 128;
  const size_t smem = (size_t)MLP_BM * (D + 8) * sizeof(bf16) +
                      (size_t)MLP_BM * MLP_LDH * sizeof(bf16) +
                      (size_t)8 * 2 * 256 * sizeof(float);
  auto kern = ln_mlp_kernel<NCB, GATED>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + MLP_BM - 1) / MLP_BM;
  kern<<<blocks, MLP_THREADS, smem, stream>>>(
      (const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)w1,
      (const float*)b1, (const bf16*)w3, (const float*)b3, (const bf16*)w2,
      (const float*)b2, (bf16*)out, M, HID, eps);
  return (int)cudaGetLastError();
}

}  // namespace fourm

// Returns cudaErrorInvalidValue for a width it was not built for
// (D must be 256, 512, 768 or 1024; HID % 64 == 0).
extern "C" int fourm_ln_mlp(const void* x, const void* gamma, const void* beta,
                            const void* w1, const void* b1, const void* w3,
                            const void* b3, const void* w2, const void* b2,
                            void* out, int M, int D, int HID, int gated, float eps,
                            void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
#define FOURM_MLP_CASE(ncb)                                                       \
  if (D == ncb * 128) {                                                           \
    return gated ? launch_ln_mlp<ncb, true>(x, gamma, beta, w1, b1, w3, b3, w2, b2, \
                                            out, M, HID, eps, s)                  \
                 : launch_ln_mlp<ncb, false>(x, gamma, beta, w1, b1, w3, b3, w2,  \
                                             b2, out, M, HID, eps, s);            \
  }
  FOURM_MLP_CASE(2)
  FOURM_MLP_CASE(4)
  FOURM_MLP_CASE(6)
  FOURM_MLP_CASE(8)
#undef FOURM_MLP_CASE
  return (int)cudaErrorInvalidValue;
}
