// nearest_code / nearest_code_cosine: exact fp32 nearest-codebook search, the
// first index winning ties.
//
// Replaces: fourm_tpu/kernels/vq_codebook.py:pallas_nearest_code (argmax of
// -(||x||^2 - 2 x.e + ||e||^2)) and pallas_nearest_code_cosine (argmax of
// x.e on l2-normalised inputs): the search of every VQ tokenizer.
//
// What bounds it on an H100: operations, and on the CUDA cores. At the
// tokenize shape (N = 64*196 latents, K = 16384 codes, D = 32) it does
// 2*N*K*D = 13.2 GFLOP of fp32 against (N*D + K*D)*4 + N*8 = 3.8 MB. Exact
// fp32 rules out the tensor cores (TF32 flips indices), so the rate is the
// fp32 CUDA-core one (67 TFLOP/s counting an FMA as two); and the products
// and sums are rounded apart (no FMA), which doubles the instructions.
//
// Exactness: the kernel and its plain twin (kernels/vq_codebook.py) share
// one arithmetic, so their indices agree exactly: each dot product and each
// squared norm is summed over d = 0..D-1 in order, from 0, with every product
// and every sum rounded on its own (__fmul_rn / __fadd_rn: nvcc may not
// contract them into an FMA); the distance is -((x2 - 2*xe) + e2). A row keeps
// a running (best, index) pair that moves only on strict improvement while
// the codes are walked in ascending order; the lanes' pairs are merged taking
// the larger value and, on equal values, the smaller index. That is argmax
// with the first index on ties, as vq_codebook.py:97-99.
//
// Design: a block owns 32 rows and walks the whole codebook in tiles of 256
// codes through shared memory (rows padded to D + 1 floats, so the 32 lanes
// of a warp reading 32 codes hit 32 banks). Warp w holds rows w, w + 4, ...,
// lane l codes l, l + 32, ... of each tile: 8 x 8 running sums per thread.
// Padded codes are never compared. A first version: no double buffering of the codebook tiles.
#include <float.h>
#include <math.h>

#include "common.cuh"

namespace fourm {

constexpr int NC_ROWS = 32;
constexpr int NC_CODES = 256;
constexpr int NC_THREADS = 128;
constexpr int NC_RPT = NC_ROWS / (NC_THREADS / 32);  // rows per thread: 8
constexpr int NC_CPT = NC_CODES / 32;                // codes per thread: 8

template <bool COSINE>
__global__ void __launch_bounds__(NC_THREADS)
nearest_code_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    long long* __restrict__ out, int N, int K, int D) {
  extern __shared__ __align__(16) float nc_smem[];
  const int ld = D + 1;
  float* xs = nc_smem;                // NC_ROWS x ld
  float* es = xs + NC_ROWS * ld;      // NC_CODES x ld
  float* x2s = es + NC_CODES * ld;    // NC_ROWS
  float* e2s = x2s + NC_ROWS;         // NC_CODES
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * NC_ROWS;

  for (int i = threadIdx.x; i < NC_ROWS * D; i += NC_THREADS) {
    const int r = i / D, d = i % D;
    xs[r * ld + d] = row0 + r < N ? x[(size_t)row0 * D + i] : 0.f;
  }
  __syncthreads();
  if (!COSINE && threadIdx.x < NC_ROWS) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float v = xs[threadIdx.x * ld + d];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    x2s[threadIdx.x] = s;
  }

  float best[NC_RPT];
  int bidx[NC_RPT];
#pragma unroll
  for (int i = 0; i < NC_RPT; ++i) {
    best[i] = -INFINITY;
    bidx[i] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += NC_CODES) {
    const int kc = min(NC_CODES, K - k0);
    __syncthreads();  // every warp is done with the previous tile
    const float* src = e + (size_t)k0 * D;
    for (int i = threadIdx.x; i < kc * D; i += NC_THREADS) {
      const int c = i / D, d = i % D;
      es[c * ld + d] = src[i];
    }
    __syncthreads();
    if (!COSINE) {
      for (int c = threadIdx.x; c < kc; c += NC_THREADS) {
        float s = 0.f;
        for (int d = 0; d < D; ++d) {
          const float v = es[c * ld + d];
          s = __fadd_rn(s, __fmul_rn(v, v));
        }
        e2s[c] = s;
      }
      __syncthreads();
    }

    float acc[NC_RPT][NC_CPT];
#pragma unroll
    for (int i = 0; i < NC_RPT; ++i)
#pragma unroll
      for (int j = 0; j < NC_CPT; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float xv[NC_RPT], ev[NC_CPT];
#pragma unroll
      for (int i = 0; i < NC_RPT; ++i) xv[i] = xs[(warp + 4 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < NC_CPT; ++j) ev[j] = es[(lane + 32 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < NC_RPT; ++i)
#pragma unroll
        for (int j = 0; j < NC_CPT; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv[i], ev[j]));
    }

#pragma unroll
    for (int j = 0; j < NC_CPT; ++j) {  // this thread's codes, ascending
      const int c = lane + 32 * j;
      if (c >= kc) break;
#pragma unroll
      for (int i = 0; i < NC_RPT; ++i) {
        float dist = acc[i][j];
        if (!COSINE)
          dist = -__fadd_rn(__fsub_rn(x2s[warp + 4 * i], __fmul_rn(2.f, dist)), e2s[c]);
        if (dist > best[i]) {
          best[i] = dist;
          bidx[i] = k0 + c;
        }
      }
    }
  }

  // merge the 32 lanes of each row: larger value, then smaller index
#pragma unroll
  for (int i = 0; i < NC_RPT; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], o);
      if (ob > best[i] || (ob == best[i] && oi < bidx[i])) {
        best[i] = ob;
        bidx[i] = oi;
      }
    }
    const int row = row0 + warp + 4 * i;
    if (lane == 0 && row < N) out[row] = bidx[i];
  }
}

template <bool COSINE>
int launch_nearest(const float* x, const float* e, long long* out, int N, int K, int D,
                   cudaStream_t stream) {
  const size_t smem = ((size_t)(NC_ROWS + NC_CODES) * (D + 1) + NC_ROWS + NC_CODES) *
                      sizeof(float);
  auto kern = nearest_code_kernel<COSINE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(N + NC_ROWS - 1) / NC_ROWS, NC_THREADS, smem, stream>>>(x, e, out, N, K, D);
  return (int)cudaGetLastError();
}

}  // namespace fourm

// x (N, D) and e (K, D) fp32, row-major; out (N,) int64. cosine: argmax x.e
// (inputs already l2-normalised), else the Euclidean form.
extern "C" int fourm_nearest_code(const void* x, const void* e, void* out, int N, int K,
                                  int D, int cosine, void* stream) {
  using namespace fourm;
  const float* xp = (const float*)x;
  const float* ep = (const float*)e;
  long long* op = (long long*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return cosine ? launch_nearest<true>(xp, ep, op, N, K, D, s)
                : launch_nearest<false>(xp, ep, op, N, K, D, s);
}
