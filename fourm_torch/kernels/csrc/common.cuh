// Shared helpers for the fourm_torch Hopper kernels (sm_90a).
//
// Every kernel here takes bf16 activations and weights and keeps statistics
// and sums in fp32. The many-row kernels compute their products by wgmma
// (gemm_sm90.cuh's TMA-fed GEMM; the attention core of attn_sm90.cuh), and
// so do the decode step's projections (gemv_sm90.cuh's weight streaming);
// the single-query decode attention (decode_attn.cu) with fp32 FMAs. The C
// entry points return cudaGetLastError() so the Python wrapper can raise on
// a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fourm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of rows [row0, row0 + rows) of x (M, D), row-major, into shared
// memory as bf16 with row stride `ld` (elements). One warp per row; fp32
// mean and variance (two passes over the staged row), y = (x - mean) *
// rsqrt(var + eps) * gamma + beta, then one rounding to bf16 -- the order
// of fourm_tpu/kernels/fused_mlp.py:_ln. Rows at or past M are zero.
// Requires D % 8 == 0 and 16-byte aligned rows.
__device__ __forceinline__ void ln_rows_to_smem(
    const bf16* __restrict__ x, int M, int D, int row0, int rows,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, bf16* out, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int nvec = D / 8;
  for (int r = warp; r < rows; r += nwarps) {
    const int row = row0 + r;
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)r * ld);
    if (row >= M) {
      for (int v = lane; v < nvec; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row * D);
    float s = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      uint4 u = src[v];
      dst[v] = u;
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
    }
    const float mean = warp_sum(s) / (float)D;
    float q = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      uint4 u = dst[v];
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = __bfloat162float(e[i]) - mean;
        q += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)D + eps);
    for (int v = lane; v < nvec; v += 32) {
      uint4 u = dst[v];
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = v * 8 + i;
        float y = (__bfloat162float(e[i]) - mean) * rstd * gamma[c];
        if (beta != nullptr) y += beta[c];
        e[i] = __float2bfloat16(y);
      }
      dst[v] = u;
    }
  }
}

// ---- helpers of the decode-step kernels: one token per batch row.

// Element i of a small parameter vector (LN scale or shift, bias) held in
// fp32 or in bf16 (is_bf16), so the wrapper needs no copy kernel.
__device__ __forceinline__ float ld_param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}

// LayerNorm of one bf16 row of C values (C % 8 == 0, 16-byte aligned) by
// one warp, into `out` (shared or device memory, 16-byte aligned) as bf16:
// fp32 mean, then fp32 mean of squared deviations, y = (x - mean) *
// rsqrt(var + eps) * g (+ b), one rounding -- the order of
// fused_mlp.py:_ln. A null x writes zeros.
__device__ __forceinline__ void warp_ln_row(const bf16* __restrict__ x, int C,
                                            const void* g, const void* b, int pbf,
                                            float eps, bf16* out) {
  const int lane = threadIdx.x % 32;
  uint4* dst = reinterpret_cast<uint4*>(out);
  if (x == nullptr) {
    for (int v = lane; v < C / 8; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(x);
  float s = 0.f;
  for (int v = lane; v < C / 8; v += 32) {
    float f[8];
    unpack8(src[v], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mean = warp_sum(s) / (float)C;
  float q = 0.f;
  for (int v = lane; v < C / 8; v += 32) {
    float f[8];
    unpack8(src[v], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) q += (f[i] - mean) * (f[i] - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);
  for (int v = lane; v < C / 8; v += 32) {
    float f[8];
    unpack8(src[v], f);
    uint4 u;
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = v * 8 + i;
      float y = (f[i] - mean) * rstd * ld_param(g, c, pbf);
      if (b != nullptr) y += ld_param(b, c, pbf);
      e[i] = __float2bfloat16(y);
    }
    dst[v] = u;
  }
}

inline int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace fourm
