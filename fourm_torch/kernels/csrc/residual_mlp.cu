// residual_mlp: the tail of one decode step, for B token rows.
//   x1  = x + bf16(attn Wp^T (+bp))                 (the cross-attn residual)
//   out = x1 + bf16(fc2(act(fc1(LN2 x1))))          (the MLP half)
//   act = silu(fc1) * fc3 (SwiGLU) or exact-erf GELU(fc1); LN2 statistics
//   in fp32, one rounding to bf16; products summed in fp32, biases added in
//   fp32, the hidden activation rounded to bf16 before fc2 -- the
//   arithmetic of the TPU kernel.
//
// Replaces: fourm_tpu/kernels/decode_step.py:pallas_residual_mlp.
//
// What bounds it on an H100: bytes. At B <= 16 rows it is weight streaming:
// (C*C + 3*C*HID) bf16 = 10.6 MB at C = 768, HID = 2048, 3.2 us at
// 3.35 TB/s, against 2*B*(C*C + 3*C*HID) = 85 MFLOP at B = 8.
//
// Design: the weights' rows are spread over the SMs, not the token rows
// (a block of 32 token rows, as in ln_mlp, would leave one SM to stream all
// of them at B = 8). Three kernels, each a set of warp GEMVs in which one
// warp reads its weight rows once, 4 loads per lane and row in flight, and
// dots them with up to 8 token rows staged in shared memory (rows in groups
// of 8 for any B):
//   1. proj: a warp per output column c of Wp -> x1 (B, C) bf16 scratch;
//   2. hidden: every block recomputes LN2 of the token rows (cheap), a warp
//      per hidden unit reads its fc1 (and fc3) rows -> act (B, HID) bf16
//      scratch (32 KB at B = 8);
//   3. out: a warp per output column c of fc2 (a row of W2, HID long) -> out.
// No partial sums cross blocks, so there are no atomics and a run is
// reproducible; the scratch round trips are the B-row activations only.
// The activation scratch has rows of HIDS = HID rounded up to 8, the tail
// zero. A HID that is not a multiple of 8 (SwiGLU at 4M-L / 4M-XL: 2730,
// 5461) leaves W2's rows unaligned (10922 bytes each at 4M-XL), so kernel 3
// reads each row as the aligned 16-byte blocks that cover it, and pairs
// each weight with the activation of its own hidden index, staged between
// 8 zeros on either side, so the neighbouring rows' elements in the first
// and last block meet a zero; an aligned row (HID % 8 == 0) is the case
// with no shift.
// A first version: no cp.async/TMA, CUDA-core FMAs.
#include "common.cuh"

namespace fourm {

constexpr int RM_THREADS = 256;
constexpr int RM_WARPS = RM_THREADS / 32;
constexpr int RM_ROWS = 8;   // token rows per pass
constexpr int RM_UNITS = 2;  // hidden units per warp in kernel 2
constexpr int RM_U = 4;      // 16-byte slices per lane and weight row in flight

// Stage token rows [r0, r0 + 8) of src (B, K) into s (8 rows of stride ld);
// rows past B are zero.
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, int B, int K,
                                           int r0, bf16* s, int ld) {
  const int nv = K / 8;
  for (int i = threadIdx.x; i < RM_ROWS * nv; i += blockDim.x) {
    const int r = i / nv, v = i % nv;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < B) u = reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * K)[v];
    *reinterpret_cast<uint4*>(s + (size_t)r * ld + v * 8) = u;
  }
}

// out[r][c] = bf16(res[r][c] + bf16(acc[r] + bias[c])) for one column c,
// lane r writing row r0 + r.
__device__ __forceinline__ void residual_store(const float (&acc)[RM_ROWS], const void* bias,
                                               int pbf, const bf16* __restrict__ res,
                                               bf16* __restrict__ out, int B, int K, int r0,
                                               int c) {
  const int lane = threadIdx.x % 32;
  float y = 0.f;
#pragma unroll
  for (int r = 0; r < RM_ROWS; ++r)
    if (lane == r) y = acc[r];
  if (lane < RM_ROWS && r0 + lane < B) {
    if (bias != nullptr) y += ld_param(bias, c, pbf);
    const size_t i = (size_t)(r0 + lane) * K + c;
    out[i] = __float2bfloat16(__bfloat162float(res[i]) + bf16_round(y));
  }
}

// kernel 1: x1 = x + bf16(attn Wp^T + bp); a warp per output column
__global__ void __launch_bounds__(RM_THREADS)
proj_residual_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
                     const bf16* __restrict__ wp, const void* bp, int pbf,
                     bf16* __restrict__ x1, int B, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  const int c = blockIdx.x * RM_WARPS + threadIdx.x / 32;
  for (int r0 = 0; r0 < B; r0 += RM_ROWS) {
    __syncthreads();
    stage_rows(attn, B, C, r0, as, C + 8);
    __syncthreads();
    if (c < C) {
      const bf16* wr[1] = {wp + (size_t)c * C};
      float acc[1][RM_ROWS];
      warp_gemv<RM_ROWS, 1, RM_U>(as, C + 8, wr, C, acc);
      residual_store(acc[0], bp, pbf, x, x1, B, C, r0, c);
    }
  }
}

// kernel 2: act = silu(LN2(x1) W1^T + b1) * (LN2(x1) W3^T + b3), or GELU;
// act rows are HIDS = HID rounded up to 8 long, the tail written as zeros
template <bool GATED>
__global__ void __launch_bounds__(RM_THREADS)
hidden_kernel(const bf16* __restrict__ x1, const void* g2, const void* be2,
              const bf16* __restrict__ w1, const void* b1, const bf16* __restrict__ w3,
              const void* b3, int pbf, bf16* __restrict__ act, int B, int C, int HID,
              float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int HIDS = (HID + 7) / 8 * 8;
  for (int r0 = 0; r0 < B; r0 += RM_ROWS) {
    __syncthreads();
    for (int r = warp; r < RM_ROWS; r += RM_WARPS)
      warp_ln_row(r0 + r < B ? x1 + (size_t)(r0 + r) * C : nullptr, C, g2, be2, pbf, eps,
                  hs + (size_t)r * (C + 8));
    __syncthreads();
    // this warp's RM_UNITS hidden units: their fc1 (and fc3) rows at once
    constexpr int NW = GATED ? 2 * RM_UNITS : RM_UNITS;
    const int j0 = (blockIdx.x * RM_WARPS + warp) * RM_UNITS;
    const bf16* wr[NW];
#pragma unroll
    for (int u = 0; u < RM_UNITS; ++u) {
      const int j = min(j0 + u, HID - 1);
      wr[u] = w1 + (size_t)j * C;
      if constexpr (GATED) wr[RM_UNITS + u] = w3 + (size_t)j * C;
    }
    float acc[NW][RM_ROWS];
    warp_gemv<RM_ROWS, NW, RM_U>(hs, C + 8, wr, C, acc);
#pragma unroll
    for (int u = 0; u < RM_UNITS; ++u) {
      const int j = j0 + u;
      if (j >= HID) continue;
      float gv = 0.f, uv = 0.f;
#pragma unroll
      for (int r = 0; r < RM_ROWS; ++r)
        if (lane == r) {
          gv = acc[u][r];
          if constexpr (GATED) uv = acc[(RM_UNITS + u) % NW][r];
        }
      if (lane < RM_ROWS && r0 + lane < B) {
        if (b1 != nullptr) gv += ld_param(b1, j, pbf);
        float hv;
        if (GATED) {
          if (b3 != nullptr) uv += ld_param(b3, j, pbf);
          hv = gv * (1.f / (1.f + expf(-gv))) * uv;  // silu(fc1) * fc3
        } else {
          hv = 0.5f * gv * (1.f + erff(gv * 0.70710678118654752f));  // exact GELU
        }
        bf16* arow = act + (size_t)(r0 + lane) * HIDS;
        arow[j] = __float2bfloat16(hv);
        if (j == HID - 1)
          for (int t = HID; t < HIDS; ++t) arow[t] = __float2bfloat16(0.f);
      }
    }
  }
}

// acc[r] = sum_k a[r][k] * w[e0 + k] over k < K for the RM_ROWS staged rows
// of `a` (row stride lda; a[r][-8 .. 0) and a[r][K .. K + 8) zero) and a
// weight row that starts at element e0 of w, at any alignment, by one warp:
// lanes read the 16-byte aligned blocks that cover the row (elements below
// `total`, the size of w, only), RM_U blocks per lane in flight; a block's
// elements outside the row meet the zeros. Every lane returns the sums.
__device__ __forceinline__ void warp_gemv_unaligned(const bf16* a, int lda,
                                                    const bf16* __restrict__ w, size_t e0,
                                                    int K, size_t total,
                                                    float (&acc)[RM_ROWS]) {
  const int lane = threadIdx.x % 32;
  const size_t f0 = e0 & ~(size_t)7;
  const int sh = (int)(e0 - f0);  // the row starts sh elements into its first block
  const int nb = (sh + K + 7) / 8;
#pragma unroll
  for (int r = 0; r < RM_ROWS; ++r) acc[r] = 0.f;
  for (int v0 = lane; v0 < nb; v0 += 32 * RM_U) {
    uint4 wu[RM_U];
#pragma unroll
    for (int u = 0; u < RM_U; ++u) {
      const int v = v0 + 32 * u;
      const size_t f = f0 + 8 * (size_t)v;
      wu[u] = make_uint4(0, 0, 0, 0);
      if (v < nb) {
        if (f + 8 <= total) {
          wu[u] = __ldg(reinterpret_cast<const uint4*>(w + f));
        } else {  // the last block of w
          bf16* e = reinterpret_cast<bf16*>(&wu[u]);
          for (int i = 0; i < 8; ++i)
            if (f + i < total) e[i] = w[f + i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < RM_U; ++u) {
      const int v = v0 + 32 * u;
      if (v >= nb) break;
      float wf[8];
      unpack8(wu[u], wf);
      const bf16* ak = a + 8 * v - sh;  // a[.][k] of this block's first element
#pragma unroll
      for (int r = 0; r < RM_ROWS; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[r] += __bfloat162float(ak[(size_t)r * lda + i]) * wf[i];
    }
  }
#pragma unroll
  for (int r = 0; r < RM_ROWS; ++r) acc[r] = warp_sum(acc[r]);
}

// kernel 3: out = x1 + bf16(act W2^T + b2); a warp per output column. act
// rows are HIDS long (zero past HID), staged with 8 zeros ahead and behind;
// W2's rows are read as the aligned blocks that cover them
__global__ void __launch_bounds__(RM_THREADS)
out_residual_kernel(const bf16* __restrict__ act, const bf16* __restrict__ x1,
                    const bf16* __restrict__ w2, const void* b2, int pbf,
                    bf16* __restrict__ out, int B, int C, int HID) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  const int c = blockIdx.x * RM_WARPS + threadIdx.x / 32;
  const int HIDS = (HID + 7) / 8 * 8;
  const int lda = HIDS + 16;
  for (int r0 = 0; r0 < B; r0 += RM_ROWS) {
    __syncthreads();
    stage_rows(act, B, HIDS, r0, hs + 8, lda);  // between 8 zeros ...
    for (int i = threadIdx.x; i < RM_ROWS * 2; i += blockDim.x)  // ... on either side
      *reinterpret_cast<uint4*>(hs + (size_t)(i / 2) * lda + (i % 2) * (HIDS + 8)) =
          make_uint4(0, 0, 0, 0);
    __syncthreads();
    if (c < C) {
      float acc[RM_ROWS];
      warp_gemv_unaligned(hs + 8, lda, w2, (size_t)c * HID, HID, (size_t)C * HID, acc);
      residual_store(acc, b2, pbf, x1, out, B, C, r0, c);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace fourm

extern "C" int fourm_residual_mlp(const void* x, const void* attn, const void* wp,
                                  const void* w1, const void* w3, const void* w2,
                                  const void* bp, const void* g2, const void* be2,
                                  const void* b1, const void* b3, const void* b2, int pbf,
                                  void* x1, void* act, void* out, int B, int C, int HID,
                                  int gated, float eps, void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
  const int HIDS = (HID + 7) / 8 * 8;
  const size_t smem_c = (size_t)RM_ROWS * (C + 8) * sizeof(bf16);
  const size_t smem_h = (size_t)RM_ROWS * (HIDS + 16) * sizeof(bf16);
  auto hid_kern = gated ? hidden_kernel<true> : hidden_kernel<false>;
  cudaError_t err;
  if ((err = allow_smem(proj_residual_kernel, smem_c)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(hid_kern, smem_c)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(out_residual_kernel, smem_h)) != cudaSuccess) return (int)err;
  const int col_blocks = (C + RM_WARPS - 1) / RM_WARPS;
  proj_residual_kernel<<<col_blocks, RM_THREADS, smem_c, s>>>(
      (const bf16*)x, (const bf16*)attn, (const bf16*)wp, bp, pbf, (bf16*)x1, B, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int hid_blocks = (HID + RM_WARPS * RM_UNITS - 1) / (RM_WARPS * RM_UNITS);
  hid_kern<<<hid_blocks, RM_THREADS, smem_c, s>>>(
      (const bf16*)x1, g2, be2, (const bf16*)w1, b1, (const bf16*)w3, b3, pbf, (bf16*)act, B,
      C, HID, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  out_residual_kernel<<<col_blocks, RM_THREADS, smem_h, s>>>(
      (const bf16*)act, (const bf16*)x1, (const bf16*)w2, b2, pbf, (bf16*)out, B, C, HID);
  return (int)cudaGetLastError();
}
