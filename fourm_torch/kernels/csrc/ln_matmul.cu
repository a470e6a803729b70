// ln_matmul: out = LN(x) @ W^T + b, bf16 in and out, fp32 LN statistics and
// fp32 accumulation.
//
// Replaces: fourm_tpu/kernels/fused_mlp.py:pallas_ln_matmul (the pre-norm
// LN -> QKV projection of every encoder and decoder self-attention).
//
// What bounds it on an H100: operations. At the main path's encoder shape
// (M = 16*2048 rows, D = 768, F = 2304) it does 2*M*D*F = 116 GFLOP against
// (M*D + D*F + M*F)*2 = 205 MB, about 565 FLOP/byte, above the card's ~295
// bf16 FLOP/byte ridge; at 4M-21 XL (M = 8*2304, D = 2048, F = 6144) 464
// GFLOP against 0.33 GB.
//
// Design: two kernels, both in gemm_sm90.cuh. The LN prologue
// (ln_rows_kernel, one warp per row) writes h = bf16(LN(x)) to a scratch
// (M, D) that the wrapper allocates: 2*M*D*2 bytes of extra traffic, ~45 us
// at XL, ~30 us at 4M-B, which the bound (the fused work) does not count.
// Then the TMA-fed wgmma GEMM (128 x 128 tiles, a 6-stage ring, two
// consumer warpgroups and a producer warp) computes h @ W^T; its epilogue
// adds b in fp32 and stores bf16 straight from the accumulators. The output
// stays (..., F) contiguous: flash_mha reads q/k/v as column slices of it.
// D and F are any multiples of 8 (TMA's 16-byte row strides); ragged rows,
// columns and K steps are zero-filled by TMA and masked in the epilogue.
#include "gemm_sm90.cuh"

namespace fourm {

struct BiasEpi {  // out[r, c] = bf16(acc + b[c])
  bf16* out;
  const float* b;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float a0, float a1) const {
    if (b != nullptr) {
      a0 += b[c];
      a1 += b[c + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ld + c) = __floats2bfloat162_rn(a0, a1);
  }
};

}  // namespace fourm

// x (M, D) bf16; gamma, beta (D) fp32 (beta may be null); w (F, D) bf16;
// b (F) fp32 or null; h (M, D) bf16 scratch; out (M, F) bf16. D % 8 == 0,
// F % 8 == 0, 16-byte aligned x, w and h.
extern "C" int fourm_ln_matmul(const void* x, const void* gamma, const void* beta,
                               const void* w, const void* b, void* h, void* out, int M,
                               int D, int F, float eps, void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 8 != 0 || F % 8 != 0) return (int)cudaErrorInvalidValue;
  int err = sm90::launch_ln_rows<0>(x, gamma, beta, h, M, D, eps, s);
  if (err != 0) return err;
  return sm90::launch_gemm<BiasEpi, false, 6>(h, w, nullptr, M, F, D, F,
                                              BiasEpi{(bf16*)out, (const float*)b, F}, s);
}
