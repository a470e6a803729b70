// ln_mlp: out = x + fc2(act(fc1(LN(x)))), act = SwiGLU silu(g) * u with
// u = fc3(LN x), or exact-erf GELU. bf16 in and out, fp32 LN statistics,
// fp32 accumulation, bf16 hidden activation.
//
// Replaces: fourm_tpu/kernels/fused_mlp.py:pallas_ln_mlp (the MLP half of
// every encoder and decoder block).
//
// What bounds it on an H100: operations. SwiGLU at M = 16*2048 rows,
// D = 768, HID = 2048 does 3*2*M*D*HID = 309 GFLOP against
// (2*M*D + 3*D*HID)*2 = 110 MB, far above the ~295 FLOP/byte ridge; at
// 4M-21 XL (M = 8*2304, D = 2048, HID = 5461) 1.24 TFLOP.
//
// Design: three kernels, all from gemm_sm90.cuh (TMA-fed wgmma GEMMs with
// 128 x 128 tiles), instead of one kernel whose row blocks each re-read
// every weight (67 MB per 16 rows at XL, more than the 50 MB L2):
//   1. the LN prologue writes h = bf16(LN(x)) to a scratch (M, D);
//   2. stage 1, h @ W1^T: gated, a dual-B GEMM that loads the W1 and W3
//      tiles into the same stage and keeps two accumulators (4 stages of
//      48 KB); its epilogue adds b1 / b3 in fp32, applies silu(g) * u, or
//      exact-erf GELU on the one product, and stores bf16 act to a scratch
//      (M, HID8), HID8 = HID rounded up to 8. Units at or past HID read
//      zero weight rows (TMA's zero fill) and are written as exact zeros;
//   3. stage 2, act @ W2^T: its epilogue adds b2 in fp32, rounds the branch
//      to bf16 and adds the residual x, as the TPU kernel does.
// act crosses device memory once: 2*M*HID8*2 bytes (~0.12 ms at XL against
// a 1.25 ms bound), the price of reading each weight tile once per 128
// rows. W2 (D, HID) must have 16-byte row strides for TMA: when HID % 8 !=
// 0 (SwiGLU's 1365 / 2730 / 5461) the wrapper passes a copy zero-padded to
// (D, HID8), made on each call (22 MB at XL); the padded units meet exact
// zeros in act. Any D % 8 == 0 and HID >= 1 are taken.
#include "gemm_sm90.cuh"

namespace fourm {

template <bool GATED>
struct ActEpi {  // act[r, c] = bf16(silu(g + b1) * (u + b3)) or bf16(gelu(g + b1)); 0 past HID
  bf16* act;
  const float* b1;
  const float* b3;
  int hid, ld;
  __device__ __forceinline__ float unit(int c, float g, float u) const {
    if (c >= hid) return 0.f;
    if (b1 != nullptr) g += b1[c];
    if (GATED) {
      if (b3 != nullptr) u += b3[c];
      return g * (1.f / (1.f + expf(-g))) * u;
    }
    return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
  }
  __device__ __forceinline__ void operator()(int r, int c, float g0, float g1) const {
    store(r, c, unit(c, g0, 0.f), unit(c + 1, g1, 0.f));
  }
  __device__ __forceinline__ void operator()(int r, int c, float g0, float g1, float u0,
                                             float u1) const {
    store(r, c, unit(c, g0, u0), unit(c + 1, g1, u1));
  }
  __device__ __forceinline__ void store(int r, int c, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(act + (size_t)r * ld + c) = __floats2bfloat162_rn(v0, v1);
  }
};

struct ResidualEpi {  // out[r, c] = bf16(x[r, c] + bf16(acc + b2[c]))
  bf16* out;
  const bf16* x;
  const float* b2;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float a0, float a1) const {
    if (b2 != nullptr) {
      a0 += b2[c];
      a1 += b2[c + 1];
    }
    const size_t i = (size_t)r * ld + c;
    const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + i));
    *reinterpret_cast<__nv_bfloat162*>(out + i) =
        __floats2bfloat162_rn(xr.x + bf16_round(a0), xr.y + bf16_round(a1));
  }
};

}  // namespace fourm

// x (M, D) bf16; gamma, beta (D) fp32 (beta may be null); w1, w3 (HID, D)
// bf16; b1, b3 (HID) fp32 or null; w2 (D, HID8) bf16, the columns past HID
// zero; b2 (D) fp32 or null; h (M, D) and act (M, HID8) bf16 scratch; out
// (M, D) bf16. D % 8 == 0, HID8 = HID rounded up to 8, 16-byte aligned
// x, w1, w3, w2, h and act.
extern "C" int fourm_ln_mlp(const void* x, const void* gamma, const void* beta,
                            const void* w1, const void* b1, const void* w3,
                            const void* b3, const void* w2, const void* b2, void* h,
                            void* act, void* out, int M, int D, int HID, int gated, float eps,
                            void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
  const int HID8 = (HID + 7) / 8 * 8;
  if (D % 8 != 0 || HID < 1) return (int)cudaErrorInvalidValue;
  int err = sm90::launch_ln_rows<1>(x, gamma, beta, h, M, D, eps, s);
  if (err != 0) return err;
  if (gated)
    err = sm90::launch_gemm<ActEpi<true>, true, 4>(
        h, w1, w3, M, HID8, D, HID,
        ActEpi<true>{(bf16*)act, (const float*)b1, (const float*)b3, HID, HID8}, s);
  else
    err = sm90::launch_gemm<ActEpi<false>, false, 6>(
        h, w1, nullptr, M, HID8, D, HID,
        ActEpi<false>{(bf16*)act, (const float*)b1, nullptr, HID, HID8}, s);
  if (err != 0) return err;
  return sm90::launch_gemm<ResidualEpi, false, 6>(
      act, w2, nullptr, M, D, HID8, D, ResidualEpi{(bf16*)out, (const bf16*)x, (const float*)b2, D},
      s);
}
