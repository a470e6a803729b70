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
// What bounds it on an H100: bytes. At B <= 64 rows it is weight streaming:
// (C*C + 3*C*HID) bf16 = 10.6 MB at C = 768, HID = 2048 (3.2 us at
// 3.35 TB/s) and 75.5 MB at 4M-21 XL (C = 2048, HID = 5461: 22.5 us),
// against 2*B*(C*C + 3*C*HID) = 85 MFLOP at B = 8.
//
// Design: three products on the weight-streaming core of gemv_sm90.cuh
// (each weight streamed once by TMA through an mbarrier ring, the B token
// rows the wgmma N operand, split-K partials added in cluster shared memory
// in a fixed order), each stage launched with programmatic dependent launch
// so that its weights stream while the stage before it finishes:
//   1. Wp: tokens = attn; epilogue x1 = x + bf16(acc + bp) -> x1 (B, C);
//   2. W1 and W3 as one dual product (SwiGLU's gate and up; W1 alone for
//      GELU): tokens = LN2(x1), every CTA recomputing the statistics of its
//      rows (LN2's parameters read before the wait); epilogue act =
//      silu(fc1 + b1) * (fc3 + b3) or GELU(fc1 + b1) -> act (B, HIDS) bf16,
//      HIDS = HID rounded up to 8, the tail zero;
//   3. W2: tokens = act; epilogue out = x1 + bf16(acc + b2).
// Stage 3 reads W2's HID columns with its rows ld2 elements apart (a
// multiple of 8: TMA's 16-byte row stride), the columns past HID as TMA's
// zeros. A HID that is not a multiple of 8 (SwiGLU at 4M-L / 4M-XL: 2730,
// 5461) is read in place where the weight is the (C, HID) view of
// zero-padded storage, as the MLP modules keep a ragged bf16 fc2 weight
// (ops/transformer.py); any other ragged W2 is padded by the wrapper on
// that call (decode_step.py:_w2_for_tma). The tile plan (N tile, split and
// K blocks of each stage) comes from the wrapper.
#include "gemv_sm90.cuh"

namespace fourm {

using gemv::THREADS;
using gemv::TM;

// stage 1: x1 = x + bf16(attn Wp^T + bp)
struct ResidualProj {
  const bf16* x;
  const bf16* attn;
  const void* bp;
  int pbf;
  bf16* x1;
  int B, C;

  static constexpr bool LN = false;
  __device__ void prologue(float*, int, int, int, int, int) const {}
  __device__ void stage(unsigned char* act, const float*, int kb0, int nkb, int nt, int n0) const {
    gemv::stage_copy(act, kb0, nkb, nt, n0, attn, B, C, C);
  }
  __device__ void epilogue(const float* sum, const float*, int m0, int n0, int nt) const {
    for (int i = threadIdx.x; i < nt * TM; i += THREADS) {
      const int c = i / TM, r = i % TM, b = n0 + c, col = m0 + r;
      if (b >= B || col >= C) continue;
      float y = sum[r * gemv::cs(nt) + c];
      if (bp != nullptr) y += ld_param(bp, col, pbf);
      const size_t o = (size_t)b * C + col;
      x1[o] = __float2bfloat16(__bfloat162float(x[o]) + bf16_round(y));
    }
  }
};

// stage 2: act = silu(LN2(x1) W1^T + b1) * (LN2(x1) W3^T + b3), or GELU; act
// rows are HIDS long, the tail written as zeros
template <bool GATED>
struct ResidualHidden {
  const bf16* x1;
  const void *g2, *be2, *b1, *b3;
  int pbf;
  bf16* act;
  int B, C, HID, HIDS;
  float eps;

  static constexpr bool LN = true;
  __device__ void prologue(float* lnp, int kb0, int nkb, int, int, int) const {
    gemv::ln_prologue(lnp, kb0, nkb, C, g2, be2, pbf);
  }
  __device__ void stage(unsigned char* s, const float* lnp, int kb0, int nkb, int nt,
                        int n0) const {
    gemv::stage_ln(s, lnp, kb0, nkb, nt, n0, x1, B, C, eps);
  }
  __device__ void epilogue(const float* sum, const float* sum2, int m0, int n0, int nt) const {
    for (int i = threadIdx.x; i < nt * TM; i += THREADS) {
      const int c = i / TM, r = i % TM, b = n0 + c, j = m0 + r;
      if (b >= B || j >= HIDS) continue;
      float hv = 0.f;
      if (j < HID) {
        float gv = sum[r * gemv::cs(nt) + c];
        if (b1 != nullptr) gv += ld_param(b1, j, pbf);
        if constexpr (GATED) {
          float uv = sum2[r * gemv::cs(nt) + c];
          if (b3 != nullptr) uv += ld_param(b3, j, pbf);
          hv = gv * (1.f / (1.f + expf(-gv))) * uv;  // silu(fc1) * fc3
        } else {
          hv = 0.5f * gv * (1.f + erff(gv * 0.70710678118654752f));  // exact GELU
        }
      }
      act[(size_t)b * HIDS + j] = __float2bfloat16(hv);
    }
  }
};

// stage 3: out = x1 + bf16(act W2^T + b2), W2 read with rows of HIDS
struct ResidualOut {
  const bf16* act;
  const bf16* x1;
  const void* b2;
  int pbf;
  bf16* out;
  int B, C, HIDS;

  static constexpr bool LN = false;
  __device__ void prologue(float*, int, int, int, int, int) const {}
  __device__ void stage(unsigned char* s, const float*, int kb0, int nkb, int nt, int n0) const {
    gemv::stage_copy(s, kb0, nkb, nt, n0, act, B, HIDS, HIDS);
  }
  __device__ void epilogue(const float* sum, const float*, int m0, int n0, int nt) const {
    for (int i = threadIdx.x; i < nt * TM; i += THREADS) {
      const int c = i / TM, r = i % TM, b = n0 + c, col = m0 + r;
      if (b >= B || col >= C) continue;
      float y = sum[r * gemv::cs(nt) + c];
      if (b2 != nullptr) y += ld_param(b2, col, pbf);
      const size_t o = (size_t)b * C + col;
      out[o] = __float2bfloat16(__bfloat162float(x1[o]) + bf16_round(y));
    }
  }
};

}  // namespace fourm

// plan: (N tile, passes over B, split, K blocks per CTA) of stages 1, 2 and
// 3 (decode_step.py:residual_mlp_plan). ld2: W2's row stride in elements.
extern "C" int fourm_residual_mlp(const void* x, const void* attn, const void* wp,
                                  const void* w1, const void* w3, const void* w2,
                                  const void* bp, const void* g2, const void* be2,
                                  const void* b1, const void* b3, const void* b2, int pbf,
                                  void* x1, void* act, void* out, int B, int C, int HID, int HIDS,
                                  int ld2, int gated, float eps, const int* plan, void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
  const gemv::Plan p1{plan[0], plan[1], plan[2], plan[3]}, p2{plan[4], plan[5], plan[6], plan[7]},
      p3{plan[8], plan[9], plan[10], plan[11]};
  int err = gemv::launch_gemv<ResidualProj, false>(
      wp, nullptr, C, C, p1,
      ResidualProj{(const bf16*)x, (const bf16*)attn, bp, pbf, (bf16*)x1, B, C}, s);
  if (err != 0) return err;
  if (gated)
    err = gemv::launch_gemv<ResidualHidden<true>, true>(
        w1, w3, HID, C, p2,
        ResidualHidden<true>{(const bf16*)x1, g2, be2, b1, b3, pbf, (bf16*)act, B, C, HID, HIDS,
                             eps},
        s);
  else
    err = gemv::launch_gemv<ResidualHidden<false>, false>(
        w1, nullptr, HID, C, p2,
        ResidualHidden<false>{(const bf16*)x1, g2, be2, b1, nullptr, pbf, (bf16*)act, B, C, HID,
                              HIDS, eps},
        s);
  if (err != 0) return err;
  return gemv::launch_gemv<ResidualOut, false>(
      w2, nullptr, C, HIDS, p3,
      ResidualOut{(const bf16*)act, (const bf16*)x1, b2, pbf, (bf16*)out, B, C, HIDS}, s, HID,
      ld2);
}
