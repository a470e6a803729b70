// One-pass AdamW over every parameter leaf of a model, in one launch.
// Replaces fourm_tpu/kernels/fused_adamw.py:fused_adamw_leaf (pallas_call
// :101), which runs once per leaf, and the optax chain the JAX package
// builds around it (utils/optim.py:create_optimizer, parallel/train.py:
// build_train_step): the global-norm clip, per-layer learning-rate scales
// in the reference's order, the frozen-trunk mask and skip_large_grads.
// Per element, in this order (the twin's):
//   g  = g / gnorm * max_norm           (only when clipping and gnorm >= max)
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + ((1 - b2) g) g
//   u  = (m' c1) / (sqrt(v' c2) + eps)  c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t)
//   u  = u + wd p                       (leaves with decay only)
//   p' = p - (lr u) scale               (trainable leaves; a frozen p is not
//                                        read or written)
// p, m and v (fp32) are updated in place. Every operation is one IEEE
// rounding (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, no
// FMA contraction), so the result equals the plain PyTorch twin's bit for
// bit. A leaf without a gradient (null pointer) is stepped with g = 0, as
// the JAX package's zero gradient of an unused parameter. A frozen leaf's
// moments step on its gradient as given (the train step zeroes a frozen
// trunk's gradients first, as JAX multiplies them by the trainable mask).
//
// The step's scalars come from the card, so that neither a skip nor the
// step count needs the host: the step count t - 1 is read from count_in,
// lr from the schedule's table at it and (c1, c2) from the bias table (both
// clamped to their last entry: the caller's tables cover every count it
// can reach). With skip set, a step whose gradient norm is not finite or
// exceeds skip_max changes nothing and writes count_out = count_in (JAX's
// skip_large_grads keeps the moments and the count); otherwise count_out =
// count_in + 1. count_in and count_out are two words the caller swaps each
// step, so that no block reads a count another block has written.
//
// What bounds it on an H100: bytes. 7 x 4 bytes per element of a trainable
// leaf (read g, p, m, v; write p, m, v), 5 x 4 of a frozen one (p is left
// alone), against ~20 FLOP: the 361M-element 4M-B tree is ~10.1 GB, ~3.0 ms
// at 3.35 TB/s.
//
// Design: the model's leaves are one launch (a leaf of 768 elements is all
// launch overhead). A static table cuts every leaf into chunks of at most
// ADAM_CHUNK elements; blocks walk the chunks grid-stride and their threads
// the elements, 16 bytes a thread where the chunk is aligned. The leaf
// table (p, m, v pointers, flags, lr scale) and the chunk table are uploaded
// once per optimizer and mask; the gradient pointers, one per leaf, each
// step.
#include "common.cuh"

namespace fourm {

constexpr int ADAM_THREADS = 256;

struct AdamScalars {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd, max_norm;
};

// The moments' step; returns the update u (before lr and the scale).
__device__ __forceinline__ float adam_moments(float g, float& m, float& v, const AdamScalars& s,
                                              bool clip, float gnorm) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, gnorm), s.max_norm);
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  return __fdiv_rn(__fmul_rn(m, s.c1), __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.c2)), s.eps));
}

__device__ __forceinline__ void adam_param(float u, float& p, const AdamScalars& s, bool decay,
                                           float scale) {
  if (decay) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(__fmul_rn(s.lr, u), scale));
}

// leaves: (L, 5) int64 rows [p, m, v, flags (1 decay, 2 trainable), lr
// scale (fp32 bits)]; grads: (L,) int64 pointers (0 = no gradient); chunks:
// (C, 3) int32 rows [leaf, start, length]; count: (2,) int32; lr_table:
// (n_lr,) fp32; bias_table: (n_bias, 2) fp32 rows (c1, c2).
__global__ void __launch_bounds__(ADAM_THREADS) adamw_kernel(
    const long long* __restrict__ leaves, const long long* __restrict__ grads,
    const int* __restrict__ chunks, int nchunks, AdamScalars s,
    const float* __restrict__ gnorm_ptr, bool clip_on, bool skip_on, float skip_max,
    const int* __restrict__ count_in, int* __restrict__ count_out,
    const float* __restrict__ lr_table, int n_lr, const float* __restrict__ bias_table,
    int n_bias) {
  const float gnorm = gnorm_ptr != nullptr ? *gnorm_ptr : 0.f;
  // optax's clip_by_global_norm keeps g when gnorm < max_norm
  const bool clip = clip_on && !(gnorm < s.max_norm);
  const bool skip = skip_on && !(isfinite(gnorm) && gnorm <= skip_max);
  const int t = *count_in;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count_out = skip ? t : t + 1;
  if (skip) return;
  s.lr = lr_table[min(t, n_lr - 1)];
  const int b = min(t, n_bias - 1);
  s.c1 = bias_table[2 * b];
  s.c2 = bias_table[2 * b + 1];
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int leaf = chunks[3 * c], start = chunks[3 * c + 1], len = chunks[3 * c + 2];
    float* p = reinterpret_cast<float*>(leaves[5 * leaf]) + start;
    float* m = reinterpret_cast<float*>(leaves[5 * leaf + 1]) + start;
    float* v = reinterpret_cast<float*>(leaves[5 * leaf + 2]) + start;
    const long long flags = leaves[5 * leaf + 3];
    const bool decay = (flags & 1) != 0, trainable = (flags & 2) != 0;
    const float scale = __int_as_float(static_cast<int>(leaves[5 * leaf + 4]));
    const float* g = grads[leaf] != 0 ? reinterpret_cast<const float*>(grads[leaf]) + start
                                      : nullptr;
    // a frozen leaf's p is neither read nor written: 20 bytes an element
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v) |
                           reinterpret_cast<uintptr_t>(g) |
                           (trainable ? reinterpret_cast<uintptr_t>(p) : 0);
    if (len % 4 == 0 && ptrs % 16 == 0) {
      for (int i = threadIdx.x; i < len / 4; i += ADAM_THREADS) {
        float4 mv = reinterpret_cast<float4*>(m)[i];
        float4 vv = reinterpret_cast<float4*>(v)[i];
        const float4 gv = g != nullptr ? reinterpret_cast<const float4*>(g)[i]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        float4 pv = trainable ? reinterpret_cast<float4*>(p)[i]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 u = make_float4(adam_moments(gv.x, mv.x, vv.x, s, clip, gnorm),
                                     adam_moments(gv.y, mv.y, vv.y, s, clip, gnorm),
                                     adam_moments(gv.z, mv.z, vv.z, s, clip, gnorm),
                                     adam_moments(gv.w, mv.w, vv.w, s, clip, gnorm));
        reinterpret_cast<float4*>(m)[i] = mv;
        reinterpret_cast<float4*>(v)[i] = vv;
        if (trainable) {
          adam_param(u.x, pv.x, s, decay, scale);
          adam_param(u.y, pv.y, s, decay, scale);
          adam_param(u.z, pv.z, s, decay, scale);
          adam_param(u.w, pv.w, s, decay, scale);
          reinterpret_cast<float4*>(p)[i] = pv;
        }
      }
    } else {
      for (int i = threadIdx.x; i < len; i += ADAM_THREADS) {
        const float u = adam_moments(g != nullptr ? g[i] : 0.f, m[i], v[i], s, clip, gnorm);
        if (trainable) adam_param(u, p[i], s, decay, scale);
      }
    }
  }
}

}  // namespace fourm

extern "C" int fourm_fused_adamw(const void* leaves, const void* grads, const void* chunks,
                                 int nchunks, float b1, float omb1, float b2, float omb2,
                                 float eps, float wd, const void* gnorm, float max_norm,
                                 int clip_on, int skip_on, float skip_max, const void* count_in,
                                 void* count_out, const void* lr_table, int n_lr,
                                 const void* bias_table, int n_bias, void* stream) {
  using namespace fourm;
  if (nchunks <= 0) return 0;
  AdamScalars s{0.f, 0.f, 0.f, b1, omb1, b2, omb2, eps, wd, max_norm};
  const int grid = nchunks < 8 * num_sms() ? nchunks : 8 * num_sms();
  adamw_kernel<<<grid, ADAM_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)leaves, (const long long*)grads, (const int*)chunks, nchunks, s,
      (const float*)gnorm, clip_on != 0, skip_on != 0, skip_max, (const int*)count_in,
      (int*)count_out, (const float*)lr_table, n_lr, (const float*)bias_table, n_bias);
  return (int)cudaGetLastError();
}
