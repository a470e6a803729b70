// One-pass AdamW over every parameter leaf of a model, in one launch.
// Replaces fourm_tpu/kernels/fused_adamw.py:fused_adamw_leaf (pallas_call
// :101), which runs once per leaf. Per element, in this order (the twin's):
//   g  = g / gnorm * max_norm          (only when clipping and gnorm >= max)
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + ((1 - b2) g) g
//   u  = (m' c1) / (sqrt(v' c2) + eps)  c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t)
//   u  = u + wd p                       (leaves with decay only)
//   p' = p - lr u
// p, m and v (fp32) are updated in place. Every operation is one IEEE
// rounding (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, no
// FMA contraction), so the result equals the plain PyTorch twin's bit for
// bit. A leaf without a gradient (null pointer) is stepped with g = 0, as
// the JAX package's zero gradient of an unused parameter.
//
// What bounds it on an H100: bytes. 7 x 4 bytes per element (read g, p, m,
// v; write p, m, v) against ~20 FLOP: the 361M-element 4M-B tree is ~10.1
// GB, ~3.0 ms at 3.35 TB/s.
//
// Design: the model's 256 leaves are one launch, not 256 (a leaf of 768
// elements is all launch overhead). A static table cuts every leaf into
// chunks of at most ADAM_CHUNK elements; blocks walk the chunks grid-stride
// and their threads the elements, 16 bytes a thread where the chunk is
// aligned. The leaf table (p, m, v pointers, decay flag) and the chunk
// table are uploaded once per optimizer; the gradient pointers, one per
// leaf, each step.
#include "common.cuh"

namespace fourm {

constexpr int ADAM_THREADS = 256;

struct AdamScalars {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd, max_norm;
};

__device__ __forceinline__ float adam_elem(float g, float& p, float& m, float& v,
                                           const AdamScalars& s, bool decay, bool clip,
                                           float gnorm) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, gnorm), s.max_norm);
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  float u = __fdiv_rn(__fmul_rn(m, s.c1), __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.c2)), s.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, u));
  return p;
}

// leaves: (L, 4) int64 rows [p, m, v, decay]; grads: (L,) int64 pointers
// (0 = no gradient); chunks: (C, 3) int32 rows [leaf, start, length].
__global__ void __launch_bounds__(ADAM_THREADS) adamw_kernel(
    const long long* __restrict__ leaves, const long long* __restrict__ grads,
    const int* __restrict__ chunks, int nchunks, AdamScalars s,
    const float* __restrict__ gnorm_ptr) {
  // clip when a norm is given and it is not below the maximum (optax's
  // clip_by_global_norm keeps g when gnorm < max_norm)
  const float gnorm = gnorm_ptr != nullptr ? *gnorm_ptr : 0.f;
  const bool clip = gnorm_ptr != nullptr && !(gnorm < s.max_norm);
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int leaf = chunks[3 * c], start = chunks[3 * c + 1], len = chunks[3 * c + 2];
    float* p = reinterpret_cast<float*>(leaves[4 * leaf]) + start;
    float* m = reinterpret_cast<float*>(leaves[4 * leaf + 1]) + start;
    float* v = reinterpret_cast<float*>(leaves[4 * leaf + 2]) + start;
    const bool decay = leaves[4 * leaf + 3] != 0;
    const float* g = grads[leaf] != 0 ? reinterpret_cast<const float*>(grads[leaf]) + start
                                      : nullptr;
    const bool vec = len % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(m) |
                       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) % 16) == 0;
    if (vec) {
      for (int i = threadIdx.x; i < len / 4; i += ADAM_THREADS) {
        float4 pv = reinterpret_cast<float4*>(p)[i];
        float4 mv = reinterpret_cast<float4*>(m)[i];
        float4 vv = reinterpret_cast<float4*>(v)[i];
        const float4 gv = g != nullptr ? reinterpret_cast<const float4*>(g)[i]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        adam_elem(gv.x, pv.x, mv.x, vv.x, s, decay, clip, gnorm);
        adam_elem(gv.y, pv.y, mv.y, vv.y, s, decay, clip, gnorm);
        adam_elem(gv.z, pv.z, mv.z, vv.z, s, decay, clip, gnorm);
        adam_elem(gv.w, pv.w, mv.w, vv.w, s, decay, clip, gnorm);
        reinterpret_cast<float4*>(p)[i] = pv;
        reinterpret_cast<float4*>(m)[i] = mv;
        reinterpret_cast<float4*>(v)[i] = vv;
      }
    } else {
      for (int i = threadIdx.x; i < len; i += ADAM_THREADS)
        adam_elem(g != nullptr ? g[i] : 0.f, p[i], m[i], v[i], s, decay, clip, gnorm);
    }
  }
}

}  // namespace fourm

extern "C" int fourm_fused_adamw(const void* leaves, const void* grads, const void* chunks,
                                 int nchunks, float lr, float c1, float c2, float b1, float omb1,
                                 float b2, float omb2, float eps, float wd, const void* gnorm,
                                 float max_norm, void* stream) {
  using namespace fourm;
  if (nchunks <= 0) return 0;
  AdamScalars s{lr, c1, c2, b1, omb1, b2, omb2, eps, wd, max_norm};
  const int grid = nchunks < 8 * num_sms() ? nchunks : 8 * num_sms();
  adamw_kernel<<<grid, ADAM_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)leaves, (const long long*)grads, (const int*)chunks, nchunks, s,
      (const float*)gnorm);
  return (int)cudaGetLastError();
}
