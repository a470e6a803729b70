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
// at C = 768, 25.2 MB at 4M-21 XL) and the live part of the caches (2 *
// B*H*step*64 bf16: 6.3 MB at B = 8, H = 12, step = 256), 1-9 us at
// 3.35 TB/s; its FLOPs are nothing.
//
// Design: two kernels under programmatic dependent launch.
//   1. The projection on the weight-streaming core of gemv_sm90.cuh: Wqkv
//      is streamed once by TMA for all B rows (the wgmma N operand, staged
//      as LN1(x) by every CTA for its K range), split over K, the partials
//      added in cluster shared memory in a fixed order. Wqkv's 64-row tiles
//      are one head's q, k or v each (heads of 64), so the epilogue of one
//      CTA does the head's bias, QK-norm and bf16 rounding, writes q / k / v
//      to a (B, 3, H, 64) bf16 scratch and k, v into the caches at `step`
//      (0 <= step < L).
//   2. Attention over the cache, a CTA per (head, batch row), L split over
//      its warps in chunks of 32 positions, each warp an online softmax over
//      its chunks, the warps' (max, sum, p V) combined in order in shared
//      memory (no atomics). The work of a (b, h) is small (at most a few
//      hundred 128-byte rows), so the kernel is built for latency: only
//      positions < step are read from the caches, and kernel 1 writes only
//      row `step`, so before its wait on kernel 1 every warp reads `step`
//      and loads its first chunk of keys and values into registers (8
//      16-byte loads a lane each, all in flight); q, k_new and v_new come
//      from the scratch after the wait. No block-wide barrier but the one
//      before the combine. A step at or past L writes nothing and attends
//      to all L positions; at step 0 the output is v_new.
#include <float.h>

#include "gemv_sm90.cuh"

namespace fourm {

constexpr int SD_DH = 64;

// kernel 1's operation: tokens LN1(x); epilogue per head tile
struct SelfDecodeQkv {
  const bf16* x;
  const void *g1, *be1, *bqkv, *qng, *qnb, *kng, *knb;
  int pbf;
  bf16* qkv;
  bf16* ck;
  bf16* cv;
  const int* step_ptr;
  int B, H, L, C;
  float eps;

  static constexpr bool LN = true;
  // before the wait: LN1's parameters
  __device__ void prologue(float* lnp, int kb0, int nkb, int, int, int) const {
    gemv::ln_prologue(lnp, kb0, nkb, C, g1, be1, pbf);
  }
  __device__ void stage(unsigned char* act, const float* lnp, int kb0, int nkb, int nt,
                        int n0) const {
    gemv::stage_ln(act, lnp, kb0, nkb, nt, n0, x, B, C, eps);
  }
  // a warp per token: lane holds head dims lane and lane + 32
  __device__ void epilogue(const float* sum, const float*, int m0, int n0, int nt) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int tile = m0 / SD_DH, part = tile / H, h = tile % H;
    const int step = *step_ptr;
    const bool norm = qng != nullptr && part < 2;
    const void* ng = part == 0 ? qng : kng;
    const void* nb = part == 0 ? qnb : knb;
    bf16* cache = part == 1 ? ck : cv;
    for (int c = warp; c < nt; c += gemv::THREADS / 32) {
      const int b = n0 + c;
      if (b >= B) break;
      float a0 = sum[lane * gemv::cs(nt) + c], a1 = sum[(lane + 32) * gemv::cs(nt) + c];
      if (bqkv != nullptr) {
        a0 += ld_param(bqkv, m0 + lane, pbf);
        a1 += ld_param(bqkv, m0 + lane + 32, pbf);
      }
      if (norm) gemv::head_norm(a0, a1, ng, nb, pbf, eps);
      const bf16 y0 = __float2bfloat16(a0), y1 = __float2bfloat16(a1);
      bf16* dst = qkv + (((size_t)b * 3 + part) * H + h) * SD_DH;
      dst[lane] = y0;
      dst[lane + 32] = y1;
      if (part > 0 && step >= 0 && step < L) {
        bf16* row = cache + (((size_t)b * H + h) * L + step) * SD_DH;
        row[lane] = y0;
        row[lane + 32] = y1;
      }
    }
  }
};

// kernel 2: a CTA of `warps` warps per (head, batch row); warp w takes the
// 32-position chunks w, w + warps, ... of the cache positions < step, an
// online softmax over them; the warps combine in order in shared memory.
// A lane holds 16 bytes (dims 8 vi .. 8 vi + 8) of rows g, g + 4, ..., g + 28
// of a chunk (g = lane / 8, vi = lane % 8), so a warp's loads of a chunk are
// 8 independent 16-byte loads a lane, for its keys and for its values.
constexpr int SC_CHUNK = 32;
constexpr int SC_ROWS = SC_CHUNK / 4;  // rows of a chunk a lane holds
constexpr int SC_MAX_WARPS = 16;

__device__ __forceinline__ void load_chunk(const bf16* __restrict__ cache, size_t row0, int j0,
                                           int n, int g, int vi, uint4 (&r)[SC_ROWS]) {
#pragma unroll
  for (int i = 0; i < SC_ROWS; ++i) {
    const int j = j0 + g + 4 * i;
    r[i] = j < n ? __ldg(reinterpret_cast<const uint4*>(cache + (row0 + j) * SD_DH) + vi)
                 : make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(SC_MAX_WARPS * 32)
self_decode_cache_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ ck,
                         const bf16* __restrict__ cv, const int* __restrict__ step_ptr,
                         bf16* __restrict__ out, int H, int L, int zero_attn) {
  __shared__ float wm[SC_MAX_WARPS], wl[SC_MAX_WARPS], wacc[SC_MAX_WARPS][SD_DH];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 8, vi = lane % 8;
  // `step` and the cache rows below it were written before kernel 1, which
  // lets this kernel start only once it has waited for them: the first
  // chunk's rows are loaded before the wait
  const int n = min(max(*step_ptr, 0), L);  // cache positions attended
  const size_t row0 = ((size_t)b * H + h) * L;
  uint4 kr[SC_ROWS], vr[SC_ROWS];
  load_chunk(ck, row0, warp * SC_CHUNK, n, g, vi, kr);
  load_chunk(cv, row0, warp * SC_CHUNK, n, g, vi, vr);
  sm90::wait_prerequisites();  // q, k_new, v_new come from kernel 1
  sm90::allow_dependents();
  const bf16* src = qkv + (((size_t)b * 3) * H + h) * SD_DH + vi * 8;
  float q[8], kn[8];
  unpack8(*reinterpret_cast<const uint4*>(src), q);
  unpack8(*reinterpret_cast<const uint4*>(src + (size_t)H * SD_DH), kn);
  const float scale = rsqrtf((float)SD_DH);
  float snew = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) snew += q[e] * kn[e];
  snew += __shfl_xor_sync(0xffffffffu, snew, 1);
  snew += __shfl_xor_sync(0xffffffffu, snew, 2);
  snew += __shfl_xor_sync(0xffffffffu, snew, 4);
  snew *= scale;
  // the warp's softmax state: max (with the new token's logit, and 0 for
  // softmax1, so that with one chunk the combine's weights are exactly 1),
  // sum and p V (dims 8 vi .. 8 vi + 8 of the rows of group g)
  float m = zero_attn ? fmaxf(snew, 0.f) : snew, l = 0.f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j0 = warp * SC_CHUNK; j0 < n; j0 += warps * SC_CHUNK) {
    if (j0 != warp * SC_CHUNK) {
      load_chunk(ck, row0, j0, n, g, vi, kr);
      load_chunk(cv, row0, j0, n, g, vi, vr);
    }
    float s[SC_ROWS];
    float cm = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < SC_ROWS; ++i) {
      float f[8];
      unpack8(kr[i], f);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d += q[e] * f[e];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      s[i] = d * scale;
      if (j0 + g + 4 * i < n) cm = fmaxf(cm, s[i]);
    }
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 8));
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
    const float mn = fmaxf(m, cm), corr = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= corr;
#pragma unroll
    for (int i = 0; i < SC_ROWS; ++i) {
      const float p = j0 + g + 4 * i < n ? expf(s[i] - m) : 0.f;
      ps += p;
      float f[8];
      unpack8(vr[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += p * f[e];
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 8);
    ps += __shfl_xor_sync(0xffffffffu, ps, 16);
    l = l * corr + ps;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 8);
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
  }
  if (g == 0)
#pragma unroll
    for (int e = 0; e < 8; ++e) wacc[warp][vi * 8 + e] = acc[e];
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {  // the warps' partials in order, then the new token
    float mx = wm[0];
    for (int w = 1; w < warps; ++w) mx = fmaxf(mx, wm[w]);
    float den = 0.f, o0 = 0.f, o1 = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float wt = expf(wm[w] - mx);
      den += wl[w] * wt;
      o0 += wacc[w][lane] * wt;
      o1 += wacc[w][lane + 32] * wt;
    }
    const float pn = expf(snew - mx);
    den += pn;
    if (zero_attn) den += expf(-mx);
    const bf16* vrow = src - vi * 8 + (size_t)2 * H * SD_DH;  // v_new
    const float vn0 = __bfloat162float(vrow[lane]), vn1 = __bfloat162float(vrow[lane + 32]);
    bf16* o = out + (size_t)b * H * SD_DH + h * SD_DH;
    o[lane] = __float2bfloat16((o0 + pn * vn0) / den);
    o[lane + 32] = __float2bfloat16((o1 + pn * vn1) / den);
  }
}

}  // namespace fourm

// plan: kernel 1's N tile, passes over B, split and K blocks per CTA;
// kernel 2's warps (decode_step.py:self_decode_plan).
extern "C" int fourm_self_decode(const void* x, const void* g1, const void* b1,
                                 const void* bqkv, const void* qng, const void* qnb,
                                 const void* kng, const void* knb, int pbf, const void* w,
                                 void* ck, void* cv, const void* step, void* qkv, void* out, int B,
                                 int H, int L, int C, float eps, int zero_attn, const int* plan,
                                 void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
  const gemv::Plan p1{plan[0], plan[1], plan[2], plan[3]};
  int err = gemv::launch_gemv<SelfDecodeQkv, false>(
      w, nullptr, 3 * C, C, p1,
      SelfDecodeQkv{(const bf16*)x, g1, b1, bqkv, qng, qnb, kng, knb, pbf, (bf16*)qkv,
                    (bf16*)ck, (bf16*)cv, (const int*)step, B, H, L, C, eps},
      s);
  if (err != 0) return err;
  const int warps = plan[4];
  if (warps < 1 || warps > SC_MAX_WARPS) return (int)cudaErrorInvalidValue;
  return gemv::launch_cluster(self_decode_cache_kernel, dim3(H, B), warps * 32, 1, 0, s,
                              (const bf16*)qkv, (const bf16*)ck, (const bf16*)cv,
                              (const int*)step, (bf16*)out, H, L, zero_attn);
}
