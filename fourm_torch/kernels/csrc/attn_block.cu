// attn_block: the whole pre-norm attention half of a block,
// out = x + proj(MHA(LN(x) @ Wqkv^T + bqkv)) + bproj, bf16 in and out, fp32
// LN statistics, fp32 sums, fp32 softmax, probabilities cast to bf16 before
// P V (attention.py:422).
//
// Replaces: fourm_tpu/kernels/attention.py:pallas_attn_block (the attention
// half of every short-sequence block without QK-norm: the ViT encoders of
// the VQ tokenizers).
//
// What bounds it on an H100: operations. At the tokenize shape (B = 64
// images, N = 196 tokens, C = 768, 12 heads) it does 2*B*N*C*4C +
// 4*B*H*N*N*Dh = 66.7 GFLOP against (2*B*N*C + 4*C*C)*2 = 43 MB.
//
// Design: the point of the TPU kernel is that the (B, N, 3C) QKV activation
// never leaves fast memory; here it never leaves shared memory. Three
// kernels:
//   1. ln_rows_kernel<2> (gemm_sm90.cuh) writes bf16 LN(x) of every row once
//      to a (B, N, C) scratch, as ln_matmul does;
//   2. attn_heads_kernel, one CTA per (head, image), three warpgroups (two
//      consumers, one producer thread issuing every TMA load). The producer
//      streams the image's LN rows in chunks of 128 (TMA zero-fills rows
//      past N) and this head's 3 x 64 rows of Wqkv through a ring of 64-wide
//      K steps; each consumer warpgroup accumulates q, k and v of its 64
//      rows with wgmma m64n64k16, adds bqkv in fp32 and writes them as bf16
//      into shared memory in the 128-byte swizzle that the attention's
//      wgmma descriptors read. Then each warpgroup attends its 64-query
//      blocks over the resident keys in tiles of 64 with the core of
//      attn_sm90.cuh (S by wgmma, register softmax, P V with P from
//      registers) and writes its (64, 64) output into a bf16 (B, N, C)
//      scratch at this head's columns;
//   3. the projection and residual as one gemm_sm90 launch whose epilogue
//      writes out = x + bf16(scratch @ Wproj^T + bproj), the rounding order
//      of attention.py:253-257.
// Shared memory bounds N: q, k and v of one image and head, 3 x
// roundup(N, 64) x 128 bytes, and its key bias, beside at least one 40 KB
// ring stage, in 227 KB: N <= 448 at every width; fourm_attn_block_fits says whether they fit,
// for the wrapper and the routing (attention.attn_block_takes).
#include "attn_sm90.cuh"

namespace fourm {

constexpr int AB_THREADS = 384;
constexpr int AB_A_BYTES = 128 * 64 * 2;        // LN rows: 128 x 64
constexpr int AB_W_BYTES = 64 * 64 * 2;         // one of q, k, v's 64 Wqkv rows x 64
constexpr int AB_STAGE = AB_A_BYTES + 3 * AB_W_BYTES;  // 40 KB
constexpr int AB_MAX_STAGES = 3;
constexpr size_t AB_SMEM_MAX = 232448;

__host__ __device__ inline int ab_rows(int N) { return (N + 63) / 64 * 64; }

// q, k, v regions, then the ring, then 2 barriers per stage and the key
// bias of every key; 1 KB for the alignment of the dynamic base
inline size_t ab_fixed(int N) {
  return 1024 + (size_t)3 * ab_rows(N) * 128 + 2 * AB_MAX_STAGES * sizeof(uint64_t) +
         (size_t)ab_rows(N) * sizeof(float);
}

inline int ab_stages(int N) {
  if (N < 1 || ab_fixed(N) > AB_SMEM_MAX) return 0;
  const size_t st = (AB_SMEM_MAX - ab_fixed(N)) / AB_STAGE;
  return st < AB_MAX_STAGES ? (int)st : AB_MAX_STAGES;
}

struct AttnHeadsArgs {
  const float* bqkv;  // (3C) or null
  const float* bias;  // (B, N) additive key bias or null
  bf16* attn;         // (B, N, C) scratch
  int N, C, stages; float scale; int zero_attn;
};

// The resident K, V and key bias of one image and head, as attend() reads
// them.
struct ResidentKV {
  const unsigned char* k;
  const unsigned char* v;
  const float* kbias;
  __device__ __forceinline__ void wait(int t, uint64_t& dk, uint64_t& dv) {
    dk = sm90::desc_sw128(k + t * 64 * 128);
    dv = sm90::desc_sw128_mn(v + t * 64 * 128);
  }
  __device__ __forceinline__ const float* key_bias(int t) const { return kbias + t * 64; }
  __device__ __forceinline__ void release(int) {}
};

template <int BIAS>
__global__ void __launch_bounds__(AB_THREADS, 1)
attn_heads_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  AttnHeadsArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int N = p.N, C = p.C, NS = p.stages;
  const int NP = ab_rows(N);
  unsigned char* region[3] = {smem, smem + (size_t)NP * 128, smem + (size_t)2 * NP * 128};
  unsigned char* ring = smem + (size_t)3 * NP * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)NS * AB_STAGE);
  uint64_t* empty = full + NS;
  float* kbias = reinterpret_cast<float*>(empty + NS);  // NP keys
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_chunks = (NP + 127) / 128, nk = C / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  sm90::wait_prerequisites();  // ln_rows_kernel's LN(x)

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      for (int i = 0; i < n_chunks * nk; ++i) {
        const int c = i / nk, kb = i % nk, s = i % NS;
        sm90::mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);  // the first round passes
        unsigned char* st = ring + (size_t)s * AB_STAGE;
        sm90::mbar_expect_tx(&full[s], AB_STAGE);
        sm90::tma_load_3d(st, &tx, &full[s], kb * 64, c * 128, b);
#pragma unroll
        for (int part = 0; part < 3; ++part)
          sm90::tma_load_2d(st + AB_A_BYTES + part * AB_W_BYTES, &tw, &full[s], kb * 64,
                            part * C + h * 64);
      }
    }
    return;
  }

  // ---- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, quad = lane % 4;
  const int rlocal = warp * 16 + lane / 4;  // the thread's first row of a 64-row block

  // q, k, v of 64-row block 2c + wg for every chunk c
  {
    float acc[3][32];
    int i = 0, prev = -1;
    for (int c = 0; c < n_chunks; ++c) {
      const int rb = 2 * c + wg;
      const bool active = rb * 64 < NP;
      for (int kb = 0; kb < nk; ++kb, ++i) {
        const int s = i % NS;
        sm90::mbar_wait(&full[s], (i / NS) & 1);
        if (active) {
          unsigned char* st = ring + (size_t)s * AB_STAGE;
          const uint64_t da = sm90::desc_sw128(st + wg * 64 * 128);
#pragma unroll
          for (int part = 0; part < 3; ++part) sm90::fence_acc(acc[part]);
          sm90::wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int part = 0; part < 3; ++part)
              sm90::wgmma_m64n64k16(acc[part], da + 2 * k,
                                    sm90::desc_sw128(st + AB_A_BYTES + part * AB_W_BYTES) + 2 * k,
                                    kb > 0 || k > 0);
          sm90::wgmma_commit();
#pragma unroll
          for (int part = 0; part < 3; ++part) sm90::fence_acc(acc[part]);
        }
        if (NS == 1) {  // one stage: release it as soon as its products are done
          sm90::wgmma_wait<0>();
          sm90::mbar_arrive(&empty[s]);
        } else {  // release the previous stage, whose products are done
          sm90::wgmma_wait<1>();
          if (prev >= 0) sm90::mbar_arrive(&empty[prev]);
          prev = s;
        }
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int part = 0; part < 3; ++part) sm90::fence_acc(acc[part]);
      if (NS > 1) {
        sm90::mbar_arrive(&empty[prev]);
        prev = -1;
      }
      if (!active) continue;
      // + bqkv in fp32, bf16 into the regions at rows rb * 64 + rlocal (+8):
      // 16-byte chunk j of row r at chunk j ^ (r % 8) (the 128-byte swizzle)
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const float* bq = p.bqkv != nullptr ? p.bqkv + part * C + h * 64 : nullptr;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rb * 64 + rlocal + 8 * r;
          unsigned char* dst = region[part] + (size_t)row * 128 + 4 * quad;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v0 = acc[part][4 * j + 2 * r], v1 = acc[part][4 * j + 2 * r + 1];
            if (bq != nullptr) {
              v0 += bq[8 * j + 2 * quad];
              v1 += bq[8 * j + 2 * quad + 1];
            }
            *reinterpret_cast<__nv_bfloat162*>(dst + ((j ^ (row & 7)) << 4)) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
  // the image's key bias, clamped and in log2 units, as the softmax reads it
  if (BIAS != 0)
    for (int i = threadIdx.x; i < NP; i += 256)
      kbias[i] = i < N ? sm90::key_bias_log2(p.bias[(size_t)b * N + i]) : 0.f;
  // the generic-proxy stores above, before any wgmma (async proxy) reads them
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, 256;" ::: "memory");

  // ---- attention: warpgroup wg takes the 64-query blocks wg, wg + 2, ...
  const sm90::BiasRows bias{{nullptr, nullptr}, 1};  // the key bias is in kbias
  ResidentKV kv{region[1], region[2], kbias};
  for (int qb = wg; qb * 64 < NP; qb += 2) {
    sm90::RowState st;
    sm90::attend<64, BIAS>(kv, sm90::desc_sw128(region[0] + qb * 64 * 128), NP / 64, N, p.scale,
                           bias, p.zero_attn, st);
    bf16* dst[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = qb * 64 + rlocal + 8 * r;
      dst[r] = n < N ? p.attn + ((size_t)b * N + n) * C + h * 64 : nullptr;
    }
    sm90::store_rows(st, p.zero_attn, dst);
  }
}

struct AttnOutEpi {  // out[r, c] = bf16(x[r, c] + bf16(acc + b[c]))
  bf16* out;
  const bf16* x;
  const float* b;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float a0, float a1) const {
    if (b != nullptr) {
      a0 += b[c];
      a1 += b[c + 1];
    }
    const size_t at = (size_t)r * ld + c;
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
    *reinterpret_cast<__nv_bfloat162*>(out + at) =
        __floats2bfloat162_rn(xv.x + bf16_round(a0), xv.y + bf16_round(a1));
  }
};

}  // namespace fourm

// 1 if attn_heads_kernel's shared memory holds N tokens of width C, else 0.
extern "C" int fourm_attn_block_fits(int N, int C) {
  return C % 64 == 0 && fourm::ab_stages(N) >= 1 ? 1 : 0;
}

// x (B, N, C) bf16; gamma, beta (C) fp32 (beta may be null); wqkv (3C, C) and
// wproj (C, C) bf16, nn.Linear layout; bqkv (3C), bproj (C) fp32 or null;
// bias (B, N) fp32 or null; hln and attn (B, N, C) bf16 scratch; out (B, N,
// C) bf16. Head dim 64, C % 64 == 0, 16-byte aligned x, wqkv, wproj and
// scratch. Returns cudaErrorInvalidValue for a shape it does not take.
extern "C" int fourm_attn_block(const void* x, const void* gamma, const void* beta,
                                const void* wqkv, const void* bqkv, const void* wproj,
                                const void* bproj, const void* bias, void* hln, void* attn,
                                void* out, int B, int N, int C, int H, float eps, float scale,
                                int zero_attn, void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
  const int stages = ab_stages(N);
  if (H * 64 != C || C % 64 != 0 || stages < 1) return (int)cudaErrorInvalidValue;
  int err = sm90::launch_ln_rows<2>(x, gamma, beta, hln, B * N, C, eps, s);
  if (err != 0) return err;

  CUtensorMap tx, tw;
  err = sm90::make_map_batched(&tx, hln, B, N, C, 128);
  if (err == 0) err = sm90::make_map(&tw, wqkv, 3 * C, C, 64);
  if (err != 0) return err;
  AttnHeadsArgs a;
  a.bqkv = (const float*)bqkv; a.bias = (const float*)bias; a.attn = (bf16*)attn;
  a.N = N; a.C = C; a.stages = stages; a.scale = scale; a.zero_attn = zero_attn;
  const size_t smem = ab_fixed(N) + (size_t)stages * AB_STAGE;
  auto kern = bias != nullptr ? attn_heads_kernel<1> : attn_heads_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  err = sm90::launch_dependent(kern, dim3(H, B), dim3(AB_THREADS), smem, s, tx, tw, a);
  if (err != 0) return err;

  return sm90::launch_gemm<AttnOutEpi, false, 6>(
      attn, wproj, nullptr, B * N, C, C, C,
      AttnOutEpi{(bf16*)out, (const bf16*)x, (const float*)bproj, C}, s);
}
