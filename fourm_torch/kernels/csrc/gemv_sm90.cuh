// The Hopper weight-streaming core of self_decode.cu, residual_mlp.cu and
// decode_attn.cu's q product (CrossQ): a
// skinny product at a few token rows, out^T (rows x B) = W (rows x K) act^T,
// with A and B swapped against gemm_sm90.cuh's GEMM so that the weight, not
// the handful of tokens, fills the 64-row wgmma M dimension. Built from
// gemm_sm90.cuh's primitives (mbarriers, TMA loads and maps, 128-byte-swizzle
// descriptors, programmatic dependent launch).
//
// What bounds such a product on an H100: bytes. At B <= 64 tokens a weight
// byte meets at most 64 tokens, 64 FLOP against the card's 295 FLOP per byte
// at the bf16 peak; so the kernel must keep enough weight bytes in flight on
// every SM to stream at the HBM rate, and read each byte once.
//
// Design:
//   * a CTA owns one 64-row tile of W and a range of K (split-K): its
//     producer thread (in a ninth warp) streams the tile's 64 x 64 K-major
//     boxes (8 KB, one 128-byte swizzle row per weight row; two boxes for a
//     dual product, the gate and up weights of SwiGLU) by TMA through a ring
//     of up to 8 mbarrier stages (a dual product: 4) from the kernel's first
//     instruction: the weights do not depend on the kernel before, so they
//     stream while it finishes (programmatic dependent launch);
//   * the token rows (B rounded up to the N tile NT = 8, 16, 32 or 64) are
//     the N operand: after wait_prerequisites() eight other warps stage them
//     once, for the CTA's K range, as a K-major tile in the same swizzle
//     (Op::stage: a copy, or a LayerNorm of the rows), rows past B zero;
//   * one consumer warpgroup runs wgmma m64nNTk16 (bf16 -> fp32) per 16 K,
//     one group in flight behind the one being issued;
//   * the split-K partials meet in cluster shared memory: the CTAs of one
//     tile form a cluster of `split`; each but rank 0 sends its 64 x NT
//     fp32 sums into its slot of rank 0's gather buffer by st.async, which
//     completes the transaction count of an mbarrier of rank 0, and exits;
//     rank 0 adds them to its own in rank order (no atomics: a run is
//     bit-reproducible) and runs Op::epilogue on the full sums (bias,
//     activation, residual, QK-norm, stores);
//   * B past the largest N tile takes more passes (grid.y), each reading the
//     weights again;
//   * two CTAs an SM (the launch bound; the SM's whole 228 KB as shared
//     memory), and a plan whose grid is resident at once, so that no CTA
//     waits for a second wave; what does not depend on the kernel before
//     (the LN parameters) is read before the wait.
// The tile plan (NT, split, K blocks per CTA) is the wrapper's, in Python
// (decode_step.py:gemv_plan), passed as plain ints; smem_bytes() below is
// mirrored there.
#pragma once

#include <cooperative_groups.h>

#include <mutex>
#include <vector>

#include "gemm_sm90.cuh"

namespace fourm {
namespace gemv {

namespace cg = cooperative_groups;
using sm90::desc_sw128;
using sm90::fence_acc;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::tma_load_2d;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int TM = 64;                // weight rows per tile: the wgmma M
constexpr int TK = 64;                // K per ring stage: 128 bytes of bf16
constexpr int STAGERS = 256;           // warps 0-7 stage tokens; warpgroup 0 consumes
constexpr int PRODUCER_WARP = 8;       // its lane 0 produces
constexpr int THREADS = STAGERS + 32;
constexpr int RING = 8;                // weight boxes in the ring: up to 8 stages, or 4 of two
constexpr int WTILE = TM * TK * 2;     // one weight box, 8 KB
// The fp32 sums of a tile: weight row r, token c at [r * cs(nt) + c], rows
// padded by 2 floats (token pairs stay 8-byte aligned, reads along r meet
// 2-way bank conflicts at most).
__host__ __device__ constexpr int cs(int nt) { return nt + 2; }
constexpr int MAX_SMEM = 232448 - 1024;  // dynamic, beside the static barriers

// Dynamic shared memory: the ring (stages() x 1|2 weight boxes), the staged
// tokens (kpb K blocks of NT rows x 128 bytes) and, for an Op whose tokens
// are LayerNormed, the fp32 gamma and beta of its K range (2 x kpb x 64):
// the work area, which holds rank 0's full sums (1|2 x 64 x cs(NT) fp32)
// once its products are done; then rank 0's gather buffer of the other
// ranks' partials (split - 1 of those); and slack for the 1024-byte
// alignment of the ring. The barriers are static.
// Ring stages: as many as the CTA's K blocks, up to a 64 KB ring.
__host__ __device__ constexpr int stages(int kpb, bool dual) {
  return kpb < RING / (dual ? 2 : 1) ? kpb : RING / (dual ? 2 : 1);
}
__host__ __device__ constexpr size_t sums_bytes(int nt, bool dual) {
  return (size_t)(dual ? 2 : 1) * TM * cs(nt) * 4;
}
__host__ __device__ constexpr size_t work_bytes(int nt, int kpb, bool dual, bool ln) {
  const size_t work = (size_t)stages(kpb, dual) * (dual ? 2 : 1) * WTILE +
                      (size_t)kpb * nt * 128 + (ln ? (size_t)kpb * TK * 2 * 4 : 0);
  return work > sums_bytes(nt, dual) ? work : sums_bytes(nt, dual);
}
__host__ __device__ constexpr size_t smem_bytes(int nt, int kpb, bool dual, bool ln, int split) {
  return 1024 + work_bytes(nt, kpb, dual, ln) + (size_t)(split - 1) * sums_bytes(nt, dual);
}
constexpr int LN_MAX = 2048;  // the widest row an LN prologue takes

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// Barrier 1 among the STAGERS threads (warps 0-7).
__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(STAGERS) : "memory");
}
// The cluster barrier, split: every thread arrives once (relaxed: it only
// publishes the mbarrier inits, which fence.mbarrier_init released) and
// waits once before it touches a peer's shared memory or exits.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}
// The shared::cluster address of `p` (this CTA's shared memory) in the
// shared memory of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(sm90::smem_u32(p)), "r"(rank));
  return remote;
}
// An asynchronous store of (v0, v1) to a peer's shared memory (8-byte
// aligned) that completes 8 bytes of the transaction count of the peer's
// mbarrier at `bar`.
__device__ __forceinline__ void st_async(uint32_t addr, float v0, float v1, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::"r"(
          addr),
      "f"(v0), "f"(v1), "r"(bar)
      : "memory");
}
// Wait for phase `parity` of a barrier that peers complete, acquiring their
// writes at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sm90::smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- wgmma m64nNk16

// d[64 x N per warpgroup] += A[64 x 16] @ B[N x 16]^T, both K-major in shared
// memory (the 64 rows of a weight box; N staged token rows). The scale-d
// predicate is always set: the callers zero their accumulators.
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <int NT>
__device__ __forceinline__ void wgmma_nt(float (&d)[NT / 2], uint64_t da, uint64_t db) {
  if constexpr (NT == 8)
    wgmma_n8(d, da, db);
  else if constexpr (NT == 16)
    wgmma_n16(d, da, db);
  else if constexpr (NT == 32)
    wgmma_n32(d, da, db);
  else
    sm90::wgmma_m64n64k16(d, da, db);
}

// ------------------------------------------------------------ token staging

// Stage token rows n0 .. n0 + nt of a (B, Kv) operand for K blocks kb0 ..
// kb0 + nkb into `act` as nkb K-major boxes of nt rows x 128 bytes in the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), by the
// STAGERS threads. load(b, k) gives the 8 bf16 of row b at columns k .. k + 8
// (k < Kv, a multiple of 8); rows >= B and columns >= Kv are zero.
template <class Load>
__device__ __forceinline__ void stage_tokens(unsigned char* act, int kb0, int nkb, int nt, int n0,
                                             int B, int Kv, Load load) {
  constexpr int BATCH = 8;  // loads in flight a thread
  const int total = nkb * nt * 8;
  for (int i0 = threadIdx.x; i0 < total; i0 += BATCH * STAGERS) {
    uint4 u[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * STAGERS;
      const int c = i % 8, r = (i / 8) % nt, kbl = i / (8 * nt);
      const int k = (kb0 + kbl) * TK + c * 8, b = n0 + r;
      u[j] = i < total && b < B && k < Kv ? load(b, k) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * STAGERS;
      if (i >= total) break;
      const int c = i % 8, r = (i / 8) % nt, kbl = i / (8 * nt);
      *reinterpret_cast<uint4*>(act + (size_t)kbl * nt * 128 + r * 128 + ((c ^ (r & 7)) << 4)) =
          u[j];
    }
  }
}

// Elements i .. i + 8 of a small parameter vector held in fp32 or in bf16
// (is_bf16), 16-byte aligned, i a multiple of 8.
__device__ __forceinline__ void ld_param8(const void* p, int i, int is_bf16, float (&f)[8]) {
  if (is_bf16) {
    unpack8(*reinterpret_cast<const uint4*>(reinterpret_cast<const bf16*>(p) + i), f);
  } else {
    const float4* q = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
    const float4 a = q[0], b = q[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
}

// Before the wait (the parameters are weights, not the kernel before's
// output): gamma g and shift be (or none), fp32 or bf16 by pbf, 16-byte
// aligned, of columns kb0 * 64 .. (kb0 + nkb) * 64 below C into lnp (gamma
// at [0, nkb * 64), beta after it, by column - kb0 * 64), 8 columns a
// STAGERS thread.
__device__ __forceinline__ void ln_prologue(float* lnp, int kb0, int nkb, int C, const void* g,
                                            const void* be, int pbf) {
  for (int ch = threadIdx.x; ch < nkb * 8; ch += STAGERS) {
    const int c = kb0 * TK + ch * 8;
    float fg[8], fb[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (c < C) {
      ld_param8(g, c, pbf, fg);
      if (be != nullptr) ld_param8(be, c, pbf, fb);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      lnp[ch * 8 + k] = c < C ? fg[k] : 0.f;
      lnp[nkb * TK + ch * 8 + k] = fb[k];
    }
  }
}

// Stage bf16(LN(x)) of token rows n0 .. n0 + nt of x (B, C), C <= 32 * 8 *
// VEC, for K blocks kb0 .. kb0 + nkb, with ln_prologue's parameters in lnp
// (synced by the caller). A warp of the STAGERS takes 8 / VEC rows at a
// time (one at C = 2048, two at C <= 1024), reads them once into registers
// (VEC 16-byte chunks a lane each, all loads in flight together), takes the
// fp32 mean and the mean of squared deviations in the order of warp_ln_row,
// and writes the chunks of the CTA's K range; rows >= B and columns >= C
// are zero.
template <int VEC>
__device__ __forceinline__ void stage_ln_rows(unsigned char* act, const float* lnp, int kb0,
                                              int nkb, int nt, int n0,
                                              const bf16* __restrict__ x, int B, int C,
                                              float eps) {
  constexpr int ROWS = 8 / VEC, NSW = STAGERS / 32;
  const int lane = threadIdx.x % 32, nv = C / 8;
  const int v0 = kb0 * 8, v1 = (kb0 + nkb) * 8;  // the CTA's 16-byte chunks of a row
  for (int r0 = threadIdx.x / 32; r0 < nt; r0 += ROWS * NSW) {
    uint4 u[ROWS][VEC];
    float mean[ROWS], rstd[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int b = n0 + r0 + j * NSW;
      const bool live = r0 + j * NSW < nt && b < B;
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(live ? b : 0) * C);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        u[j][i] = live && lane + 32 * i < nv ? src[lane + 32 * i] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float f[8];
        unpack8(u[j][i], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += f[e];
      }
      mean[j] = warp_sum(s) / (float)C;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (lane + 32 * i >= nv) break;
        float f[8];
        unpack8(u[j][i], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) q += (f[e] - mean[j]) * (f[e] - mean[j]);
      }
      rstd[j] = rsqrtf(warp_sum(q) / (float)C + eps);
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int r = r0 + j * NSW;
      if (r >= nt) break;
      const bool live = n0 + r < B;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int v = lane + 32 * i;
        if (v < v0 || v >= v1) continue;
        uint4 o = make_uint4(0, 0, 0, 0);
        if (live && v < nv) {
          float f[8];
          unpack8(u[j][i], f);
          bf16* e = reinterpret_cast<bf16*>(&o);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            e[k] = __float2bfloat16((f[k] - mean[j]) * rstd[j] * lnp[8 * (v - v0) + k] +
                                    lnp[nkb * TK + 8 * (v - v0) + k]);
        }
        const int c = v % 8;
        *reinterpret_cast<uint4*>(act + (size_t)(v / 8 - kb0) * nt * 128 + r * 128 +
                                  ((c ^ (r & 7)) << 4)) = o;
      }
    }
  }
}

// The LN prologue of self_decode's projection and of residual_mlp's hidden
// product, C <= LN_MAX. Every CTA recomputes the statistics of its rows (B x
// C values from L2, cheap).
__device__ __forceinline__ void stage_ln(unsigned char* act, const float* lnp, int kb0, int nkb,
                                         int nt, int n0, const bf16* __restrict__ x, int B, int C,
                                         float eps) {
  if (C <= LN_MAX / 2)
    stage_ln_rows<LN_MAX / 512>(act, lnp, kb0, nkb, nt, n0, x, B, C, eps);
  else
    stage_ln_rows<LN_MAX / 256>(act, lnp, kb0, nkb, nt, n0, x, B, C, eps);
}

// Stage rows of a row-major bf16 matrix (B, Kv) with row stride ld.
__device__ __forceinline__ void stage_copy(unsigned char* act, int kb0, int nkb, int nt, int n0,
                                           const bf16* __restrict__ src, int B, int Kv, int ld) {
  stage_tokens(act, kb0, nkb, nt, n0, B, Kv, [&](int b, int k) {
    return *reinterpret_cast<const uint4*>(src + (size_t)b * ld + k);
  });
}

// Per-head QK-norm of a 64-value head held by one warp, two values a lane
// (dims lane, lane + 32): LayerNorm in fp32 (the fp32 projection's
// statistics, decode_step.py:126-134), scale g and shift b (or none), fp32
// or bf16 by pbf. The callers then round to bf16.
__device__ __forceinline__ void head_norm(float& a0, float& a1, const void* g, const void* b,
                                          int pbf, float eps) {
  const int lane = threadIdx.x % 32;
  const float mean = warp_sum(a0 + a1) / 64.f;
  const float d0 = a0 - mean, d1 = a1 - mean;
  const float rstd = rsqrtf(warp_sum(d0 * d0 + d1 * d1) / 64.f + eps);
  a0 = d0 * rstd * ld_param(g, lane, pbf);
  a1 = d1 * rstd * ld_param(g, lane + 32, pbf);
  if (b != nullptr) {
    a0 += ld_param(b, lane, pbf);
    a1 += ld_param(b, lane + 32, pbf);
  }
}

// ------------------------------------------------------------------ the kernel

// Op provides
//   LN: whether its tokens are LayerNormed (lnp then holds 2 x kpb x 64
//     floats, else none);
//   prologue(lnp, kb0, nkb, m0, rank, split): by the STAGERS before the
//     wait, what does not depend on the kernel before (parameters,
//     prefetches);
//   stage(act, lnp, kb0, nkb, nt, n0): the token rows for K blocks kb0 ..
//     + nkb, by the STAGERS after wait_prerequisites() (and a sync after
//     the prologue);
//   epilogue(sum, sum2, m0, n0, nt): by all THREADS of rank 0, once the
//     split's partials are added: sum[r * cs(nt) + c] is the fp32 product of
//     weight row m0 + r (r < 64) and token n0 + c (c < nt); sum2 that of the
//     second weight of a dual product.
// Grid: (tiles * split, passes); cluster (split, 1, 1); kpb K blocks per CTA.
template <class Op, int NT, bool DUAL>
__global__ void __launch_bounds__(THREADS, 2)
gemv_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tw2,
            int K, int kpb, Op op) {
  constexpr int NW = DUAL ? 2 : 1;
  constexpr int CS = cs(NT), PART = NW * TM * CS;  // floats of one rank's partial
  const int STAGES = stages(kpb, DUAL);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* act = ring + STAGES * NW * WTILE;  // a multiple of 1024 bytes

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  float* lnp = reinterpret_cast<float*>(act + (size_t)kpb * NT * 128);
  float* gather = reinterpret_cast<float*>(ring + work_bytes(NT, kpb, DUAL, Op::LN));
  float* sum = reinterpret_cast<float*>(ring);  // rank 0's, once its products are done
  __shared__ uint64_t bars[2 * RING + 1];
  uint64_t* full = bars;
  uint64_t* empty = full + STAGES;
  uint64_t* gathered = empty + STAGES;  // rank 0's: the others' partials arrived
  const int m0 = (blockIdx.x / split) * TM, n0 = blockIdx.y * NT;
  const int nkb = (K + TK - 1) / TK;
  const int kb0 = rank * kpb;
  const int mine = max(0, min(kpb, nkb - kb0));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(gathered, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_arrive_relaxed();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {  // the producer: the weights stream before the wait
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < mine; ++i) {
        mbar_wait(&empty[s], phase ^ 1);  // the first round passes at once
        unsigned char* st = ring + s * NW * WTILE;
        mbar_expect_tx(&full[s], NW * WTILE);
        tma_load_2d(st, &tw, &full[s], (kb0 + i) * TK, m0);
        if (DUAL) tma_load_2d(st + WTILE, &tw2, &full[s], (kb0 + i) * TK, m0);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    cluster_wait();
  } else {
    op.prologue(lnp, kb0, mine, m0, rank, split);
    sm90::wait_prerequisites();  // the tokens come from the kernel before
    sm90::allow_dependents();
    stagers_sync();  // the prologue's shared memory
    op.stage(act, lnp, kb0, mine, NT, n0);
    fence_proxy_async();  // generic-proxy stores, read by wgmma
    stagers_sync();
    if (warp >= 4) {
      cluster_wait();
    } else {  // the consumer warpgroup
      float acc[NT / 2];
      float acc2[DUAL ? NT / 2 : 1];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      if constexpr (DUAL) {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc2[i] = 0.f;
      }
      int s = 0, prev = -1;
      uint32_t phase = 0;
      for (int i = 0; i < mine; ++i) {
        mbar_wait(&full[s], phase);
        unsigned char* st = ring + s * NW * WTILE;
        const uint64_t da = desc_sw128(st);
        const uint64_t db = desc_sw128(act + (size_t)i * NT * 128);
        fence_acc(acc);
        if constexpr (DUAL) fence_acc(acc2);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < TK / 16; ++k) {
          wgmma_nt<NT>(acc, da + 2 * k, db + 2 * k);
          if constexpr (DUAL) wgmma_nt<NT>(acc2, desc_sw128(st + WTILE) + 2 * k, db + 2 * k);
        }
        wgmma_commit();
        fence_acc(acc);
        if constexpr (DUAL) fence_acc(acc2);
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if constexpr (DUAL) fence_acc(acc2);
      // the other ranks send their partials into rank 0's gather buffer by
      // st.async, which completes the transaction count of rank 0's
      // `gathered`; rank 0 adds them to its own in rank order (no atomics:
      // bit-reproducible) and writes the sums to its work area. Accumulator
      // register 4j + 2i + e is weight row 16 warp + lane / 4 + 8i, token
      // 8j + 2 (lane % 4) + e
      cluster_wait();  // rank 0's barrier is initialised
      const int at0 = (16 * warp + lane / 4) * CS + 2 * (lane % 4);
      if (rank > 0) {
        const uint32_t dst = cluster_addr(gather + (rank - 1) * PART, 0);
        const uint32_t bar = cluster_addr(gathered, 0);
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int at = at0 + 8 * i * CS + 8 * j;
            st_async(dst + 4 * at, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], bar);
            if constexpr (DUAL)
              st_async(dst + 4 * (TM * CS + at), acc2[4 * j + 2 * i], acc2[4 * j + 2 * i + 1],
                       bar);
          }
      } else {
        if (threadIdx.x == 0) mbar_expect_tx(gathered, (split - 1) * NW * TM * NT * 4);
        mbar_wait_cluster(gathered, 0);
        for (int q = 0; q + 1 < split; ++q) {  // in rank order
          const float* part = gather + q * PART;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int at = at0 + 8 * i * CS + 8 * j + e;
                acc[4 * j + 2 * i + e] += part[at];
                if constexpr (DUAL) acc2[4 * j + 2 * i + e] += part[TM * CS + at];
              }
        }
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int at = at0 + 8 * i * CS + 8 * j + e;
              sum[at] = acc[4 * j + 2 * i + e];
              if constexpr (DUAL) sum[TM * CS + at] = acc2[4 * j + 2 * i + e];
            }
      }
    }
  }
  if (rank != 0) return;  // no peer reads this CTA's shared memory
  __syncthreads();        // rank 0's sums
  op.epilogue(sum, sum + TM * CS, m0, n0, NT);
}

// ------------------------------------------------------------------ host side

// Launch kern<<<grid, threads, smem, stream>>>(args...) as clusters of
// `cluster_x` CTAs along x, with programmatic stream serialization: it may
// start while the kernel before it finishes, and reads that kernel's output
// only after wait_prerequisites().
// The attributes launch_cluster needs, set once per kernel and device (a
// decode step launches these kernels once per layer and token, and the host
// is the chain's bottleneck): the dynamic shared memory (the most asked for
// so far), the whole of the SM's 228 KB as shared memory, so that as many
// CTAs fit on an SM as their shared memory allows (else the driver may
// carve out less and the grid runs in two waves), and clusters past 8.
inline cudaError_t kernel_attributes(const void* kern, size_t smem, int cluster_x) {
  struct Set {
    const void* kern;
    int dev;
    size_t smem;
    bool nonportable;
  };
  static std::mutex lock;
  static std::vector<Set> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> guard(lock);
  Set* set = nullptr;
  for (Set& d : done)
    if (d.kern == kern && d.dev == dev) set = &d;
  if (set == nullptr) {
    done.push_back(Set{kern, dev, 0, false});
    set = &done.back();
  }
  if (smem > set->smem) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    set->smem = smem;
  }
  if (cluster_x > 8 && !set->nonportable) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    set->nonportable = true;
  }
  return cudaSuccess;
}

template <class... Params, class... Args>
int launch_cluster(void (*kern)(Params...), dim3 grid, int threads, int cluster_x, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = kernel_attributes(reinterpret_cast<const void*>(kern), smem, cluster_x);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The plan of one product, from the wrapper: N tile, passes over B, split-K
// (the cluster size) and K blocks per CTA.
struct Plan {
  int nt, passes, split, kpb;
};

// Launch gemv_kernel<Op, NT, DUAL> for W (rows, K) [and W2] at the plan's
// N tile. K % 8 == 0 (TMA's 16-byte row stride). W alone may hold fewer
// columns, `cols`, with rows `ld` elements apart (a multiple of 8): TMA
// reads the columns past cols as zero.
template <class Op, bool DUAL>
int launch_gemv(const void* w, const void* w2, int rows, int K, Plan p, Op op,
                cudaStream_t stream, int cols = 0, int ld = 0) {
  CUtensorMap tw, tw2;
  int err = sm90::make_map(&tw, w, rows, cols ? cols : K, TM, ld);
  if (err == 0) err = sm90::make_map(&tw2, DUAL ? w2 : w, rows, K, TM);
  if (err != 0) return err;
  const size_t smem = smem_bytes(p.nt, p.kpb, DUAL, Op::LN, p.split);
  if (smem > (size_t)MAX_SMEM || p.split < 1 || p.split > 16 || p.kpb < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(((rows + TM - 1) / TM) * p.split, p.passes);
  switch (p.nt) {
    case 8:
      return launch_cluster(gemv_kernel<Op, 8, DUAL>, grid, THREADS, p.split, smem, stream,
                            tw, tw2, K, p.kpb, op);
    case 16:
      return launch_cluster(gemv_kernel<Op, 16, DUAL>, grid, THREADS, p.split, smem, stream,
                            tw, tw2, K, p.kpb, op);
    case 32:
      return launch_cluster(gemv_kernel<Op, 32, DUAL>, grid, THREADS, p.split, smem, stream,
                            tw, tw2, K, p.kpb, op);
    case 64:
      return launch_cluster(gemv_kernel<Op, 64, DUAL>, grid, THREADS, p.split, smem, stream,
                            tw, tw2, K, p.kpb, op);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gemv
}  // namespace fourm
