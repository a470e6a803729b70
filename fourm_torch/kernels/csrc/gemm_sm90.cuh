// The Hopper GEMM core of ln_matmul.cu, ln_mlp.cu and attn_block.cu's
// projection: C = A @ B^T with A (M, K) and B (N, K) both row-major bf16 (B
// in nn.Linear layout, so both operands are K-major), fp32 accumulation, and
// an epilogue functor that turns each accumulator pair into the caller's
// output. Also the LN prologue those sources run first (ln_rows_kernel), and
// the primitives attn_sm90.cuh builds the attention kernels from: mbarriers,
// 2- to 4-D TMA loads and their tensor maps, 128-byte-swizzle descriptors
// (K-major and MN-major) and the wgmma shapes m64n128k16 / m64n64k16 (A from
// shared memory, K- or MN-major, or, m64n64k16, from registers), and the
// TF32 m64n128k8 of vq_codebook.cu's screen.
//
// Design (raw PTX, no CUTLASS GEMM):
//   * a CTA owns a 128 x 128 output tile and walks K in steps of 64: bf16
//     tiles of 64 columns are 128 bytes wide, one row of the 128-byte
//     swizzle, which is both what TMA writes and what wgmma reads;
//   * a ring of STAGES shared-memory stages, each the A tile (128 x 64) and
//     one or two B tiles (128 x 64; two for a dual-B GEMM that computes
//     A @ B1^T and A @ B2^T at once, SwiGLU's W1 and W3), filled by TMA
//     (cp.async.bulk.tensor.2d) and tracked by mbarriers: `full` (the
//     producer's expect_tx, completed by the copy's bytes) and `empty` (one
//     arrival from each consumer thread once its wgmma read the stage);
//   * three warpgroups: warpgroups 0 and 1 are consumers, each 64 rows of
//     the tile, issuing wgmma.mma_async m64n128k16 (bf16 -> fp32) from
//     shared-memory descriptors, one wgmma group in flight behind the one
//     being issued; warpgroup 2 is the producer, one thread of which keeps
//     the TMA loads in flight. setmaxnreg gives the consumers 232 registers
//     and the producer 40 (a dual-B consumer holds 128 fp32 accumulators);
//   * out-of-bounds rows and K columns of a box are zero-filled by TMA, so
//     ragged M, N and K need no predication in the main loop; the epilogue
//     masks rows >= M and columns >= N;
//   * tiles are visited in groups of GROUP_M row tiles, the row tile
//     fastest, so the CTAs of one wave share B's column strips (the
//     weights) in L2.
// TMA needs 16-byte aligned bases and row strides that are multiples of 16
// bytes: K % 8 == 0, checked by the wrappers' predicates.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include "common.cuh"

namespace fourm {
namespace sm90 {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int CONSUMERS = 2;                   // warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int TILE_BYTES = BM * BK * 2;        // 16 KB: A, B and B2 tiles alike
constexpr int GROUP_M = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------- TMA

// The box at (c0 = column, c1 = row) of the 2-D map into dst, completing
// its bytes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A plain bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global memory into dst, completing its bytes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------- programmatic dependent launch

// In a kernel whose output the next kernel of the stream reads: let that
// kernel, launched with launch_dependent, start its prologue once every
// CTA of this one is running.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
// In a kernel launched with launch_dependent: wait until the kernels before
// it in the stream have finished and their writes are visible (at once
// when it was launched without the attribute).
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// -------------------------------------------------------------------- wgmma

// Descriptor of a K-major operand tile in the 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart (SBO), tile base 1024-byte aligned.
// Stepping 16 elements along K adds 32 bytes to the start address (2 in the
// descriptor's 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint32_t a = smem_u32(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Descriptor of an MN-major operand tile in the 128-byte swizzle, the B
// operand of a product whose 64 N columns are one 128-byte row (a V tile:
// rows are keys, the K dimension): 8-row groups along K 1024 bytes apart
// (SBO); one 64-column swizzle atom along N, so the atom stride (LBO) is not
// read. Stepping 16 rows along K adds 2048 bytes (128 in 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* tile) {
  const uint32_t a = smem_u32(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for the registers of a wgmma A fragment: they stay live, and
// untouched, until the wait that follows the product that reads them.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64x128 per warpgroup] (+)= A[64x16] @ B[128x16]^T, both from shared memory;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64x128 per warpgroup] (+)= A[64x8] @ B[128x8]^T in TF32, both fp32 tiles
// K-major from shared memory (the tensor core reads the top 19 bits of each
// fp32 operand; TF32 takes no transpose): a k8 step is 32 bytes, so the
// descriptors step as the bf16 k16 ones do. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                                     int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64x64 per warpgroup] (+)= A[64x16] @ B[64x16]^T, both K-major from shared memory;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64x64 per warpgroup] += A[64x16] @ B[16x64] with A from registers (a: the
// m64nNk16 A fragment, two bf16 per register) and B an MN-major tile in shared
// memory (trans-b: the 64 columns contiguous, K along its rows).
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (&d)[32], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[64x64 per warpgroup] (+)= A[64x16] @ B[16x64] with A and B both MN-major
// tiles in shared memory (trans-a, trans-b: each tile's 64 M or N columns
// contiguous, K along its rows, as a V tile is); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss_mn(float (&d)[32], uint64_t da, uint64_t db,
                                                    int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// -------------------------------------------------------------- the kernel

// Shared memory: STAGES x (A tile, B tile[, B2 tile]), 1024-byte aligned,
// then the full and empty barriers.
template <bool DUAL>
__host__ __device__ constexpr int stage_bytes() {
  return (DUAL ? 3 : 2) * TILE_BYTES;
}
template <bool DUAL, int STAGES>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)STAGES * stage_bytes<DUAL>() + 2 * STAGES * sizeof(uint64_t) + 1024;
}

// Epi is called once per accumulator pair (columns col, col + 1 of row
// row; col even, row < M, col < N): epi(row, col, a0, a1) or, DUAL,
// epi(row, col, a0, a1, b0, b1) with b the A @ B2^T sums.
template <class Epi, bool DUAL, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tb2, int M, int N, int K, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int SB = stage_bytes<DUAL>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * SB);
  uint64_t* empty = full + STAGES;

  // grouped tile order: GROUP_M row tiles, the row tile fastest
  const int tm = (M + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tn;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int gsize = min(tm - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gsize) * BM;
  const int n0 = (in_group / gsize) * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 128 * CONSUMERS) {
      int s = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[s], phase ^ 1);  // the first round passes at once
        unsigned char* st = smem + s * SB;
        mbar_expect_tx(&full[s], SB);
        tma_load_2d(st, &ta, &full[s], kb * BK, m0);
        tma_load_2d(st + TILE_BYTES, &tb, &full[s], kb * BK, n0);
        if (DUAL) tma_load_2d(st + 2 * TILE_BYTES, &tb2, &full[s], kb * BK, n0);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows wg*64 .. +64 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float acc[64];
    float acc2[DUAL ? 64 : 1];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if constexpr (DUAL) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc2[i] = 0.f;
    }
    int s = 0, prev = -1;
    uint32_t phase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[s], phase);
      unsigned char* st = smem + s * SB;
      const uint64_t da = desc_sw128(st + wg * 64 * 128);
      const uint64_t db = desc_sw128(st + TILE_BYTES);
      fence_acc(acc);
      if constexpr (DUAL) fence_acc(acc2);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        wgmma_m64n128k16(acc, da + 2 * k, db + 2 * k);
        if constexpr (DUAL) {
          const uint64_t db2 = desc_sw128(st + 2 * TILE_BYTES);
          wgmma_m64n128k16(acc2, da + 2 * k, db2 + 2 * k);
        }
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

    // ---- epilogue: accumulator register 4j + 2i + c holds row
    // 16 * warp + lane / 4 + 8i, column 8j + 2 (lane % 4) + c of the
    // warpgroup's 64 x 128 block
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < M && col < N) {
          if constexpr (DUAL)
            epi(row, col, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], acc2[4 * j + 2 * i],
                acc2[4 * j + 2 * i + 1]);
          else
            epi(row, col, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the CUDA runtime, so
// the library links no libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of `rank` dimensions (innermost first; byte strides of the
// outer ones) read in boxes of `box` elements in the 128-byte swizzle (or
// `swizzle`), out-of-bounds elements read as zero; bf16 unless `type` says
// otherwise. TMA's rules: a 16-byte aligned base, strides that are
// multiples of 16 bytes, an innermost box of 128 bytes (64 bf16, 32 fp32)
// when swizzled, a multiple of 16 bytes when not.
inline int encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16 != 0) return (int)cudaErrorInvalidValue;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The map of a row-major (rows, cols) bf16 matrix read in box_rows x 64
// boxes, rows `ld` elements apart (0: cols). The row stride is a multiple
// of 8; columns past cols read as zero.
inline int make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows = BM,
                    int ld = 0) {
  if (ld == 0) ld = cols;
  if (ld % 8 != 0 || ld < cols) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  return encode_map(map, base, 2, dims, strides, box);
}

// The map of `batch` row-major (rows, cols) bf16 matrices stored one after
// another, read in box_rows x 64 boxes of one matrix: rows past `rows` read
// as zero, never as the next matrix's. cols % 8 == 0.
inline int make_map_batched(CUtensorMap* map, const void* base, int batch, int rows, int cols,
                            int box_rows = BM) {
  if (cols % 8 != 0) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  return encode_map(map, base, 3, dims, strides, box);
}

// The map of an attention operand: (batch, heads, rows, 64) bf16 read
// through element strides sb, sh, sr (the 64 head dims contiguous), in boxes
// of box_rows rows x 64 of one (batch, head): rows past `rows` read as zero.
// The three outer dimensions are ordered by stride, smallest first (a dim of
// size 1 last), since q, k and v may be column slices of one row (heads
// within a row) or (B, H, N, Dh) views with any order of strides. *ord gets
// the coordinate slot (1-3) of the rows, heads and batch: bits 0-1, 2-3, 4-5;
// tma_rows in attn_sm90.cuh places its coordinates by it. `int8`: an int8
// operand (64-byte rows), read unswizzled (decode_attn.cu's CUDA-core
// reads need no swizzle; a 64-byte row is no 128-byte swizzle row).
inline int make_rows_map(CUtensorMap* map, const void* base, int batch, int heads, int rows,
                         long long sb, long long sh, long long sr, int box_rows, int* ord,
                         bool int8 = false,
                         CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const int esize = int8 ? 1 : 2;
  long long size[3] = {rows, heads, batch};
  long long stride[3] = {sr, sh, sb};
  long long widest = 8;
  for (int i = 0; i < 3; ++i) widest = stride[i] > widest ? stride[i] : widest;
  for (int i = 0; i < 3; ++i)
    if (size[i] == 1) stride[i] = widest;  // any stride: its coordinate is always 0
  int perm[3] = {0, 1, 2};  // insertion sort by stride, stable
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[perm[j]] < stride[perm[j - 1]]; --j) {
      const int t = perm[j];
      perm[j] = perm[j - 1];
      perm[j - 1] = t;
    }
  cuuint64_t dims[4] = {64, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  *ord = 0;
  for (int slot = 1; slot <= 3; ++slot) {
    const int d = perm[slot - 1];
    dims[slot] = (cuuint64_t)size[d];
    strides[slot - 1] = (cuuint64_t)stride[d] * esize;
    if (d == 0) box[slot] = (cuuint32_t)box_rows;
    *ord |= slot << (2 * d);
  }
  return encode_map(map, base, 4, dims, strides, box,
                    int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : swizzle);
}

// Launch kern<<<grid, block, smem, stream>>>(args...) with programmatic
// stream serialization: it may start while the kernel before it finishes,
// and must call wait_prerequisites() before it reads that kernel's output.
template <class... Params, class... Args>
int launch_dependent(void (*kern)(Params...), dim3 grid, dim3 block, size_t smem,
                     cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// C = A (M, K) @ B (b_rows, K)^T [and A @ B2^T], tiles over (M, N), through
// epi. b_rows may be below N (rows past it read as zero).
template <class Epi, bool DUAL, int STAGES>
int launch_gemm(const void* a, const void* b, const void* b2, int M, int N, int K, int b_rows,
                Epi epi, cudaStream_t stream) {
  CUtensorMap ta, tb, tb2;
  int err = make_map(&ta, a, M, K);
  if (err == 0) err = make_map(&tb, b, b_rows, K);
  if (err == 0) err = make_map(&tb2, DUAL ? b2 : b, b_rows, K);
  if (err != 0) return err;
  auto kern = gemm_kernel<Epi, DUAL, STAGES>;
  constexpr size_t smem = smem_bytes<DUAL, STAGES>();
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kern<<<tiles, THREADS, smem, stream>>>(ta, tb, tb2, M, N, K, epi);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ LN prologue

// h = bf16(LN(x)) over rows of x (M, D), one warp per row (fp32 mean, fp32
// mean of squared deviations, one rounding; the arithmetic and summation
// order of warp_ln_row): the A operand of the GEMM, read back through TMA.
// A row of up to 32 x 8 x LN_VEC values is read once and kept in
// registers; a wider one goes through warp_ln_row. OWNER (0: ln_matmul, 1:
// ln_mlp, 2: attn_block) changes only the kernel's name, so that a profile
// assigns its time to the wrapper that launched it.
constexpr int LN_VEC = 8;

template <int OWNER>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ h, int M, int D, float eps) {
  allow_dependents();
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  const int lane = threadIdx.x % 32, nv = D / 8;
  if (nv > 32 * LN_VEC) {
    warp_ln_row(x + (size_t)row * D, D, gamma, beta, 0, eps, h + (size_t)row * D);
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  uint4 u[LN_VEC];
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k)
    u[k] = lane + 32 * k < nv ? src[lane + 32 * k] : make_uint4(0, 0, 0, 0);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k) {
    if (lane + 32 * k >= nv) break;
    float f[8];
    unpack8(u[k], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mean = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k) {
    if (lane + 32 * k >= nv) break;
    float f[8];
    unpack8(u[k], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) q += (f[i] - mean) * (f[i] - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)D + eps);
  uint4* dst = reinterpret_cast<uint4*>(h + (size_t)row * D);
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k) {
    const int v = lane + 32 * k;
    if (v >= nv) break;
    float f[8];
    unpack8(u[k], f);
    uint4 o;
    bf16* e = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y = (f[i] - mean) * rstd * __ldg(gamma + v * 8 + i);
      if (beta != nullptr) y += __ldg(beta + v * 8 + i);
      e[i] = __float2bfloat16(y);
    }
    dst[v] = o;
  }
}

template <int OWNER>
int launch_ln_rows(const void* x, const void* gamma, const void* beta, void* h, int M, int D,
                   float eps, cudaStream_t stream) {
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  ln_rows_kernel<OWNER><<<(M + 7) / 8, 256, 0, stream>>>((const bf16*)x, (const float*)gamma,
                                                  (const float*)beta, (bf16*)h, M, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace fourm
