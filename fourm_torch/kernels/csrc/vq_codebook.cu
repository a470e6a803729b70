// nearest_code / nearest_code_cosine: exact fp32 nearest-codebook search, the
// first index winning ties.
//
// Replaces: fourm_tpu/kernels/vq_codebook.py:pallas_nearest_code (argmax of
// -(||x||^2 - 2 x.e + ||e||^2)) and pallas_nearest_code_cosine (argmax of
// x.e on l2-normalised inputs): the search of every VQ tokenizer.
//
// What bounds it on an H100: operations. At the tokenize shape (N = 64*196
// latents, K = 16384 codes, D = 32) the products are 2*N*K*D = 13.2 GFLOP
// against (N*D + K*D)*4 + N*8 = 3.8 MB. Done exactly on the CUDA cores
// (67 TFLOP/s, and the twin's separate roundings forbid FMA) they take at
// least 0.196 ms; TF32 on the tensor cores (495 TFLOP/s) 0.027 ms, and the
// N*K = 205.5 M scores then need a pass of one or two lane-instructions
// each (a max; and an FMA for the Euclidean form: 0.006-0.012 ms). TF32
// alone flips indices; as a screen whose survivors are rescored exactly it
// does not.
//
// Exactness: the result equals the plain twins (kernels/vq_codebook.py)
// index for index. The twins sum each dot product and squared norm over
// d = 0..D-1 in order, from 0, every product and every sum rounded on its
// own (__fmul_rn / __fadd_rn here: nvcc may not contract them into an FMA);
// the Euclidean value is -((x2 - 2*xe) + e2); the argmax takes the first
// index on ties.
//
// Design: screen on the tensor cores, decide on the CUDA cores.
//   * code_norms_kernel, one thread a code, writes e2 with the twin's
//     arithmetic (Euclidean) and each 128-code tile's largest ||e_k||
//     (fp64, rounded up) once per call. nearest_kernel launches behind it
//     under PDL: it loads its x rows before griddepcontrol.wait.
//   * nearest_kernel: a CTA owns 128 rows of x, loaded once by TMA (fp32,
//     32-column blocks of 128-byte rows in the 128-byte swizzle), and a
//     range of 128-code tiles that TMA streams, with their e2, through an
//     mbarrier ring. Two warpgroups, 64 rows each, screen a tile with wgmma
//     m64n128k8 tf32, both operands K-major from shared memory, four to a
//     32-column block of D (those past D on TMA's zero columns): s = x.e
//     (cosine) or s = fl(2 x.e - e2) (Euclidean; x2 is constant per row and
//     left out). Thread 0 also issues the loads, so a
//     CTA is 8 warps and two CTAs an SM leave a thread 128 registers (a
//     ninth warp would cap them at 96 and spill the accumulators).
//   * decide: per row a running screen max m, each tile's max taken first
//     (a quad's shuffles). Every code with s >= m - 2 eps_row (rounded
//     down) is a candidate, buffered with its screen score (four a thread
//     and row; a full buffer drops those now below the threshold, else is
//     rescored at once). After the rank's last tile the candidates still
//     within 2 eps of its final m are rescored with the twin's arithmetic
//     (the code read from L2) and folded into an exact (value, index) pair:
//     larger value, else smaller index, which gives one result in any
//     order. The exact winner c* always survives: s(c*) >= X(c*) - eps >=
//     X(c) - eps >= s(c) - 2 eps for every code c, so s(c*) >= m - 2 eps at
//     every step. Rescoring inline, in the warp that screens, would stall
//     that warp and the ring behind it; a thread scans its scores (by a
//     bitmask) only where its own max clears the threshold.
//   * the codes of a row block are split over a cluster of `split` CTAs
//     (the wrapper's search_plan: 98 row blocks at N = 12544 are too few
//     for 132 SMs); ranks send their pairs to rank 0 by st.async, rank 0
//     folds them and writes the indices.
//   * codes past K (TMA's zero fill) are never compared; rows past N are
//     screened but never rescored or written.
//
// The margin (kernels/vq_codebook.py:SCREEN_* pass the constants).
// u = 2^-24; t = 2^-10 bounds the relative error of the tensor core's TF32
// reading of an fp32 operand, whether it truncates or rounds the low 13
// bits. nx = ||x_row||, E = max_k ||e_k|| (fp64, rounded up); P = sum_d
// |x_d e_d| <= nx E by Cauchy-Schwarz. D <= 128.
//   (a) the twin's dot q: recursive summation of rounded products,
//       |q - x.e| <= D u / (1 - D u) P <= 2^-16.9 P;
//   (b) TF32 operands: |sum x~ e~ - x.e| <= (2t + t^2) P;
//   (c) the tensor core's fp32 accumulation of D products in any order, an
//       error of at most one ulp (2u) per addition: <= 2 D u (1+t)^2 P
//       <= 2^-15.9 P;
//   so the cosine screen s = acc has |s - q| <= 1.0125 * 2^-9 * nx E.
//   Euclidean: X = V + x2, V the twin's value (argmax V = argmax X, ties
//   alike). With a = fl(x2 - 2q), V = -fl(a + e2): |X - (2q - e2)| <=
//   u (2.01 x2 + 4.02 |q| + e2) <= 4.1 u (nx^2 + E^2); the screen's one
//   rounding, |s - (2 acc - e2)| <= 2.02 u (nx^2 + E^2); and |2 acc - 2q|
//   <= 1.0125 * 2^-8 nx E. e2 is the same fp32 number in s and X.
//   Underflow: a tensor core may flush subnormal operands, products and
//   sums: at most D * 2^-126 (nx + E) from flushed operands and (3D + 1)
//   2^-126 from the rest.
//   eps_row = SCREEN_REL nx E [+ SCREEN_SQ (nx^2 + E^2)] + SCREEN_ABS
//   (1 + nx + E), SCREEN_REL = 2^-8 (cosine), 2^-7 (Euclidean), SCREEN_SQ
//   = 2^-20, SCREEN_ABS = 2^-110: at least 1.97 times each bound, the rest
//   covering eps's own fp32 evaluation. Inputs are taken to be finite, with
//   finite scores.
#include <float.h>
#include <math.h>

#include "gemv_sm90.cuh"

namespace fourm {
namespace vq {

namespace cg = cooperative_groups;

constexpr int ROWS = 128;      // latent rows per CTA: two consumer warpgroups of 64
constexpr int TILE = 128;      // codes per ring stage: the wgmma N
constexpr int THREADS = 256;   // the two warpgroups; thread 0 also issues the loads
constexpr int BLOCK = 128 * 128;  // one 32-column block of 128 rows: 16 KB
constexpr int MAX_STAGES = 4;
constexpr int CAP = 4;         // buffered candidates per thread and row

__host__ __device__ constexpr int nblocks(int D) { return (D + 31) / 32; }
// a ring stage: the code tile's blocks, then its 128 e2 values (1 KB kept
// for them, so stages stay 1024-byte aligned)
__host__ __device__ constexpr int stage_bytes(int D) { return nblocks(D) * BLOCK + 1024; }
__host__ __device__ constexpr size_t smem_bytes(int D, int stages, int split) {
  return 1024 + (size_t)nblocks(D) * BLOCK + (size_t)stages * stage_bytes(D) +
         (size_t)THREADS * 2 * CAP * 8 + (size_t)(split - 1) * ROWS * 8;
}

// Columns d .. d + 3 (d % 4 == 0) of row r of a 128-row tile as TMA wrote
// it: 32-column blocks of 128-byte rows, 16-byte chunks swizzled by r % 8.
__device__ __forceinline__ float4 quad_at(const unsigned char* tile, int r, int d) {
  const int chunk = ((d & 31) >> 2) ^ (r & 7);
  return *reinterpret_cast<const float4*>(tile + (d >> 5) * BLOCK + r * 128 + (chunk << 4));
}

// (bv, bi) <- the better of it and (v, i): the larger value, else the
// smaller index. Commutative and associative: any fold order agrees.
__device__ __forceinline__ void fold(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

struct Args {
  const float* e;     // (K, D) the codebook, for rescoring
  const float* e2;    // (tiles * TILE) squared code norms, Euclidean only
  const float* emax;  // (tiles) each tile's largest code norm, rounded up
  long long* out;     // (N) indices
  int N, K, D, tiles, per_rank, stages;
  float c_rel, c_sq, c_abs;  // the margin's constants
};

// The twin's value of (row r of the x tile, code k): the dot product summed
// in order from 0, each product and sum rounded; Euclidean
// -((x2 - 2 dot) + e2[k]). The code is read from global memory (L2).
template <bool COSINE>
__device__ __forceinline__ float exact_score(const Args& a, const unsigned char* xs, int r, int k,
                                             float x2) {
  const float4* code = reinterpret_cast<const float4*>(a.e + (size_t)k * a.D);
  float dot = 0.f;
  for (int d = 0; d < a.D; d += 4) {
    const float4 x = quad_at(xs, r, d), c = __ldg(code + d / 4);
    dot = __fadd_rn(dot, __fmul_rn(x.x, c.x));
    dot = __fadd_rn(dot, __fmul_rn(x.y, c.y));
    dot = __fadd_rn(dot, __fmul_rn(x.z, c.z));
    dot = __fadd_rn(dot, __fmul_rn(x.w, c.w));
  }
  if (COSINE) return dot;
  return -__fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, dot)), __ldg(a.e2 + k));
}

struct Best {
  float v;
  int i, n;
};

// A thread's candidate buffer of one row is full: drop the candidates whose
// screen score fell below the row's threshold; if none did, rescore them all
// and fold them into the row's pair. Out of line: with the buffer four deep
// it runs only where codes crowd near the max (ties).
template <bool COSINE>
__device__ __noinline__ Best make_room(const Args& a, float2* buf, float thr,
                                       const unsigned char* xs, int r, float x2, float bv,
                                       int bi) {
  int n = 0;
  for (int k = 0; k < CAP; ++k)
    if (buf[k].x >= thr) buf[n++] = buf[k];
  if (n == CAP) {
    for (int k = 0; k < CAP; ++k) {
      const int idx = __float_as_int(buf[k].y);
      fold(bv, bi, exact_score<COSINE>(a, xs, r, idx, x2), idx);
    }
    n = 0;
  }
  return Best{bv, bi, n};
}

// One thread a code: e2[k] with the twin's arithmetic (Euclidean; 0 past
// K), and emax[tile] = the tile's largest ||e_k||, summed in fp64 and
// rounded up.
template <bool COSINE>
__global__ void __launch_bounds__(TILE)
code_norms_kernel(const float* __restrict__ e, float* __restrict__ e2, float* __restrict__ emax,
                  int K, int D) {
  sm90::allow_dependents();
  __shared__ float wmax[TILE / 32];
  const int k = blockIdx.x * TILE + threadIdx.x;
  float s = 0.f;
  double q = 0.0;
  if (k < K) {
    const float4* row = reinterpret_cast<const float4*>(e + (size_t)k * D);
    for (int v = 0; v < D / 4; ++v) {
      const float4 f = row[v];
      s = __fadd_rn(s, __fmul_rn(f.x, f.x));
      s = __fadd_rn(s, __fmul_rn(f.y, f.y));
      s = __fadd_rn(s, __fmul_rn(f.z, f.z));
      s = __fadd_rn(s, __fmul_rn(f.w, f.w));
      q += (double)f.x * f.x + (double)f.y * f.y + (double)f.z * f.z + (double)f.w * f.w;
    }
  }
  if (!COSINE) e2[k] = s;
  float n = __double2float_ru(sqrt(q));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n = fmaxf(n, __shfl_xor_sync(0xffffffffu, n, o));
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = wmax[0];
#pragma unroll
    for (int w = 1; w < TILE / 32; ++w) m = fmaxf(m, wmax[w]);
    emax[blockIdx.x] = m;
  }
}

// NB: the 32-column blocks of D (1..4); the k8 steps past D read TMA's
// zero columns, which add nothing to the screen.
template <bool COSINE, int NB>
__global__ void __launch_bounds__(THREADS, 2)
nearest_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap te,
               Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int SB = stage_bytes(a.D), S = a.stages;
  unsigned char* ring = xs + NB * BLOCK;
  float2* cand = reinterpret_cast<float2*>(ring + (size_t)S * SB);
  float2* gather = cand + THREADS * 2 * CAP;
  __shared__ uint64_t full[MAX_STAGES], empty[MAX_STAGES], xfull, gathered;
  __shared__ float wmax[THREADS / 32];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / split) * ROWS;
  const int t0 = rank * a.per_rank;
  const int nt = max(0, min(a.per_rank, a.tiles - t0));  // the rank's code tiles
  const int kend = min(a.K, (t0 + nt) * TILE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // thread 0 issues every load: tile t into stage t % S, once the eight
  // warps released the tile before it there
  auto load_tile = [&](int t) {
    const int st = t % S;
    unsigned char* dst = ring + st * SB;
    sm90::mbar_expect_tx(&full[st], NB * BLOCK + (COSINE ? 0 : TILE * 4));
    for (int b = 0; b < NB; ++b)
      sm90::tma_load_2d(dst + b * BLOCK, &te, &full[st], 32 * b, (t0 + t) * TILE);
    if (!COSINE) sm90::bulk_load(dst + NB * BLOCK, a.e2 + (t0 + t) * TILE, TILE * 4, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], THREADS / 32);
    }
    sm90::mbar_init(&xfull, 1);
    sm90::mbar_init(&gathered, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sm90::mbar_expect_tx(&xfull, NB * BLOCK);
    for (int b = 0; b < NB; ++b) sm90::tma_load_2d(xs + b * BLOCK, &tx, &xfull, 32 * b, row0);
  }
  __syncthreads();
  gemv::cluster_arrive_relaxed();
  sm90::wait_prerequisites();  // e2 and emax are the prologue's
  if (threadIdx.x == 0)
    for (int t = 0; t < min(S, nt); ++t) load_tile(t);

  // rows rl and rl + 8 of the CTA's 128, columns 8j + 2q + c of each tile
  // (the wgmma accumulator layout)
  const int wg = warp / 4, q = lane % 4;
  const int rl = wg * 64 + (warp % 4) * 16 + lane / 4;
  float E = 0.f;  // max_k ||e_k||: the prologue's tile maxima
  for (int i = threadIdx.x; i < a.tiles; i += THREADS) E = fmaxf(E, a.emax[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) E = fmaxf(E, __shfl_xor_sync(0xffffffffu, E, o));
  if (lane == 0) wmax[warp] = E;
  sm90::mbar_wait(&xfull, 0);
  __syncthreads();
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) E = fmaxf(E, wmax[w]);
  float x2[2], m[2], bv[2], eps2[2];
  int bi[2], n[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rl + 8 * i;
    float s = 0.f;
    double qd = 0.0;
    for (int d = 0; d < a.D; d += 4) {
      const float4 f = quad_at(xs, r, d);
      s = __fadd_rn(s, __fmul_rn(f.x, f.x));
      s = __fadd_rn(s, __fmul_rn(f.y, f.y));
      s = __fadd_rn(s, __fmul_rn(f.z, f.z));
      s = __fadd_rn(s, __fmul_rn(f.w, f.w));
      qd += (double)f.x * f.x + (double)f.y * f.y + (double)f.z * f.z + (double)f.w * f.w;
    }
    const float nx = __double2float_ru(sqrt(qd));
    float ep = a.c_rel * nx * E + a.c_abs * (1.f + nx + E);
    if (!COSINE) ep += a.c_sq * (nx * nx + E * E);
    x2[i] = s;
    eps2[i] = 2.f * ep;
    live[i] = row0 + r < a.N;
    m[i] = -INFINITY;
    bv[i] = -INFINITY;  // index 0 unless a code beats -inf: the twin's argmax then too
    bi[i] = 0;
    n[i] = 0;
  }
  float2* mine = cand + threadIdx.x * 2 * CAP;  // row i's buffer: mine + i * CAP

  const uint64_t xdesc = sm90::desc_sw128(xs + wg * 64 * 128);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int s = t % S;
    sm90::mbar_wait(&full[s], (t / S) & 1);
    const unsigned char* st = ring + s * SB;
    const uint64_t edesc = sm90::desc_sw128(st);
    sm90::fence_acc(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {  // block kk / 4, 32 bytes per k8 step within it
      const uint64_t off = (uint64_t)((kk >> 2) * (BLOCK >> 4) + 2 * (kk & 3));
      sm90::wgmma_m64n128k8_tf32(acc, xdesc + off, edesc + off, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);

    const int k0 = (t0 + t) * TILE;
    const int valid = min(TILE, kend - k0);
    if (!COSINE) {
      const float* e2s = reinterpret_cast<const float*>(st + NB * BLOCK);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 ee = *reinterpret_cast<const float2*>(e2s + 8 * j + 2 * q);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * j + 2 * i] = fmaf(2.f, acc[4 * j + 2 * i], -ee.x);
          acc[4 * j + 2 * i + 1] = fmaf(2.f, acc[4 * j + 2 * i + 1], -ee.y);
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);  // the stage is read
    uint32_t vmask = 0xffffffffu;  // the thread's columns below `valid`
    if (valid < TILE) {  // the last tile: codes past the rank's range
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (8 * j + 2 * q + c >= valid) {
            acc[4 * j + c] = -INFINITY;
            acc[4 * j + 2 + c] = -INFINITY;
            vmask &= ~(1u << (2 * j + c));
          }
    }
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tm[i] = fmaxf(tm[i], fmaxf(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float qm = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 1));
      qm = fmaxf(qm, __shfl_xor_sync(0xffffffffu, qm, 2));
      m[i] = fmaxf(m[i], qm);
      const float thr = live[i] ? __fsub_rd(m[i], eps2[i]) : INFINITY;
      if (tm[i] >= thr) {  // this thread holds candidates of row i: buffer them
        uint32_t mask = 0;  // bit 2j + c: column 8j + 2q + c
#pragma unroll
        for (int b = 0; b < 32; ++b)
          mask |= acc[4 * (b >> 1) + 2 * i + (b & 1)] >= thr ? 1u << b : 0u;
        mask &= vmask;
        const bool one = __popc(mask) == 1;  // then the candidate is the thread's max
        while (mask != 0) {
          const int b = __ffs(mask) - 1;
          mask &= mask - 1;
          float v = one ? tm[i] : acc[2 * i];  // acc of bit b, by selection: no indexed registers
          if (!one)
#pragma unroll
            for (int bb = 1; bb < 32; ++bb)
              if (bb == b) v = acc[4 * (bb >> 1) + 2 * i + (bb & 1)];
          if (n[i] == CAP) {
            const Best r = make_room<COSINE>(a, mine + i * CAP, thr, xs, rl + 8 * i, x2[i], bv[i],
                                             bi[i]);
            bv[i] = r.v;
            bi[i] = r.i;
            n[i] = r.n;
          }
          mine[i * CAP + n[i]++] =
              make_float2(v, __int_as_float(k0 + 8 * (b >> 1) + 2 * q + (b & 1)));
        }
      }
    }
    // thread 0 refills the stage of the tile before, which the other warps
    // have most likely released by now: S - 1 tiles stay in flight
    if (threadIdx.x == 0 && t > 0 && t - 1 + S < nt) {
      sm90::mbar_wait(&empty[(t - 1) % S], ((t - 1) / S) & 1);
      load_tile(t - 1 + S);
    }
  }

  // the candidates within 2 eps of the rank's final screen max, rescored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float thr = live[i] ? __fsub_rd(m[i], eps2[i]) : INFINITY;
    for (int k = 0; k < n[i]; ++k) {
      const float2 c = mine[i * CAP + k];
      const int idx = __float_as_int(c.y);
      if (c.x >= thr) fold(bv[i], bi[i], exact_score<COSINE>(a, xs, rl + 8 * i, idx, x2[i]), idx);
    }
  }
  // the row's pair from its quad, then from the cluster's ranks
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], o);
      fold(bv[i], bi[i], ov, oi);
    }
  gemv::cluster_wait();  // rank 0's barrier is initialised
  if (rank > 0) {
    if (q == 0) {
      const uint32_t bar = gemv::cluster_addr(&gathered, 0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        gemv::st_async(gemv::cluster_addr(gather + (rank - 1) * ROWS + rl + 8 * i, 0), bv[i],
                       __int_as_float(bi[i]), bar);
    }
    return;
  }
  if (split > 1) {
    if (threadIdx.x == 0) sm90::mbar_expect_tx(&gathered, (split - 1) * ROWS * 8);
    gemv::mbar_wait_cluster(&gathered, 0);
  }
  if (q == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rl + 8 * i;
      for (int k = 1; k < split; ++k) {
        const float2 g = gather[(k - 1) * ROWS + r];
        fold(bv[i], bi[i], g.x, __float_as_int(g.y));
      }
      if (row0 + r < a.N) a.out[row0 + r] = bi[i];
    }
  }
}

template <bool COSINE>
int launch(const float* x, const float* e, float* e2, float* emax, long long* out, int N, int K,
           int D, int split, int stages, float c_rel, float c_sq, float c_abs, cudaStream_t s) {
  if (D % 4 != 0 || D < 4 || D > 128 || split < 1 || split > 8 || stages < 2 ||
      stages > MAX_STAGES || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = (K + TILE - 1) / TILE;
  CUtensorMap tx, te;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)N};
  const cuuint64_t edims[2] = {(cuuint64_t)D, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t box[2] = {32, ROWS};  // ROWS == TILE
  int err = sm90::encode_map(&tx, x, 2, xdims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == 0)
    err = sm90::encode_map(&te, e, 2, edims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != 0) return err;
  code_norms_kernel<COSINE><<<tiles, TILE, 0, s>>>(e, e2, emax, K, D);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const Args a{e, e2, emax, out, N, K, D, tiles, (tiles + split - 1) / split, stages,
               c_rel, c_sq, c_abs};
  const dim3 grid(((N + ROWS - 1) / ROWS) * split);
  const size_t smem = smem_bytes(D, stages, split);
  switch (nblocks(D)) {
    case 1:
      return gemv::launch_cluster(nearest_kernel<COSINE, 1>, grid, THREADS, split, smem, s, tx,
                                  te, a);
    case 2:
      return gemv::launch_cluster(nearest_kernel<COSINE, 2>, grid, THREADS, split, smem, s, tx,
                                  te, a);
    case 3:
      return gemv::launch_cluster(nearest_kernel<COSINE, 3>, grid, THREADS, split, smem, s, tx,
                                  te, a);
    default:
      return gemv::launch_cluster(nearest_kernel<COSINE, 4>, grid, THREADS, split, smem, s, tx,
                                  te, a);
  }
}

}  // namespace vq
}  // namespace fourm

// x (N, D) and e (K, D) fp32, row-major, D % 4 == 0 (the wrapper pads);
// e2 (tiles * 128) and emax (tiles) fp32 scratch; out (N,) int64. cosine:
// argmax x.e (inputs already l2-normalised), else the Euclidean form. split
// and stages: the wrapper's search_plan; c_rel, c_sq, c_abs: its margin.
extern "C" int fourm_nearest_code(const void* x, const void* e, void* e2, void* emax, void* out,
                                  int N, int K, int D, int cosine, int split, int stages,
                                  float c_rel, float c_sq, float c_abs, void* stream) {
  using namespace fourm::vq;
  const float* xp = (const float*)x;
  const float* ep = (const float*)e;
  cudaStream_t s = (cudaStream_t)stream;
  return cosine ? launch<true>(xp, ep, (float*)e2, (float*)emax, (long long*)out, N, K, D, split,
                               stages, c_rel, c_sq, c_abs, s)
                : launch<false>(xp, ep, (float*)e2, (float*)emax, (long long*)out, N, K, D, split,
                                stages, c_rel, c_sq, c_abs, s);
}
