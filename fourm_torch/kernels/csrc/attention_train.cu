// Differentiable attention of the training step: a forward kernel and a
// three-kernel backward.
//   forward  -- replaces fourm_tpu/kernels/attention_bwd.py:_train_fwd_call
//               (pallas_call :177): o = softmax(q k^T * scale + bias) v, or
//               softmax1, and per row the running max m and the inverse
//               sum 1/l (fp32) as the backward's residual (the TPU kernel
//               recomputes the row statistics instead). Not one log-sum-exp:
//               m + log(l) rounds log(l) away when m is the finfo.min of a
//               fully masked row.
//   backward -- replaces _train_bwd_call (pallas_call :212):
//                 D  = rowsum(do * o)            (dsum pre-pass, fp32)
//                 p  = exp(s - m) / l            (s recomputed from q, k)
//                 dv = p^T do, p cast to bf16    (dkdv kernel)
//                 ds = p * (do v^T - D), cast to bf16
//                 dk = (ds^T q) * scale          (dkdv kernel)
//                 dq = (ds k) * scale            (dq kernel)
//               the roundings of attention_bwd.py:107-139. softmax1 needs
//               no case of its own: its l holds the implicit zero logit.
// q/k/v/o/do and the outputs are (B, H, N|M, 64) bf16 read and written
// through (batch, head, row) strides; the bias is fp32 (B, 1, 1|N, M) read
// through (batch, row, key) strides (row stride 0 for a key-only bias), or
// absent.
//
// What bounds it on an H100: bytes at the training shapes (N = M = 128):
// 4*N*M*Dh FLOP per (batch, head) forward against (2N + 2M)*Dh*2 bytes is
// ~64 FLOP/byte, below the card's ~295. The design keeps every (N, M) score,
// probability and ds tile in shared memory and registers: nothing of size
// N*M reaches device memory (the TPU kernel's reason to exist, too).
//
// Design: a block takes one (batch, head, 64-row tile); 4 warps own 16 rows
// each; products on WMMA 16x16x16 bf16 fragments with fp32 accumulation.
// The forward is attention.cu's online softmax plus the row statistics. The backward
// is deterministic, with no float atomics: the dkdv kernel takes a 64-key
// tile and walks the query tiles, accumulating dk and dv in registers; the
// dq kernel takes a 64-query tile and walks the key tiles. Both recompute s
// and dp = do v^T from q, k, v (two products more than one fused pass with
// atomics). Masked logits carry the finite finfo(f32).min, so a fully
// masked row gets uniform weights, never NaN. Rows and keys past N and M
// take no weight. A first version: no TMA, no wgmma, no pipelining.
#include <float.h>

#include "common.cuh"

namespace fourm {

constexpr int TR_DH = 64;
constexpr int TR_T = 64;            // rows of a query or key tile
constexpr int TR_THREADS = 128;
constexpr int TR_LD = TR_DH + 8;    // bf16 tile row stride (elements)
constexpr int TR_LDS = TR_T + 4;    // fp32 score row stride

struct TrainArgs {
  const bf16 *q, *k, *v, *o, *dout;
  bf16 *out, *dq, *dk, *dv;
  float *stats;  // (B, H, N, 2) contiguous: row max, inverse row sum
  float *dsum;   // (B, H, N) contiguous
  const float* bias;
  int B, H, N, M;
  // (batch, head, row) strides of q, k, v, o, do, dq, dk, dv; then the
  // bias's (batch, row, key) strides
  int s[8][3];
  int sbb, sbn, sbm;
  float scale;
  int zero_attn;
};

enum { SQ = 0, SK, SV, SO, SDO, SDQ, SDK, SDV };

__device__ __forceinline__ size_t off(const TrainArgs& a, int t, int b, int h, int row) {
  return (size_t)b * a.s[t][0] + (size_t)h * a.s[t][1] + (size_t)row * a.s[t][2];
}

// Copy a 64 x 64 bf16 tile (rows past `rows` zero) into shared memory.
__device__ __forceinline__ void tile_to_smem(const bf16* __restrict__ src, int stride, int rows,
                                             bf16* dst) {
#pragma unroll
  for (int pass = 0; pass < TR_T * 8 / TR_THREADS; ++pass) {
    const int idx = pass * TR_THREADS + threadIdx.x;
    const int r = idx / 8, vi = idx % 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < rows) u = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + vi * 8);
    *reinterpret_cast<uint4*>(dst + r * TR_LD + vi * 8) = u;
  }
}

// out[16 x 64] (fp32, row stride TR_LDS) = A[16 x 64] B^T for the 16 rows
// of `a` (row-major, stride TR_LD) against the 64 rows of `b` (row-major,
// stride TR_LD): S = Q K^T, dP = dO V^T.
__device__ __forceinline__ void rows_times_t(const bf16* a, const bf16* b, float* out) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[TR_DH / 16];
#pragma unroll
  for (int kk = 0; kk < TR_DH / 16; ++kk) wmma::load_matrix_sync(af[kk], a + kk * 16, TR_LD);
#pragma unroll
  for (int j = 0; j < TR_T / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < TR_DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, b + (j * 16) * TR_LD + kk * 16, TR_LD);
      wmma::mma_sync(acc, af[kk], bf, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, TR_LDS, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(TR_THREADS) attn_train_fwd_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TR_T * TR_LD;
  bf16* vs = ks + TR_T * TR_LD;
  bf16* ps = vs + TR_T * TR_LD;                                // 4 warps x 16 rows
  float* ss = reinterpret_cast<float*>(ps + TR_T * TR_LD);    // 4 warps x 16 x TR_LDS

  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * TR_T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  tile_to_smem(a.q + off(a, SQ, b, h, n0), a.s[SQ][2], min(TR_T, a.N - n0), qs);

  bf16* pw = ps + warp * 16 * TR_LD;
  float* sw = ss + warp * 16 * TR_LDS;
  const int r = lane / 2, c0 = (lane % 2) * 32;
  const int n = n0 + warp * 16 + r;
  const float* brow = nullptr;
  if (a.bias != nullptr)
    brow = a.bias + (size_t)b * a.sbb + (size_t)min(n, a.N - 1) * a.sbn;

  float m_run = a.zero_attn ? 0.f : -FLT_MAX;  // finite start: never -inf - -inf
  float l_run = 0.f;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int m0 = 0; m0 < a.M; m0 += TR_T) {
    const int kr = min(TR_T, a.M - m0);
    __syncthreads();  // every warp is done with the previous K/V tile
    tile_to_smem(a.k + off(a, SK, b, h, m0), a.s[SK][2], kr, ks);
    tile_to_smem(a.v + off(a, SV, b, h, m0), a.s[SV][2], kr, vs);
    __syncthreads();
    rows_times_t(qs + warp * 16 * TR_LD, ks, sw);
    __syncwarp();

    float sv[32];
    float mx = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = m0 + c0 + i;
      float s = sw[r * TR_LDS + c0 + i] * a.scale;
      if (brow != nullptr && key < a.M) s += brow[(size_t)key * a.sbm];
      sv[i] = s;
      if (key < a.M) mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pv = m0 + c0 + i < a.M ? expf(sv[i] - m_new) : 0.f;
      lsum += pv;
      pw[r * TR_LD + c0 + i] = __float2bfloat16(pv);
    }
    l_run = l_run * alpha + lsum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha;
    __syncwarp();

    // acc += P V
#pragma unroll
    for (int j = 0; j < TR_DH / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int kk = 0; kk < TR_T / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, pw + kk * 16, TR_LD);
        wmma::load_matrix_sync(vf, vs + (kk * 16) * TR_LD + j * 16, TR_LD);
        wmma::mma_sync(o, pa, vf, o);
      }
      wmma::store_matrix_sync(sw + j * 16, o, TR_LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += sw[r * TR_LDS + c0 + i];
    __syncwarp();
  }

  float l_tot = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
  if (a.zero_attn) l_tot += expf(-m_run);  // softmax1: the implicit zero logit
  const float inv = 1.f / l_tot;
  if (n < a.N) {
    bf16* dst = a.out + off(a, SO, b, h, n) + c0;
#pragma unroll
    for (int v8 = 0; v8 < 4; ++v8) {
      uint4 u;
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(acc[v8 * 8 + i] * inv);
      reinterpret_cast<uint4*>(dst)[v8] = u;
    }
    if (c0 == 0) {
      float* st = a.stats + 2 * (((size_t)b * a.H + h) * a.N + n);
      st[0] = m_run;
      st[1] = inv;
    }
  }
}

// --------------------------------------------------------------- backward

// D[b, h, n] = sum_d do * o in fp32, one thread per row, d in order.
__global__ void __launch_bounds__(TR_THREADS) attn_train_dsum_kernel(TrainArgs a) {
  const size_t row = (size_t)blockIdx.x * TR_THREADS + threadIdx.x;
  if (row >= (size_t)a.B * a.H * a.N) return;
  const int n = (int)(row % a.N), h = (int)((row / a.N) % a.H), b = (int)(row / ((size_t)a.N * a.H));
  const uint4* dov = reinterpret_cast<const uint4*>(a.dout + off(a, SDO, b, h, n));
  const uint4* ov = reinterpret_cast<const uint4*>(a.o + off(a, SO, b, h, n));
  float d = 0.f;
#pragma unroll
  for (int v8 = 0; v8 < TR_DH / 8; ++v8) {
    float x[8], y[8];
    unpack8(dov[v8], x);
    unpack8(ov[v8], y);
#pragma unroll
    for (int i = 0; i < 8; ++i) d += x[i] * y[i];
  }
  a.dsum[row] = d;
}

// For the 16 query rows at `row0` of the query tile at n0 (q rows in qs, do
// rows in dos) against the key tile at m0 (ks, vs): s and dp on WMMA into
// sw / dpw, then p = exp(s - m) / l and ds = p (dp - D), both rounded to
// bf16 into pt / dt (row-major [query][key], stride TR_LD; pt only if
// WRITE_P). m, 1/l and D of the tile's rows are in st_t (pairs) and d_t.
template <bool WRITE_P>
__device__ __forceinline__ void p_and_ds(const TrainArgs& a, int b, int n0, int row0, int m0,
                                         const bf16* qs, const bf16* dos, const bf16* ks,
                                         const bf16* vs, float* sw, float* dpw, bf16* pt,
                                         bf16* dt, const float* st_t, const float* d_t) {
  const int lane = threadIdx.x % 32;
  rows_times_t(qs + row0 * TR_LD, ks, sw);
  rows_times_t(dos + row0 * TR_LD, vs, dpw);
  __syncwarp();
  const int r = lane / 2, c0 = (lane % 2) * 32;
  const int n = n0 + row0 + r;
  const bool row_ok = n < a.N;
  const float* brow = nullptr;
  if (a.bias != nullptr)
    brow = a.bias + (size_t)b * a.sbb + (size_t)min(n, a.N - 1) * a.sbn;
  const float mrow = st_t[2 * (row0 + r)], inv = st_t[2 * (row0 + r) + 1];
  const float dd = d_t[row0 + r];
#pragma unroll 8
  for (int i = 0; i < 32; ++i) {
    const int key = m0 + c0 + i;
    float p = 0.f;
    if (row_ok && key < a.M) {
      float s = sw[r * TR_LDS + c0 + i] * a.scale;
      if (brow != nullptr) s += brow[(size_t)key * a.sbm];
      p = expf(s - mrow) * inv;
    }
    const float ds = p * (dpw[r * TR_LDS + c0 + i] - dd);
    if (WRITE_P) pt[(row0 + r) * TR_LD + c0 + i] = __float2bfloat16(p);
    dt[(row0 + r) * TR_LD + c0 + i] = __float2bfloat16(ds);
  }
}

// Write 16 rows x 64 of fp32 accumulators (times `scale`) as bf16 rows of
// (B, H, rows, 64) at row0; rows at or past `limit` are not written. sw is
// the warp's fp32 scratch.
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[TR_DH / 16], float* sw,
    float scale, bf16* dst_row0, int stride, int row0, int limit) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < TR_DH / 16; ++j)
    wmma::store_matrix_sync(sw + j * 16, acc[j], TR_LDS, wmma::mem_row_major);
  __syncwarp();
  const int r = lane / 2, c0 = (lane % 2) * 32;
  if (row0 + r < limit) {
    bf16* dst = dst_row0 + (size_t)r * stride + c0;
#pragma unroll
    for (int v8 = 0; v8 < 4; ++v8) {
      uint4 u;
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(sw[r * TR_LDS + c0 + v8 * 8 + i] * scale);
      reinterpret_cast<uint4*>(dst)[v8] = u;
    }
  }
  __syncwarp();
}

struct BwdSmem {
  bf16 *qs, *dos, *ks, *vs, *pt, *dt;
  float *sw, *dpw, *st_t, *d_t;
};

__device__ __forceinline__ BwdSmem carve(unsigned char* smem) {
  BwdSmem s;
  s.qs = reinterpret_cast<bf16*>(smem);
  s.dos = s.qs + TR_T * TR_LD;
  s.ks = s.dos + TR_T * TR_LD;
  s.vs = s.ks + TR_T * TR_LD;
  s.pt = s.vs + TR_T * TR_LD;
  s.dt = s.pt + TR_T * TR_LD;
  s.sw = reinterpret_cast<float*>(s.dt + TR_T * TR_LD);
  s.dpw = s.sw + TR_T * TR_LDS;
  s.st_t = s.dpw + TR_T * TR_LDS;
  s.d_t = s.st_t + 2 * TR_T;
  return s;
}

constexpr size_t BWD_SMEM = (size_t)6 * TR_T * TR_LD * sizeof(bf16) +
                            (size_t)2 * TR_T * TR_LDS * sizeof(float) + 3 * TR_T * sizeof(float);
// The tiles are fixed, whatever N and M: they must fit sm_90's opt-in block
// limit, so the kernels take any N and M at Dh = TR_DH.
static_assert(BWD_SMEM <= 227 * 1024, "the backward's tiles exceed sm_90's shared memory");

__device__ __forceinline__ void load_row_stats(const TrainArgs& a, int b, int h, int n0,
                                               float* st_t, float* d_t) {
  for (int i = threadIdx.x; i < TR_T; i += TR_THREADS) {
    const int n = n0 + i;
    const size_t idx = ((size_t)b * a.H + h) * a.N + n;
    st_t[2 * i] = n < a.N ? a.stats[2 * idx] : 0.f;
    st_t[2 * i + 1] = n < a.N ? a.stats[2 * idx + 1] : 0.f;
    d_t[i] = n < a.N ? a.dsum[idx] : 0.f;
  }
}

// One block per (batch, head, 64-key tile): dv and dk of those keys, summed
// over every query tile in order.
__global__ void __launch_bounds__(TR_THREADS) attn_train_dkdv_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem s = carve(smem);
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * TR_T;
  const int warp = threadIdx.x / 32;
  tile_to_smem(a.k + off(a, SK, b, h, m0), a.s[SK][2], min(TR_T, a.M - m0), s.ks);
  tile_to_smem(a.v + off(a, SV, b, h, m0), a.s[SV][2], min(TR_T, a.M - m0), s.vs);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[TR_DH / 16], dv[TR_DH / 16];
#pragma unroll
  for (int j = 0; j < TR_DH / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }
  float* sw = s.sw + warp * 16 * TR_LDS;
  float* dpw = s.dpw + warp * 16 * TR_LDS;
  const int kr0 = warp * 16;  // this warp's key rows in the tile

  for (int n0 = 0; n0 < a.N; n0 += TR_T) {
    const int rows = min(TR_T, a.N - n0);
    __syncthreads();  // every warp is done with the previous query tile
    tile_to_smem(a.q + off(a, SQ, b, h, n0), a.s[SQ][2], rows, s.qs);
    tile_to_smem(a.dout + off(a, SDO, b, h, n0), a.s[SDO][2], rows, s.dos);
    load_row_stats(a, b, h, n0, s.st_t, s.d_t);
    __syncthreads();
    p_and_ds<true>(a, b, n0, warp * 16, m0, s.qs, s.dos, s.ks, s.vs, sw, dpw, s.pt, s.dt,
                   s.st_t, s.d_t);
    __syncthreads();  // p and ds of all 64 query rows
    // dv[keys] += p^T do, dk[keys] += ds^T q over the tile's 64 queries
#pragma unroll
    for (int kk = 0; kk < TR_T / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa, da;
      wmma::load_matrix_sync(pa, s.pt + (kk * 16) * TR_LD + kr0, TR_LD);
      wmma::load_matrix_sync(da, s.dt + (kk * 16) * TR_LD + kr0, TR_LD);
#pragma unroll
      for (int j = 0; j < TR_DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> dof, qf;
        wmma::load_matrix_sync(dof, s.dos + (kk * 16) * TR_LD + j * 16, TR_LD);
        wmma::load_matrix_sync(qf, s.qs + (kk * 16) * TR_LD + j * 16, TR_LD);
        wmma::mma_sync(dv[j], pa, dof, dv[j]);
        wmma::mma_sync(dk[j], da, qf, dk[j]);
      }
    }
  }
  const int key0 = m0 + kr0;
  const int lim = a.M - m0;
  store_rows(dv, sw, 1.f, a.dv + off(a, SDV, b, h, min(key0, a.M - 1)), a.s[SDV][2], kr0, lim);
  store_rows(dk, sw, a.scale, a.dk + off(a, SDK, b, h, min(key0, a.M - 1)), a.s[SDK][2], kr0,
             lim);
}

// One block per (batch, head, 64-query tile): dq of those rows, summed over
// every key tile in order.
__global__ void __launch_bounds__(TR_THREADS) attn_train_dq_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem s = carve(smem);
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * TR_T;
  const int warp = threadIdx.x / 32;
  const int rows = min(TR_T, a.N - n0);
  tile_to_smem(a.q + off(a, SQ, b, h, n0), a.s[SQ][2], rows, s.qs);
  tile_to_smem(a.dout + off(a, SDO, b, h, n0), a.s[SDO][2], rows, s.dos);
  load_row_stats(a, b, h, n0, s.st_t, s.d_t);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[TR_DH / 16];
#pragma unroll
  for (int j = 0; j < TR_DH / 16; ++j) wmma::fill_fragment(dq[j], 0.f);
  float* sw = s.sw + warp * 16 * TR_LDS;
  float* dpw = s.dpw + warp * 16 * TR_LDS;
  const int row0 = warp * 16;

  for (int m0 = 0; m0 < a.M; m0 += TR_T) {
    const int kr = min(TR_T, a.M - m0);
    __syncthreads();  // every warp is done with the previous key tile
    tile_to_smem(a.k + off(a, SK, b, h, m0), a.s[SK][2], kr, s.ks);
    tile_to_smem(a.v + off(a, SV, b, h, m0), a.s[SV][2], kr, s.vs);
    __syncthreads();
    p_and_ds<false>(a, b, n0, row0, m0, s.qs, s.dos, s.ks, s.vs, sw, dpw, nullptr, s.dt,
                    s.st_t, s.d_t);
    __syncwarp();
    // dq[rows] += ds k over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < TR_T / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> da;
      wmma::load_matrix_sync(da, s.dt + row0 * TR_LD + kk * 16, TR_LD);
#pragma unroll
      for (int j = 0; j < TR_DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kf;
        wmma::load_matrix_sync(kf, s.ks + (kk * 16) * TR_LD + j * 16, TR_LD);
        wmma::mma_sync(dq[j], da, kf, dq[j]);
      }
    }
  }
  store_rows(dq, sw, a.scale, a.dq + off(a, SDQ, b, h, min(n0 + row0, a.N - 1)), a.s[SDQ][2],
             row0, rows);
}

constexpr size_t FWD_SMEM = (size_t)4 * TR_T * TR_LD * sizeof(bf16) +
                            (size_t)TR_T * TR_LDS * sizeof(float);

// dims: B, H, N, M, then the (batch, head, row) strides of q, k, v, o, do,
// dq, dk, dv (24 ints), then the bias's (batch, row, key) strides.
TrainArgs make_args(const int* dims, float scale, int zero_attn) {
  TrainArgs a{};
  a.B = dims[0]; a.H = dims[1]; a.N = dims[2]; a.M = dims[3];
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) a.s[t][i] = dims[4 + 3 * t + i];
  a.sbb = dims[28]; a.sbn = dims[29]; a.sbm = dims[30];
  a.scale = scale;
  a.zero_attn = zero_attn;
  return a;
}

}  // namespace fourm

extern "C" int fourm_attention_train_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* stats, const void* bias, const int* dims,
                                         float scale, int zero_attn, void* stream) {
  using namespace fourm;
  TrainArgs a = make_args(dims, scale, zero_attn);
  a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v;
  a.out = (bf16*)o; a.stats = (float*)stats; a.bias = (const float*)bias;
  cudaError_t err = cudaFuncSetAttribute(attn_train_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.N + TR_T - 1) / TR_T, a.H, a.B);
  attn_train_fwd_kernel<<<grid, TR_THREADS, FWD_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int fourm_attention_train_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* stats,
                                         const void* bias, void* dq, void* dk, void* dv,
                                         void* dsum, const int* dims, float scale, void* stream) {
  using namespace fourm;
  TrainArgs a = make_args(dims, scale, 0);
  a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v; a.o = (const bf16*)o;
  a.dout = (const bf16*)dout; a.stats = (float*)stats; a.bias = (const float*)bias;
  a.dq = (bf16*)dq; a.dk = (bf16*)dk; a.dv = (bf16*)dv; a.dsum = (float*)dsum;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(attn_train_dkdv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BWD_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_train_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)a.B * a.H * a.N;
  attn_train_dsum_kernel<<<(unsigned)((rows + TR_THREADS - 1) / TR_THREADS), TR_THREADS, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 gk((a.M + TR_T - 1) / TR_T, a.H, a.B);
  attn_train_dkdv_kernel<<<gk, TR_THREADS, BWD_SMEM, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 gq((a.N + TR_T - 1) / TR_T, a.H, a.B);
  attn_train_dq_kernel<<<gq, TR_THREADS, BWD_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}
