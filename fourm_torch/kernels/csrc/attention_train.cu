// The backward of the training step's attention, on Hopper.
//   replaces fourm_tpu/kernels/attention_bwd.py:_train_bwd_call (pallas_call
//   :212), with the roundings of attention_bwd.py:107-139:
//     p  = exp2(s * scale * log2(e) + bias * log2(e) - m2) / l
//                                   (s = q k^T recomputed; m2 and 1/l the
//                                    forward's row statistics, log2 units)
//     dv = p^T do,  p cast to bf16
//     D  = rowsum(do * o)           (fp32, from the bf16 o)
//     ds = p (do v^T - D), cast to bf16
//     dk = (ds^T q) * scale,  dq = (ds k) * scale
//   softmax1 needs no case of its own: its 1/l holds the implicit zero
//   logit. The forward (_train_fwd_call, pallas_call :177) is attention.cu's
//   kernel with its STATS output (attention_train.py:attention_train_fwd).
// q/k/v/o/do and the outputs are (B, H, N|M, 64) bf16 read and written
// through (batch, head, row) strides; the bias is fp32 (B, 1, 1|N, M) read
// through (batch, row, key) strides (row stride 0 for a key bias), or absent.
//
// What bounds it on an H100: bytes at the training shapes. At N = M = 128
// the five products do 10*N*M*Dh FLOP per (batch, head) against (4N + 4M)*Dh
// bf16 values read and written (q, o, do, k, v in; dq, dk, dv out): 80 FLOP
// per byte (the forward: 64), below the card's ~295. So every operand is
// read once and nothing of size N*M reaches device memory (the TPU kernel's
// reason to exist too); past that, the time is each CTA's latency: load K
// and V, stream the query tiles, write dk, dv.
//
// Design (one kernel; attn_sm90.cuh's primitives):
//   * key-tile-major: a CTA owns (batch, head, 128 keys) -- two consumer
//     warpgroups of 64 keys each and a producer warpgroup. At the train
//     step's M = 128 one CTA holds every key of its (batch, head);
//   * the producer's thread 0 loads K and V once by TMA, then streams each
//     query tile's Q, dO and O (64 rows each, 4-D maps over the caller's
//     strides, rows past N zero-filled) and, with a full bias, the tile's 64
//     x 128 bias through a two-stage mbarrier ring. The producer's 128
//     threads stage the tile's row statistics beside it and compute D =
//     rowsum(dO o) from the O and dO tiles in shared memory, two threads a
//     row, so D needs no pre-pass;
//   * per query tile each consumer computes, with rows its keys: S^T = K Q^T
//     and dP^T = V dO^T by wgmma into registers; P^T = exp2(logit2 - m2) *
//     (1/l) from the saved statistics; dS^T = P^T (dP^T - D); then dV += P^T
//     dO and dK += dS^T Q by wgmma with P^T and dS^T, rounded to bf16, as the
//     register A operand (the accumulator layout is the A fragment layout,
//     as in the forward's P V), and dQ over its 64 keys = dS K with dS^T,
//     stored in shared memory in the 128-byte swizzle, as an MN-major A
//     operand. Five products per query tile; none recomputed;
//   * deterministic, no float atomics: the two consumers' dQ partials meet
//     in shared memory (one adds the other's, the roles alternating by tile)
//     and are written once as bf16 when one CTA holds every key; past M =
//     128 each key-tile CTA writes an fp32 partial and dq_reduce_kernel sums
//     them in key-tile order. One launch per backward at M <= 128, two past;
//   * a key bias is per key, so each consumer thread keeps its two keys'
//     values in registers; a full bias comes by TMA in fp32 boxes of 32 keys
//     in the 128-byte swizzle, which a consumer reads (8 keys x 4 queries a
//     warp) without bank conflicts. The logits are clamped at BIAS_FLOOR and
//     taken in log2 units as in the forward, so a fully masked row gets
//     uniform weights, never NaN; keys past M get -inf, rows past N 1/l = 0:
//     they take no weight.
#include "attn_sm90.cuh"

namespace fourm {

constexpr int BW_CONS = 2;                    // consumer warpgroups, 64 keys each
constexpr int BW_KEYS = 64 * BW_CONS;         // keys per CTA
constexpr int BW_THREADS = 128 * (BW_CONS + 1);
constexpr int BW_STAGES = 2;
constexpr int BW_TILE = 64 * 128;             // 64 bf16 rows of 64 (8 KB)
constexpr int BW_BIAS_BYTES = 64 * BW_KEYS * 4;  // a query tile's full bias (fp32)

// Shared memory (from a 1024-byte aligned base): K, V (BW_KEYS rows each);
// the consumers' dS^T tiles; two fp32 64 x 64 dQ exchange buffers; then
// BW_STAGES stages of Q, dO, O (and the full bias); then per stage the
// rows' statistics (64 x 2) and D (64); then the barriers.
template <int BIAS>
struct BwdSmem {
  static constexpr int K = 0, V = K + BW_KEYS * 128, DS = V + BW_KEYS * 128,
                       X = DS + BW_CONS * BW_TILE, STAGES = X + 2 * 64 * 64 * 4;
  static constexpr int STAGE = 3 * BW_TILE + (BIAS == 2 ? BW_BIAS_BYTES : 0);
  static constexpr int ROWS = STAGES + BW_STAGES * STAGE;  // 192 floats a stage
  static constexpr int BARS = ROWS + BW_STAGES * 192 * 4;
  static constexpr size_t BYTES = 1024 + BARS + (1 + 3 * BW_STAGES) * sizeof(uint64_t);
};
static_assert(BwdSmem<2>::BYTES <= 227 * 1024, "the backward's tiles exceed sm_90's shared memory");

struct BwdArgs {
  bf16 *dq, *dk, *dv;
  float* dq_part;       // fp32 (T, B, H, N, 64) partials when T = gridDim.x > 1
  const float* stats;   // (B, H, N, 2): max logit in log2 units, 1 / sum
  const float* bias;    // a key bias, read by the consumers (BIAS 1)
  int sbb, sbm;
  int B, H, N, M;
  int sdq[3], sdk[3], sdv[3];
  float scale;
  int ord_q, ord_k, ord_v, ord_o, ord_do, bias_flags;
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// BIAS: 0 none, 1 a key bias (B, 1, 1, M), 2 a full bias (B, 1, N, M) through
// its TMA map tb.
template <int BIAS>
__global__ void __launch_bounds__(BW_THREADS, 1)
attn_train_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                      const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tb,
                      BwdArgs p) {
  using L = BwdSmem<BIAS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* tile = kvbar + 1;           // the TMA bytes of a stage
  uint64_t* full = tile + BW_STAGES;    // + its statistics and D (the producer's 128 threads)
  uint64_t* empty = full + BW_STAGES;   // released by the 256 consumer threads

  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * BW_KEYS;
  const int n_qt = (p.N + 63) / 64;
  if (threadIdx.x == 0) {
    sm90::mbar_init(kvbar, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      sm90::mbar_init(&tile[s], 1);
      sm90::mbar_init(&full[s], 128);
      sm90::mbar_init(&empty[s], 128 * BW_CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == BW_CONS) {
    // ---- producer warpgroup: thread 0 issues every TMA load; all 128
    // threads stage the statistics and compute D of each query tile
    const int i = threadIdx.x - 128 * BW_CONS;
    if (i == 0) {
      sm90::mbar_expect_tx(kvbar, 2 * BW_KEYS * 128);
      sm90::tma_rows(smem + L::K, &tk, kvbar, p.ord_k, m0, h, b);
      sm90::tma_rows(smem + L::V, &tv, kvbar, p.ord_v, m0, h, b);
    }
    const float2* stats = reinterpret_cast<const float2*>(p.stats) + ((size_t)b * p.H + h) * p.N;
    const int row = i >> 1, half = i & 1;
    for (int t = 0; t < n_qt; ++t) {
      const int s = t % BW_STAGES, n0 = t * 64;
      const uint32_t ph = (t / BW_STAGES) & 1;
      unsigned char* st = smem + L::STAGES + s * L::STAGE;
      float* rs = reinterpret_cast<float*>(smem + L::ROWS) + s * 192;
      sm90::mbar_wait(&empty[s], ph ^ 1);  // the first round passes at once
      if (i == 0) {
        sm90::mbar_expect_tx(&tile[s], L::STAGE);
        sm90::tma_rows(st, &tq, &tile[s], p.ord_q, n0, h, b);
        sm90::tma_rows(st + BW_TILE, &tdo, &tile[s], p.ord_do, n0, h, b);
        sm90::tma_rows(st + 2 * BW_TILE, &to, &tile[s], p.ord_o, n0, h, b);
        if (BIAS == 2)
          for (int j = 0; j < BW_KEYS / 32; ++j)
            sm90::tma_bias(st + 3 * BW_TILE + j * 64 * 128, &tb, &tile[s], p.bias_flags,
                           m0 + 32 * j, n0, h, b);
      }
      if (i < 64) {  // rows past N: 1/l = 0, so they take no weight
        const float2 v = n0 + i < p.N ? __ldg(stats + n0 + i) : make_float2(0.f, 0.f);
        reinterpret_cast<float2*>(rs)[i] = v;
      }
      sm90::mbar_wait(&tile[s], ph);
      // D of `row`: 32 head dims per thread from the swizzled dO and O rows
      const unsigned char* dor = st + BW_TILE + row * 128;
      const unsigned char* orow = st + 2 * BW_TILE + row * 128;
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int at = ((half * 4 + c) ^ (row & 7)) << 4;
        float x[8], y[8];
        unpack8(*reinterpret_cast<const uint4*>(dor + at), x);
        unpack8(*reinterpret_cast<const uint4*>(orow + at), y);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(x[e], y[e], d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (half == 0) rs[128 + row] = d;
      sm90::mbar_arrive(&full[s]);
    }
  } else {
    // ---- consumer warpgroup c: keys m0 + 64c .. + 64, as accumulator rows
    const int c = wg;
    const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = threadIdx.x % 32, quad = lane % 4;
    const int krow = 16 * warp + lane / 4;  // + 8r: the thread's key rows in the warpgroup's 64
    const float scale2 = p.scale * sm90::LOG2E;
    const float neg_inf = __int_as_float(0xff800000);
    float kb2[2];  // per key row: its key bias in log2 units (0 without), -inf past M
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = m0 + 64 * c + krow + 8 * r;
      float v = 0.f;
      if (BIAS == 1 && key < p.M)
        v = sm90::key_bias_log2(__ldg(p.bias + (size_t)b * p.sbb + (size_t)key * p.sbm));
      kb2[r] = key < p.M ? v : neg_inf;
    }
    float dk[32], dv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
    unsigned char* kc = smem + L::K + c * BW_TILE;
    const uint64_t desc_k = sm90::desc_sw128(kc);
    const uint64_t desc_v = sm90::desc_sw128(smem + L::V + c * BW_TILE);
    unsigned char* dst = smem + L::DS + c * BW_TILE;  // dS^T: rows keys, columns queries
    float* xbuf = reinterpret_cast<float*>(smem + L::X);
    sm90::mbar_wait(kvbar, 0);

    for (int t = 0; t < n_qt; ++t) {
      const int s = t % BW_STAGES, n0 = t * 64;
      const uint32_t ph = (t / BW_STAGES) & 1;
      const unsigned char* st = smem + L::STAGES + s * L::STAGE;
      const float* rs = reinterpret_cast<const float*>(smem + L::ROWS) + s * 192;
      sm90::mbar_wait(&tile[s], ph);
      sm90::mbar_wait(&full[s], ph);

      // S^T = K_c Q^T and dP^T = V_c dO^T (all K-major), rows keys
      float sa[32], dp[32];
      sm90::wgmma_fence();
      sm90::qk_tile<64>(sa, desc_k, sm90::desc_sw128(st));
      sm90::qk_tile<64>(dp, desc_v, sm90::desc_sw128(st + BW_TILE));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(sa);
      sm90::fence_acc(dp);

      // P^T and dS^T: accumulator 4j + 2r + e is key row krow + 8r, query
      // 8j + 2 quad + e; register 2j + r of a packed pair holds e = 0, 1
      uint32_t pp[16], dsp[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q0 = 8 * j + 2 * quad;
        const float4 mi = sm90::lds_f4(rs + 2 * q0);  // m2, 1/l of q0 and q0 + 1
        const float2 dd = sm90::lds_f2(rs + 128 + q0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float b0 = kb2[r], b1 = kb2[r];
          if (BIAS == 2) {
            const unsigned char* bt = st + 3 * BW_TILE;
            const int key = 64 * c + krow + 8 * r;
            b0 += sm90::key_bias_log2(*sm90::bias_at(bt, 64, q0, key));
            b1 += sm90::key_bias_log2(*sm90::bias_at(bt, 64, q0 + 1, key));
          }
          const int a = 4 * j + 2 * r;
          const float p0 = sm90::ex2(fmaf(sa[a], scale2, b0) - mi.x) * mi.y;
          const float p1 = sm90::ex2(fmaf(sa[a + 1], scale2, b1) - mi.z) * mi.w;
          const float ds0 = p0 * (dp[a] - dd.x), ds1 = p1 * (dp[a + 1] - dd.y);
          const __nv_bfloat162 hp = __floats2bfloat162_rn(p0, p1);
          const __nv_bfloat162 hd = __floats2bfloat162_rn(ds0, ds1);
          pp[2 * j + r] = *reinterpret_cast<const uint32_t*>(&hp);
          dsp[2 * j + r] = *reinterpret_cast<const uint32_t*>(&hd);
          // dS^T into the 128-byte swizzle: chunk j of key row kr at j ^ (kr % 8)
          const int kr = krow + 8 * r;
          *reinterpret_cast<uint32_t*>(dst + kr * 128 + ((j ^ (kr & 7)) << 4) + 4 * quad) =
              dsp[2 * j + r];
        }
      }
      // the generic-proxy stores of dS^T, seen by the warpgroup's wgmma
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_sync(1 + c, 128);

      // dV += P^T dO, dK += dS^T Q (A from registers, B MN-major), and
      // dQ_c = dS K_c over the warpgroup's 64 keys (A = dS^T MN-major)
      float dq[32];
      sm90::fence_acc(dk);
      sm90::fence_acc(dv);
      sm90::fence_regs(pp);
      sm90::fence_regs(dsp);
      sm90::wgmma_fence();
      sm90::pv_tile<64>(dv, pp, sm90::desc_sw128_mn(st + BW_TILE));
      sm90::pv_tile<64>(dk, dsp, sm90::desc_sw128_mn(st));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_m64n64k16_ss_mn(dq, sm90::desc_sw128_mn(dst) + kk * (2048 >> 4),
                                    sm90::desc_sw128_mn(kc) + kk * (2048 >> 4), kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(dk);
      sm90::fence_acc(dv);
      sm90::fence_acc(dq);
      sm90::fence_regs(pp);
      sm90::fence_regs(dsp);
      sm90::mbar_arrive(&empty[s]);  // Q, dO, statistics, D and bias read

      // dQ of the tile: the partial of consumer 1 - t % 2 goes through
      // xbuf[t % 2] to consumer t % 2, which adds it to its own (both
      // orders give the same fp32 sum) and writes the tile's rows
      float4* xb = reinterpret_cast<float4*>(xbuf + (t & 1) * 64 * 64);
      const int bar = 3 + (t & 1);
      if (c != (t & 1)) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xb[e * 128 + t128] = make_float4(dq[4 * e], dq[4 * e + 1], dq[4 * e + 2], dq[4 * e + 3]);
        bar_arrive(bar, 256);
      } else {
        bar_sync(bar, 256);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 o = xb[e * 128 + t128];
          dq[4 * e] += o.x;
          dq[4 * e + 1] += o.y;
          dq[4 * e + 2] += o.z;
          dq[4 * e + 3] += o.w;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = n0 + krow + 8 * r;  // accumulator rows: queries
          if (n >= p.N) continue;
          if (gridDim.x == 1) {
            bf16* out = p.dq + (size_t)b * p.sdq[0] + (size_t)h * p.sdq[1] + (size_t)n * p.sdq[2];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * quad) = __floats2bfloat162_rn(
                  dq[4 * j + 2 * r] * p.scale, dq[4 * j + 2 * r + 1] * p.scale);
          } else {
            float* out = p.dq_part +
                         ((((size_t)blockIdx.x * p.B + b) * p.H + h) * p.N + n) * 64;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<float2*>(out + 8 * j + 2 * quad) =
                  make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
          }
        }
      }
    }

    // dK (times the scale) and dV of the warpgroup's keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = m0 + 64 * c + krow + 8 * r;
      if (key >= p.M) continue;
      bf16* ok = p.dk + (size_t)b * p.sdk[0] + (size_t)h * p.sdk[1] + (size_t)key * p.sdk[2];
      bf16* ov = p.dv + (size_t)b * p.sdv[0] + (size_t)h * p.sdv[1] + (size_t)key * p.sdv[2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int a = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(ok + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(dk[a] * p.scale, dk[a + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(ov + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(dv[a], dv[a + 1]);
      }
    }
  }
}

// dq = bf16(scale * sum of the T key tiles' fp32 partials), summed in
// key-tile order: four head dims a thread.
__global__ void __launch_bounds__(256)
dq_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dq, int T, int B, int H,
                 int N, int s0, int s1, int s2, float scale) {
  const size_t rows = (size_t)B * H * N;
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= rows * 16) return;
  const size_t row = idx / 16;
  const int c4 = (int)(idx % 16);
  const float4* src = reinterpret_cast<const float4*>(part) + idx;
  float4 acc = src[0];
  for (int kt = 1; kt < T; ++kt) {
    const float4 v = src[(size_t)kt * rows * 16];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  const int n = (int)(row % N), h = (int)((row / N) % H), b = (int)(row / ((size_t)N * H));
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
      dq + (size_t)b * s0 + (size_t)h * s1 + (size_t)n * s2 + 4 * c4);
  out[0] = __floats2bfloat162_rn(acc.x * scale, acc.y * scale);
  out[1] = __floats2bfloat162_rn(acc.z * scale, acc.w * scale);
}

template <int BIAS>
int launch_bwd(const CUtensorMap (&maps)[6], const BwdArgs& a, dim3 grid, cudaStream_t st) {
  auto kern = attn_train_bwd_kernel<BIAS>;
  constexpr size_t smem = BwdSmem<BIAS>::BYTES;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, BW_THREADS, smem, st>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a);
  return (int)cudaGetLastError();
}

}  // namespace fourm

// dims: B, H, N, M, then the (batch, head, row) element strides of q, k, v,
// o, do, dq, dk, dv (24 ints: multiples of 8, the last dim contiguous,
// 16-byte aligned bases), then the bias's (batch, row, key) strides (row
// stride 0: a key bias; a full bias needs contiguous keys and rows of a
// multiple of 4 keys, as TMA reads it). stats: the forward's (B, H, N, 2).
// dq_part: fp32 (ceil(M / 128), B, H, N, 64) when M > 128, else unused.
extern "C" int fourm_attention_train_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* stats,
                                         const void* bias, void* dq, void* dk, void* dv,
                                         void* dq_part, const int* dims, float scale,
                                         void* stream) {
  using namespace fourm;
  cudaStream_t st = (cudaStream_t)stream;
  const int B = dims[0], H = dims[1], N = dims[2], M = dims[3];
  const int* s = dims + 4;  // s[3 t + i]: operand t (q, k, v, o, do, dq, dk, dv)
  const int sbb = dims[28], sbn = dims[29], sbm = dims[30];
  if (N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const int T = (M + BW_KEYS - 1) / BW_KEYS;
  if (T > 1 && dq_part == nullptr) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.dq = (bf16*)dq; a.dk = (bf16*)dk; a.dv = (bf16*)dv;
  a.dq_part = (float*)dq_part; a.stats = (const float*)stats; a.bias = (const float*)bias;
  a.sbb = sbb; a.sbm = sbm;
  a.B = B; a.H = H; a.N = N; a.M = M;
  for (int i = 0; i < 3; ++i) {
    a.sdq[i] = s[15 + i];
    a.sdk[i] = s[18 + i];
    a.sdv[i] = s[21 + i];
  }
  a.scale = scale;
  a.bias_flags = 0;
  // the kernel's tq, tk, tv, to, tdo and (a full bias) tb
  CUtensorMap maps[6] = {};
  const void* ptrs[5] = {q, k, v, o, dout};
  int* ords[5] = {&a.ord_q, &a.ord_k, &a.ord_v, &a.ord_o, &a.ord_do};
  for (int t = 0; t < 5; ++t) {
    const bool keys = t == 1 || t == 2;
    const int err = sm90::make_rows_map(&maps[t], ptrs[t], B, H, keys ? M : N, s[3 * t],
                                        s[3 * t + 1], s[3 * t + 2], keys ? BW_KEYS : 64, ords[t]);
    if (err != 0) return err;
  }
  const int kind = bias == nullptr ? 0 : (sbn == 0 || N == 1) ? 1 : 2;
  if (kind == 2) {
    if (sbm != 1) return (int)cudaErrorInvalidValue;
    const int err = sm90::make_bias_map(&maps[5], bias, B, H, N, M, sbb, 0, sbn, 64,
                                        &a.bias_flags);
    if (err != 0) return err;
  }
  const dim3 grid(T, H, B);
  int err = kind == 0   ? launch_bwd<0>(maps, a, grid, st)
            : kind == 1 ? launch_bwd<1>(maps, a, grid, st)
                        : launch_bwd<2>(maps, a, grid, st);
  if (err != 0 || T == 1) return err;
  const size_t n4 = (size_t)B * H * N * 16;
  dq_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      (const float*)dq_part, (bf16*)dq, T, B, H, N, s[15], s[16], s[17], scale);
  return (int)cudaGetLastError();
}
