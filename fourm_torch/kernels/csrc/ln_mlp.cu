// ln_mlp: out = x + fc2(act(fc1(LN(x)))), act = SwiGLU silu(g) * u with
// u = fc3(LN x), or exact-erf GELU. bf16 in and out, fp32 LN statistics,
// fp32 accumulation, bf16 hidden activation.
//
// Replaces: fourm_tpu/kernels/fused_mlp.py:pallas_ln_mlp (the MLP half of
// every encoder and decoder block).
//
// What bounds it on an H100: operations. SwiGLU at M = 16*2048 rows,
// D = 768, HID = 2048 does 3*2*M*D*HID = 309 GFLOP against
// (2*M*D + 3*D*HID)*2 = 110 MB, far above the ~295 FLOP/byte ridge.
//
// Design: one kernel. A block owns BM rows: 32 at D <= 1024, 16 at D =
// 2048. Their LayerNorm goes once into shared memory as bf16 (48 KB at
// D = 768, 64 KB at D = 2048). The hidden dimension is walked in chunks of
// HC = 64 (32 rows) or 128 (16 rows): the 8 warps compute the BM x HC chunk
// of fc1 (and fc3) with WMMA, one 16 x 16 block each, apply bias and
// activation through a per-warp fp32 staging tile, and write the bf16 chunk
// to shared memory; then every warp adds that chunk's contribution to its
// BM x D/8 slice of fc2, which stays in WMMA accumulators (registers) for
// the whole walk: 128 fp32 per thread at both block heights (32 rows x 128
// columns at D = 1024, 16 x 256 at D = 2048; 32 x 256 would not fit the
// register file). So neither the LN output nor the hidden activation
// touches device memory. Weight fragments are read straight from W1/W3
// (HID, D) and W2 (D, HID), nn.Linear layout, which stay L2 resident (9.4
// MB at 4M-B; 67 MB at 4M-XL, above the 50 MB L2). The epilogue adds b2,
// rounds the branch to bf16 and adds the residual, as the TPU kernel does.
//
// A hidden width that is not a multiple of HC (SwiGLU's int(2 * 4D / 3):
// 2730 at 4M-L, 5461 at 4M-XL) takes the RAGGED variant, built for gated
// MLPs at D = 1024 and 2048, the widths that need it. Its last chunk is
// predicated: a 16-unit block past HID is zero, and one that straddles HID
// reads W1/W3 rows [HID - 16, HID) (all inside the matrix) and keeps only
// its own units, writing 0 for the rest. W2's rows are then HID long, so
// they are not 16-byte aligned and WMMA cannot read them in place (it needs
// 32-byte aligned tiles and a stride that is a multiple of 8): each warp
// stages its D/8 rows of the chunk's 16 hidden columns in shared memory
// (aligned 4-byte loads, realigned with byte permutes when a row starts on
// an odd element; element loads with zero fill past HID), then multiplies
// from there. The padded units contribute exactly 0 (a zero activation
// times a zero weight), and the module's parameters keep their shapes.
// A first version: no TMA, no wgmma, no pipelining; each block re-reads
// the weights from L2.
#include "common.cuh"

namespace fourm {

constexpr int MLP_THREADS = 256;  // 8 warps
constexpr int MLP_LDB = 24;       // staged W2 tile: bf16 stride of one output column

template <int RB> struct MlpShape {
  static constexpr int BM = 16 * RB;       // rows per block
  static constexpr int HC = 128 / RB;      // hidden chunk: 8 blocks of 16 x 16
  static constexpr int HB = HC / 16;       // 16-unit hidden blocks per chunk
  static constexpr int LDH = HC + 8;       // bf16 hidden chunk row stride
};

// Stage W2[o0 + n][j .. j + 16) for n < NR into dst (col-major 16 x NR tile,
// column stride MLP_LDB), one row per lane and pass; elements at or past
// HID are zero. W2 is (D, HID) row-major with HID not a multiple of 8.
template <int NR>
__device__ __forceinline__ void stage_w2(const bf16* __restrict__ w2, int HID, int o0, int j,
                                         bf16* dst) {
  const int lane = threadIdx.x % 32;
  const bool tail = j + 16 >= HID;  // the words past a row's last element may lie past W2
#pragma unroll 2
  for (int n = lane; n < NR; n += 32) {
    const size_t e = (size_t)(o0 + n) * HID + j;
    uint32_t out[8];
    if (tail) {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(w2 + e);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t lo = j + 2 * i < HID ? src[2 * i] : 0u;
        const uint32_t hi = j + 2 * i + 1 < HID ? src[2 * i + 1] : 0u;
        out[i] = lo | (hi << 16);
      }
    } else if ((e & 1) == 0) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(w2 + e);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = __ldg(src + i);
    } else {  // odd start: 9 aligned words cover elements e - 1 .. e + 16
      const uint32_t* src = reinterpret_cast<const uint32_t*>(w2 + e - 1);
      uint32_t w[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) w[i] = __ldg(src + i);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = __byte_perm(w[i], w[i + 1], 0x5432);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + (size_t)n * MLP_LDB);
    d[0] = make_uint4(out[0], out[1], out[2], out[3]);
    d[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

template <int NCB, int RB, bool GATED, bool RAGGED>
__global__ void __launch_bounds__(MLP_THREADS, 1)
ln_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w3,
              const float* __restrict__ b3, const bf16* __restrict__ w2,
              const float* __restrict__ b2, bf16* __restrict__ out, int M,
              int HID, float eps) {
  using S = MlpShape<RB>;
  constexpr int D = NCB * 128;  // each warp owns D/8 = 16*NCB output columns
  constexpr int LDX = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + (size_t)S::BM * LDX;
  float* stage = reinterpret_cast<float*>(hs + (size_t)S::BM * S::LDH);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* gst = stage + warp * 2 * 256;  // this warp's two 16x16 fp32 tiles
  float* ust = gst + 256;
  // RAGGED: this warp's staged W2 tile, after the 8 warps' fp32 tiles
  bf16* w2s = reinterpret_cast<bf16*>(stage + 8 * 2 * 256) + (size_t)warp * (D / 8) * MLP_LDB;
  const int row0 = blockIdx.x * S::BM;

  ln_rows_to_smem(x, M, D, row0, S::BM, gamma, beta, eps, xs, LDX);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RB][NCB];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < NCB; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int rb = warp / S::HB;  // fc1 row block of this warp
  const int hb = warp % S::HB;  // fc1 hidden block of this warp
  const int sr = lane / 2, sc = (lane % 2) * 8;  // staging element slice

  for (int j0 = 0; j0 < HID; j0 += S::HC) {
    // ---- fc1 (and fc3): the 16x16 block (rb, hb) of the BM x HC chunk
    const int hj = j0 + hb * 16;
    // RAGGED: a block straddling HID reads W1/W3 rows [HID - 16, HID) and
    // keeps its own units (column c of the block is unit hj + c, found at
    // column c + off of the product); a block past HID is all zero
    const bool live = !RAGGED || hj < HID;
    const int base = RAGGED ? min(hj, HID - 16) : hj;
    const int off = hj - base;
    if (live) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> g, u;
      wmma::fill_fragment(g, 0.f);
      if (GATED) wmma::fill_fragment(u, 0.f);
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(a, xs + (size_t)(rb * 16) * LDX + k, LDX);
        wmma::load_matrix_sync(bw, w1 + (size_t)base * D + k, D);
        wmma::mma_sync(g, a, bw, g);
        if (GATED) {
          wmma::load_matrix_sync(bw, w3 + (size_t)base * D + k, D);
          wmma::mma_sync(u, a, bw, u);
        }
      }
      wmma::store_matrix_sync(gst, g, 16, wmma::mem_row_major);
      if (GATED) wmma::store_matrix_sync(ust, u, 16, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = sc + i;
      float h = 0.f;
      if (live && (!RAGGED || hj + c < HID)) {
        float gv = gst[sr * 16 + c + off];
        if (b1 != nullptr) gv += b1[hj + c];
        if (GATED) {
          float uv = ust[sr * 16 + c + off];
          if (b3 != nullptr) uv += b3[hj + c];
          h = gv * (1.f / (1.f + expf(-gv))) * uv;  // silu(g) * u
        } else {
          h = 0.5f * gv * (1.f + erff(gv * 0.70710678118654752f));  // exact GELU
        }
      }
      hs[(size_t)(rb * 16 + sr) * S::LDH + hb * 16 + c] = __float2bfloat16(h);
    }
    __syncthreads();

    // ---- fc2: acc[:, cols of this warp] += h_chunk @ W2[cols, chunk]^T
#pragma unroll
    for (int kk = 0; kk < S::HC; kk += 16) {
      if (RAGGED && j0 + kk >= HID) break;  // the rest of the chunk is padding
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        wmma::load_matrix_sync(a[i], hs + (size_t)(i * 16) * S::LDH + kk, S::LDH);
      if (RAGGED) {
        __syncwarp();  // the previous step's reads of w2s are done
        stage_w2<D / 8>(w2, HID, warp * (D / 8), j0 + kk, w2s);
        __syncwarp();
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        if (RAGGED) {
          wmma::load_matrix_sync(bw, w2s + (size_t)(cb * 16) * MLP_LDB, MLP_LDB);
        } else {
          const int o0 = warp * (D / 8) + cb * 16;
          wmma::load_matrix_sync(bw, w2 + (size_t)o0 * HID + j0 + kk, HID);
        }
#pragma unroll
        for (int i = 0; i < RB; ++i) wmma::mma_sync(acc[i][cb], a[i], bw, acc[i][cb]);
      }
    }
    __syncthreads();  // hs is rewritten by the next chunk
  }

  // ---- epilogue: out = x + bf16(acc + b2)
#pragma unroll
  for (int i = 0; i < RB; ++i) {
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      wmma::store_matrix_sync(gst, acc[i][cb], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = row0 + i * 16 + sr;
      const int col = warp * (D / 8) + cb * 16 + sc;
      if (row < M) {
        const uint4 xu = *reinterpret_cast<const uint4*>(x + (size_t)row * D + col);
        const bf16* xe = reinterpret_cast<const bf16*>(&xu);
        uint4 ou;
        bf16* oe = reinterpret_cast<bf16*>(&ou);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float y = gst[sr * 16 + sc + e];
          if (b2 != nullptr) y += b2[col + e];
          const float branch = __bfloat162float(__float2bfloat16(y));
          oe[e] = __float2bfloat16(__bfloat162float(xe[e]) + branch);
        }
        *reinterpret_cast<uint4*>(out + (size_t)row * D + col) = ou;
      }
      __syncwarp();
    }
  }
}

template <int NCB, int RB, bool GATED, bool RAGGED>
int launch_ln_mlp(const void* x, const void* gamma, const void* beta, const void* w1,
                  const void* b1, const void* w3, const void* b3, const void* w2,
                  const void* b2, void* out, int M, int HID, float eps,
                  cudaStream_t stream) {
  using S = MlpShape<RB>;
  constexpr int D = NCB * 128;
  const size_t smem = (size_t)S::BM * (D + 8) * sizeof(bf16) +
                      (size_t)S::BM * S::LDH * sizeof(bf16) +
                      (size_t)8 * 2 * 256 * sizeof(float) +
                      (RAGGED ? (size_t)D * MLP_LDB * sizeof(bf16) : 0);
  auto kern = ln_mlp_kernel<NCB, RB, GATED, RAGGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + S::BM - 1) / S::BM;
  kern<<<blocks, MLP_THREADS, smem, stream>>>(
      (const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)w1,
      (const float*)b1, (const bf16*)w3, (const float*)b3, (const bf16*)w2,
      (const float*)b2, (bf16*)out, M, HID, eps);
  return (int)cudaGetLastError();
}

// The RAGGED variant is built only where a configuration needs it: gated
// MLPs at D = 1024 and 2048 (SwiGLU at 4M-L and 4M-XL).
template <int NCB, int RB>
int launch_width(int gated, int HID, const void* x, const void* gamma, const void* beta,
                 const void* w1, const void* b1, const void* w3, const void* b3, const void* w2,
                 const void* b2, void* out, int M, float eps, cudaStream_t s) {
#define FOURM_MLP_LAUNCH(G, R) \
  launch_ln_mlp<NCB, RB, G, R>(x, gamma, beta, w1, b1, w3, b3, w2, b2, out, M, HID, eps, s)
  if (HID % MlpShape<RB>::HC == 0)
    return gated ? FOURM_MLP_LAUNCH(true, false) : FOURM_MLP_LAUNCH(false, false);
  if constexpr (NCB >= 8) {
    if (gated) return FOURM_MLP_LAUNCH(true, true);
  }
  return (int)cudaErrorInvalidValue;
#undef FOURM_MLP_LAUNCH
}

}  // namespace fourm

// Returns cudaErrorInvalidValue for a width it was not built for: D must be
// 256, 512, 768, 1024 or 2048, and HID a multiple of the hidden chunk (64;
// 128 at D = 2048), or any HID >= 16 for a gated MLP at D = 1024 or 2048.
extern "C" int fourm_ln_mlp(const void* x, const void* gamma, const void* beta,
                            const void* w1, const void* b1, const void* w3,
                            const void* b3, const void* w2, const void* b2,
                            void* out, int M, int D, int HID, int gated, float eps,
                            void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
  if (HID < 16) return (int)cudaErrorInvalidValue;
#define FOURM_MLP_CASE(ncb, rb)                                                         \
  if (D == ncb * 128)                                                                   \
    return launch_width<ncb, rb>(gated, HID, x, gamma, beta, w1, b1, w3, b3, w2, b2, out, \
                                 M, eps, s);
  FOURM_MLP_CASE(2, 2)
  FOURM_MLP_CASE(4, 2)
  FOURM_MLP_CASE(6, 2)
  FOURM_MLP_CASE(8, 2)
  FOURM_MLP_CASE(16, 1)
#undef FOURM_MLP_CASE
  return (int)cudaErrorInvalidValue;
}
