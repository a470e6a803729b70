// ln_matmul: out = LN(x) @ W^T + b, bf16 in and out, fp32 LN statistics and
// fp32 accumulation.
//
// Replaces: fourm_tpu/kernels/fused_mlp.py:pallas_ln_matmul (the pre-norm
// LN -> QKV projection of every encoder and decoder self-attention).
//
// What bounds it on an H100: operations. At the main path's encoder shape
// (M = 16*2048 rows, D = 768, F = 2304) it does 2*M*D*F = 116 GFLOP against
// (M*D + D*F + M*F)*2 = 205 MB, about 565 FLOP/byte, above the card's ~295
// bf16 FLOP/byte ridge.
//
// Design: a block owns BM = 64 rows (D <= 1536) or 32 (D = 2048, 4M-XL's
// width: 64 LN rows of 2056 bf16 and the fp32 tile would need 297 KB of
// the 227 KB a block may have). It computes their LayerNorm once, in fp32,
// into shared memory as bf16 (64 x 768 x 2 = 96 KB; 32 x 2048 x 2 = 128
// KB; padded rows against bank conflicts), so the normalised rows never go
// to device memory. It then sweeps column tiles of W, 128 wide at 64 rows
// and 256 wide at 32: 8 warps, each a 32 x 32 block of WMMA accumulators,
// A fragments from shared memory, B fragments straight from W (nn.Linear
// layout (F, D), read as a column-major D x F operand, L2 resident). The
// epilogue stages fp32 sums in shared memory, adds the fp32 bias and writes
// bf16 in 16-byte vectors. When there are too few row blocks to fill the
// card (decoder shapes: 16*196 rows), the column tiles are split over
// gridDim.y and each split recomputes its rows' LN.
// A first version: no TMA, no wgmma, no pipelining.
#include "common.cuh"

namespace fourm {

constexpr int LM_THREADS = 256;
constexpr int LM_WIDE_D = 1536;  // widest D that 64-row blocks hold

// BM rows per block; 8 warps of 32 x 32 accumulators, WR = BM / 32 of them
// down the rows, so the column tile is LM_BN = 32 * 8 / WR wide
template <int BM>
__global__ void __launch_bounds__(LM_THREADS)
ln_matmul_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const bf16* __restrict__ w,
                 const float* __restrict__ b, bf16* __restrict__ out, int M,
                 int D, int F, float eps, int tiles_per_split) {
  constexpr int LM_BM = BM;
  constexpr int WC = 8 / (BM / 32);  // warps across the column tile
  constexpr int LM_BN = 32 * WC;
  constexpr int LM_LDC = LM_BN + 4;  // fp32 staging row stride
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = D + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* cs = reinterpret_cast<float*>(smem + (size_t)LM_BM * ldx * sizeof(bf16));

  const int row0 = blockIdx.x * LM_BM;
  ln_rows_to_smem(x, M, D, row0, LM_BM, gamma, beta, eps, xs, ldx);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int wr = warp / WC;  // rows wr*32 .. +32
  const int wc = warp % WC;  // cols wc*32 .. +32 of the tile
  const int ntiles = (F + LM_BN - 1) / LM_BN;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);

  for (int t = t0; t < t1; ++t) {
    const int col0 = t * LM_BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (size_t)(wr * 32 + i * 16) * ldx + k, ldx);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = col0 + wc * 32 + j * 16;
        if (c < F)  // F % 16 == 0: a fragment is all in or all out
          wmma::load_matrix_sync(bm[j], w + (size_t)c * D + k, D);
        else
          wmma::fill_fragment(bm[j], __float2bfloat16(0.f));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bm[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (size_t)(wr * 32 + i * 16) * LM_LDC + wc * 32 + j * 16,
                                acc[i][j], LM_LDC, wmma::mem_row_major);
    __syncthreads();
    for (int v = threadIdx.x; v < LM_BM * LM_BN / 8; v += LM_THREADS) {
      const int r = v / (LM_BN / 8);
      const int c8 = (v % (LM_BN / 8)) * 8;
      const int row = row0 + r, col = col0 + c8;
      if (row < M && col < F) {
        uint4 u;
        bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float y = cs[r * LM_LDC + c8 + i];
          if (b != nullptr) y += b[col + i];
          e[i] = __float2bfloat16(y);
        }
        *reinterpret_cast<uint4*>(out + (size_t)row * F + col) = u;
      }
    }
    __syncthreads();
  }
}

template <int BM>
int launch_ln_matmul(const void* x, const void* gamma, const void* beta, const void* w,
                     const void* b, void* out, int M, int D, int F, float eps,
                     cudaStream_t stream) {
  constexpr int BN = 32 * 8 / (BM / 32);
  const size_t smem = (size_t)BM * (D + 8) * sizeof(bf16) + (size_t)BM * (BN + 4) * sizeof(float);
  auto kern = ln_matmul_kernel<BM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (M + BM - 1) / BM;
  const int ntiles = (F + BN - 1) / BN;
  int splits = (2 * num_sms() + row_blocks - 1) / row_blocks;
  splits = max(1, min(splits, ntiles));
  const int per = (ntiles + splits - 1) / splits;
  splits = (ntiles + per - 1) / per;
  dim3 grid(row_blocks, splits);
  kern<<<grid, LM_THREADS, smem, stream>>>(
      (const bf16*)x, (const float*)gamma, (const float*)beta, (const bf16*)w,
      (const float*)b, (bf16*)out, M, D, F, eps, per);
  return (int)cudaGetLastError();
}

}  // namespace fourm

// D % 16 == 0 and D <= 2048; F % 16 == 0.
extern "C" int fourm_ln_matmul(const void* x, const void* gamma, const void* beta,
                               const void* w, const void* b, void* out, int M,
                               int D, int F, float eps, void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= LM_WIDE_D) return launch_ln_matmul<64>(x, gamma, beta, w, b, out, M, D, F, eps, s);
  return launch_ln_matmul<32>(x, gamma, beta, w, b, out, M, D, F, eps, s);
}
