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
// never leaves fast memory; here it never leaves shared memory.
//   1. attn_heads_kernel, one block per (head, image), 8 warps. In chunks of
//      32 rows it computes LN(x) in fp32, rounds it to bf16 into shared
//      memory (common.cuh ln_rows_to_smem), and multiplies it by this head's
//      192 rows of Wqkv (WMMA, B fragments straight from Wqkv, L2 resident),
//      adds bqkv in fp32 and keeps q, k, v of the whole image in shared
//      memory as bf16 (3 x N x 64). Then each warp attends 16-query tiles
//      over the keys in steps of 64 with an online softmax (the body of
//      attention.cu: scale, then the key bias; a finite running max; P cast
//      to bf16 for P V), and writes its (16, 64) output into a bf16 (B, N, C)
//      scratch at this head's columns.
//   2. proj_residual_kernel: out = x + bf16(scratch @ Wproj^T + bproj), the
//      rows of a 64-row block staged in shared memory, 128-column WMMA tiles.
// Shared memory bounds N: 3 x N x 144 bytes of q/k/v plus the working area
// must fit in 227 KB (N <= 400 at C = 768); fourm_attn_block_fits says
// whether they do, for the wrapper and the routing (attention.attn_block_takes).
// A first version: no TMA, no wgmma; 768 blocks of 8 warps at one block per SM.
#include <float.h>

#include "common.cuh"

namespace fourm {

constexpr int AB_DH = 64;
constexpr int AB_THREADS = 256;   // 8 warps
constexpr int AB_RC = 32;         // rows per projection chunk
constexpr int AB_LD = AB_DH + 8;  // bf16 q/k/v and P row stride
constexpr int AB_BK = 64;         // keys per online-softmax step
constexpr int AB_LDS = AB_BK + 4; // fp32 score row stride
constexpr int AB_SMEM_MAX = 232448;

struct AttnBlockArgs {
  const bf16* x; const float* gamma; const float* beta;
  const bf16* wqkv; const float* bqkv;
  const float* bias;  // (B, N) additive key bias or null
  bf16* attn;         // (B, N, C) scratch
  int N, C; float eps, scale; int zero_attn;
};

inline size_t attn_heads_smem(int N, int C) {
  const size_t np = (size_t)(N + 15) / 16 * 16;
  const size_t proj = (size_t)AB_RC * (C + 8) * sizeof(bf16) + 8 * 256 * sizeof(float);
  const size_t attn = 8 * (16 * AB_LDS * sizeof(float) + 16 * AB_LD * sizeof(bf16));
  return 3 * np * AB_LD * sizeof(bf16) + (proj > attn ? proj : attn);
}

__global__ void __launch_bounds__(AB_THREADS, 1) attn_heads_kernel(AttnBlockArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.N, C = p.C;
  const int NP = (N + 15) / 16 * 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + (size_t)NP * AB_LD;
  bf16* vs = ks + (size_t)NP * AB_LD;
  unsigned char* work = reinterpret_cast<unsigned char*>(vs + (size_t)NP * AB_LD);

  // ---- q, k, v of this head for the whole image, into shared memory
  const int ldx = C + 8;
  bf16* xln = reinterpret_cast<bf16*>(work);
  float* stage = reinterpret_cast<float*>(work + (size_t)AB_RC * ldx * sizeof(bf16)) + warp * 256;
  const bf16* ximg = p.x + (size_t)b * N * C;
  const int rt = warp & 1;          // row tile of the chunk
  const int ct0 = (warp >> 1) * 3;  // first of this warp's 3 of the 12 column tiles
  const int sr = lane / 2, sc = (lane % 2) * 8;
  for (int r0 = 0; r0 < NP; r0 += AB_RC) {
    __syncthreads();  // every warp is done with the previous chunk
    ln_rows_to_smem(ximg, N, C, r0, AB_RC, p.gamma, p.beta, p.eps, xln, ldx);
    __syncthreads();
    if (r0 + rt * 16 >= NP) continue;  // warp-uniform: a row tile past the image
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xln + (size_t)(rt * 16) * ldx + k, ldx);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int ct = ct0 + j;
        const int wrow = (ct / 4) * C + h * AB_DH + (ct % 4) * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, p.wqkv + (size_t)wrow * C + k, C);
        wmma::mma_sync(acc[j], a, bw, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int ct = ct0 + j, part = ct / 4, col = (ct % 4) * 16 + sc;
      const int row = r0 + rt * 16 + sr;
      bf16* dst = (part == 0 ? qs : part == 1 ? ks : vs) + (size_t)row * AB_LD + col;
      const float* bq = p.bqkv != nullptr ? p.bqkv + part * C + h * AB_DH + col : nullptr;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float y = stage[sr * 16 + sc + i];
        if (bq != nullptr) y += bq[i];
        dst[i] = __float2bfloat16(row < N ? y : 0.f);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- attention: warp w takes the 16-query tiles w, w + 8, ...
  float* sw = reinterpret_cast<float*>(work) + warp * 16 * AB_LDS;
  bf16* pw = reinterpret_cast<bf16*>(work + (size_t)8 * 16 * AB_LDS * sizeof(float)) +
             warp * 16 * AB_LD;
  const int r = lane / 2, c0 = (lane % 2) * 32;
  const float* brow = p.bias != nullptr ? p.bias + (size_t)b * N : nullptr;
  for (int qt = warp; qt * 16 < NP; qt += 8) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[AB_DH / 16];
#pragma unroll
    for (int kk = 0; kk < AB_DH / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], qs + (size_t)(qt * 16) * AB_LD + kk * 16, AB_LD);
    float m_run = p.zero_attn ? 0.f : -FLT_MAX;  // finite start: never -inf - -inf
    float l_run = 0.f;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    for (int m0 = 0; m0 < N; m0 += AB_BK) {
      // S = Q K^T over the key tiles that exist (keys < NP)
#pragma unroll
      for (int j = 0; j < AB_BK / 16; ++j) {
        if (m0 + j * 16 >= NP) break;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
        wmma::fill_fragment(s, 0.f);
#pragma unroll
        for (int kk = 0; kk < AB_DH / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, ks + (size_t)(m0 + j * 16) * AB_LD + kk * 16, AB_LD);
          wmma::mma_sync(s, qa[kk], kf, s);
        }
        wmma::store_matrix_sync(sw + j * 16, s, AB_LDS, wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax over this thread's half row; keys past N take no weight
      float sv[32];
      float mx = -FLT_MAX;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = m0 + c0 + i;
        float s = 0.f;
        if (key < N) {
          s = sw[r * AB_LDS + c0 + i] * p.scale;
          if (brow != nullptr) s += brow[key];
          mx = fmaxf(mx, s);
        }
        sv[i] = s;
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = m0 + c0 + i;
        const float pv = key < N ? expf(sv[i] - m_new) : 0.f;
        lsum += pv;
        pw[r * AB_LD + c0 + i] = __float2bfloat16(pv);
      }
      l_run = l_run * alpha + lsum;
      m_run = m_new;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha;
      __syncwarp();

      // acc += P V
#pragma unroll
      for (int j = 0; j < AB_DH / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::fill_fragment(o, 0.f);
#pragma unroll
        for (int kk = 0; kk < AB_BK / 16; ++kk) {
          if (m0 + kk * 16 >= NP) break;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(pa, pw + kk * 16, AB_LD);
          wmma::load_matrix_sync(vf, vs + (size_t)(m0 + kk * 16) * AB_LD + j * 16, AB_LD);
          wmma::mma_sync(o, pa, vf, o);
        }
        wmma::store_matrix_sync(sw + j * 16, o, AB_LDS, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += sw[r * AB_LDS + c0 + i];
      __syncwarp();
    }

    float l_tot = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
    if (p.zero_attn) l_tot += expf(-m_run);  // softmax1: the implicit zero logit
    const float inv = 1.f / l_tot;
    const int n = qt * 16 + r;
    if (n < N) {
      bf16* dst = p.attn + ((size_t)b * N + n) * C + h * AB_DH + c0;
#pragma unroll
      for (int v8 = 0; v8 < 4; ++v8) {
        uint4 u;
        bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(acc[v8 * 8 + i] * inv);
        reinterpret_cast<uint4*>(dst)[v8] = u;
      }
    }
  }
}

constexpr int PR_BM = 64;
constexpr int PR_BN = 128;
constexpr int PR_LDC = PR_BN + 4;  // fp32 staging row stride

// out = x + bf16(a @ W^T + b) over M rows of C; W (C, C). A block stages its
// 64 rows of `a` in shared memory and sweeps 128-wide column tiles of W
// (8 warps, each 32 x 32 of WMMA accumulators), as ln_matmul.cu does.
__global__ void __launch_bounds__(AB_THREADS)
proj_residual_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                     const float* __restrict__ b, const bf16* __restrict__ x,
                     bf16* __restrict__ out, int M, int C, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + 8;
  bf16* as = reinterpret_cast<bf16*>(smem);
  float* cs = reinterpret_cast<float*>(smem + (size_t)PR_BM * lda * sizeof(bf16));
  const int row0 = blockIdx.x * PR_BM;
  const int nvec = C / 8;
  for (int v = threadIdx.x; v < PR_BM * nvec; v += AB_THREADS) {
    const int r = v / nvec, c = v % nvec;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row0 + r < M) u = reinterpret_cast<const uint4*>(a + (size_t)(row0 + r) * C)[c];
    reinterpret_cast<uint4*>(as + (size_t)r * lda)[c] = u;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int wr = warp / 4, wc = warp % 4;
  const int ntiles = C / PR_BN;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * PR_BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], as + (size_t)(wr * 32 + i * 16) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bm[j], w + (size_t)(col0 + wc * 32 + j * 16) * C + k, C);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bm[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (size_t)(wr * 32 + i * 16) * PR_LDC + wc * 32 + j * 16,
                                acc[i][j], PR_LDC, wmma::mem_row_major);
    __syncthreads();
    for (int v = threadIdx.x; v < PR_BM * PR_BN / 8; v += AB_THREADS) {
      const int r = v / (PR_BN / 8);
      const int c8 = (v % (PR_BN / 8)) * 8;
      const int row = row0 + r, col = col0 + c8;
      if (row < M) {
        const uint4 xu = *reinterpret_cast<const uint4*>(x + (size_t)row * C + col);
        const bf16* xe = reinterpret_cast<const bf16*>(&xu);
        uint4 u;
        bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float y = cs[r * PR_LDC + c8 + i];
          if (b != nullptr) y += b[col + i];
          e[i] = __float2bfloat16(__bfloat162float(xe[i]) + bf16_round(y));
        }
        *reinterpret_cast<uint4*>(out + (size_t)row * C + col) = u;
      }
    }
    __syncthreads();
  }
}

}  // namespace fourm

// 1 if attn_heads_kernel's shared memory holds N tokens of width C, else 0.
extern "C" int fourm_attn_block_fits(int N, int C) {
  return fourm::attn_heads_smem(N, C) <= (size_t)fourm::AB_SMEM_MAX ? 1 : 0;
}

// x (B, N, C) bf16; gamma, beta (C) fp32 (beta may be null); wqkv (3C, C) and
// wproj (C, C) bf16, nn.Linear layout; bqkv (3C), bproj (C) fp32 or null;
// bias (B, N) fp32 or null; attn (B, N, C) bf16 scratch; out (B, N, C) bf16.
// Head dim 64, C % 128 == 0. Returns cudaErrorInvalidValue for a shape it
// does not take.
extern "C" int fourm_attn_block(const void* x, const void* gamma, const void* beta,
                                const void* wqkv, const void* bqkv, const void* wproj,
                                const void* bproj, const void* bias, void* attn, void* out,
                                int B, int N, int C, int H, float eps, float scale,
                                int zero_attn, void* stream) {
  using namespace fourm;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = attn_heads_smem(N, C);
  if (H * AB_DH != C || C % PR_BN != 0 || smem > AB_SMEM_MAX) return (int)cudaErrorInvalidValue;
  AttnBlockArgs a;
  a.x = (const bf16*)x; a.gamma = (const float*)gamma; a.beta = (const float*)beta;
  a.wqkv = (const bf16*)wqkv; a.bqkv = (const float*)bqkv; a.bias = (const float*)bias;
  a.attn = (bf16*)attn; a.N = N; a.C = C; a.eps = eps; a.scale = scale; a.zero_attn = zero_attn;
  cudaError_t err = cudaFuncSetAttribute(attn_heads_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_heads_kernel<<<dim3(H, B), AB_THREADS, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int M = B * N;
  const size_t psmem = (size_t)PR_BM * (C + 8) * sizeof(bf16) + (size_t)PR_BM * PR_LDC * sizeof(float);
  err = cudaFuncSetAttribute(proj_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)psmem);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (M + PR_BM - 1) / PR_BM;
  const int ntiles = C / PR_BN;
  int splits = (2 * num_sms() + row_blocks - 1) / row_blocks;
  splits = max(1, min(splits, ntiles));
  const int per = (ntiles + splits - 1) / splits;
  splits = (ntiles + per - 1) / per;
  proj_residual_kernel<<<dim3(row_blocks, splits), AB_THREADS, psmem, s>>>(
      (const bf16*)attn, (const bf16*)wproj, (const float*)bproj, (const bf16*)x, (bf16*)out,
      M, C, per);
  return (int)cudaGetLastError();
}
