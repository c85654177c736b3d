// Block-level tiled GEMMs shared by the port's kernels that end in a
// product with a dense weight: each block computes its output tile of
// x (M, K) @ w (K, N), row-major and contiguous, with fp32 accumulators and
// hands every element inside the matrix to an epilogue functor
// epi(row, col, acc).  quanta_linear.cu adds the chain's delta there,
// banked_gather.cu the rounded base plus each row's LoRA delta.
//
// bf16: nvcuda::wmma (mma.sync 16x16x16) over shared-memory K tiles
// loaded as 16-byte vectors (K % 8 == 0 and N % 8 == 0, x and w 16-byte
// aligned); eight warps, WM x WN of them over the tile with FM x FN
// fragments each and KS of them over each K step, whose sums are added in a
// fixed order.  float32: a SIMT 64 x 64 tile of exact fp32 FMAs (TF32
// would change the numbers).  No cp.async, TMA or wgmma yet: those are for
// the PRs that make these kernels fast.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace tiled {

using bf16 = __nv_bfloat16;

template <int WM_, int WN_, int FM_, int FN_, int KS_>
struct WmmaTile {
  static_assert(WM_ * WN_ * KS_ == 8, "eight warps");
  static constexpr int WM = WM_, WN = WN_, FM = FM_, FN = FN_, KS = KS_;
  static constexpr int BM = 16 * WM * FM, BN = 16 * WN * FN;
  static constexpr int BKW = 32, BK = BKW * KS, PAD = 8;
};

// The block (blockIdx.y, blockIdx.x) tile of x @ w, 256 threads.
template <typename T, typename Epi>
__device__ __forceinline__ void wmma_gemm(const bf16* __restrict__ x,
                                          const bf16* __restrict__ w, int M,
                                          int N, int K, Epi epi) {
  using namespace nvcuda;
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, BKW = T::BKW;
  constexpr int PAD = T::PAD, WM = T::WM, WN = T::WN, FM = T::FM,
                FN = T::FN, KS = T::KS;
  __shared__ __align__(32) bf16 As[BM][BK + PAD];
  __shared__ __align__(32) bf16 Bs[BK][BN + PAD];
  __shared__ __align__(32) float Cs[8][16 * 16];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ks = warp / (WM * WN), wm = (warp % (WM * WN)) / WN,
            wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // a 16-byte vector lies wholly inside or outside the matrix
    for (int v = threadIdx.x; v < BM * BK / 8; v += 256) {
      const int rr = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int gr = m0 + rr, gc = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < M && gc < K)
        val = *reinterpret_cast<const uint4*>(x + (size_t)gr * K + gc);
      *reinterpret_cast<uint4*>(&As[rr][c]) = val;
    }
    for (int v = threadIdx.x; v < BK * BN / 8; v += 256) {
      const int rr = v / (BN / 8), c = (v % (BN / 8)) * 8;
      const int gr = k0 + rr, gc = n0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < K && gc < N)
        val = *reinterpret_cast<const uint4*>(w + (size_t)gr * N + gc);
      *reinterpret_cast<uint4*>(&Bs[rr][c]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKW; kk += 16) {
      const int kc = ks * BKW + kk;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * FM + i) * 16][kc], BK + PAD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kc][(wn * FN + j) * 16], BN + PAD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // one fragment at a time: every warp stages its fp32 fragment, the
  // first K slice adds the others and calls the epilogue per element
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncthreads();
      if (ks == 0) {
        for (int e = lane; e < 256; e += 32) {
          float v = Cs[warp][e];
#pragma unroll
          for (int s = 1; s < KS; ++s) v += Cs[s * WM * WN + warp][e];
          const int gr = m0 + (wm * FM + i) * 16 + e / 16;
          const int gc = n0 + (wn * FN + j) * 16 + e % 16;
          if (gr < M && gc < N) epi(gr, gc, v);
        }
      }
      __syncthreads();
    }
  }
}

constexpr int SIMT_BM = 64, SIMT_BN = 64, SIMT_BK = 16;

// The block (blockIdx.y, blockIdx.x) tile of x @ w in float32, 256
// threads.
template <typename Epi>
__device__ __forceinline__ void simt_gemm_f32(const float* __restrict__ x,
                                              const float* __restrict__ w,
                                              int M, int N, int K, Epi epi) {
  __shared__ float As[SIMT_BK][SIMT_BM + 4];
  __shared__ float Bs[SIMT_BK][SIMT_BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * SIMT_BM, n0 = blockIdx.x * SIMT_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SIMT_BK) {
    for (int e = threadIdx.x; e < SIMT_BM * SIMT_BK; e += 256) {
      const int r = e / SIMT_BK, c = e % SIMT_BK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? x[(size_t)gr * K + gc] : 0.f;
    }
    for (int e = threadIdx.x; e < SIMT_BK * SIMT_BN; e += 256) {
      const int r = e / SIMT_BN, c = e % SIMT_BN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < K && gc < N) ? w[(size_t)gr * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SIMT_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty + 16 * i, gc = n0 + tx + 16 * j;
      if (gr < M && gc < N) epi(gr, gc, acc[i][j]);
    }
  }
}

}  // namespace tiled
