// The float32 block-level GEMM shared by the port's kernels that end in a
// product with a dense weight: each block computes its 64 x 64 output tile
// of x (M, K) @ w (K, N), row-major and contiguous, with exact fp32 FMAs
// (TF32 would change the numbers) and hands every element inside the
// matrix to an epilogue functor epi(row, col, acc).  quanta_linear.cu adds
// the chain's delta there, banked_gather.cu each row's LoRA delta.  Their
// bf16 paths run on wgmma (wgmma_gemm.cuh).

#pragma once

#include <stdint.h>

namespace tiled {

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
