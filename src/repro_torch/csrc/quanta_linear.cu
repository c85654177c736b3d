// The base product of the adapted linear y = x @ W + chain(x), for Hopper
// (sm_90a), with the QuanTA delta added in its epilogue.
//
// Replaces the TPU kernel repro/kernels/quanta_linear.py
// (quanta_linear_kernel_call, body _kernel).
//
// The TPU kernel walks a (row-block, column-block) grid in order and keeps
// the chain of a row block in an fp32 (Br, d_out) scratch from column step
// 0 to the last.  Hopper blocks run in no fixed order, so nothing can be
// carried across column tiles.  The port runs in two phases inside one
// wrapper (kernels/quanta_linear.py):
//   (a) the quanta_apply kernel writes the chain of every row once to a
//       (rows, d_out) buffer in the activation dtype -- chain FLOPs are not
//       duplicated across column tiles, as in the TPU design;
//   (b) this file's tiled GEMM computes x @ W with fp32 accumulators and
//       adds the delta tile in its epilogue before a single store.
// The TPU's chain output is already rounded to the activation dtype before
// it enters the fp32 scratch, so keeping the delta in that dtype loses
// nothing.
//
// What bounds it on the H100: at prefill (thousands of rows) the tensor
// cores (989 TFLOP/s bf16); at decode (8 rows) reading W (32 MB for a
// 4096 x 4096 bf16 projection) at 3.35 TB/s.  The design here is the
// simple one: bf16 runs on the tensor cores through nvcuda::wmma
// (mma.sync 16x16x16, fp32 accumulators) over 128 x 128 block tiles with
// shared-memory K tiles of 32; float32 runs a SIMT 64 x 64 tile with
// exact fp32 FMAs (TF32 would change the numbers).  No cp.async, TMA or
// wgmma yet, and no split-K for the 8-row decode case: those are for the
// PRs that make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ---------------------------------------------------------------- bf16
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int APAD = 8, BPAD = 8;

__global__ void __launch_bounds__(256)
    gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ delta, bf16* __restrict__ out,
                     int M, int N, int K) {
  __shared__ __align__(32) bf16 As[BM][BK + APAD];
  __shared__ __align__(32) bf16 Bs[BK][BN + BPAD];
  __shared__ __align__(32) float Cs[8][16 * 16];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1;  // 4 warps along M: rows wm*32 .. +31
  const int wn = warp & 1;   // 2 warps along N: cols wn*64 .. +63
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK as 16-byte vectors (K % 8 == 0 is checked by the
    // wrapper, so a vector is wholly inside or outside the matrix)
    for (int v = threadIdx.x; v < BM * BK / 8; v += 256) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < M && gc < K)
        val = *reinterpret_cast<const uint4*>(x + (size_t)gr * K + gc);
      *reinterpret_cast<uint4*>(&As[r][c]) = val;
    }
    for (int v = threadIdx.x; v < BK * BN / 8; v += 256) {
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      const int gr = k0 + r, gc = n0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < K && gc < N)
        val = *reinterpret_cast<const uint4*>(w + (size_t)gr * N + gc);
      *reinterpret_cast<uint4*>(&Bs[r][c]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], BK + APAD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * 64 + j * 16], BN + BPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fp32 fragment at a time, adds the
  // delta and stores once in bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = m0 + wm * 32 + i * 16 + e / 16;
        const int gc = n0 + wn * 64 + j * 16 + e % 16;
        if (gr < M && gc < N) {
          const size_t o = (size_t)gr * N + gc;
          out[o] = __float2bfloat16(Cs[warp][e] + __bfloat162float(delta[o]));
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------- float32
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ delta, float* __restrict__ out,
                    int M, int N, int K) {
  __shared__ float As[FK][FM + 4];
  __shared__ float Bs[FK][FN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int e = threadIdx.x; e < FM * FK; e += 256) {
      const int r = e / FK, c = e % FK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? x[(size_t)gr * K + gc] : 0.f;
    }
    for (int e = threadIdx.x; e < FK * FN; e += 256) {
      const int r = e / FN, c = e % FN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < K && gc < N) ? w[(size_t)gr * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
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
      if (gr < M && gc < N) {
        const size_t o = (size_t)gr * N + gc;
        out[o] = acc[i][j] + delta[o];
      }
    }
  }
}

}  // namespace

// out (M, N) = x (M, K) @ w (K, N) + delta (M, N), all row-major and
// contiguous in one dtype (0 float32, 1 bfloat16; bf16 needs K % 8 == 0,
// N % 8 == 0 and 16-byte aligned x and w).  Returns the cudaError_t of
// the launch.
extern "C" int quanta_linear_gemm_launch(int dtype, const void* x,
                                         const void* w, const void* delta,
                                         void* out, int M, int N, int K,
                                         void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_bf16_kernel<<<grid, 256, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(delta), static_cast<bf16*>(out), M, N, K);
  } else if (dtype == 0) {
    dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    gemm_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(delta), static_cast<float*>(out), M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
