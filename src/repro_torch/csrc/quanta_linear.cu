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
// simple one, the tiled GEMMs of tiled_gemm.cuh: bf16 on the tensor cores
// through nvcuda::wmma over 128 x 128 block tiles with shared-memory K
// tiles of 32, float32 a SIMT 64 x 64 tile.  No split-K for the 8-row
// decode case yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiled_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
// 128 x 128 block tiles, four warps along M by two along N, K steps of 32
using Tile = tiled::WmmaTile<4, 2, 2, 4, 1>;

// the epilogue adds the delta tile and stores once
__global__ void __launch_bounds__(256)
    gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ delta, bf16* __restrict__ out,
                     int M, int N, int K) {
  tiled::wmma_gemm<Tile>(x, w, M, N, K, [=](int r, int c, float v) {
    const size_t o = (size_t)r * N + c;
    out[o] = __float2bfloat16(v + __bfloat162float(delta[o]));
  });
}

__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ delta, float* __restrict__ out,
                    int M, int N, int K) {
  tiled::simt_gemm_f32(x, w, M, N, K, [=](int r, int c, float v) {
    const size_t o = (size_t)r * N + c;
    out[o] = v + delta[o];
  });
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
    dim3 grid((N + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM);
    gemm_bf16_kernel<<<grid, 256, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(delta), static_cast<bf16*>(out), M, N, K);
  } else if (dtype == 0) {
    dim3 grid((N + tiled::SIMT_BN - 1) / tiled::SIMT_BN,
              (M + tiled::SIMT_BM - 1) / tiled::SIMT_BM);
    gemm_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(delta), static_cast<float*>(out), M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
