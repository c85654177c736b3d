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
//   (b) this file computes x @ W with fp32 accumulators and adds the delta
//       before a single rounding: out = round(acc + float(delta)).
// The TPU's chain output is already rounded to the activation dtype before
// it enters the fp32 scratch, so keeping the delta in that dtype loses
// nothing.  On a column-parallel shard (tensor parallelism over `model`)
// W holds N of the chain's ldd output columns, from column dcol: (b)
// reads delta[row * ldd + dcol + col] in place, and no copy is made.
//
// What bounds (b) on the H100: at prefill (3072 rows of 4096 -> 4096) the
// tensor cores, 2 * 3072 * 4096 * 4096 operations; at decode (8 rows)
// reading W, 32 MiB of bf16, at 3.35 TB/s.  The bf16 bodies
// (kernels/smem.py quanta_linear_plan picks one by rows):
//   * more than 64 rows: wg::gemm_tile<256> (wgmma_gemm.cuh), 128 x 256
//     tiles fed by a TMA ring, one block an SM; the epilogue adds each
//     accumulator's delta read from device memory and stores bf16 pairs;
//   * at most 64 rows (a decode tick): wg::decode_partials streams W over
//     every SM with K split so that each SM holds four blocks, writing
//     fp32 partials to a scratch; a second pass adds the splits in split
//     order plus the delta and rounds once.
// float32 keeps a SIMT 64 x 64 tile of exact fp32 FMAs (tiled_gemm.cuh):
// TF32 would change the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "geometry.cuh"
#include "tiled_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPrefillBN = 256;   // columns of a prefill tile

// bf16, more than 64 rows: the wgmma mainloop, then out = acc + delta
// rounded once, stored as bf16 pairs (N % 8 == 0: a pair never straddles
// the edge)
__global__ void __launch_bounds__(wg::kGemmThreads, 1)
    ql_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw,
                    const bf16* __restrict__ delta, bf16* __restrict__ out,
                    int M, int N, int K, int ldd, int dcol) {
  extern __shared__ uint8_t ql_smem[];
  wg::gemm_tile<kPrefillBN>(
      &tmx, &tmw, K, ql_smem,
      [&](float (&acc)[kPrefillBN / 128][64], uint8_t*, int m0, int n0) {
        const int t = threadIdx.x, lane = t & 31;
        const int r0 = m0 + 64 * (t >> 7) + 16 * ((t >> 5) & 3) + (lane >> 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row >= M) continue;
#pragma unroll
          for (int j = 0; j < kPrefillBN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * (lane & 3);
            if (col >= N) continue;
            const size_t o = (size_t)row * N + col;
            const float2 d = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    delta + (size_t)row * ldd + dcol + col));
            *reinterpret_cast<uint32_t*>(out + o) = sm90::pack_bf16(
                acc[j / 16][4 * (j % 16) + 2 * h] + d.x,
                acc[j / 16][4 * (j % 16) + 2 * h + 1] + d.y);
          }
        }
      });
}

// bf16, at most 64 rows: the fp32 partials of one K split
template <int RN>
__global__ void __launch_bounds__(wg::kDecThreads, wg::kDecBlocksPerSm)
    ql_partials_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmw,
                       float* __restrict__ part, int M, int N, int K,
                       int steps_per_split) {
  extern __shared__ uint8_t ql_dec_smem[];
  wg::decode_partials<RN>(&tmx, &tmw, part, M, N, K, steps_per_split,
                          ql_dec_smem);
}

// the decode body's second pass: out = the splits' partials added in
// split order, plus the delta, rounded once
__global__ void __launch_bounds__(256)
    ql_sum_kernel(const float* __restrict__ part, int splits,
                  const bf16* __restrict__ delta, bf16* __restrict__ out,
                  int N, int MN, int ldd, int dcol) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= MN) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += part[(size_t)z * MN + e];
  const size_t d = (size_t)(e / N) * ldd + dcol + e % N;
  out[e] = __float2bfloat16(v + __bfloat162float(delta[d]));
}

__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ delta, float* __restrict__ out,
                    int M, int N, int K, int ldd, int dcol) {
  tiled::simt_gemm_f32(x, w, M, N, K, [=](int r, int c, float v) {
    out[(size_t)r * N + c] = v + delta[(size_t)r * ldd + dcol + c];
  });
}

int launch_prefill(const geom::Launch& l, const bf16* x, const bf16* w,
                   const bf16* delta, bf16* out, int M, int N, int K, int ldd,
                   int dcol, int smem_limit, cudaStream_t s) {
  static int granted[wg::kMaxDevices] = {};
  int err = wg::allow_smem(ql_wgmma_kernel, l.smem, smem_limit, granted);
  if (err) return err;
  CUtensorMap tmx, tmw;
  if ((err = wg::tensor_map(&tmx, x, M, K, wg::kGemmBM, 64)) ||
      (err = wg::tensor_map(&tmw, w, K, N, 64, 64)))
    return err;
  ql_wgmma_kernel<<<l.grid, l.threads, l.smem, s>>>(tmx, tmw, delta, out, M,
                                                    N, K, ldd, dcol);
  return (int)cudaGetLastError();
}

template <int RN>
int launch_decode(const geom::Geometry& g, const bf16* x, const bf16* w,
                  const bf16* delta, float* part, bf16* out, int M, int N,
                  int K, int ldd, int dcol, int smem_limit, cudaStream_t s) {
  static int granted[wg::kMaxDevices] = {};
  const geom::Launch &lp = g.l[0], &ls = g.l[1];
  int err =
      wg::allow_smem(ql_partials_kernel<RN>, lp.smem, smem_limit, granted);
  if (err) return err;
  const int steps = (K + 63) / 64;
  const int per = (steps + (int)lp.grid.y - 1) / (int)lp.grid.y;
  CUtensorMap tmx, tmw;
  if ((err = wg::tensor_map(&tmx, x, M, K, RN, 64)) ||
      (err = wg::tensor_map(&tmw, w, K, N, 64, 64)))
    return err;
  ql_partials_kernel<RN><<<lp.grid, lp.threads, lp.smem, s>>>(
      tmx, tmw, part, M, N, K, per);
  if ((err = (int)cudaGetLastError())) return err;
  ql_sum_kernel<<<ls.grid, ls.threads, ls.smem, s>>>(part, (int)lp.grid.y,
                                                     delta, out, N, M * N,
                                                     ldd, dcol);
  return (int)cudaGetLastError();
}

// The launches of quanta_linear_gemm_launch: the float32 tile's grid
// (ceil(N/64), ceil(M/64)); the bf16 prefill body's (ceil(N/256),
// ceil(M/128)); the decode body's (ceil(N/64), splits), then the sum's
// ceil(M*N/256) blocks.
int geometry(int dtype, int variant, const void* x, const void* w,
             const void* part, int M, int N, int K, int ldd, int dcol,
             int splits, int smem_limit, geom::Geometry* g) {
  if (M <= 0 || N <= 0) return 0;
  // the delta's columns [dcol, dcol + N) of rows of ldd; bf16 reads pairs
  if (dcol < 0 || ldd < dcol + N || (dtype == 1 && (ldd % 2 || dcol % 2)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && variant == 2) {
    g->add(dim3((N + tiled::SIMT_BN - 1) / tiled::SIMT_BN,
                (M + tiled::SIMT_BM - 1) / tiled::SIMT_BM),
           256, 0);
    return 0;
  }
  if (dtype != 1 || K < 1 || K % 8 || N % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    constexpr int smem = wg::GemmPlan<kPrefillBN>::BYTES;
    if (smem > smem_limit) return (int)cudaErrorInvalidValue;
    g->add(dim3((N + kPrefillBN - 1) / kPrefillBN,
                (M + wg::kGemmBM - 1) / wg::kGemmBM),
           wg::kGemmThreads, smem);
    return 0;
  }
  if (variant != 1 || M > 64) return (int)cudaErrorInvalidValue;
  const int smem =
      M <= 8 ? wg::DecPlan<8>::BYTES : wg::DecPlan<64>::BYTES;
  if (smem > smem_limit) return (int)cudaErrorInvalidValue;
  const int steps = (K + 63) / 64;
  // every split holds at least one K step
  if (splits < 1 || part == nullptr ||
      (steps + (steps + splits - 1) / splits - 1) /
              ((steps + splits - 1) / splits) != splits)
    return (int)cudaErrorInvalidValue;
  g->add(dim3((N + wg::kDecBN - 1) / wg::kDecBN, splits), wg::kDecThreads,
         smem);
  g->add(dim3((M * N + 255) / 256), 256, 0);
  return 0;
}

}  // namespace

// out (M, N) = x (M, K) @ w (K, N) + delta[:, dcol:dcol + N], all
// row-major and contiguous in one dtype (0 float32, 1 bfloat16); delta
// has rows of ldd >= dcol + N elements (both even in bf16).  variant
// (kernels/smem.py quanta_linear_plan): 0 the bf16 prefill body, 1 the
// bf16 decode body (M <= 64; part an fp32 (splits, M, N) scratch, K split
// into `splits` non-empty parts of 64-row steps), 2 the float32 tile.  The
// bf16 bodies need K % 8 == 0, N % 8 == 0 and 16-byte aligned x and w.
// smem_limit: the shared memory a block of this device may opt in to.
// Returns the cudaError_t of the launches.
extern "C" int quanta_linear_gemm_launch(int dtype, int variant,
                                         const void* x, const void* w,
                                         const void* delta, void* part,
                                         void* out, int M, int N, int K,
                                         int ldd, int dcol, int splits,
                                         int smem_limit, void* stream) {
  geom::Geometry g;
  const int err = geometry(dtype, variant, x, w, part, M, N, K, ldd, dcol,
                           splits, smem_limit, &g);
  if (err || g.n == 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const geom::Launch& l = g.l[0];
    gemm_f32_kernel<<<l.grid, l.threads, l.smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(delta), static_cast<float*>(out), M, N, K,
        ldd, dcol);
    return (int)cudaGetLastError();
  }
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* db = static_cast<const bf16*>(delta);
  bf16* ob = static_cast<bf16*>(out);
  float* pf = static_cast<float*>(part);
  if (variant == 0)
    return launch_prefill(g.l[0], xb, wb, db, ob, M, N, K, ldd, dcol,
                          smem_limit, s);
  return M <= 8 ? launch_decode<8>(g, xb, wb, db, pf, ob, M, N, K, ldd,
                                   dcol, smem_limit, s)
                : launch_decode<64>(g, xb, wb, db, pf, ob, M, N, K, ldd,
                                    dcol, smem_limit, s);
}

// quanta_linear_gemm_launch's geometry (geometry.cuh), launching nothing.
extern "C" int quanta_linear_gemm_describe(int dtype, int variant,
                                           const void* x, const void* w,
                                           const void* delta, void* part,
                                           void* out, int M, int N, int K,
                                           int ldd, int dcol, int splits,
                                           int smem_limit, int* desc,
                                           int cap) {
  geom::Geometry g;
  return geom::describe(geometry(dtype, variant, x, w, part, M, N, K, ldd,
                                 dcol, splits, smem_limit, &g),
                        g, desc, cap);
}
