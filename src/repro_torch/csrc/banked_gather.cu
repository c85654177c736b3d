// Banked-gather LoRA for Hopper (sm_90a): per batch slot s, with its bank
// row g = ids[s],
//     y[s] = x[s] @ W + scale * ((x[s] @ A[g]) @ B[g])       (fused)
//     y[s] =            scale * ((x[s] @ A[g]) @ B[g])       (delta only)
// over a bank A (G+1, d_in, r), B (G+1, r, d_out) whose row 0 is neutral.
//
// Replaces the TPU kernel repro/kernels/banked_gather.py (_call, body
// _kernel).  There each grid step (slot, column block) holds the slot's
// whole x (S, d_in), its gathered A row, a B column block and a W column
// block in VMEM, with the bank row addressed by a scalar-prefetched id;
// its JAX caller sends prefill shapes, whose full-K tiles overflow VMEM,
// to a reference gather instead.  Here the work is split the Punica way
// ("shrink, then expand"), with K tiled so that every shape runs:
//   (a) shrink: za[row, :] = x[row] @ A[ids[row / S]], one block per 16
//       rows of one slot, A staged through shared memory 64 K-rows at a
//       time, exact fp32 FMAs (r <= 64, so this is a small share of the
//       work).  za goes to a (rows, r) fp32 scratch, already rounded to the
//       adapter dtype.  With few rows (a decode tick: one block per slot)
//       K is split over blocks too, and a second pass adds the fp32
//       partial sums in a fixed order before rounding;
//   (b) expand: the base product x @ W as a tiled GEMM with fp32
//       accumulators (tiled_gemm.cuh, shared with quanta_linear.cu; bf16:
//       nvcuda::wmma on the tensor cores, 128 x 128 tiles for many rows
//       and 16 x 32 tiles with the K step split over warps for a few;
//       float32: a SIMT 64 x 64 tile), whose epilogue adds each
//       output row's delta, reading B[ids[row / S]] per
//       row because a tile may hold rows of several slots (at decode, 8
//       slots give 8 rows).  Without the base, a plain elementwise pass
//       computes the delta alone.
// Rounding follows LoraAdapter.delta and the TPU kernel body: x is cast to
// the adapter dtype, za and za @ B are in the adapter dtype, scale
// multiplies the product in the adapter dtype, the delta is cast to x's
// dtype, and the base x @ W is rounded to x's dtype on its own before the
// two are added (and rounded once more).  A neutral row adds an exact 0.
//
// What bounds it on the H100: at prefill (3072 rows of 4096 -> 4096) the
// tensor cores, 2 * 3072 * 4096 * 4096 operations of the base product; at
// decode (8 rows) reading W, 32 MiB of bf16, at 3.35 TB/s.  The narrow
// tile gives d_out / 32 blocks at d_out 4096 (128, about one per SM) so
// that every SM streams a stripe of W.  No cp.async, TMA or wgmma yet:
// those are for the PRs that make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiled_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_RANK = 64;  // the shrink stages (SK, r) fp32 A tiles
constexpr int SR = 16;        // rows of one slot per shrink block
constexpr int SK = 64;        // K rows of A per shrink step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T's precision, kept as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// the bank row of a slot; an id outside the bank reads row 0 or G rather
// than memory outside it
__device__ __forceinline__ int bank_row(const int* ids, int slot,
                                        int n_bank) {
  const int id = ids[slot];
  return id < 0 ? 0 : (id >= n_bank ? n_bank - 1 : id);
}

// ------------------------------------------------------------- (a) shrink
// blockIdx.z takes K rows [z * k_split, (z + 1) * k_split).  With one
// split the block writes za rounded to the adapter dtype; with several
// (few rows: a decode tick has one block per slot otherwise) it writes
// its fp32 partial sum to zpart[z], and reduce_kernel adds the splits in
// order and rounds.
template <typename XT, typename AT>
__global__ void __launch_bounds__(256)
    shrink_kernel(const XT* __restrict__ x, const AT* __restrict__ a,
                  const int* __restrict__ ids, float* __restrict__ za,
                  float* __restrict__ zpart, int S, int d_in, int r,
                  int n_bank, int k_split) {
  __shared__ float xs[SR][SK + 1];
  __shared__ float as[SK][MAX_RANK];
  const int slot = blockIdx.y, row0 = blockIdx.x * SR;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(d_in, k_begin + k_split);
  const AT* A = a + (size_t)bank_row(ids, slot, n_bank) * d_in * r;
  const XT* X = x + (size_t)slot * S * d_in;
  const int n_out = SR * r;  // <= 1024: four outputs per thread at most
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = k_begin; k0 < k_end; k0 += SK) {
    for (int e = threadIdx.x; e < SR * SK; e += 256) {
      const int rr = e / SK, c = e % SK;
      const int gr = row0 + rr, gc = k0 + c;
      // x cast to the adapter dtype first
      xs[rr][c] = (gr < S && gc < k_end)
                      ? round_to<AT>(to_f(X[(size_t)gr * d_in + gc]))
                      : 0.f;
    }
    for (int e = threadIdx.x; e < SK * r; e += 256) {
      const int i = e / r, k = e % r;
      as[i][k] = (k0 + i < k_end) ? to_f(A[(size_t)(k0 + i) * r + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = threadIdx.x + 256 * j;
      if (o < n_out) {
        const int rr = o / r, k = o % r;
        float s = acc[j];
#pragma unroll 8
        for (int i = 0; i < SK; ++i) s = fmaf(xs[rr][i], as[i][k], s);
        acc[j] = s;
      }
    }
    __syncthreads();
  }
  const size_t rows = (size_t)gridDim.y * S;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = threadIdx.x + 256 * j;
    if (o < n_out) {
      const int rr = o / r, k = o % r, gr = row0 + rr;
      if (gr < S) {
        const size_t at = ((size_t)slot * S + gr) * r + k;
        if (gridDim.z == 1)
          za[at] = round_to<AT>(acc[j]);
        else
          zpart[blockIdx.z * rows * r + at] = acc[j];
      }
    }
  }
}

// za = the splits' partial sums added in order, rounded to the adapter
// dtype
template <typename AT>
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ zpart, float* __restrict__ za,
                  int n, int splits) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += zpart[(size_t)z * n + e];
  za[e] = round_to<AT>(s);
}

// The delta of one output element, in x's precision:
// round_x(round_a(scale * round_a(za[row] . B[g][:, col])))
template <typename XT, typename AT>
__device__ __forceinline__ float lora_delta(const float* __restrict__ za,
                                            const AT* __restrict__ b,
                                            const int* __restrict__ ids,
                                            int row, int col, int S, int r,
                                            int N, int n_bank, float scale) {
  const AT* B = b + (size_t)bank_row(ids, row / S, n_bank) * r * N + col;
  const float* z = za + (size_t)row * r;
  float dot = 0.f;
  for (int k = 0; k < r; ++k) dot = fmaf(z[k], to_f(B[(size_t)k * N]), dot);
  return round_to<XT>(round_to<AT>(scale * round_to<AT>(dot)));
}

// ------------------------------------------------- (b) expand, no base
template <typename XT, typename AT>
__global__ void __launch_bounds__(256)
    delta_kernel(const float* __restrict__ za, const AT* __restrict__ b,
                 const int* __restrict__ ids, XT* __restrict__ out, int N,
                 int S, int r, int n_bank, float scale) {
  const int row = blockIdx.x, col = blockIdx.y * 256 + threadIdx.x;
  if (col < N)
    out[(size_t)row * N + col] = from_f<XT>(
        lora_delta<XT, AT>(za, b, ids, row, col, S, r, N, n_bank, scale));
}

// ------------------------------------------ (b) expand, fused base
// The tiled GEMMs of tiled_gemm.cuh; the epilogue rounds the base to x's
// dtype on its own and adds the row's delta.
template <typename T, typename AT>
__global__ void __launch_bounds__(256)
    fused_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ za, const AT* __restrict__ b,
                      const int* __restrict__ ids, bf16* __restrict__ out,
                      int M, int N, int K, int S, int r, int n_bank,
                      float scale) {
  tiled::wmma_gemm<T>(x, w, M, N, K, [=](int row, int col, float v) {
    out[(size_t)row * N + col] = __float2bfloat16(
        round_to<bf16>(v) + lora_delta<bf16, AT>(za, b, ids, row, col, S, r,
                                                 N, n_bank, scale));
  });
}

// the two bf16 tiles (variant codes of kernels/smem.py BANKED_TILES)
using WideTile = tiled::WmmaTile<4, 2, 2, 4, 1>;    // 128 x 128, BK 32
using NarrowTile = tiled::WmmaTile<1, 2, 1, 1, 4>;  // 16 x 32, BK 128

template <typename AT>
__global__ void __launch_bounds__(256)
    fused_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ za, const AT* __restrict__ b,
                     const int* __restrict__ ids, float* __restrict__ out,
                     int M, int N, int K, int S, int r, int n_bank,
                     float scale) {
  tiled::simt_gemm_f32(x, w, M, N, K, [=](int row, int col, float v) {
    out[(size_t)row * N + col] =
        v + lora_delta<float, AT>(za, b, ids, row, col, S, r, N, n_bank,
                                  scale);
  });
}

template <typename T, typename AT>
void launch_bf16(const bf16* x, const bf16* w, const float* za, const AT* b,
                 const int* ids, bf16* out, int M, int N, int K, int S, int r,
                 int n_bank, float scale, cudaStream_t s) {
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  fused_bf16_kernel<T, AT><<<grid, 256, 0, s>>>(x, w, za, b, ids, out, M, N,
                                                K, S, r, n_bank, scale);
}

template <typename XT, typename AT>
int launch(int variant, const void* xv, const void* av, const void* bv,
           const int* ids, const void* wv, float* za, float* zpart,
           void* outv, int n_slots, int S, int d_in, int d_out, int r,
           int n_bank, float scale, int splits, int k_split,
           cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  const AT* a = static_cast<const AT*>(av);
  const AT* b = static_cast<const AT*>(bv);
  const XT* w = static_cast<const XT*>(wv);
  XT* out = static_cast<XT*>(outv);
  const int M = n_slots * S;
  if (splits < 1 || k_split % SK || (splits > 1 && zpart == nullptr) ||
      (size_t)(splits - 1) * k_split >= (size_t)d_in)
    return (int)cudaErrorInvalidValue;
  shrink_kernel<XT, AT>
      <<<dim3((S + SR - 1) / SR, n_slots, splits), 256, 0, s>>>(
          x, a, ids, za, zpart, S, d_in, r, n_bank, k_split);
  if (splits > 1)
    reduce_kernel<AT><<<(M * r + 255) / 256, 256, 0, s>>>(zpart, za, M * r,
                                                         splits);
  if (w == nullptr) {
    delta_kernel<XT, AT><<<dim3(M, (d_out + 255) / 256), 256, 0, s>>>(
        za, b, ids, out, d_out, S, r, n_bank, scale);
  } else if constexpr (sizeof(XT) == 4) {
    if (variant != 2) return (int)cudaErrorInvalidValue;
    dim3 grid((d_out + tiled::SIMT_BN - 1) / tiled::SIMT_BN,
              (M + tiled::SIMT_BM - 1) / tiled::SIMT_BM);
    fused_f32_kernel<AT><<<grid, 256, 0, s>>>(x, w, za, b, ids, out, M,
                                              d_out, d_in, S, r, n_bank,
                                              scale);
  } else {
    if (d_in % 8 || d_out % 8) return (int)cudaErrorInvalidValue;
    if (variant == 0)
      launch_bf16<WideTile, AT>(x, w, za, b, ids, out, M, d_out, d_in, S, r,
                                n_bank, scale, s);
    else if (variant == 1)
      launch_bf16<NarrowTile, AT>(x, w, za, b, ids, out, M, d_out, d_in, S, r,
                                  n_bank, scale, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_slots, S, d_in) in x_dtype; a (n_bank, d_in, r) and b (n_bank, r,
// d_out) in a_dtype; ids (n_slots,) int32; w (d_in, d_out) in x_dtype, or
// null for the delta alone; za an fp32 (n_slots * S, r) scratch, zpart an
// fp32 (splits, n_slots * S, r) one when splits > 1 (the shrink's K split
// in parts of k_split rows, a multiple of 64); out (n_slots, S, d_out) in
// x_dtype.  All row-major and contiguous; dtypes 0 float32, 1 bfloat16.
// The bf16 base product needs d_in % 8 == 0, d_out % 8 == 0 and 16-byte
// aligned x and w.  variant: the output tile of the fused product
// (kernels/smem.py).  Returns the cudaError_t of the launches.
extern "C" int banked_lora_launch(int x_dtype, int a_dtype, int variant,
                                  const void* x, const void* a,
                                  const void* b, const void* ids,
                                  const void* w, void* za, void* zpart,
                                  void* out, int n_slots, int S, int d_in,
                                  int d_out, int r, int n_bank, float scale,
                                  int splits, int k_split, void* stream) {
  if (n_slots <= 0 || S <= 0 || d_out <= 0) return 0;
  if (r < 1 || r > MAX_RANK || n_bank < 1 || d_in < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  float* z = static_cast<float*>(za);
  float* zp = static_cast<float*>(zpart);
  if (x_dtype == 0 && a_dtype == 0)
    return launch<float, float>(variant, x, a, b, id, w, z, zp, out, n_slots,
                                S, d_in, d_out, r, n_bank, scale, splits,
                                k_split, s);
  if (x_dtype == 0 && a_dtype == 1)
    return launch<float, bf16>(variant, x, a, b, id, w, z, zp, out, n_slots,
                               S, d_in, d_out, r, n_bank, scale, splits,
                               k_split, s);
  if (x_dtype == 1 && a_dtype == 0)
    return launch<bf16, float>(variant, x, a, b, id, w, z, zp, out, n_slots,
                               S, d_in, d_out, r, n_bank, scale, splits,
                               k_split, s);
  if (x_dtype == 1 && a_dtype == 1)
    return launch<bf16, bf16>(variant, x, a, b, id, w, z, zp, out, n_slots,
                              S, d_in, d_out, r, n_bank, scale, splits,
                              k_split, s);
  return (int)cudaErrorInvalidValue;
}
