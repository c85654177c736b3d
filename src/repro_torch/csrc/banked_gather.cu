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
//   (b) expand: the base product x @ W with fp32 accumulators, rounded
//       to x's dtype, plus each output row's delta.  bf16, many rows (the
//       prefill body): wgmma with a TMA ring (wgmma_gemm.cuh, 128 x 256
//       tiles, two consumer warpgroups and a producer); its epilogue
//       stages the tile's za rows and, once per slot the tile holds (a
//       tile may straddle slots), that slot's B[g] column tile in shared
//       memory, so each thread sums its rows' deltas from shared memory.
//       bf16, at most 64 rows (the decode body): W streamed by TMA over
//       every SM, as wgmma's A operand (W^T, 64 columns a block, MN-major)
//       against the x tile, K split so that every SM holds four blocks;
//       the fp32 partial sums go to a scratch and a combine pass adds
//       them in split order, rounds the base and adds the row's delta
//       (each B element read once per row that uses it).  Both fold the
//       shrink's split sum into their reading of za.  float32: a SIMT
//       64 x 64 tile (tiled_gemm.cuh) whose epilogue reads B[ids[row / S]]
//       per element.  Without the base, a plain elementwise pass computes
//       the delta alone.
// Rounding follows LoraAdapter.delta and the TPU kernel body: x is cast to
// the adapter dtype, za and za @ B are in the adapter dtype, scale
// multiplies the product in the adapter dtype, the delta is cast to x's
// dtype, and the base x @ W is rounded to x's dtype on its own before the
// two are added (and rounded once more).  A neutral row adds an exact 0.
//
// What bounds it on the H100: at prefill (3072 rows of 4096 -> 4096) the
// tensor cores, 2 * 3072 * 4096 * 4096 operations of the base product; at
// decode (8 rows) reading W, 32 MiB of bf16, at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "geometry.cuh"
#include "tiled_gemm.cuh"
#include "wgmma_gemm.cuh"

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

// The delta of one output element from its fp32 dot product za . B[:, col],
// in x's precision: round_x(round_a(scale * round_a(dot)))
template <typename XT, typename AT>
__device__ __forceinline__ float delta_of(float dot, float scale) {
  return round_to<XT>(round_to<AT>(scale * round_to<AT>(dot)));
}

// The delta of one output element, B[ids[row / S]] read from device memory
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
  return delta_of<XT, AT>(dot, scale);
}

// za[row, k] rounded to the adapter dtype: the shrink's value, or the sum
// of its zsplits fp32 partials in split order (as reduce_kernel adds them)
template <typename AT>
__device__ __forceinline__ float za_at(const float* __restrict__ za,
                                       const float* __restrict__ zpart,
                                       int zsplits, int M, int r, int row,
                                       int k) {
  const size_t at = (size_t)row * r + k;
  if (zsplits == 1) return za[at];
  float s = 0.f;
  for (int z = 0; z < zsplits; ++z) s += zpart[(size_t)z * M * r + at];
  return round_to<AT>(s);
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
// bf16 prefill body: the wgmma mainloop of wgmma_gemm.cuh, then the
// epilogue.  za (with the shrink's split sum folded in) is staged for the
// tile's 128 rows, and for each slot the tile holds, in row order, that
// slot's B[g] columns n0..n0+BN-1 (fp32); a thread adds the delta of each
// of its two rows in its slot's turn, 64 columns at a time, k ascending,
// and stores bf16 pairs.
template <int BN, typename AT>
__global__ void __launch_bounds__(wg::kGemmThreads, 1)
    fused_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmw,
                       const float* __restrict__ za,
                       const float* __restrict__ zpart, int zsplits,
                       const AT* __restrict__ b, const int* __restrict__ ids,
                       bf16* __restrict__ out, int M, int N, int K, int S,
                       int r, int n_bank, float scale) {
  extern __shared__ uint8_t fused_smem[];
  wg::gemm_tile<BN>(&tmx, &tmw, K, fused_smem, [&](float (&acc)[BN / 128][64],
                                                   uint8_t* ring, int m0,
                                                   int n0) {
    constexpr int BM = wg::kGemmBM, JB = 8;   // column groups a pass
    float* zs = reinterpret_cast<float*>(ring);   // [BM][r]
    float* bs = zs + BM * r;                       // [r][BN]
    const int t = threadIdx.x, lane = t & 31, quad = lane & 3;
    const int ra = 64 * (t >> 7) + 16 * ((t >> 5) & 3) + (lane >> 2);
    for (int e = t; e < BM * r; e += 256) {
      const int row = m0 + e / r;
      zs[e] = row < M ? za_at<AT>(za, zpart, zsplits, M, r, row, e % r)
                      : 0.f;
    }
    const int q_end = (min(m0 + BM, M) - 1) / S;
    for (int q = m0 / S; q <= q_end; ++q) {
      sm90::named_sync(1, 256);   // za staged; the last slot's B consumed
      const AT* B = b + (size_t)bank_row(ids, q, n_bank) * r * N;
      for (int e = t; e < r * BN; e += 256) {
        const int col = n0 + e % BN;
        bs[e] = col < N ? to_f(B[(size_t)(e / BN) * N + col]) : 0.f;
      }
      sm90::named_sync(1, 256);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = ra + 8 * h, row = m0 + rl;
        if (row >= M || row / S != q) continue;
#pragma unroll
        for (int jb = 0; jb < BN / 8; jb += JB) {
          float dot[2 * JB];
#pragma unroll
          for (int i = 0; i < 2 * JB; ++i) dot[i] = 0.f;
          for (int k = 0; k < r; ++k) {
            const float z = zs[rl * r + k];
#pragma unroll
            for (int jj = 0; jj < JB; ++jj) {
              const float2 bv = *reinterpret_cast<const float2*>(
                  bs + k * BN + 8 * (jb + jj) + 2 * quad);
              dot[2 * jj] = fmaf(z, bv.x, dot[2 * jj]);
              dot[2 * jj + 1] = fmaf(z, bv.y, dot[2 * jj + 1]);
            }
          }
#pragma unroll
          for (int jj = 0; jj < JB; ++jj) {
            const int j = jb + jj, col = n0 + 8 * j + 2 * quad;
            if (col >= N) continue;   // N % 8 == 0: col + 1 < N too
            float o[2];
#pragma unroll
            for (int c = 0; c < 2; ++c)
              o[c] = round_to<bf16>(acc[j / 16][4 * (j % 16) + 2 * h + c]) +
                     delta_of<bf16, AT>(dot[2 * jj + c], scale);
            *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
                sm90::pack_bf16(o[0], o[1]);
          }
        }
      }
    }
  });
}

// bf16 decode body: the partial products of wg::decode_partials (W
// streamed over every SM, K split), one split a blockIdx.y.
template <int RN>
__global__ void __launch_bounds__(wg::kDecThreads, wg::kDecBlocksPerSm)
    decode_gemm_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmw,
                       float* __restrict__ part, int M, int N, int K,
                       int steps_per_split) {
  extern __shared__ uint8_t dec_smem[];
  wg::decode_partials<RN>(&tmx, &tmw, part, M, N, K, steps_per_split,
                          dec_smem);
}

// The decode body's second pass: out[row, col] = the splits' partials
// added in order and rounded, plus the row's delta (za with the shrink's
// split sum folded in, staged once a block).
template <typename AT>
__global__ void __launch_bounds__(256)
    combine_kernel(const float* __restrict__ part, int gsplits,
                   const float* __restrict__ za,
                   const float* __restrict__ zpart, int zsplits,
                   const AT* __restrict__ b, const int* __restrict__ ids,
                   bf16* __restrict__ out, int M, int N, int S, int r,
                   int n_bank, float scale) {
  __shared__ float zs[MAX_RANK];
  const int row = blockIdx.y, col = blockIdx.x * 256 + threadIdx.x;
  if (threadIdx.x < r)
    zs[threadIdx.x] = za_at<AT>(za, zpart, zsplits, M, r, row, threadIdx.x);
  __syncthreads();
  if (col >= N) return;
  float v = 0.f;
  for (int z = 0; z < gsplits; ++z)
    v += part[((size_t)z * M + row) * N + col];
  const AT* B = b + (size_t)bank_row(ids, row / S, n_bank) * r * N + col;
  float dot = 0.f;
  for (int k = 0; k < r; ++k) dot = fmaf(zs[k], to_f(B[(size_t)k * N]), dot);
  out[(size_t)row * N + col] =
      __float2bfloat16(round_to<bf16>(v) + delta_of<bf16, AT>(dot, scale));
}

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

// What the launches take, as the entry point received it.
struct Args {
  int variant;
  const void *x, *a, *b, *w;
  const int* ids;
  float *za, *zpart, *gpart;
  void* out;
  int n_slots, S, d_in, d_out, r, n_bank;
  float scale;
  int splits, k_split, gsplits, smem_limit;
};

// The launches of banked_lora_launch, in order: the shrink, grid
// (ceil(S/16), n_slots, splits); with several splits and no bf16 base, the
// reduce of za; then the delta alone, grid (M, ceil(d_out/256)), or the
// fused product: float32 (ceil(d_out/64), ceil(M/64)), bf16 prefill
// (ceil(d_out/256), ceil(M/128)), or bf16 decode (ceil(d_out/64), gsplits)
// and its combine (ceil(d_out/256), M).  M = n_slots * S.
int geometry(const Args& g, int x_dtype, int a_dtype, geom::Geometry* out) {
  if (g.n_slots <= 0 || g.S <= 0 || g.d_out <= 0) return 0;
  if (g.r < 1 || g.r > MAX_RANK || g.n_bank < 1 || g.d_in < 1)
    return (int)cudaErrorInvalidValue;
  if ((x_dtype != 0 && x_dtype != 1) || (a_dtype != 0 && a_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int M = g.n_slots * g.S, d_in = g.d_in, d_out = g.d_out;
  const bool bf16_base = g.w != nullptr && x_dtype == 1;
  if (g.splits < 1 || g.k_split % SK ||
      (g.splits > 1 && g.zpart == nullptr) ||
      (size_t)(g.splits - 1) * g.k_split >= (size_t)d_in)
    return (int)cudaErrorInvalidValue;
  if (bf16_base &&
      (d_in % 8 || d_out % 8 || reinterpret_cast<uintptr_t>(g.x) % 16 ||
       reinterpret_cast<uintptr_t>(g.w) % 16 || g.variant > 1 ||
       (g.variant == 1 && M > 64)))
    return (int)cudaErrorInvalidValue;
  if (g.w != nullptr && !bf16_base && g.variant != 2)
    return (int)cudaErrorInvalidValue;
  out->add(dim3((g.S + SR - 1) / SR, g.n_slots, g.splits), 256, 0);
  // the bf16 fused bodies add the split sums as they read za
  if (g.splits > 1 && !bf16_base)
    out->add(dim3((M * g.r + 255) / 256), 256, 0);
  if (g.w == nullptr) {
    out->add(dim3(M, (d_out + 255) / 256), 256, 0);
  } else if (x_dtype == 0) {
    out->add(dim3((d_out + tiled::SIMT_BN - 1) / tiled::SIMT_BN,
                  (M + tiled::SIMT_BM - 1) / tiled::SIMT_BM),
             256, 0);
  } else if (g.variant == 0) {
    constexpr int smem = wg::GemmPlan<256>::BYTES;
    if (smem > g.smem_limit) return (int)cudaErrorInvalidValue;
    out->add(dim3((d_out + 255) / 256, (M + wg::kGemmBM - 1) / wg::kGemmBM),
             wg::kGemmThreads, smem);
  } else {
    const int smem = M <= 8 ? wg::DecPlan<8>::BYTES : wg::DecPlan<64>::BYTES;
    if (smem > g.smem_limit) return (int)cudaErrorInvalidValue;
    const int steps = (d_in + 63) / 64;
    if (g.gsplits < 1 || g.gpart == nullptr ||
        (steps + (steps + g.gsplits - 1) / g.gsplits - 1) /
                ((steps + g.gsplits - 1) / g.gsplits) != g.gsplits)
      return (int)cudaErrorInvalidValue;
    out->add(dim3((d_out + wg::kDecBN - 1) / wg::kDecBN, g.gsplits),
             wg::kDecThreads, smem);
    out->add(dim3((d_out + 255) / 256, M), 256, 0);
  }
  return 0;
}

template <int BN, typename AT>
int launch_prefill(const Args& g, const geom::Launch& l, cudaStream_t s) {
  static int granted[wg::kMaxDevices] = {};
  const int M = g.n_slots * g.S;
  int err = wg::allow_smem(fused_wgmma_kernel<BN, AT>, l.smem, g.smem_limit,
                           granted);
  if (err) return err;
  CUtensorMap tmx, tmw;
  if ((err = wg::tensor_map(&tmx, g.x, M, g.d_in, wg::kGemmBM, 64)) ||
      (err = wg::tensor_map(&tmw, g.w, g.d_in, g.d_out, 64, 64)))
    return err;
  fused_wgmma_kernel<BN, AT><<<l.grid, l.threads, l.smem, s>>>(
      tmx, tmw, g.za, g.zpart, g.splits, static_cast<const AT*>(g.b), g.ids,
      static_cast<bf16*>(g.out), M, g.d_out, g.d_in, g.S, g.r, g.n_bank,
      g.scale);
  return (int)cudaGetLastError();
}

template <int RN, typename AT>
int launch_decode_rn(const Args& g, const geom::Launch& ld,
                     const geom::Launch& lc, cudaStream_t s) {
  static int granted[wg::kMaxDevices] = {};
  const int M = g.n_slots * g.S;
  int err =
      wg::allow_smem(decode_gemm_kernel<RN>, ld.smem, g.smem_limit, granted);
  if (err) return err;
  const int steps = (g.d_in + 63) / 64;
  const int per = (steps + g.gsplits - 1) / g.gsplits;
  CUtensorMap tmx, tmw;
  if ((err = wg::tensor_map(&tmx, g.x, M, g.d_in, RN, 64)) ||
      (err = wg::tensor_map(&tmw, g.w, g.d_in, g.d_out, 64, 64)))
    return err;
  decode_gemm_kernel<RN><<<ld.grid, ld.threads, ld.smem, s>>>(
      tmx, tmw, g.gpart, M, g.d_out, g.d_in, per);
  if ((err = (int)cudaGetLastError())) return err;
  combine_kernel<AT><<<lc.grid, lc.threads, lc.smem, s>>>(
      g.gpart, g.gsplits, g.za, g.zpart, g.splits,
      static_cast<const AT*>(g.b), g.ids, static_cast<bf16*>(g.out), M,
      g.d_out, g.S, g.r, g.n_bank, g.scale);
  return (int)cudaGetLastError();
}

template <typename XT, typename AT>
int launch(const Args& g, const geom::Geometry& geo, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(g.x);
  const AT* a = static_cast<const AT*>(g.a);
  const AT* b = static_cast<const AT*>(g.b);
  XT* out = static_cast<XT*>(g.out);
  const int M = g.n_slots * g.S, S = g.S, r = g.r, d_in = g.d_in,
            d_out = g.d_out;
  const bool bf16_base = g.w != nullptr && sizeof(XT) == 2;
  int i = 0;
  const geom::Launch& ls = geo.l[i++];
  shrink_kernel<XT, AT><<<ls.grid, ls.threads, ls.smem, s>>>(
      x, a, g.ids, g.za, g.zpart, S, d_in, r, g.n_bank, g.k_split);
  if (g.splits > 1 && !bf16_base) {
    const geom::Launch& l = geo.l[i++];
    reduce_kernel<AT><<<l.grid, l.threads, l.smem, s>>>(g.zpart, g.za, M * r,
                                                        g.splits);
  }
  const geom::Launch& l = geo.l[i];
  if (g.w == nullptr) {
    delta_kernel<XT, AT><<<l.grid, l.threads, l.smem, s>>>(
        g.za, b, g.ids, out, d_out, S, r, g.n_bank, g.scale);
  } else if constexpr (sizeof(XT) == 4) {
    fused_f32_kernel<AT><<<l.grid, l.threads, l.smem, s>>>(
        x, static_cast<const float*>(g.w), g.za, b, g.ids, out, M, d_out,
        d_in, S, r, g.n_bank, g.scale);
  } else {
    const int err = (int)cudaGetLastError();
    if (err) return err;
    if (g.variant == 0) return launch_prefill<256, AT>(g, l, s);
    return M <= 8 ? launch_decode_rn<8, AT>(g, l, geo.l[i + 1], s)
                  : launch_decode_rn<64, AT>(g, l, geo.l[i + 1], s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_slots, S, d_in) in x_dtype; a (n_bank, d_in, r) and b (n_bank, r,
// d_out) in a_dtype; ids (n_slots,) int32; w (d_in, d_out) in x_dtype, or
// null for the delta alone; za an fp32 (n_slots * S, r) scratch, zpart an
// fp32 (splits, n_slots * S, r) one when splits > 1 (the shrink's K split
// in parts of k_split rows, a multiple of 64); gpart an fp32 (gsplits,
// n_slots * S, d_out) scratch for the bf16 decode body (its K split into
// gsplits non-empty parts of 64-row steps); out (n_slots, S, d_out) in
// x_dtype.  All row-major and contiguous; dtypes 0 float32, 1 bfloat16.
// variant (kernels/smem.py): 0 the bf16 prefill body, 1 the bf16 decode
// body (at most 64 rows), 2 the float32 tile.  The bf16 bodies need
// d_in % 8 == 0, d_out % 8 == 0 and 16-byte aligned x and w.  smem_limit:
// the shared memory a block of this device may opt in to.  Returns the
// cudaError_t of the launches.
extern "C" int banked_lora_launch(int x_dtype, int a_dtype, int variant,
                                  const void* x, const void* a,
                                  const void* b, const void* ids,
                                  const void* w, void* za, void* zpart,
                                  void* gpart, void* out, int n_slots, int S,
                                  int d_in, int d_out, int r, int n_bank,
                                  float scale, int splits, int k_split,
                                  int gsplits, int smem_limit,
                                  void* stream) {
  const Args g{variant, x, a, b, w, static_cast<const int*>(ids),
               static_cast<float*>(za), static_cast<float*>(zpart),
               static_cast<float*>(gpart), out, n_slots, S, d_in, d_out, r,
               n_bank, scale, splits, k_split, gsplits, smem_limit};
  geom::Geometry geo;
  const int err = geometry(g, x_dtype, a_dtype, &geo);
  if (err || geo.n == 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && a_dtype == 0) return launch<float, float>(g, geo, s);
  if (x_dtype == 0 && a_dtype == 1) return launch<float, bf16>(g, geo, s);
  if (x_dtype == 1 && a_dtype == 0) return launch<bf16, float>(g, geo, s);
  return launch<bf16, bf16>(g, geo, s);
}

// banked_lora_launch's geometry (geometry.cuh), launching nothing.
extern "C" int banked_lora_describe(int x_dtype, int a_dtype, int variant,
                                    const void* x, const void* a,
                                    const void* b, const void* ids,
                                    const void* w, void* za, void* zpart,
                                    void* gpart, void* out, int n_slots,
                                    int S, int d_in, int d_out, int r,
                                    int n_bank, float scale, int splits,
                                    int k_split, int gsplits, int smem_limit,
                                    int* desc, int cap) {
  const Args g{variant, x, a, b, w, static_cast<const int*>(ids),
               static_cast<float*>(za), static_cast<float*>(zpart),
               static_cast<float*>(gpart), out, n_slots, S, d_in, d_out, r,
               n_bank, scale, splits, k_split, gsplits, smem_limit};
  geom::Geometry geo;
  return geom::describe(geometry(g, x_dtype, a_dtype, &geo), geo, desc, cap);
}
