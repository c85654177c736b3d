// Fused dequant-matmul y = x @ dequant(Wq) for blockwise NF4 / int8
// frozen weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quantized_matmul.py
// (quantized_matmul_kernel_call, body _kernel).
//
// What it computes, as the TPU kernel and core/quantize.matmul_ref do:
// every weight element is decoded in fp32 -- the NF4 codebook entry of its
// nibble (high nibble = even row of d_in) or the int8 code, times the
// fp32 scale of its d_in block, times the row norm, times the column norm,
// in that order -- then cast to x's dtype; the products accumulate in
// fp32 and the output is rounded once to x's dtype.  The dense weight
// never exists in device memory: codes are decoded into a shared-memory
// tile per K step.
//
// The TPU kernel keeps the whole d_in per tile, which at llama2-7b widths
// does not fit even the TPU's VMEM budget (its wrapper falls back to the
// reference there).  Here K is tiled in steps of 64 rows (a multiple of
// the 64-element quant block and of the two rows of an NF4 byte), so every
// shape of the serving path takes the kernel.
//
// What bounds it on the H100: at 8 decode rows the weight bytes (0.5 B a
// weight for NF4, 1 B for int8, plus 4 B of scale per block of 64); at
// 3072 prefill rows the tensor cores.  The design is the simple one:
//   * bf16 runs on the tensor cores through nvcuda::wmma (mma.sync
//     16x16x16, fp32 accumulators): 128 x 128 block tiles of 8 warps for
//     many rows, 16 x 64 tiles of 4 warps for few rows;
//   * float32 runs 64 x 64 SIMT tiles with exact fp32 FMAs (TF32 would
//     change the numbers);
//   * when the output tiles alone do not fill the card (decode), K is
//     split across blocks (split-K): each block writes an fp32 partial and
//     a second kernel adds the partials in a fixed order and rounds once,
//     so the result does not depend on block scheduling.
// Decoding is one byte load per two weights (coalesced across a warp's
// columns) and a cached scale per block of rows; no cp.async, TMA or
// wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BK = 64;         // K rows per step (two rows per NF4 byte)
constexpr int kNf4 = 0, kInt8 = 1;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Tile shapes.  Wide: many rows (prefill); Narrow: few rows (decode);
// F32: the SIMT float32 tile.  kVariant* are the codes the host passes.
constexpr int kWide = 0, kNarrow = 1, kF32 = 2;
template <int V>
struct Tile;
template <>
struct Tile<kWide> {
  static constexpr int BM = 128, BN = 128, THREADS = 256;
  static constexpr int WARPS_N = 2, FRAG_M = 2, FRAG_N = 4;
};
template <>
struct Tile<kNarrow> {
  static constexpr int BM = 16, BN = 64, THREADS = 128;
  static constexpr int WARPS_N = 4, FRAG_M = 1, FRAG_N = 1;
};
template <>
struct Tile<kF32> {
  static constexpr int BM = 64, BN = 64, THREADS = 256;
};

constexpr int XPAD = 8;        // row padding of the x tile (elements)

// Load the x tile rows [m0, m0+BM) x cols [k0, k0+BK) as 16-byte vectors
// (the host checks K % 8 == 0 and 16-byte alignment, so a vector is
// wholly inside or outside the matrix); out-of-range rows are zero.
template <typename T, int BM, int THREADS, int LD>
__device__ __forceinline__ void load_x(const T* __restrict__ x, T* xs, int M,
                                       int K, int m0, int k0) {
  constexpr int E = 16 / sizeof(T);
  for (int v = threadIdx.x; v < BM * BK / E; v += THREADS) {
    const int r = v / (BK / E), c = (v % (BK / E)) * E;
    const int gr = m0 + r, gc = k0 + c;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < M && gc < K)
      val = *reinterpret_cast<const uint4*>(x + (size_t)gr * K + gc);
    *reinterpret_cast<uint4*>(xs + r * LD + c) = val;
  }
}

// Decode the weight tile rows [k0, k0+BK) x cols [n0, n0+BN) into ws
// (row stride LD) in T.  Thread t owns column t % BN and a run of
// BK / (THREADS / BN) consecutive rows; a warp's loads are consecutive
// bytes of one packed row.
template <typename T, int FMT, int BN, int THREADS, int LD>
__device__ __forceinline__ void load_w(const uint8_t* __restrict__ packed,
                                       const float* __restrict__ scales,
                                       const float* __restrict__ row_norm,
                                       const float* __restrict__ col_norm,
                                       const float* cb, T* ws, int N, int K,
                                       int bs, int n0, int k0) {
  constexpr int G = THREADS / BN;
  constexpr int R = BK / G;
  static_assert(R % 2 == 0, "rows per thread come in NF4 pairs");
  const int n = threadIdx.x % BN, g = threadIdx.x / BN;
  const int gn = n0 + n;
  const bool col_ok = gn < N;
  const float cn = (col_ok && col_norm != nullptr) ? __ldg(col_norm + gn)
                                                   : 1.f;
  int sb = -1;
  float s = 0.f;
#pragma unroll 4
  for (int i = 0; i < R; i += 2) {
    const int k = g * R + i, gk = k0 + k;
    float v[2] = {0.f, 0.f};
    if (col_ok && gk < K) {  // K is even, so gk + 1 < K too
      if (FMT == kNf4) {
        const uint8_t b = __ldg(packed + (size_t)(gk >> 1) * N + gn);
        v[0] = cb[b >> 4];
        v[1] = cb[b & 15];
      } else {
        const int8_t* q = reinterpret_cast<const int8_t*>(packed);
        v[0] = (float)__ldg(q + (size_t)gk * N + gn);
        v[1] = (float)__ldg(q + (size_t)(gk + 1) * N + gn);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int blk = (gk + e) / bs;
        if (blk != sb) {
          sb = blk;
          s = __ldg(scales + (size_t)blk * N + gn);
        }
        float w = v[e] * s;
        if (row_norm != nullptr) w = w * __ldg(row_norm + gk + e);
        if (col_norm != nullptr) w = w * cn;
        v[e] = w;
      }
    }
    ws[k * LD + n] = from_f<T>(v[0]);
    ws[(k + 1) * LD + n] = from_f<T>(v[1]);
  }
}

struct Args {
  const void* x;
  const uint8_t* packed;
  const float* scales;
  const float* row_norm;
  const float* col_norm;
  const float* codebook;
  void* out;      // (M, N) in x's dtype when splits == 1
  float* partial;  // (splits, M, N) fp32 when splits > 1
  int M, N, K, bs, steps_per_split;
};

// The k-step range of this block's split.
__device__ __forceinline__ void split_range(const Args& a, int* s0,
                                            int* s1) {
  const int steps = (a.K + BK - 1) / BK;
  *s0 = blockIdx.z * a.steps_per_split;
  *s1 = min(steps, *s0 + a.steps_per_split);
}

// Write one fp32 result: rounded into out, or as this split's partial.
template <typename T>
__device__ __forceinline__ void emit(const Args& a, int gr, int gc, float v) {
  if (gr >= a.M || gc >= a.N) return;
  const size_t o = (size_t)gr * a.N + gc;
  if (a.partial == nullptr)
    static_cast<T*>(a.out)[o] = from_f<T>(v);
  else
    a.partial[(size_t)blockIdx.z * a.M * a.N + o] = v;
}

// ------------------------------------------------------------- bf16 (wmma)
template <int V, int FMT>
__global__ void __launch_bounds__(Tile<V>::THREADS)
    qmm_bf16_kernel(Args a) {
  using TL = Tile<V>;
  constexpr int BM = TL::BM, BN = TL::BN, THREADS = TL::THREADS;
  constexpr int LDX = BK + XPAD, LDW = BN + 8;
  constexpr int WARPS = THREADS / 32;
  __shared__ __align__(32) bf16 Xs[BM * LDX];
  __shared__ __align__(32) bf16 Ws[BK * LDW];
  __shared__ __align__(32) float Cs[WARPS][16 * 16];
  __shared__ float cb[16];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (threadIdx.x < 16)
    cb[threadIdx.x] = a.codebook != nullptr ? a.codebook[threadIdx.x] : 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TL::FRAG_M]
                                                          [TL::FRAG_N];
#pragma unroll
  for (int i = 0; i < TL::FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < TL::FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  int s0, s1;
  split_range(a, &s0, &s1);
  const bf16* x = static_cast<const bf16*>(a.x);
  for (int step = s0; step < s1; ++step) {
    const int k0 = step * BK;
    __syncthreads();  // cb is written; the previous tiles are consumed
    load_x<bf16, BM, THREADS, LDX>(x, Xs, a.M, a.K, m0, k0);
    load_w<bf16, FMT, BN, THREADS, LDW>(a.packed, a.scales, a.row_norm,
                                        a.col_norm, cb, Ws, a.N, a.K, a.bs,
                                        n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[TL::FRAG_M];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[TL::FRAG_N];
#pragma unroll
      for (int i = 0; i < TL::FRAG_M; ++i)
        wmma::load_matrix_sync(
            fa[i], Xs + (wm * TL::FRAG_M * 16 + i * 16) * LDX + kk, LDX);
#pragma unroll
      for (int j = 0; j < TL::FRAG_N; ++j)
        wmma::load_matrix_sync(
            fb[j], Ws + kk * LDW + wn * TL::FRAG_N * 16 + j * 16, LDW);
#pragma unroll
      for (int i = 0; i < TL::FRAG_M; ++i)
#pragma unroll
        for (int j = 0; j < TL::FRAG_N; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  // epilogue: each warp stages one 16x16 fp32 fragment at a time
#pragma unroll
  for (int i = 0; i < TL::FRAG_M; ++i) {
#pragma unroll
    for (int j = 0; j < TL::FRAG_N; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = m0 + wm * TL::FRAG_M * 16 + i * 16 + e / 16;
        const int gc = n0 + wn * TL::FRAG_N * 16 + j * 16 + e % 16;
        emit<bf16>(a, gr, gc, Cs[warp][e]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------- float32 (SIMT)
template <int FMT>
__global__ void __launch_bounds__(Tile<kF32>::THREADS)
    qmm_f32_kernel(Args a) {
  constexpr int BM = Tile<kF32>::BM, BN = Tile<kF32>::BN;
  constexpr int THREADS = Tile<kF32>::THREADS;
  constexpr int LDX = BK + 4, LDW = BN;
  __shared__ __align__(16) float Xs[BM * LDX];
  __shared__ __align__(16) float Ws[BK * LDW];
  __shared__ float cb[16];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (threadIdx.x < 16)
    cb[threadIdx.x] = a.codebook != nullptr ? a.codebook[threadIdx.x] : 0.f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int s0, s1;
  split_range(a, &s0, &s1);
  const float* x = static_cast<const float*>(a.x);
  for (int step = s0; step < s1; ++step) {
    const int k0 = step * BK;
    __syncthreads();
    load_x<float, BM, THREADS, LDX>(x, Xs, a.M, a.K, m0, k0);
    load_w<float, FMT, BN, THREADS, LDW>(a.packed, a.scales, a.row_norm,
                                         a.col_norm, cb, Ws, a.N, a.K, a.bs,
                                         n0, k0);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xa[4], wb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = Xs[(ty + 16 * i) * LDX + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wb[j] = Ws[kk * LDW + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      emit<float>(a, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

// out = sum of the splits' fp32 partials, in split order, rounded once
template <typename T>
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     T* __restrict__ out, int splits,
                                     size_t mn) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * mn + i];
    out[i] = from_f<T>(acc);
  }
}

template <int V, int FMT>
int launch_bf16(const Args& a, int splits, cudaStream_t st) {
  using TL = Tile<V>;
  dim3 grid((a.N + TL::BN - 1) / TL::BN, (a.M + TL::BM - 1) / TL::BM, splits);
  qmm_bf16_kernel<V, FMT><<<grid, TL::THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int FMT>
int launch_f32(const Args& a, int splits, cudaStream_t st) {
  using TL = Tile<kF32>;
  dim3 grid((a.N + TL::BN - 1) / TL::BN, (a.M + TL::BM - 1) / TL::BM, splits);
  qmm_f32_kernel<FMT><<<grid, TL::THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int FMT>
int launch(int dtype, int variant, const Args& a, int splits,
           cudaStream_t st) {
  if (dtype == 1 && variant == kWide) return launch_bf16<kWide, FMT>(a, splits, st);
  if (dtype == 1 && variant == kNarrow)
    return launch_bf16<kNarrow, FMT>(a, splits, st);
  if (dtype == 0 && variant == kF32) return launch_f32<FMT>(a, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out (M, N) = x (M, K) @ dequant(packed, scales[, row_norm][, col_norm]).
// dtype: 0 float32, 1 bfloat16 (x and out); fmt: 0 NF4 (packed uint8
// (K/2, N), high nibble = even row, codebook = 16 fp32 values), 1 int8
// (packed int8 (K, N)); scales fp32 (ceil(K/bs), N); row_norm fp32 (K,)
// and col_norm fp32 (N,) or null.  variant: 0 wide / 1 narrow bf16 tiles,
// 2 the float32 tile.  splits > 1 splits K over blockIdx.z, writing fp32
// partials (splits, M, N) to `partial` and adding them in a second kernel.
// Needs K % 8 == 0 and a 16-byte aligned x.  Returns the cudaError_t of
// the launches.
extern "C" int quantized_matmul_launch(
    int dtype, int fmt, int variant, const void* x, const void* packed,
    const void* scales, const void* row_norm, const void* col_norm,
    const void* codebook, void* out, void* partial, int M, int N, int K,
    int bs, int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || bs <= 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (fmt == kNf4 && codebook == nullptr) return (int)cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const int steps = (K + BK - 1) / BK;
  Args a;
  a.x = x;
  a.packed = static_cast<const uint8_t*>(packed);
  a.scales = static_cast<const float*>(scales);
  a.row_norm = static_cast<const float*>(row_norm);
  a.col_norm = static_cast<const float*>(col_norm);
  a.codebook = static_cast<const float*>(codebook);
  a.out = out;
  a.partial = splits > 1 ? static_cast<float*>(partial) : nullptr;
  a.M = M;
  a.N = N;
  a.K = K;
  a.bs = bs;
  a.steps_per_split = (steps + splits - 1) / splits;
  splits = (steps + a.steps_per_split - 1) / a.steps_per_split;  // none empty
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = fmt == kNf4   ? launch<kNf4>(dtype, variant, a, splits, st)
            : fmt == kInt8 ? launch<kInt8>(dtype, variant, a, splits, st)
                           : (int)cudaErrorInvalidValue;
  if (err || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  if (dtype == 1)
    reduce_splits_kernel<bf16><<<blocks, 256, 0, st>>>(
        a.partial, static_cast<bf16*>(out), splits, mn);
  else
    reduce_splits_kernel<float><<<blocks, 256, 0, st>>>(
        a.partial, static_cast<float*>(out), splits, mn);
  return (int)cudaGetLastError();
}
