// Bf16 GEMM mainloops for Hopper (sm_90a) on wgmma with a TMA ring,
// shared by the port's kernels that end in a product with a dense weight
// and want their own epilogue: quanta_linear.cu adds the QuanTA delta
// there, banked_gather.cu each row's LoRA delta.  Both operands are
// row-major bf16, x (M, K) and w (K, N); the sums are fp32.
//
// gemm_tile, the body for many rows: each block computes its 128 x BN
// tile (BN 128 or 256) and hands the accumulators to an epilogue functor.
// Two consumer warpgroups (64 rows each) and a producer
// warpgroup whose first thread keeps kStages K steps of 64 in flight by
// TMA: the x tile (128 rows of 64 K, one 128-byte swizzled panel) and the
// w tile (64 K rows of BN columns: 64-column panels, MN-major), each step
// landing on its stage's `full` mbarrier.  The consumers run
// wgmma.m64n128k16 with both operands in shared memory, four a step for
// each 128 columns, and free a stage through its `empty` mbarrier once
// the step after it has been issued; setmaxnreg hands them the
// producer's registers.  TMA fills rows and columns past the matrix with
// zeros; the epilogue masks its stores.  One block an SM.  What bounds
// it is L2: a 128 x 128 tile reads 32 KB a K step for 2.1 MFLOP, more
// than the SMs together can draw from L2 at the tensor cores' rate; a
// 128 x 256 tile reads 48 KB for twice the work (PERF.md).
//
// decode_partials, the body for at most 64 rows (a decode tick), which
// is bound by reading w: each block streams a 64-column strip of one K
// range of w over every SM (K split until the SMs hold kDecBlocksPerSm
// blocks each, kernels/smem.py) and writes the fp32 partial product of
// its range for every row; the caller's second pass adds the splits in
// split order.  w is wgmma's A operand (w^T, MN-major) and x its B, so
// the rows (8 or 64) are wgmma's N.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "sm90.cuh"

namespace wg {

constexpr int kGemmBM = 128;      // rows a block: two consumer warpgroups
constexpr int kGemmBK = 64;       // K a step: one 128-byte row of x
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 384;
// setmaxnreg: one block an SM starts with 65536 / 384 registers a thread
// (168, rounded down to 8) and must not ask for more in all
constexpr int kGemmProducerRegs = 40, kGemmConsumerRegs = 232;
static_assert(128 * kGemmProducerRegs + 256 * kGemmConsumerRegs <=
                  kGemmThreads * ((65536 / kGemmThreads) & ~7),
              "setmaxnreg asks for more registers than the block holds");

template <int BN>
struct GemmPlan {
  static_assert(BN == 128 || BN == 256, "the w tile is 128 or 256 wide");
  static constexpr int PANEL = 64 * 128;            // 64 rows of 128 B
  static constexpr int X = kGemmBM * 128;            // the x tile
  static constexpr int W = PANEL * (BN / 64);        // the w tile
  static constexpr int STAGE = X + W;
  static constexpr int RING = kGemmStages * STAGE;
  static constexpr int BYTES = 1024 + RING + 2 * kGemmStages * 8;
};

// The block (blockIdx.y, blockIdx.x)'s tile: all kGemmThreads threads
// call it with the tensor maps of x (box 64 x 128, swizzled) and w (box
// 64 x 64, swizzled) and the dynamic shared memory of GemmPlan<BN>::BYTES.
// Each consumer thread then calls epi(acc, ring, m0, n0): acc[q] the
// m64n128 accumulators of its warpgroup's 64 rows and the tile's columns
// 128q..128q+127 (acc[q][4j + 2h + c] is row 64 * warpgroup + 16 * warp +
// lane / 4 + 8h, column 128q + 8j + 2 * (lane % 4) + c), ring the stage
// memory, free for the epilogue once every consumer has reached it
// (named barrier 1 over the 256 consumer threads).  Producer threads
// return without calling it.
template <int BN, typename Epi>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* tmx,
                                          const CUtensorMap* tmw, int K,
                                          uint8_t* smem_raw, Epi epi) {
  using P = GemmPlan<BN>;
  constexpr int NQ = BN / 128;
  constexpr int ST = kGemmStages;
  uint8_t* smem = sm90::align1024(smem_raw);
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t bars = base + P::RING;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * BN;
  const int T = (K + kGemmBK - 1) / kGemmBK;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 256);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------------------------------------------------- producer
    sm90::reg_dealloc<kGemmProducerRegs>();
    if (tid != 256) return;
    for (int n = 0; n < T; ++n) {
      const int s = n % ST;
      if (n >= ST) sm90::mbar_wait(empty(s), ((n / ST) - 1) & 1);
      const uint32_t st = base + s * P::STAGE;
      sm90::mbar_arrive_expect(full(s), P::STAGE);
      sm90::tma_load_2d(st, tmx, n * kGemmBK, m0, full(s));
#pragma unroll
      for (int p = 0; p < BN / 64; ++p)
        sm90::tma_load_2d(st + P::X + p * P::PANEL, tmw, n0 + 64 * p,
                          n * kGemmBK, full(s));
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  sm90::reg_alloc<kGemmConsumerRegs>();
  const int w = tid >> 7;
  float acc[NQ][64];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[q][i] = 0.f;
  for (int n = 0; n < T; ++n) {
    const int s = n % ST;
    sm90::mbar_wait(full(s), (n / ST) & 1);
    const uint32_t xs = base + s * P::STAGE + w * 64 * 128;
    const uint32_t ws = base + s * P::STAGE + P::X;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        sm90::wgmma_ss<128, 0, 1>(
            acc[q], sm90::desc(xs + 32 * kk, 16, 1024),
            sm90::desc(ws + 2 * q * P::PANEL + kk * 2048, P::PANEL, 1024),
            1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();   // step n - 1's products are done
    if (n > 0) sm90::mbar_arrive(empty((n - 1) % ST));
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < NQ; ++q) sm90::fence_regs(acc[q]);
  sm90::named_sync(1, 256);   // every consumer is done with the ring
  epi(acc, smem, m0, n0);
}

// The decode body: block (column tile, split) of kDecThreads threads
// computes the fp32 partial out^T = w[k range, 64 columns]^T x[:, k
// range]^T for every row (RN: the rows rounded up to 8 or 64, wgmma's N)
// and stores it to part[split] (M, N), masked past M and N.  w comes by
// TMA through a kDecStages ring fed by the fifth warp's first thread
// (tensor maps: w boxes of 64 x 64, x boxes of RN x 64, both swizzled);
// the split takes K steps [split * steps_per_split, ...) of 64.  Dynamic
// shared memory: DecPlan<RN>::BYTES.
constexpr int kDecBN = 64, kDecStages = 4, kDecThreads = 160;
constexpr int kDecBlocksPerSm = 4;   // the plan splits K to fill this many

template <int RN>
struct DecPlan {
  static_assert(RN == 8 || RN == 64, "wgmma's N: 8 or 64 rows");
  static constexpr int W = 64 * 128;                       // one panel
  static constexpr int X = (RN * 128 + 1023) / 1024 * 1024;
  static constexpr int STAGE = W + X;
  static constexpr int BYTES = 1024 + kDecStages * STAGE + 2 * kDecStages * 8;
};

template <int RN>
__device__ __forceinline__ void decode_partials(const CUtensorMap* tmx,
                                                const CUtensorMap* tmw,
                                                float* __restrict__ part,
                                                int M, int N, int K,
                                                int steps_per_split,
                                                uint8_t* smem_raw) {
  using P = DecPlan<RN>;
  constexpr int ST = kDecStages;
  uint8_t* smem = sm90::align1024(smem_raw);
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t bars = base + ST * P::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  const int tid = threadIdx.x, n0 = blockIdx.x * kDecBN;
  const int steps = (K + 63) / 64;
  const int s0 = blockIdx.y * steps_per_split;
  const int T = min(steps, s0 + steps_per_split) - s0;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid >= 128) {
    if (tid != 128) return;
    for (int n = 0; n < T; ++n) {
      const int s = n % ST;
      if (n >= ST) sm90::mbar_wait(empty(s), ((n / ST) - 1) & 1);
      const uint32_t st = base + s * P::STAGE;
      sm90::mbar_arrive_expect(full(s), P::W + RN * 128);
      sm90::tma_load_2d(st, tmw, n0, (s0 + n) * 64, full(s));
      sm90::tma_load_2d(st + P::W, tmx, (s0 + n) * 64, 0, full(s));
    }
    return;
  }
  float acc[RN / 2];
#pragma unroll
  for (int i = 0; i < RN / 2; ++i) acc[i] = 0.f;
  for (int n = 0; n < T; ++n) {
    const int s = n % ST;
    sm90::mbar_wait(full(s), (n / ST) & 1);
    const uint32_t ws = base + s * P::STAGE, xs = ws + P::W;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss<RN, 1, 0>(acc, sm90::desc(ws + kk * 2048, P::W, 1024),
                               sm90::desc(xs + 32 * kk, 16, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (n > 0) sm90::mbar_arrive(empty((n - 1) % ST));
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  // acc[4j + 2h + c]: w column n0 + 16 * warp + lane / 4 + 8h, x row
  // 8j + 2 * (lane % 4) + c
  const int lane = tid & 31;
  const int col = n0 + 16 * (tid >> 5) + (lane >> 2);
  float* pz = part + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int j = 0; j < RN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = 8 * j + 2 * (lane & 3) + c;
        if (row < M && col + 8 * h < N)
          pz[(size_t)row * N + col + 8 * h] = acc[4 * j + 2 * h + c];
      }
}

constexpr int kMaxDevices = 64;

// Raise the kernel's dynamic shared-memory cap to `bytes` on the current
// device, once per device (granted: the cap given so far, per device);
// refuse what the device cannot give.  Returns a cudaError_t.
template <typename Kern>
int allow_smem(Kern kernel, int bytes, int smem_limit, int* granted) {
  if (bytes > smem_limit) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  granted[dev] = bytes;
  return 0;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no driver stub)
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A row-major bf16 matrix (rows, cols) as boxes of box_rows x box_cols
// (box_cols * 2 <= 128 bytes), 128-byte swizzled, zero past the matrix.
// Returns a cudaError_t.
inline int tensor_map(CUtensorMap* map, const void* base, int rows,
                      int cols, int box_rows, int box_cols) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace wg
