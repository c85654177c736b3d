// A bf16 GEMM mainloop for Hopper (sm_90a) on wgmma with a TMA ring,
// shared by the port's kernels that end in a product with a dense weight
// and want their own epilogue: each block computes its 128 x BN tile (BN
// 128 or 256) of x (M, K) @ w (K, N), both row-major bf16, with fp32
// accumulators, and hands the accumulators to an epilogue functor.  banked_gather.cu adds
// each row's LoRA delta there; tiled_gemm.cuh is the older wmma loop of
// quanta_linear.cu, which can move onto this one.
//
// The block: two consumer warpgroups (64 rows each) and a producer
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
