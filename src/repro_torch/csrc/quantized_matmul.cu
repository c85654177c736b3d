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
// tile per 64-row K step (a multiple of the quant block's alignment and
// of the two rows of an NF4 byte), so every shape of the serving path
// takes the kernel; the TPU kernel keeps the whole d_in per tile, which
// overflows its VMEM budget at llama2-7b widths.
//
// What bounds it on the H100, and what each body does about it.  Both
// bf16 bodies compute out^T = W^T x^T on the tensor cores: the weight is
// wgmma's A operand, decoded by the consumer threads straight into the
// register layout wgmma reads (no decoded tile in shared memory, no
// proxy fence), and the x tile is its B operand, K-major in a 128-byte
// swizzled shared-memory tile.  Codes arrive as the packed weight lies
// (d_out contiguous); a thread's two A rows are made two adjacent columns
// and its K pairs are the two nibbles of one NF4 byte, so one 16-bit load
// gives two fragment registers' pairs of weights.
//   * prefill (more than 64 rows): the tensor cores, 2*M*K*N bf16
//     operations against 0.5 B a weight.  A block computes 192 weight
//     columns x 128 rows, one block an SM: a producer warpgroup fills a
//     ring of kPreStagesNf4 (kPreStagesInt8) stages -- the x tile (128 x 64
//     bf16) by TMA, 128-byte swizzled as wgmma reads it, the code tile (32
//     x 192 bytes for NF4, 64 x 192 for int8), the step's scale rows and
//     row norms by 16-byte cp.async -- and every copy lands on the stage's
//     `full` mbarrier; three consumer warpgroups, 64 columns each, decode
//     step i+1 while wgmma.m64n128k16 runs step i, and free a stage through
//     its `empty` mbarrier (setmaxnreg hands them the producer's
//     registers).  What bounds it now is shared memory: per step the three
//     warpgroups read the 16 KB x tile once each, decoding costs one
//     codebook lookup per weight, and the copies land there too (PERF.md).
//   * decode (at most 64 rows): the code bytes.  One warpgroup per 64
//     columns (the rows, rounded up to 8 -- a decode tick -- or else to
//     64, are wgmma's N)
//     keeps kDecStages - 1 steps of 16-byte code, scale and x loads in
//     flight through a cp.async ring under full/empty mbarriers, every
//     thread both loading and decoding, step i+1 decoded while step i's
//     products run.  K is split over blocks to fill the kDecBlocksPerSm
//     blocks an SM holds at once, and no more (kernels/smem.py), and the
//     shared-memory carveout is set to its maximum so that they fit.
//   * float32 runs 64 x 64 SIMT tiles with exact fp32 FMAs (TF32 would
//     change the numbers), loading element by element.
// Split-K partials are fp32 and a second kernel adds them in split order
// and rounds once, so the result does not depend on block scheduling.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "geometry.cuh"
#include "sm90.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;         // K rows per step
constexpr int kNf4 = 0, kInt8 = 1;
// variant codes the host passes
constexpr int kPrefill = 0, kDecode = 1, kF32 = 2;
constexpr int kMaxDevices = 64;
// scale rows one 64-row K step can touch, for block sizes >= 8
constexpr int kMaxScaleRows = 9;
constexpr int kMinBlock = 8;


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

// ------------------------------------------------ bf16 stages (wgmma bodies)

// One ring stage of a BM x BN tile: the x tile (BM rows of 128 B,
// swizzled), the code tile (CR rows of BN bytes), the step's scale rows
// (kMaxScaleRows x BN fp32) and its 64 row norms, 1024-aligned in all.
template <int BM_, int BN_, int CR = BK>
struct Stage {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int X = 0;
  static constexpr int CODES = X + BM * 128;
  static constexpr int SCALES = CODES + CR * BN;
  static constexpr int ROWN = SCALES + kMaxScaleRows * BN * 4;
  static constexpr int BYTES = (ROWN + BK * 4 + 1023) / 1024 * 1024;
};

// Issue the cp.async (or, for code rows that are not 4-byte aligned, the
// plain copies) of K step `step` of the tile (m0, n0) into a stage at
// shared address st (generic pointer st_g), by threads pt of nt; X: the x
// tile too (the prefill body's arrives by TMA).  publish_step then
// arrives on the stage's `full` barrier.
template <int FMT, class SL, bool X = true>
__device__ __forceinline__ void issue_step(const Args& a, int step, int m0,
                                           int n0, uint32_t st,
                                           uint8_t* st_g, int pt, int nt) {
  constexpr int BM = SL::BM, BN = SL::BN;
  const int k0 = step * BK;
  const bf16* x = static_cast<const bf16*>(a.x);
  for (int i = pt; i < (X ? BM * 8 : 0); i += nt) {
    const int r = i >> 3, c = i & 7;
    const bool ok = m0 + r < a.M && k0 + 8 * c < a.K;
    sm90::cp_async16(st + SL::X + sm90::swz(r, c),
                     ok ? x + (size_t)(m0 + r) * a.K + k0 + 8 * c : x, ok);
  }
  constexpr int CR = FMT == kNf4 ? BK / 2 : BK;   // code rows a step
  const int kr0 = FMT == kNf4 ? k0 / 2 : k0;
  const int kr_end = FMT == kNf4 ? a.K / 2 : a.K;
  const uint8_t* p = a.packed;
  if (a.N % 16 == 0) {
    for (int i = pt; i < CR * (BN / 16); i += nt) {
      const int r = i / (BN / 16), c = 16 * (i % (BN / 16));
      const bool ok = kr0 + r < kr_end && n0 + c < a.N;
      sm90::cp_async16(st + SL::CODES + r * BN + c,
                       ok ? p + (size_t)(kr0 + r) * a.N + n0 + c : p, ok);
    }
  } else if (a.N % 4 == 0) {
    for (int i = pt; i < CR * (BN / 4); i += nt) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      const bool ok = kr0 + r < kr_end && n0 + c < a.N;
      sm90::cp_async4(st + SL::CODES + r * BN + c,
                      ok ? p + (size_t)(kr0 + r) * a.N + n0 + c : p, ok);
    }
  } else {
    for (int i = pt; i < CR * BN; i += nt) {
      const int r = i / BN, c = i % BN;
      const bool ok = kr0 + r < kr_end && n0 + c < a.N;
      st_g[SL::CODES + r * BN + c] =
          ok ? __ldg(p + (size_t)(kr0 + r) * a.N + n0 + c) : 0;
    }
  }
  const int sb0 = k0 / a.bs;
  const int nsb = (min(k0 + BK, a.K) - 1) / a.bs - sb0 + 1;
  const float* sc = a.scales;
  if (a.N % 4 == 0) {
    for (int i = pt; i < nsb * (BN / 4); i += nt) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      const bool ok = n0 + c < a.N;
      sm90::cp_async16(st + SL::SCALES + 4 * (r * BN + c),
                       ok ? sc + (size_t)(sb0 + r) * a.N + n0 + c : sc, ok);
    }
  } else {
    for (int i = pt; i < nsb * BN; i += nt) {
      const int r = i / BN, c = i % BN;
      const bool ok = n0 + c < a.N;
      sm90::cp_async4(st + SL::SCALES + 4 * (r * BN + c),
                      ok ? sc + (size_t)(sb0 + r) * a.N + n0 + c : sc, ok);
    }
  }
  if (a.row_norm != nullptr) {
    for (int i = pt; i < BK / 4; i += nt) {
      const bool ok = k0 + 4 * i < a.K;
      sm90::cp_async16(st + SL::ROWN + 16 * i,
                       ok ? a.row_norm + k0 + 4 * i : a.row_norm, ok);
    }
  }
}

// Arrive on `full` for this thread's part of a step issued by issue_step:
// once its cp.async copies have landed and, where the code rows took plain
// stores (d_out % 4 != 0), through an ordinary arrive that releases them to
// the threads that wait on the barrier.  Each thread counts once.
__device__ __forceinline__ void publish_step(const Args& a, uint32_t full) {
  if (a.N % 4 == 0) {
    sm90::cp_async_arrive(full);
  } else {
    sm90::cp_async_arrive_inc(full);
    sm90::mbar_arrive(full);
  }
}

// This thread's A fragments (W^T: 64 weight columns x the 64 K rows of one
// staged step) for the four 16-deep K slices, decoded from the stage's code
// tile straight into wgmma's register layout.  The A rows are a permutation
// of the columns: a thread's two rows (r and r + 8 of its warp's 16) are
// the adjacent columns col and col + 1, so one 16-bit load brings both
// columns' codes of a K pair.  frag[kk][2h + j] holds column col + j and K
// rows 16kk + 8h + 2 * quad and + 1 (low half first); each weight is the
// code value times its block's scale, times the row norm, times the column
// norm (cn), in fp32, then rounded; rows at or past K are zero.  The K rows
// a thread visits rise, so its scale row advances at most once between two
// of them (blocks of at least 8 rows) and each scale is read once per
// column and block.
template <int FMT, class SL>
__device__ __forceinline__ void decode_frags(const uint8_t* st_g,
                                             const Args& a, int k0, int col,
                                             int quad, const float (&cn)[2],
                                             const float* cb,
                                             uint32_t (&frag)[4][4]) {
  constexpr int BN = SL::BN;
  const uint8_t* codes = st_g + SL::CODES + col;
  const float* srows =
      reinterpret_cast<const float*>(st_g + SL::SCALES) + col;
  const float* rn = reinterpret_cast<const float*>(st_g + SL::ROWN);
  const int sb0 = k0 / a.bs;
  int sr = (k0 + 2 * quad) / a.bs - sb0;
  int bound = (sb0 + sr + 1) * a.bs;
  float2 s = *reinterpret_cast<const float2*>(srows + sr * BN);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float w[2][2];   // [column j][row e]
      uint32_t b[2][2];
      const int kl0 = 16 * kk + 8 * h + 2 * quad;
      if (FMT == kNf4) {
        const uint32_t two =
            *reinterpret_cast<const uint16_t*>(codes + (kl0 >> 1) * BN);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          b[j][0] = (two >> (8 * j + 4)) & 15u;
          b[j][1] = (two >> (8 * j)) & 15u;
        }
      } else {
        const uint32_t r0 =
            *reinterpret_cast<const uint16_t*>(codes + kl0 * BN);
        const uint32_t r1 =
            *reinterpret_cast<const uint16_t*>(codes + (kl0 + 1) * BN);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          b[j][0] = (r0 >> (8 * j)) & 0xffu;
          b[j][1] = (r1 >> (8 * j)) & 0xffu;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = kl0 + e, gk = k0 + kl;
        if (gk >= bound) {
          ++sr;
          bound += a.bs;
          s = *reinterpret_cast<const float2*>(srows + sr * BN);
        }
        const float r = a.row_norm != nullptr ? rn[kl] : 1.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = FMT == kNf4 ? cb[b[j][e]] : (float)(int8_t)b[j][e];
          v = v * (j ? s.y : s.x);
          if (a.row_norm != nullptr) v = v * r;
          if (a.col_norm != nullptr) v = v * cn[j];
          w[j][e] = gk < a.K ? v : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        frag[kk][2 * h + j] = sm90::pack_bf16(w[j][0], w[j][1]);
    }
}

// decode_frags for a step that lies inside K and inside one quant block
// (the main path: blocks of 64 rows, 64-row steps): the scale pair is read
// once, and every load is issued before the arithmetic that waits on it.
template <int FMT, class SL>
__device__ __forceinline__ void decode_frags_block(
    const uint8_t* st_g, const Args& a, int sr, int col, int quad,
    const float (&cn)[2], const float* cb, uint32_t (&frag)[4][4]) {
  constexpr int BN = SL::BN;
  const uint8_t* codes = st_g + SL::CODES + col;
  const float* rn = reinterpret_cast<const float*>(st_g + SL::ROWN);
  const float2 s = *reinterpret_cast<const float2*>(
      reinterpret_cast<const float*>(st_g + SL::SCALES) + sr * BN + col);
  // code words: NF4 one 16-bit pair (two columns) per K pair; int8 one per
  // K row
  constexpr int W = FMT == kNf4 ? 8 : 16;
  uint32_t word[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int kl = FMT == kNf4 ? 16 * (i >> 1) + 8 * (i & 1) + 2 * quad
                               : 16 * (i >> 2) + 8 * ((i >> 1) & 1) +
                                     2 * quad + (i & 1);
    word[i] = *reinterpret_cast<const uint16_t*>(
        codes + (FMT == kNf4 ? kl >> 1 : kl) * BN);
  }
  float v[4][2][2][2];   // [kk][h][column j][row e]
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t b;
          if (FMT == kNf4)
            b = (word[2 * kk + h] >> (8 * j + (e ? 0 : 4))) & 15u;
          else
            b = (word[4 * kk + 2 * h + e] >> (8 * j)) & 0xffu;
          v[kk][h][j][e] = FMT == kNf4 ? cb[b] : (float)(int8_t)b;
        }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float w[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float r = a.row_norm != nullptr
                            ? rn[16 * kk + 8 * h + 2 * quad + e]
                            : 1.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = v[kk][h][j][e] * (j ? s.y : s.x);
          if (a.row_norm != nullptr) x = x * r;
          if (a.col_norm != nullptr) x = x * cn[j];
          w[j][e] = x;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        frag[kk][2 * h + j] = sm90::pack_bf16(w[j][0], w[j][1]);
    }
}

// The step's fragments: the one-block fast path when the step allows it.
template <int FMT, class SL>
__device__ __forceinline__ void decode_step(const uint8_t* st_g,
                                            const Args& a, int k0, int col,
                                            int quad, const float (&cn)[2],
                                            const float* cb,
                                            uint32_t (&frag)[4][4]) {
  const int sb0 = k0 / a.bs;
  if (k0 + BK <= a.K && (k0 + BK - 1) / a.bs == sb0)
    decode_frags_block<FMT, SL>(st_g, a, 0, col, quad, cn, cb, frag);
  else
    decode_frags<FMT, SL>(st_g, a, k0, col, quad, cn, cb, frag);
}

// The column norms of global columns gn and gn + 1 (1 past N or without).
__device__ __forceinline__ void load_cn(const Args& a, int gn,
                                        float (&cn)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    cn[j] = (a.col_norm != nullptr && gn + j < a.N)
                ? __ldg(a.col_norm + gn + j)
                : 1.f;
}

// Both bf16 bodies compute out^T = W^T x^T: A is a 64-column slice of the
// weight, decoded into registers, B the x tile (rows as wgmma's N, K-major
// in shared memory).  acc[4j + 2e + c] is then column gcol + e (see
// decode_frags), x row m0 + 8j + 2 * quad + c: a thread writes two
// adjacent columns of a row at once.
template <int RN>
__device__ __forceinline__ void emit_tile(const Args& a, int m0, int gcol,
                                          int quad,
                                          const float (&acc)[RN / 2]) {
  const bool pairs = a.N % 2 == 0 && gcol + 1 < a.N;
#pragma unroll
  for (int j = 0; j < RN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gr = m0 + 8 * j + 2 * quad + c;
      const float v0 = acc[4 * j + c], v1 = acc[4 * j + 2 + c];
      if (gr >= a.M || gcol >= a.N) continue;
      const size_t o = (size_t)gr * a.N + gcol;
      if (!pairs) {
        emit<bf16>(a, gr, gcol, v0);
        emit<bf16>(a, gr, gcol + 1, v1);
      } else if (a.partial == nullptr) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + o) =
            sm90::pack_bf16(v0, v1);
      } else {
        *reinterpret_cast<float2*>(
            a.partial + (size_t)blockIdx.z * a.M * a.N + o) =
            make_float2(v0, v1);
      }
    }
}

// ---------------------------------------------------------- bf16 prefill
constexpr int kPreWGs = 3;                   // consumer warpgroups
constexpr int kPreBM = 128;                  // x rows a block (wgmma N)
constexpr int kPreBN = 64 * kPreWGs;         // weight columns a block
constexpr int kPreThreads = 128 * (kPreWGs + 1);
constexpr int kPreStagesNf4 = 7, kPreStagesInt8 = 6;   // ring depths
// setmaxnreg moves the producer's registers to the consumers: the block
// starts with 65536 / kPreThreads each (what __launch_bounds__ allows) and
// must not ask for more in all, or the consumers' request never returns
constexpr int kPreProducerRegs = 32, kPreConsumerRegs = 160;
static_assert(128 * kPreProducerRegs + 128 * kPreWGs * kPreConsumerRegs <=
                  kPreThreads * ((65536 / kPreThreads) & ~7),
              "setmaxnreg asks for more registers than the block holds");

// The prefill body's shared memory: the ring of load stages (x, codes,
// scales, row norms), then the mbarriers.
template <int FMT>
struct Pre {
  using SL = Stage<kPreBM, kPreBN, FMT == kNf4 ? BK / 2 : BK>;
  static constexpr int LS = FMT == kNf4 ? kPreStagesNf4 : kPreStagesInt8;
  static constexpr int BARS = LS * SL::BYTES;
  static constexpr int BYTES = 1024 + BARS + 2 * LS * 8;
};

// grid (ceil(N/192), ceil(M/128), splits); warpgroups 0-2 consume
// (warpgroup w owns weight columns 64w..64w+63 of the tile and decodes
// their codes itself, step i+1 while the tensor cores run step i), 3
// loads.  full[LS]: a step's loads landed; empty[LS]: it is consumed.
template <int FMT>
__global__ void __launch_bounds__(kPreThreads, 1)
    qmm_prefill_kernel(Args a, const __grid_constant__ CUtensorMap tmx) {
  using PL = Pre<FMT>;
  using SL = typename PL::SL;
  constexpr int LS = PL::LS;
  extern __shared__ uint8_t pre_smem_raw[];
  __shared__ float cb[16];
  uint8_t* smem = sm90::align1024(pre_smem_raw);
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t bars = base + PL::BARS;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (LS + s); };
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kPreBM, n0 = blockIdx.x * kPreBN;
  int s0, s1;
  split_range(a, &s0, &s1);
  const int T = s1 - s0;
  if (tid < 16) cb[tid] = a.codebook != nullptr ? a.codebook[tid] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < LS; ++s) {
      sm90::mbar_init(full(s), 128 + 1);   // + the x tile's TMA
      sm90::mbar_init(empty(s), 128 * kPreWGs);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kPreWGs) {
    // ---------------------------------------------------------- producer
    sm90::reg_dealloc<kPreProducerRegs>();
    const int pt = tid - 128 * kPreWGs;
    for (int n = 0; n < T; ++n) {
      const int s = n % LS;
      if (n >= LS) sm90::mbar_wait(empty(s), ((n / LS) - 1) & 1);
      if (pt == 0) {   // the x tile by TMA, swizzled as wgmma reads it
        sm90::mbar_arrive_expect(full(s), kPreBM * 128);
        sm90::tma_load_2d(base + s * SL::BYTES + SL::X, &tmx, (s0 + n) * BK,
                          m0, full(s));
      }
      issue_step<FMT, SL, false>(a, s0 + n, m0, n0, base + s * SL::BYTES,
                                 smem + s * SL::BYTES, pt, 128);
      publish_step(a, full(s));
    }
    sm90::cp_async_wait<0>();
  } else {
    // --------------------------------------------------------- consumers
    sm90::reg_alloc<kPreConsumerRegs>();
    const int w = tid >> 7, t = tid & 127, lane = t & 31, quad = lane & 3;
    const int col = 64 * w + 16 * (t >> 5) + 2 * (lane >> 2);  // and + 1
    float cn[2];
    load_cn(a, n0 + col, cn);
    float acc[kPreBM / 2];
#pragma unroll
    for (int i = 0; i < kPreBM / 2; ++i) acc[i] = 0.f;
    uint32_t frag[2][4][4];   // two steps' fragments: one read in flight
    auto step = [&](int n, uint32_t (&f)[4][4]) {
      const int s = n % LS;
      sm90::mbar_wait(full(s), (n / LS) & 1);
      decode_step<FMT, SL>(smem + s * SL::BYTES, a, (s0 + n) * BK, col,
                           quad, cn, cb, f);
      const uint32_t xs = base + s * SL::BYTES + SL::X;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_rs<kPreBM, 0>(acc, f[kk],
                                  sm90::desc(xs + 32 * kk, 16, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();   // step n - 1's products are done
      if (n > 0) sm90::mbar_arrive(empty((n - 1) % LS));
    };
    int n = 0;
    for (; n + 1 < T; n += 2) {
      step(n, frag[0]);
      step(n + 1, frag[1]);
    }
    if (n < T) step(n, frag[0]);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    emit_tile<kPreBM>(a, m0, n0 + col, quad, acc);
  }
}

// ----------------------------------------------------------- bf16 decode
constexpr int kDecBN = 64, kDecStages = 5, kDecThreads = 128;
// blocks an SM holds at once (registers and shared memory are sized for
// it), and the plan splits K to fill exactly that many
constexpr int kDecBlocksPerSm = 4;

template <int RN>
struct DecPlan {
  using SL = Stage<RN, kDecBN>;
  static constexpr int BYTES = 1024 + kDecStages * SL::BYTES +
                               2 * kDecStages * 8;
};

// grid (ceil(N/64), 1, splits); one warpgroup computes out^T (64 columns x
// RN rows) for its K range.  Every thread both loads and computes: the
// code, scale, norm and x tiles of the next kDecStages - 1 steps stay in
// flight through a cp.async ring whose copies arrive on each stage's
// `full` mbarrier as they land; each thread decodes its A fragments of
// step i + 1 while the four wgmma.m64nRNk16 of step i run, and a stage is
// refilled once every thread has arrived on its `empty` mbarrier.
template <int FMT, int RN>
__global__ void __launch_bounds__(kDecThreads, kDecBlocksPerSm)
    qmm_decode_kernel(Args a) {
  using DP = DecPlan<RN>;
  using SL = typename DP::SL;
  constexpr int ST = kDecStages;
  extern __shared__ uint8_t dec_smem_raw[];
  __shared__ float cb[16];
  uint8_t* smem = sm90::align1024(dec_smem_raw);
  const uint32_t ring = sm90::smem_u32(smem);
  const uint32_t bars = ring + ST * SL::BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  const int tid = threadIdx.x, lane = tid & 31, quad = lane & 3;
  const int col = 16 * (tid >> 5) + 2 * (lane >> 2);   // and col + 1
  const int n0 = blockIdx.x * kDecBN;
  int s0, s1;
  split_range(a, &s0, &s1);
  const int T = s1 - s0;
  if (tid < 16) cb[tid] = a.codebook != nullptr ? a.codebook[tid] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full(s), kDecThreads);
      sm90::mbar_init(empty(s), kDecThreads);
    }
    sm90::mbar_init_fence();
  }
  float cn[2];
  load_cn(a, n0 + col, cn);
  __syncthreads();

  auto issue = [&](int n) {
    const int s = n % ST;
    issue_step<FMT, SL>(a, s0 + n, 0, n0, ring + s * SL::BYTES,
                        smem + s * SL::BYTES, tid, kDecThreads);
    publish_step(a, full(s));
  };
  for (int n = 0; n < ST - 1 && n < T; ++n) issue(n);

  float acc[RN / 2];
#pragma unroll
  for (int i = 0; i < RN / 2; ++i) acc[i] = 0.f;
  uint32_t frag[2][4][4];   // two steps' fragments: one read in flight
  auto step = [&](int n, uint32_t (&f)[4][4]) {
    const int s = n % ST, k0 = (s0 + n) * BK;
    sm90::mbar_wait(full(s), (n / ST) & 1);
    decode_step<FMT, SL>(smem + s * SL::BYTES, a, k0, col, quad, cn, cb, f);
    const uint32_t xs = ring + s * SL::BYTES + SL::X;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_rs<RN, 0>(acc, f[kk], sm90::desc(xs + 32 * kk, 16, 1024),
                            1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();   // step n - 1's products are done
    // step n + ST - 1 goes into step n - 1's stage (the stage left free by
    // the prologue when n == 0) once every thread is done with step n - 1
    const int p = (n + ST - 1) % ST;
    if (n > 0) sm90::mbar_arrive(empty(p));
    if (n + ST - 1 < T) {
      if (n > 0) sm90::mbar_wait(empty(p), ((n - 1) / ST) & 1);
      issue(n + ST - 1);
    }
  };
  int n = 0;
  for (; n + 1 < T; n += 2) {
    step(n, frag[0]);
    step(n + 1, frag[1]);
  }
  if (n < T) step(n, frag[0]);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::cp_async_wait<0>();
  emit_tile<RN>(a, 0, n0 + col, quad, acc);
}

// ---------------------------------------------------------- float32 (SIMT)
constexpr int kF32BM = 64, kF32BN = 64, kF32Threads = 256;

// Load the x tile rows [m0, m0+BM) x cols [k0, k0+BK) as 16-byte vectors
// (the host checks K % 8 == 0 and 16-byte alignment, so a vector is
// wholly inside or outside the matrix); out-of-range rows are zero.
template <int BM, int LD>
__device__ __forceinline__ void load_x_f32(const float* __restrict__ x,
                                           float* xs, int M, int K, int m0,
                                           int k0) {
  for (int v = threadIdx.x; v < BM * BK / 4; v += kF32Threads) {
    const int r = v / (BK / 4), c = (v % (BK / 4)) * 4;
    const int gr = m0 + r, gc = k0 + c;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < M && gc < K)
      val = *reinterpret_cast<const uint4*>(x + (size_t)gr * K + gc);
    *reinterpret_cast<uint4*>(xs + r * LD + c) = val;
  }
}

// Decode the weight tile rows [k0, k0+BK) x cols [n0, n0+BN) into ws
// (row stride LD).  Thread t owns column t % BN and a run of
// BK / (THREADS / BN) consecutive rows; a warp's loads are consecutive
// bytes of one packed row.
template <int FMT, int LD>
__device__ __forceinline__ void load_w_f32(const Args& a, const float* cb,
                                           float* ws, int n0, int k0) {
  constexpr int G = kF32Threads / kF32BN;
  constexpr int R = BK / G;
  static_assert(R % 2 == 0, "rows per thread come in NF4 pairs");
  const int n = threadIdx.x % kF32BN, g = threadIdx.x / kF32BN;
  const int gn = n0 + n;
  const bool col_ok = gn < a.N;
  const float cn = (col_ok && a.col_norm != nullptr)
                       ? __ldg(a.col_norm + gn)
                       : 1.f;
  int sb = -1;
  float s = 0.f;
#pragma unroll 4
  for (int i = 0; i < R; i += 2) {
    const int k = g * R + i, gk = k0 + k;
    float v[2] = {0.f, 0.f};
    if (col_ok && gk < a.K) {  // K is even, so gk + 1 < K too
      if (FMT == kNf4) {
        const uint8_t b = __ldg(a.packed + (size_t)(gk >> 1) * a.N + gn);
        v[0] = cb[b >> 4];
        v[1] = cb[b & 15];
      } else {
        const int8_t* q = reinterpret_cast<const int8_t*>(a.packed);
        v[0] = (float)__ldg(q + (size_t)gk * a.N + gn);
        v[1] = (float)__ldg(q + (size_t)(gk + 1) * a.N + gn);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int blk = (gk + e) / a.bs;
        if (blk != sb) {
          sb = blk;
          s = __ldg(a.scales + (size_t)blk * a.N + gn);
        }
        float w = v[e] * s;
        if (a.row_norm != nullptr) w = w * __ldg(a.row_norm + gk + e);
        if (a.col_norm != nullptr) w = w * cn;
        v[e] = w;
      }
    }
    ws[k * LD + n] = v[0];
    ws[(k + 1) * LD + n] = v[1];
  }
}

template <int FMT>
__global__ void __launch_bounds__(kF32Threads) qmm_f32_kernel(Args a) {
  constexpr int LDX = BK + 4, LDW = kF32BN;
  __shared__ __align__(16) float Xs[kF32BM * LDX];
  __shared__ __align__(16) float Ws[BK * LDW];
  __shared__ float cb[16];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kF32BM, n0 = blockIdx.x * kF32BN;
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
    load_x_f32<kF32BM, LDX>(x, Xs, a.M, a.K, m0, k0);
    load_w_f32<FMT, LDW>(a, cb, Ws, n0, k0);
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

// Raise the kernel's dynamic shared-memory cap to `bytes` on the current
// device, once per device and size; refuse what the device cannot give.
template <typename K>
int allow_smem(K kernel, size_t bytes, int smem_limit, int* granted) {
  if (bytes > (size_t)smem_limit) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if ((int)bytes <= granted[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // the most shared memory the SM can give, so that several decode blocks
  // fit at once
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  granted[dev] = (int)bytes;
  return 0;
}

template <int FMT>
int launch_prefill(const geom::Launch& l, const Args& a, int smem_limit,
                   cudaStream_t st) {
  static int granted[kMaxDevices] = {};
  int err =
      allow_smem(qmm_prefill_kernel<FMT>, l.smem, smem_limit, granted);
  if (err) return err;
  // x (M, K) bf16 as 128-row x 64-column boxes, 128-byte swizzled, zero
  // past the matrix
  CUtensorMap tmx;
  err = wg::tensor_map(&tmx, a.x, a.M, a.K, kPreBM, BK);
  if (err) return err;
  qmm_prefill_kernel<FMT><<<l.grid, l.threads, l.smem, st>>>(a, tmx);
  return (int)cudaGetLastError();
}

template <int FMT, int RN>
int launch_decode(const geom::Launch& l, const Args& a, int smem_limit,
                  cudaStream_t st) {
  static int granted[kMaxDevices] = {};
  int err =
      allow_smem(qmm_decode_kernel<FMT, RN>, l.smem, smem_limit, granted);
  if (err) return err;
  qmm_decode_kernel<FMT, RN><<<l.grid, l.threads, l.smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int FMT>
int launch(const geom::Launch& l, int variant, const Args& a, int smem_limit,
           cudaStream_t st) {
  if (variant == kPrefill) return launch_prefill<FMT>(l, a, smem_limit, st);
  if (variant == kDecode)
    return a.M <= 8 ? launch_decode<FMT, 8>(l, a, smem_limit, st)
                    : launch_decode<FMT, 64>(l, a, smem_limit, st);
  qmm_f32_kernel<FMT><<<l.grid, l.threads, l.smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The launches of quantized_matmul_launch: the body's grid (prefill
// (ceil(N/192), ceil(M/128), splits); decode (ceil(N/64), 1, splits);
// float32 (ceil(N/64), ceil(M/64), splits)), splits the non-empty K
// splits, then with more than one the reduce's blocks.
int geometry(int dtype, int fmt, int variant, const void* codebook,
             const void* partial, int M, int N, int K, int bs, int splits,
             int smem_limit, geom::Geometry* g) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || bs <= 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (fmt == kNf4 && codebook == nullptr) return (int)cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  if (fmt != kNf4 && fmt != kInt8) return (int)cudaErrorInvalidValue;
  const int steps = (K + BK - 1) / BK;
  const int per = (steps + splits - 1) / splits;
  splits = (steps + per - 1) / per;  // none empty
  if (dtype == 1 && bs < kMinBlock) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && variant == kPrefill) {
    const int smem = fmt == kNf4 ? Pre<kNf4>::BYTES : Pre<kInt8>::BYTES;
    if (smem > smem_limit) return (int)cudaErrorInvalidValue;
    g->add(dim3((N + kPreBN - 1) / kPreBN, (M + kPreBM - 1) / kPreBM, splits),
           kPreThreads, smem);
  } else if (dtype == 1 && variant == kDecode && M <= 64) {
    const int smem = M <= 8 ? DecPlan<8>::BYTES : DecPlan<64>::BYTES;
    if (smem > smem_limit) return (int)cudaErrorInvalidValue;
    g->add(dim3((N + kDecBN - 1) / kDecBN, 1, splits), kDecThreads, smem);
  } else if (dtype == 0 && variant == kF32) {
    g->add(dim3((N + kF32BN - 1) / kF32BN, (M + kF32BM - 1) / kF32BM, splits),
           kF32Threads, 0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    g->add(dim3((unsigned)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096)),
           256, 0);
  }
  return 0;
}

}  // namespace

// out (M, N) = x (M, K) @ dequant(packed, scales[, row_norm][, col_norm]).
// dtype: 0 float32, 1 bfloat16 (x and out); fmt: 0 NF4 (packed uint8
// (K/2, N), high nibble = even row, codebook = 16 fp32 values), 1 int8
// (packed int8 (K, N)); scales fp32 (ceil(K/bs), N); row_norm fp32 (K,)
// and col_norm fp32 (N,) or null.  variant: 0 the bf16 prefill body, 1 the
// bf16 decode body (M <= 64), 2 the float32 tile.  splits > 1 splits K
// over blockIdx.z, writing fp32 partials (splits, M, N) to `partial` and
// adding them in a second kernel.  Needs K % 8 == 0, 16-byte aligned
// x, packed, scales and row_norm, and in bf16 bs >= 8.  smem_limit: the
// shared memory a block of this device may opt in to.  Returns the
// cudaError_t of the launches.
extern "C" int quantized_matmul_launch(
    int dtype, int fmt, int variant, const void* x, const void* packed,
    const void* scales, const void* row_norm, const void* col_norm,
    const void* codebook, void* out, void* partial, int M, int N, int K,
    int bs, int splits, int smem_limit, void* stream) {
  geom::Geometry g;
  int err = geometry(dtype, fmt, variant, codebook, partial, M, N, K, bs,
                     splits, smem_limit, &g);
  if (err || g.n == 0) return err;
  const int steps = (K + BK - 1) / BK;
  Args a;
  a.x = x;
  a.packed = static_cast<const uint8_t*>(packed);
  a.scales = static_cast<const float*>(scales);
  a.row_norm = static_cast<const float*>(row_norm);
  a.col_norm = static_cast<const float*>(col_norm);
  a.codebook = static_cast<const float*>(codebook);
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.bs = bs;
  a.steps_per_split = (steps + splits - 1) / splits;
  splits = (int)g.l[0].grid.z;  // (steps + steps_per_split - 1) / it
  a.partial = splits > 1 ? static_cast<float*>(partial) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = fmt == kNf4 ? launch<kNf4>(g.l[0], variant, a, smem_limit, st)
                    : launch<kInt8>(g.l[0], variant, a, smem_limit, st);
  if (err || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const geom::Launch& l = g.l[1];
  if (dtype == 1)
    reduce_splits_kernel<bf16><<<l.grid, l.threads, l.smem, st>>>(
        a.partial, static_cast<bf16*>(out), splits, mn);
  else
    reduce_splits_kernel<float><<<l.grid, l.threads, l.smem, st>>>(
        a.partial, static_cast<float*>(out), splits, mn);
  return (int)cudaGetLastError();
}

// quantized_matmul_launch's geometry (geometry.cuh), launching nothing.
extern "C" int quantized_matmul_describe(
    int dtype, int fmt, int variant, const void* x, const void* packed,
    const void* scales, const void* row_norm, const void* col_norm,
    const void* codebook, void* out, void* partial, int M, int N, int K,
    int bs, int splits, int smem_limit, int* desc, int cap) {
  geom::Geometry g;
  return geom::describe(geometry(dtype, fmt, variant, codebook, partial, M, N,
                                 K, bs, splits, smem_limit, &g),
                        g, desc, cap);
}
