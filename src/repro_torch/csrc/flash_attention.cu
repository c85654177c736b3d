// Causal flash attention (prefill), and flash decode over a dense cache
// or a paged block pool of bf16/f32 rows or of NF4/int8 codes, for Hopper
// (sm_90a).
//
// Replaces four TPU kernels of repro/kernels/flash_attention.py:
//   * _flash_forward / _flash_kernel (public flash_attention): causal,
//     optionally sliding-window GQA attention, q (B,S,H,hd), k/v
//     (B,S,KV,hd);
//   * flash_decode_attention / _decode_kernel: one query token per slot
//     over a dense cache (B,S_max,KV,hd), masked by each slot's cache_len;
//   * paged_flash_decode_attention / _paged_decode_kernel: the same over a
//     pool (n_blocks, bs, KV, hd) whose rows a per-slot block table names
//     (slot b's logical block j is pool row table[b, j]);
//   * its kv_quant branch / _paged_decode_quant_kernel: the pool holds
//     NF4 codes (uint8 (.., hd/2), high nibble = even element) or int8
//     codes, with fp32 scales per quant_block elements of each row; each
//     element is decoded (codebook entry or int8 code, times its scale)
//     and rounded to the value dtype as it enters shared memory, so no
//     decoded copy of the cache exists in device memory.
//
// The rules every body keeps, as the TPU kernels do: fp32 running max,
// denominator and accumulator (online softmax) over 64-key tiles, p cast
// to the value dtype before the PV product, masking by MASK_VALUE = -1e30
// (finite, so a fully masked tile never makes inf - inf), one division at
// the end with denom == 0 guarded.  GQA reads KV head h / (H / KV); any S
// is taken, keys and query rows past the end masked, with no padding copy.
//
// The bf16 prefill forward (fwd::flash_forward_bf16_kernel) is bound by
// operations at llama2-7b widths (4 * hd FLOPs per visible (query, key)
// pair against 2 * hd bytes per key) and by the bytes it must read at
// short S.  It is built for Hopper's tensor cores: a block of 64 query
// rows, a producer warpgroup that streams Q and each visible K/V tile by
// 16-byte cp.async into a two-stage ring of 128-byte swizzled tiles
// (mbarrier full/empty), and a consumer warpgroup that runs QK^T and PV
// as wgmma with p fed from registers, the online softmax on the
// accumulator registers, two blocks an SM (setmaxnreg gives the consumers
// the producer's registers).  Only the visible tiles are visited
// (_visible_j_range), and tiles wholly inside the causal window skip the
// mask.  QK^T is summed in partial sums of 8 products (see the body).
//
// The bf16 decodes (over a dense cache, a pool of rows or a pool of
// NF4/int8 codes) split each step over the card in two passes that keep
// attend_block's bits (dec::, below the forward).  The float32 forward
// and the float32 decodes (over rows or codes) share attend_block,
// templated on how a key and value element is fetched: up to 64 query rows
// against a walk over 64-key tiles in SIMT fp32 (float32 must not round
// through TF32).  Decode reads each valid key and value row once for G =
// H/KV query rows: bytes (4 B an element in float32, 0.5 B plus a 4 B
// scale per 64 in NF4).
// Only tiles up to the slot's length are visited (the block reads its
// length itself); a 64-key tile of a paged pool gathers 64 / bs table
// entries (4 at the serving block size of 16) and reads the table only
// below the length, so entries past the slot's block count (which repeat
// its last row) are never read.  K and V tiles sit in shared memory as
// fp32 (rows padded by one word against bank conflicts), the score tile is
// a 4x4 register micro-tile per thread, and each thread owns 8 rows x 4
// head dims of the output accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "geometry.cuh"
#include "sm90.cuh"

namespace {

constexpr int kRows = 64;     // query rows per block
constexpr int kKeys = 64;     // keys per KV tile
constexpr int kThreads = 256;
// head_dim limits: the decodes (kernels 4-6) take up to 128, the forward
// (kernel 3) up to 256
constexpr int kMaxHd = 128;
constexpr int kMaxFwdHd = 256;
constexpr float kMask = -1e30f;
constexpr int kMaxDevices = 64;

// attend_block's conversions to and from the value dtype T: float32 only
// (the bf16 bodies convert with the intrinsics)
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kRows * (hd + 1) + (size_t)kKeys * (hd + 1) +
                          (size_t)kKeys * hd + (size_t)kRows * (kKeys + 1) +
                          2 * kRows);
}

// How attend_block fetches element d of the key and value at position
// pos, as fp32 values already rounded to the value dtype T.

// A dense (.., S, KV, hd) stripe of one KV head (key stride kv_s).
template <typename T>
struct DenseKV {
  const T* k;
  const T* v;
  long long kv_s;
  __device__ __forceinline__ void load(int pos, int d, float* kval,
                                       float* vval) const {
    const long long off = (long long)pos * kv_s + d;
    *kval = to_f(k[off]);
    *vval = to_f(v[off]);
  }
};

// The pool row of position pos of one slot: table entry pos / bs, row
// pos % bs, KV head kvh; in units of (token, head) rows.
struct PagedRows {
  const int* table;  // this slot's table row
  int bs, KV, kvh;
  __device__ __forceinline__ long long row(int pos) const {
    const long long blk = __ldg(table + pos / bs);
    return (blk * bs + pos % bs) * KV + kvh;
  }
};

// A paged pool of rows in T.
template <typename T>
struct PagedKV {
  const T* k;
  const T* v;
  PagedRows rows;
  int hd;
  __device__ __forceinline__ void load(int pos, int d, float* kval,
                                       float* vval) const {
    const long long off = rows.row(pos) * hd + d;
    *kval = to_f(k[off]);
    *vval = to_f(v[off]);
  }
};

// A paged pool of NF4 (FMT 0) or int8 (FMT 1) codes with fp32 scales per
// qb elements, read for float32 queries (bf16 ones take the split decode's
// code path); cb is the 16-entry NF4 codebook in shared memory.
template <int FMT>
struct PagedQuantKV {
  const uint8_t* k;
  const uint8_t* v;
  const float* ks;
  const float* vs;
  const float* cb;
  PagedRows rows;
  int hd, qb, nsb;
  __device__ __forceinline__ float code(const uint8_t* c, long long row,
                                        int d) const {
    if (FMT == 0) {
      const uint8_t b = c[row * (hd >> 1) + (d >> 1)];
      return cb[(d & 1) ? (b & 15) : (b >> 4)];
    }
    return (float)reinterpret_cast<const int8_t*>(c)[row * hd + d];
  }
  __device__ __forceinline__ void load(int pos, int d, float* kval,
                                       float* vval) const {
    const long long row = rows.row(pos);
    const long long si = row * nsb + d / qb;
    *kval = code(k, row, d) * ks[si];
    *vval = code(v, row, d) * vs[si];
  }
};

// Rows r < n_rows of q (row stride q_rs elements) attend to the keys that
// kv fetches, in tiles j_lo..j_hi; row r sits at position q_pos0 + r *
// q_pos_step and sees key kv iff kv <= q_pos, kv < s_kv and (window < 0
// or q_pos - kv < window).  Keys at or past s_kv are never fetched.  A
// lane owns head dims lane + 32 * jd, jd < JD: hd <= 32 * JD.
template <typename T, typename KV, int JD = 4>
__device__ void attend_block(const T* __restrict__ q, T* __restrict__ o,
                             const KV& kv, long long q_rs, int n_rows, int hd,
                             int q_pos0, int q_pos_step, int s_kv, int j_lo,
                             int j_hi, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = hd + 1;
  const int ldp = kKeys + 1;
  float* Qs = smem;
  float* Ks = Qs + kRows * ldq;
  float* Vs = Ks + kKeys * ldq;
  float* Ps = Vs + kKeys * hd;
  float* row_m = Ps + kRows * ldp;
  float* row_l = row_m + kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    Qs[r * ldq + d] = r < n_rows ? to_f(q[r * q_rs + d]) : 0.f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    row_m[r] = kMask;
    row_l[r] = 0.f;
  }
  float acc[8][JD];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) acc[i][jd] = 0.f;
  __syncthreads();

  for (int j = j_lo; j <= j_hi; ++j) {
    const int kv0 = j * kKeys;
    const int n_keys = min(kKeys, s_kv - kv0);
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < kKeys * hd; i += kThreads) {
      const int kk = i / hd, d = i - kk * hd;
      float kval = 0.f, vval = 0.f;
      if (kk < n_keys) kv.load(kv0 + kk, d, &kval, &vval);
      Ks[kk * ldq + d] = kval;
      Vs[kk * hd + d] = vval;
    }
    __syncthreads();

    // scores: rows rg + 16*i, keys kg + 16*jj
    {
      const int rg = tid >> 4, kg = tid & 15;
      if (rg < n_rows) {
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
        for (int d = 0; d < hd; ++d) {
          float qa[4], kb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = Qs[(rg + 16 * i) * ldq + d];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) kb[jj] = Ks[(kg + 16 * jj) * ldq + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              s[i][jj] = fmaf(qa[i], kb[jj], s[i][jj]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + 16 * i;
          const int q_pos = q_pos0 + r * q_pos_step;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int kk = kg + 16 * jj;
            const int kv_pos = kv0 + kk;
            const bool ok = kk < n_keys && kv_pos <= q_pos &&
                            (window < 0 || q_pos - kv_pos < window);
            Ps[r * ldp + kk] = ok ? s[i][jj] * scale : kMask;
          }
        }
      }
    }
    __syncthreads();

    // online softmax + PV: warp w owns rows w + 8*i
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp + 8 * i;
      if (r >= n_rows) continue;  // uniform across the warp
      float* pr = Ps + r * ldp;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      pr[lane] = to_f(from_f<T>(p0));  // p in the value dtype for PV
      pr[lane + 32] = to_f(from_f<T>(p1));
      __syncwarp();
      if (lane == 0) {
        row_m[r] = m_new;
        // the FMA nvcc makes of alpha * l + sum, spelled out: the split
        // decode's value pass computes it alike, to the bit
        row_l[r] = fmaf(alpha, row_l[r], sum);
      }
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) acc[i][jd] *= alpha;
      for (int kk = 0; kk < kKeys; ++kk) {
        const float p = pr[kk];
#pragma unroll
        for (int jd = 0; jd < JD; ++jd) {
          const int d = lane + 32 * jd;
          if (d < hd) acc[i][jd] = fmaf(p, Vs[kk * hd + d], acc[i][jd]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    if (r >= n_rows) continue;
    const float l = row_l[r];
    const float denom = l == 0.f ? 1.f : l;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) {
      const int d = lane + 32 * jd;
      if (d < hd) o[r * q_rs + d] = from_f<T>(acc[i][jd] / denom);
    }
  }
}

// grid (ceil(S/64), H, B): one block per (b, h, 64-query tile); JD 8 for
// hd above 128
template <typename T, int JD>
__global__ void __launch_bounds__(kThreads)
    flash_forward_kernel(const T* q, const T* k, const T* v, T* o, int S,
                         int H, int KV, int hd, int window, float scale) {
  const int q_lo = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int n_k = (S + kKeys - 1) / kKeys;
  const int j_hi = min((q_lo + kRows - 1) / kKeys, n_k - 1);
  int j_lo = 0;
  if (window > 0) {
    const int first = q_lo - window + 1;
    j_lo = first > 0 ? first / kKeys : 0;
  }
  const long long q_off = (((long long)b * S + q_lo) * H + h) * hd;
  const long long kv_off = ((long long)b * S * KV + kvh) * hd;
  const DenseKV<T> kv{k + kv_off, v + kv_off, (long long)KV * hd};
  attend_block<T, DenseKV<T>, JD>(q + q_off, o + q_off, kv, (long long)H * hd,
                                  min(kRows, S - q_lo), hd, q_lo, 1, S, j_lo,
                                  j_hi, window, scale);
}

// grid (KV, B): one block per (b, kv head) holding the G query rows of the
// group; the block reads its slot's cache_len itself
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* q, const T* kc, const T* vc,
                        const int* __restrict__ lens, T* o, int S_max, int H,
                        int KV, int hd, int window, float scale) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int length = lens[b];
  const int q_pos = length - 1;
  const int n_k = (S_max + kKeys - 1) / kKeys;
  const int j_hi = length > 0 ? min(q_pos / kKeys, n_k - 1) : -1;
  int j_lo = 0;
  if (window > 0) {
    const int first = q_pos - window + 1;
    j_lo = first > 0 ? first / kKeys : 0;
  }
  const long long q_off = ((long long)b * H + (long long)kvh * G) * hd;
  const long long kv_off = ((long long)b * S_max * KV + kvh) * hd;
  const DenseKV<T> kv{kc + kv_off, vc + kv_off, (long long)KV * hd};
  attend_block<T>(q + q_off, o + q_off, kv, (long long)hd, G, hd, q_pos, 0,
                  S_max, j_lo, j_hi, window, scale);
}

// Decode over a paged pool.  grid (KV, B): one block per (b, kv head); the
// block reads its slot's length and table row itself and fetches keys only
// below min(length, n_b * bs).
struct PagedArgs {
  const void* q;
  void* o;
  const void* k;       // pools: T rows, or codes
  const void* v;
  const float* ks;     // scale pools (quantized only)
  const float* vs;
  const float* cb;     // NF4 codebook (global)
  const int* tables;   // (B, n_b)
  const int* lens;     // (B,)
  int n_b, bs, H, KV, hd, qb, window;
  float scale;
};

template <typename T, int FMT>  // FMT -1: rows in T; 0 NF4; 1 int8
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(PagedArgs a) {
  __shared__ float cb[16];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.KV;
  if (FMT == 0 && threadIdx.x < 16) cb[threadIdx.x] = a.cb[threadIdx.x];
  __syncthreads();
  const int length = a.lens[b];
  const int q_pos = length - 1;
  const int s_kv = min(length, a.n_b * a.bs);
  const int j_hi = s_kv > 0 ? (s_kv - 1) / kKeys : -1;
  int j_lo = 0;
  if (a.window > 0) {
    const int first = q_pos - a.window + 1;
    j_lo = first > 0 ? first / kKeys : 0;
  }
  const long long q_off = ((long long)b * a.H + (long long)kvh * G) * a.hd;
  const PagedRows rows{a.tables + (long long)b * a.n_b, a.bs, a.KV, kvh};
  const T* q = static_cast<const T*>(a.q) + q_off;
  T* o = static_cast<T*>(a.o) + q_off;
  if constexpr (FMT < 0) {
    const PagedKV<T> kv{static_cast<const T*>(a.k),
                        static_cast<const T*>(a.v), rows, a.hd};
    attend_block<T>(q, o, kv, (long long)a.hd, G, a.hd, q_pos, 0, s_kv, j_lo,
                    j_hi, a.window, a.scale);
  } else {
    const PagedQuantKV<FMT> kv{
        static_cast<const uint8_t*>(a.k), static_cast<const uint8_t*>(a.v),
        a.ks, a.vs, cb, rows, a.hd, a.qb, (a.hd + a.qb - 1) / a.qb};
    attend_block<T>(q, o, kv, (long long)a.hd, G, a.hd, q_pos, 0, s_kv, j_lo,
                    j_hi, a.window, a.scale);
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
  granted[dev] = (int)bytes;
  return 0;
}

// ------------------------------------------------- bf16 forward (wgmma)
//
// grid (ceil(S/64), H, B), the query tiles with the most visible keys
// first; 256 threads, two blocks an SM: a consumer warpgroup (threads
// 0-127) owns the block's 64 query rows, a producer warpgroup (128-255)
// streams Q once and then each visible 64-key K/V tile into a ring of
// kFwdStages shared-memory stages by 16-byte cp.async (zero-filled past S
// and past hd), each thread's copies arriving on the stage's `full`
// mbarrier as they land; the consumers free a stage through its `empty`
// mbarrier.  HDP is hd rounded up to 64, 128 or 256: the zero columns add
// exact zeros to QK^T and are never stored.
//
// HDP 256 (Griffin's head_dim): the consumers' accumulator is 128 fp32
// registers a thread, and Plan<256> holds 161 KB of shared memory, so one
// block runs an SM (Regs<256>); QK^T runs over the keys in two halves of
// 32 (N-32 products, double-buffered) and PV as two N-128 halves over the
// four 64-wide panels of V.  Its 32 partials a score are added in order
// with each addition's rounding error carried (TwoSum) and the score
// rounded once: summed as the 16 partials of hd 128 are, 32 of them left
// the bf16 output twice as far from the plain version as a correctly
// rounded sum is, at 2600 positions under the 2048 window (PERF.md).
//
// QK^T is summed as the plain version sums it only up to the order: its
// fp32 dot runs over hd in order, the tensor cores add many products at
// once.  Each score is the fp32 sum, in order, of hd / 8 partial sums of 8
// products, one wgmma each (the other half of its 16-deep A fragment set
// to zero), which keeps the rounding of p close enough to the plain
// version's for the bf16 limit (longer partials round p differently
// more often; see PERF.md).
namespace fwd {

constexpr int kFwdRows = 64;      // query rows a block: one wgmma tile
constexpr int kFwdStages = 2;
constexpr int kFwdThreads = 256;
constexpr int kSmemPerSm = 228 * 1024;   // shared memory of one H100 SM

template <int HDP>
struct Plan {
  static constexpr int NP = HDP / 64;              // 64-wide panels of hd
  static constexpr int PANEL = 64 * 128;           // 64 rows of 128 B
  static constexpr int Q = PANEL * NP;             // the Q tile
  static constexpr int KV = PANEL * NP;            // one K or V tile
  static constexpr int STAGE = 2 * KV;
  static constexpr int BYTES =
      1024 + Q + kFwdStages * STAGE + 2 * kFwdStages * 8;
};

// Registers.  Up to HDP 128 two blocks run an SM: each enters with
// 65536 / (2 * kFwdThreads) = 128 registers a thread, and setmaxnreg moves
// the producer's to the consumers (SPLIT); the two counts must fit what
// the block was given at launch, or the consumers' request never returns.
// HDP 256 holds 161 KB of shared memory, so one block runs an SM: it takes
// the launch bound of one block, every thread up to 255 registers from the
// start, and no split (a split above the 128 of two blocks would need an
// entry count the launch bound does not fix).
template <int HDP>
struct Regs {
  static constexpr bool SPLIT = HDP <= 128;
  static constexpr int BLOCKS = SPLIT ? 2 : 1;
  static constexpr int PRODUCER = 40, CONSUMER = 216;
  static_assert(!SPLIT || 128 * (PRODUCER + CONSUMER) <=
                              kFwdThreads *
                                  ((65536 / (BLOCKS * kFwdThreads)) & ~7),
                "setmaxnreg asks for more registers than the block holds");
  static_assert(SPLIT || 2 * (Plan<HDP>::BYTES + 1024) > kSmemPerSm,
                "one block an SM is what the shared memory allows");
};

template <int HDP>
__global__ void __launch_bounds__(kFwdThreads, Regs<HDP>::BLOCKS)
    flash_forward_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, int S, int H,
                              int KV, int hd, int window, float scale) {
  using P = Plan<HDP>;
  constexpr int CH = HDP / 8;  // 16-byte chunks of a row
  extern __shared__ uint8_t fwd_smem_raw[];
  uint8_t* smem = sm90::align1024(fwd_smem_raw);
  const uint32_t q_s = sm90::smem_u32(smem);
  const uint32_t kv_s = q_s + P::Q;
  const uint32_t bars = kv_s + kFwdStages * P::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kFwdStages + s); };

  const int n_q = gridDim.x;
  const int q_lo = (n_q - 1 - blockIdx.x) * kFwdRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  // [j_lo, j_hi]: _visible_j_range of the block's rows
  const int n_k = (S + kKeys - 1) / kKeys;
  const int j_hi = min((q_lo + kFwdRows - 1) / kKeys, n_k - 1);
  const int j_lo = window > 0 ? max(0, (q_lo - window + 1) / kKeys) : 0;
  const int T = j_hi - j_lo + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      sm90::mbar_init(full(s), 128);
      sm90::mbar_init(empty(s), 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---------------------------------------------------------- producer
    if constexpr (Regs<HDP>::SPLIT) sm90::reg_dealloc<Regs<HDP>::PRODUCER>();
    const int pt = tid - 128;
    const long long q_row = (long long)H * hd, kv_row = (long long)KV * hd;
    const __nv_bfloat16* qb = q + ((long long)b * S * H + h) * hd;
    const __nv_bfloat16* kb = k + ((long long)b * S * KV + kvh) * hd;
    const __nv_bfloat16* vb = v + ((long long)b * S * KV + kvh) * hd;
    for (int n = 0; n < T; ++n) {
      const int s = n % kFwdStages;
      if (n >= kFwdStages)
        sm90::mbar_wait(empty(s), ((n / kFwdStages) - 1) & 1);
      if (n == 0) {
        for (int i = pt; i < kFwdRows * CH; i += 128) {
          const int r = i / CH, c = i % CH;
          const bool ok = q_lo + r < S && 8 * c < hd;
          sm90::cp_async16(q_s + (c >> 3) * P::PANEL + sm90::swz(r, c & 7),
                           ok ? qb + (q_lo + r) * q_row + 8 * c : q, ok);
        }
      }
      const int kv0 = (j_lo + n) * kKeys;
      const uint32_t ks = kv_s + s * P::STAGE, vs = ks + P::KV;
      for (int i = pt; i < kKeys * CH; i += 128) {
        const int r = i / CH, c = i % CH;
        const bool ok = kv0 + r < S && 8 * c < hd;
        const long long off = (kv0 + r) * kv_row + 8 * c;
        const uint32_t dst = (c >> 3) * P::PANEL + sm90::swz(r, c & 7);
        sm90::cp_async16(ks + dst, ok ? kb + off : k, ok);
        sm90::cp_async16(vs + dst, ok ? vb + off : v, ok);
      }
      sm90::cp_async_arrive(full(s));
    }
    sm90::cp_async_wait<0>();
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (Regs<HDP>::SPLIT) sm90::reg_alloc<Regs<HDP>::CONSUMER>();
    const int lane = tid & 31, quad = lane & 3;
    const int r0 = 16 * (tid >> 5) + (lane >> 2);   // rows r0, r0 + 8
    const int pos[2] = {q_lo + r0, q_lo + r0 + 8};
    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
    constexpr int PARTS = HDP / 8;

    // A fragment of partial p: hd 8p .. 8p + 7 of rows r0 and r0 + 8 in
    // the half of the 16-deep fragment it belongs to, zeros in the other
    auto frag = [&](int p, uint32_t (&a)[4]) {
      const int c = p;          // the 16-byte chunk of hd 8p .. 8p + 7
      const uint32_t lo = *reinterpret_cast<const uint32_t*>(
          smem + (c >> 3) * P::PANEL + sm90::swz(r0, c & 7) + 4 * quad);
      const uint32_t hi = *reinterpret_cast<const uint32_t*>(
          smem + (c >> 3) * P::PANEL + sm90::swz(r0 + 8, c & 7) + 4 * quad);
      a[0] = p & 1 ? 0u : lo;
      a[1] = p & 1 ? 0u : hi;
      a[2] = p & 1 ? lo : 0u;
      a[3] = p & 1 ? hi : 0u;
    };

    for (int n = 0; n < T; ++n) {
      const int s = n % kFwdStages;
      const int j = j_lo + n;
      sm90::mbar_wait(full(s), (n / kFwdStages) & 1);
      const uint32_t ks = kv_s + s * P::STAGE, vs = ks + P::KV;
      float sc[32];
      if constexpr (HDP <= 128) {
        auto issue = [&](int p, float (&d)[32]) {
          uint32_t a[4];
          frag(p, a);
          const int kk = p >> 1;   // the 16-deep slice of K it reads
          const uint64_t db = sm90::desc(
              ks + (kk >> 2) * P::PANEL + ((kk & 3) << 5), 16, 1024);
          sm90::wgmma_fence();
          sm90::wgmma_rs<64, 0>(d, a, db, 0);
          sm90::wgmma_commit();
        };
        float tp[2][32];
#pragma unroll
        for (int i = 0; i < 32; ++i) tp[0][i] = tp[1][i] = 0.f;
        issue(0, tp[0]);
#pragma unroll
        for (int p = 0; p < PARTS; ++p) {
          if (p + 1 < PARTS) {
            issue(p + 1, tp[(p + 1) & 1]);
            sm90::wgmma_wait<1>();
          } else {
            sm90::wgmma_wait<0>();
          }
          sm90::fence_regs(tp[p & 1]);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = p ? sc[i] + tp[p & 1][i] : tp[0][i];
        }
      } else {
        // hd 256: keys 0-31, then 32-63 (N-32 products), each score the
        // in-order sum of its 32 partials carried as an unevaluated pair
        // (TwoSum from 0: every addition's rounding error kept in lo),
        // rounded once at the end of its half.  Products p and p + 1 are
        // issued together and p summed while p + 1 runs, in a loop that is
        // not unrolled, has no branch and leaves no product in flight
        // across its back edge: unrolled, the 64 products and sums are
        // about 140 KB of straight code a tile, past what the SM's
        // instruction caches hold; a branch around a wgmma (C7518), or an
        // accumulator read while a product is in flight across the back
        // edge (C7514), makes ptxas serialize every wgmma
        auto issue = [&](int half, int p, float (&d)[16]) {
          uint32_t a[4];
          frag(p, a);
          const int kk = p >> 1;   // the 16-deep slice of K it reads
          const uint64_t db = sm90::desc(
              ks + (kk >> 2) * P::PANEL + ((kk & 3) << 5) + 4096 * half, 16,
              1024);
          sm90::wgmma_fence();
          sm90::wgmma_rs<32, 0>(d, a, db, 0);
          sm90::wgmma_commit();
        };
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float tp[2][16], lo[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            tp[0][i] = tp[1][i] = lo[i] = 0.f;
            sc[16 * half + i] = 0.f;
          }
          auto add = [&](float (&b)[16]) {
            sm90::fence_regs(b);
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              float& hi = sc[16 * half + i];
              const float sum = hi + b[i];
              const float b_virt = sum - hi;
              lo[i] += (hi - (sum - b_virt)) + (b[i] - b_virt);
              hi = sum;
            }
          };
#pragma unroll 1
          for (int p = 0; p < PARTS; p += 2) {
            issue(half, p, tp[0]);
            issue(half, p + 1, tp[1]);
            sm90::wgmma_wait<1>();
            add(tp[0]);
            sm90::wgmma_wait<0>();
            add(tp[1]);
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) sc[16 * half + i] += lo[i];
        }
      }

      // online softmax on the accumulators: element i is row r0 + 8 *
      // ((i >> 1) & 1), key kv0 + 8 * (i >> 2) + 2 * quad + (i & 1)
      const int kv0 = j * kKeys;
      const bool clear = kv0 + kKeys - 1 <= q_lo && kv0 + kKeys <= S &&
                         (window < 0 || q_lo + kFwdRows - 1 - kv0 < window);
      float mx[2] = {kMask, kMask};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * scale;
        if (!clear) {
          const int kv = kv0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          const int qp = pos[(i >> 1) & 1];
          const bool ok =
              kv <= qp && kv < S && (window < 0 || qp - kv < window);
          x = ok ? x : kMask;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        const float m_new = fmaxf(m[e], mx[e]);
        alpha[e] = expf(m[e] - m_new);
        m[e] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = expf(sc[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += p;
        sc[i] = p;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = alpha[e] * l[e] + sum[e];
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: p rounded to bf16 as the A operand, in registers
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = sm90::pack_bf16(sc[8 * kk + 2 * e],
                                      sc[8 * kk + 2 * e + 1]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (HDP <= 128) {
          sm90::wgmma_rs<HDP, 1>(
              acc, pa[kk], sm90::desc(vs + kk * 2048, P::PANEL, 1024), 1);
        } else {
          // columns 0-127 (panels 0, 1) into acc[0..63], 128-255 (panels
          // 2, 3) into acc[64..127]: the accumulator layout of one N-256
          // product
          sm90::wgmma_rs_n128<1, 0>(
              acc, pa[kk], sm90::desc(vs + kk * 2048, P::PANEL, 1024), 1);
          sm90::wgmma_rs_n128<1, 64>(
              acc, pa[kk],
              sm90::desc(vs + 2 * P::PANEL + kk * 2048, P::PANEL, 1024), 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::mbar_arrive(empty(s));
    }

    // epilogue: one division per row, bf16 staged in the Q tile, then
    // 16-byte stores
    float den[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
      den[e] = l[e] == 0.f ? 1.f : l[e];
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");   // Q fully read
#pragma unroll
    for (int jj = 0; jj < HDP / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t off = (jj >> 3) * P::PANEL +
                             sm90::swz(r0 + 8 * e, jj & 7) + 4 * quad;
        *reinterpret_cast<uint32_t*>(smem + off) =
            sm90::pack_bf16(acc[4 * jj + 2 * e] / den[e],
                            acc[4 * jj + 2 * e + 1] / den[e]);
      }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    __nv_bfloat16* ob = o + ((long long)b * S * H + h) * hd;
    for (int i = tid; i < kFwdRows * CH; i += 128) {
      const int r = i / CH, c = i % CH;
      const int row = q_lo + r;
      if (row < S && 8 * c < hd)
        *reinterpret_cast<uint4*>(ob + (long long)row * H * hd + 8 * c) =
            *reinterpret_cast<const uint4*>(
                smem + (c >> 3) * P::PANEL + sm90::swz(r, c & 7));
    }
  }
}

template <int HDP>
int launch(const geom::Launch& l, const void* q, const void* k, const void* v,
           void* o, int S, int H, int KV, int hd, int window, float scale,
           int smem_limit, cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  int err = allow_smem(flash_forward_bf16_kernel<HDP>, l.smem, smem_limit,
                       granted);
  if (err) return err;
  flash_forward_bf16_kernel<HDP><<<l.grid, l.threads, l.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, KV, hd, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// -------------------------------------- bf16 split decode (4, 5, 6)
//
// The bf16 bodies of _decode_kernel, _paged_decode_kernel and
// _paged_decode_quant_kernel (the code path, below).  A decode
// step reads each visible key and value row once (2 * hd bytes each) for
// 4 * G * hd FLOPs, G = H / KV query rows: 1 FLOP a byte at G = 1, bound
// by bytes.  The one-block walk of attend_block reads a slot's keys tile
// after tile in one block; here the work is split over the card in two
// passes, and each output keeps the one-block walk's bits:
//
// * the score pass, grid (splits, KV, B), splits the keys: a block takes a
//   chunk of chunk_tiles 64-key tiles of one slot and KV head (the plan of
//   kernels/smem.py decode_plan, from the static extent, never from the
//   lengths; a chunk with no visible key exits at once), streams its K
//   rows and writes scale * q.k of each visible key (MASK where the window
//   hides it) to fp32 scratch: one thread per (query row, key), an fp32
//   FMA chain over hd in order, as attend_block sums it;
// * the value pass, grid (slices, KV, B), splits the head dims: a block
//   takes kDecSlice dims of one slot and KV head and walks the slot's
//   visible tiles in order with attend_block's online softmax (fp32
//   running max, denominator and accumulator, p rounded to bf16 before PV,
//   PV over the tile's keys in order), reading the tile's scores and its
//   slice of V.
//
// Splitting the keys of PV instead (flash-decoding: chunks walked apart,
// then a combine rescaling each by exp(m_c - m)) rounds p and sums the
// accumulator in another order; a 32-layer model compounds that into
// logits about 1.4e-2 (relative to the largest) away from the one-block
// walk's, where the same values must give the same bits (PERF.md).
// Nothing here uses atomics: two calls give equal bits.
//
// K rows (2 * hd contiguous bytes per token and head, in the dense cache as
// in a pool row) come by 16-byte cp.async into a ring of bf16 tiles, rows
// padded to HDP = 64 or 128 elements, 16-byte chunk c of row r at chunk
// c ^ (r % 8), so that the 8 threads of a quarter warp, one key each, read
// 8 different bank groups; a value block's ring holds a tile's V slices
// (64 bytes a row, by 16-byte cp.async) and its scores (4-byte cp.async).
// A pool row's address comes from the table entry of its position, read
// only below the slot's length.  bf16 stays in shared memory and is
// converted in registers; the arithmetic runs on the CUDA cores (the
// tensor cores' long sums move the bf16 rounding of p; PERF.md).  Head
// dims that are not a multiple of 8 (or rows not 16-byte aligned) are
// copied element by element into the same layouts.
namespace dec {

constexpr int kDecThreads = 128;
constexpr int kDecMaxSplits = 16;
constexpr int kDecStages = 2;       // K tiles in flight in a score block
constexpr int kDecSlice = 32;       // head dims of a value block
constexpr int kDecValueStages = 4;  // tiles in a value block's ring
constexpr int kDecBlocksPerSm = 8;  // 64 registers a thread at most
constexpr int kQuantScales = 4;     // scales of a K row a code stage holds

// a score block: a ring of stages bf16 K tiles and the fp32 query
size_t score_smem(int hd, int G, int stages) {
  const size_t hdp = hd <= 64 ? 64 : 128;
  return (size_t)stages * kKeys * hdp * 2 + 4 * (size_t)G * hdp;
}

// a value block: a ring of (V slice tile, fp32 scores of the G rows), then
// the accumulator slice and m, l of the G rows, and each stage's alpha
size_t value_smem(int G) {
  return (size_t)kDecValueStages * (kKeys * kDecSlice * 2 + 4 * G * kKeys) +
         4 * (size_t)G * (kDecSlice + 2 + kDecValueStages);
}

// the code path (kernel 6, FMT 0 NF4 or 1 int8): a score block holds one
// bf16 K tile, the fp32 query, a ring of stages code stages (64 rows of
// codes, padded to HDP elements, and kQuantScales fp32 scales a row) and
// the codebook
size_t quant_score_smem(int hd, int G, int stages, int fmt) {
  const size_t hdp = hd <= 64 ? 64 : 128;
  const size_t crow = fmt == 0 ? hdp / 2 : hdp;
  return kKeys * hdp * 2 + 4 * (size_t)G * hdp +
         (size_t)stages * kKeys * (crow + 4 * kQuantScales) + 64;
}

// a value block of the code path: value_smem's ring with the codes of
// each stage's V slice and the scale of each of its 8-dim chunks, then the
// codebook
size_t quant_value_smem(int G, int fmt) {
  const size_t crow = fmt == 0 ? kDecSlice / 2 : kDecSlice;
  return value_smem(G) +
         (size_t)kDecValueStages * kKeys * (crow + 4 * (kDecSlice / 8)) + 64;
}

struct Args {
  const __nv_bfloat16* q;  // (B, H, hd)
  const __nv_bfloat16* k;  // (B, extent, KV, hd), or a pool (n, bs, KV, hd)
  const __nv_bfloat16* v;
  const uint8_t* kq;       // code pools (n, bs, KV, hd / 2 | hd), kernel 6
  const uint8_t* vq;
  const float* ks;         // their fp32 scales (n, bs, KV, nsb)
  const float* vs;
  const float* cb;         // the 16-entry NF4 codebook
  const int* tables;       // (B, n_b) pool rows; null for a dense cache
  const int* lens;         // (B,)
  __nv_bfloat16* o;        // (B, H, hd)
  float* scores;           // (B, H, extent): scale * q.k, MASK if hidden
  int extent, n_b, bs, H, KV, hd, window;
  int chunk_tiles, stages, vec;  // vec: rows, or code rows, by 16 bytes
  int qb, nsb;                   // codes: scale block, scales a row
  float scale;
};

// the 64-key tiles [j_lo, j_hi] a slot of length len visits
__device__ __forceinline__ void visible_tiles(const Args& a, int len,
                                              int* j_lo, int* j_hi) {
  const int s_kv = min(len, a.extent);
  *j_hi = s_kv > 0 ? (s_kv - 1) / kKeys : -1;
  *j_lo = a.window > 0 ? max(0, len - a.window) / kKeys : 0;
}

// the (token, head) row of position pos of one slot and KV head
template <bool PAGED>
struct Rows {
  const int* table;  // the slot's table row (pools)
  long long base;    // b * extent (dense)
  int bs, KV, kvh;
  __device__ __forceinline__ long long row(int pos) const {
    if constexpr (PAGED) {
      const long long blk = __ldg(table + pos / bs);
      return (blk * bs + pos % bs) * KV + kvh;
    } else {
      return (base + pos) * KV + kvh;
    }
  }
};

// What both passes read of a block's slot and KV head.
template <bool PAGED>
struct Slot {
  int G, len, s_kv, j_lo, j_hi;
  long long row0;  // (b, first head of the group) as a row of (B * H)
  Rows<PAGED> rows;
  __device__ explicit Slot(const Args& a) {
    const int kvh = blockIdx.y, b = blockIdx.z;
    G = a.H / a.KV;
    len = a.lens[b];
    s_kv = min(len, a.extent);
    visible_tiles(a, len, &j_lo, &j_hi);
    row0 = (long long)b * a.H + (long long)kvh * G;
    rows = Rows<PAGED>{PAGED ? a.tables + (long long)b * a.n_b : nullptr,
                       (long long)b * a.extent, a.bs, a.KV, kvh};
  }
};

// the 64 K rows from position kv0 into a tile; rows at or past s_kv are
// zero, their table entries and rows never read
template <int HDP, bool PAGED>
__device__ __forceinline__ void load_keys(const Args& a,
                                          const Rows<PAGED>& rows,
                                          uint8_t* tile, int kv0, int s_kv) {
  constexpr int CHP = HDP / 8, ROWB = HDP * 2;
  if (a.vec) {
    const uint32_t t = sm90::smem_u32(tile);
    for (int i = threadIdx.x; i < kKeys * CHP; i += kDecThreads) {
      const int r = i / CHP, c = i % CHP;
      if (8 * c >= a.hd) continue;
      const int pos = kv0 + r;
      const bool ok = pos < s_kv;
      sm90::cp_async16(t + r * ROWB + ((c ^ (r & 7)) << 4),
                       a.k + (ok ? rows.row(pos) * a.hd + 8 * c : 0), ok);
    }
    return;
  }
  const int width = (a.hd + 7) & ~7;  // whole chunks, zeros past hd
  for (int i = threadIdx.x; i < kKeys * HDP; i += kDecThreads) {
    const int r = i / HDP, e = i % HDP;
    if (e >= width) continue;
    const int pos = kv0 + r;
    *reinterpret_cast<__nv_bfloat16*>(
        tile + r * ROWB + (((e >> 3) ^ (r & 7)) << 4) + 2 * (e & 7)) =
        pos < s_kv && e < a.hd ? a.k[rows.row(pos) * a.hd + e]
                               : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// scale * q.k of the G rows against the keys of one bf16 tile (rows in
// the ring layout) from kv0 below the slot's length, MASK where the window
// hides them: one (row, key) pair a thread, the dot over hd in order
template <int HDP, bool PAGED>
__device__ __forceinline__ void tile_scores(const Args& a,
                                            const Slot<PAGED>& sl,
                                            const float* Qs,
                                            const uint8_t* kt, int kv0) {
  constexpr int CHP = HDP / 8, ROWB = HDP * 2;
  const int hd = a.hd;
  for (int i = threadIdx.x; i < sl.G * kKeys; i += kDecThreads) {
    const int r = i / kKeys, kk = i % kKeys, pos = kv0 + kk;
    if (pos >= sl.s_kv) continue;
    const uint8_t* krow = kt + kk * ROWB;
    const float* qr = Qs + r * HDP;
    float s = 0.f;
#pragma unroll
    for (int cc = 0; cc < CHP; ++cc) {
      if (8 * cc < hd) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            krow + ((cc ^ (kk & 7)) << 4));
        const float4 qa = *reinterpret_cast<const float4*>(qr + 8 * cc);
        const float4 qb = *reinterpret_cast<const float4*>(qr + 8 * cc + 4);
        const float2 k0 = bf2(raw.x), k1 = bf2(raw.y), k2 = bf2(raw.z),
                     k3 = bf2(raw.w);
        s = fmaf(qa.x, k0.x, s);
        s = fmaf(qa.y, k0.y, s);
        s = fmaf(qa.z, k1.x, s);
        s = fmaf(qa.w, k1.y, s);
        s = fmaf(qb.x, k2.x, s);
        s = fmaf(qb.y, k2.y, s);
        s = fmaf(qb.z, k3.x, s);
        s = fmaf(qb.w, k3.y, s);
      }
    }
    const bool ok = a.window < 0 || sl.len - 1 - pos < a.window;
    a.scores[(sl.row0 + r) * a.extent + pos] = ok ? s * a.scale : kMask;
  }
}

// the fp32 query of the G rows of the block's group, zero past hd
template <int HDP, bool PAGED>
__device__ __forceinline__ void load_query(const Args& a,
                                           const Slot<PAGED>& sl, float* Qs) {
  for (int i = threadIdx.x; i < sl.G * HDP; i += kDecThreads) {
    const int r = i / HDP, d = i % HDP;
    Qs[i] = d < a.hd ? __bfloat162float(a.q[(sl.row0 + r) * a.hd + d]) : 0.f;
  }
}

// The score pass: scale * q.k of every key of the block's chunk below the
// slot's length, MASK where the window hides it.
template <int HDP, bool PAGED>
__device__ __forceinline__ void score_body(const Args& a) {
  constexpr int TILE = kKeys * HDP * 2;
  extern __shared__ __align__(16) uint8_t dec_smem[];
  const Slot<PAGED> sl(a);
  const int t0 = max(sl.j_lo, (int)blockIdx.x * a.chunk_tiles);
  const int t1 = min(sl.j_hi, ((int)blockIdx.x + 1) * a.chunk_tiles - 1);
  if (t0 > t1) return;  // no visible key in this chunk
  const int nt = t1 - t0 + 1;
  uint8_t* ring = dec_smem;
  float* Qs = reinterpret_cast<float*>(ring + a.stages * TILE);

  // the ring: tile n in stage n % 2, two in flight
  load_keys<HDP, PAGED>(a, sl.rows, ring, t0 * kKeys, sl.s_kv);
  sm90::cp_async_commit();
  if (nt > 1)
    load_keys<HDP, PAGED>(a, sl.rows, ring + TILE, (t0 + 1) * kKeys,
                          sl.s_kv);
  sm90::cp_async_commit();
  load_query<HDP, PAGED>(a, sl, Qs);

  for (int n = 0; n < nt; ++n) {
    const int kv0 = (t0 + n) * kKeys;
    sm90::cp_async_wait<1>();  // tile n has landed (tile n + 1 may not)
    __syncthreads();
    tile_scores<HDP, PAGED>(a, sl, Qs, ring + (n & 1) * TILE, kv0);
    __syncthreads();  // stage n % 2 is free again
    if (n + 2 < nt)
      load_keys<HDP, PAGED>(a, sl.rows, ring + (n & 1) * TILE,
                            kv0 + 2 * kKeys, sl.s_kv);
    sm90::cp_async_commit();
  }
}

// a value block's stage for the tile from kv0: the scores of the G rows
// (zero at or past s_kv), after the tile's V slice
template <bool PAGED>
__device__ __forceinline__ void load_scores(const Args& a,
                                            const Slot<PAGED>& sl,
                                            uint8_t* stage, int kv0) {
  const uint32_t sc = sm90::smem_u32(stage) + kKeys * kDecSlice * 2;
  for (int i = threadIdx.x; i < sl.G * kKeys; i += kDecThreads) {
    const int r = i / kKeys, pos = kv0 + i % kKeys;
    const bool ok = pos < sl.s_kv;
    sm90::cp_async4(sc + 4 * i,
                    a.scores + (ok ? (sl.row0 + r) * a.extent + pos : 0), ok);
  }
}

// a value block's stage for the tile from kv0: the slice [d0, d0 + sd) of
// its 64 V rows (thread t copies half of row t / 2's slice), then the
// scores of the G rows (zero at or past s_kv)
template <bool PAGED>
__device__ __forceinline__ void load_values(const Args& a,
                                            const Slot<PAGED>& sl,
                                            uint8_t* stage, int d0, int sd,
                                            int kv0) {
  constexpr int SLB = kDecSlice * 2, CH = kDecSlice / 8;
  const uint32_t st = sm90::smem_u32(stage);
  if (a.vec) {  // sd is a multiple of 8
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (CH / 2);
    const int pos = kv0 + r;
    const bool ok = pos < sl.s_kv;
    const __nv_bfloat16* src =
        a.v + (ok ? sl.rows.row(pos) * a.hd + d0 : 0);
#pragma unroll
    for (int c = c0; c < c0 + CH / 2; ++c)
      if (8 * c < sd)
        sm90::cp_async16(st + r * SLB + 16 * c, src + (ok ? 8 * c : 0), ok);
  } else {
    for (int i = threadIdx.x; i < kKeys * kDecSlice; i += kDecThreads) {
      const int r = i / kDecSlice, e = i % kDecSlice;
      if (e >= sd) continue;
      const int pos = kv0 + r;
      *reinterpret_cast<__nv_bfloat16*>(stage + r * SLB + 2 * e) =
          pos < sl.s_kv ? a.v[sl.rows.row(pos) * a.hd + d0 + e]
                        : __float2bfloat16(0.f);
    }
  }
  load_scores<PAGED>(a, sl, stage, kv0);
}

// ------------------------------------------- the code path (kernel 6)
//
// NF4 (FMT 0: uint8, two codes a byte, high nibble = even element) or
// int8 (FMT 1) code pools with fp32 scales per qb elements of a row.  A
// code loader fills the same bf16 tiles that load_keys and load_values
// fill from rows, each element decoded as the plain version decodes a
// pool (kv_dequant_values): __float2bfloat16(code value * scale) with the
// product in fp32, so everything after the fill is the rows' arithmetic
// and keeps its bits.  With vec (code rows 16-byte
// aligned, qb a multiple of 8 and at most kQuantScales scales a row) the
// codes and scales of a tile come by cp.async into a staging stage and
// are decoded once they have landed, 8 elements (one scale) at a time;
// otherwise each element is read and decoded from device memory into the
// same layouts.

// the value of element d of a code row, as PagedQuantKV::code reads it,
// times its scale
template <int FMT>
__device__ __forceinline__ float code_value(const Args& a, const uint8_t* c,
                                            const float* sc, long long row,
                                            int d, const float* cb) {
  float v;
  if constexpr (FMT == 0) {
    const uint8_t b = c[row * (a.hd >> 1) + (d >> 1)];
    v = cb[(d & 1) ? (b & 15) : (b >> 4)];
  } else {
    v = (float)reinterpret_cast<const int8_t*>(c)[row * a.hd + d];
  }
  return v * sc[row * a.nsb + d / a.qb];
}

// 8 consecutive elements from their codes (4 bytes NF4, 8 bytes int8) and
// their one scale, rounded to bf16: 16 bytes of a tile row
template <int FMT>
__device__ __forceinline__ uint4 decode8(const uint8_t* c, float s,
                                         const float* cb) {
  float f[8];
  if constexpr (FMT == 0) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b = (w >> (8 * j)) & 255u;
      f[2 * j] = cb[b >> 4] * s;
      f[2 * j + 1] = cb[b & 15u] * s;
    }
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(c);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = (float)(int8_t)(((j < 4 ? w.x : w.y) >> (8 * (j & 3))) & 255u) *
             s;
  }
  return make_uint4(sm90::pack_bf16(f[0], f[1]), sm90::pack_bf16(f[2], f[3]),
                    sm90::pack_bf16(f[4], f[5]), sm90::pack_bf16(f[6], f[7]));
}

// code bytes of n elements
template <int FMT>
__host__ __device__ constexpr int code_bytes(int n) {
  return FMT == 0 ? n / 2 : n;
}

// the scale block of element d of a row with at most kQuantScales of
// them (the staged path), without a division
__device__ __forceinline__ int scale_block(int d, int qb) {
  return (d >= qb) + (d >= 2 * qb) + (d >= 3 * qb);
}

// A code stage is filled two threads a row (kKeys rows, kDecThreads
// threads): thread t takes row t / 2 and finds its pool row once.
static_assert(kDecThreads == 2 * kKeys, "two threads a staged row");

// a score block's code stage for the 64 K rows from kv0: each row's codes
// (16-byte pieces) and its nsb scales, the row's two threads taking every
// other one; zero at or past s_kv
template <int HDP, int FMT>
__device__ __forceinline__ void stage_key_codes(const Args& a,
                                                const Rows<true>& rows,
                                                uint8_t* stg, int kv0,
                                                int s_kv) {
  constexpr int CROW = code_bytes<FMT>(HDP);
  const int rowb = code_bytes<FMT>(a.hd);
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1, pos = kv0 + r;
  const bool ok = pos < s_kv;
  const long long row = ok ? rows.row(pos) : 0;
  const uint32_t cs = sm90::smem_u32(stg) + r * CROW;
  const uint32_t ss = sm90::smem_u32(stg) + kKeys * CROW +
                      4 * r * kQuantScales;
  for (int c = h; 16 * c < rowb; c += 2)
    sm90::cp_async16(cs + 16 * c, a.kq + row * rowb + 16 * c, ok);
  for (int c = h; c < a.nsb; c += 2)
    sm90::cp_async4(ss + 4 * c, a.ks + row * a.nsb + c, ok);
}

// the 64 K rows from kv0 decoded into a bf16 tile of the ring layout: from
// a landed code stage (vec), else element by element from device memory;
// rows at or past s_kv are zero
template <int HDP, int FMT>
__device__ __forceinline__ void fill_key_tile(const Args& a,
                                              const Rows<true>& rows,
                                              const uint8_t* stg,
                                              uint8_t* tile, int kv0,
                                              int s_kv, const float* cb) {
  constexpr int CHP = HDP / 8, ROWB = HDP * 2, CROW = code_bytes<FMT>(HDP);
  if (a.vec) {
    const float* ss = reinterpret_cast<const float*>(stg + kKeys * CROW);
    for (int i = threadIdx.x; i < kKeys * CHP; i += kDecThreads) {
      const int r = i / CHP, c = i % CHP;
      if (8 * c >= a.hd) continue;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kv0 + r < s_kv)
        val = decode8<FMT>(stg + r * CROW + code_bytes<FMT>(8 * c),
                           ss[r * kQuantScales + scale_block(8 * c, a.qb)],
                           cb);
      *reinterpret_cast<uint4*>(tile + r * ROWB + ((c ^ (r & 7)) << 4)) =
          val;
    }
    return;
  }
  const int width = (a.hd + 7) & ~7;  // whole chunks, zeros past hd
  for (int i = threadIdx.x; i < kKeys * HDP; i += kDecThreads) {
    const int r = i / HDP, e = i % HDP;
    if (e >= width) continue;
    const int pos = kv0 + r;
    const float val = pos < s_kv && e < a.hd
                          ? code_value<FMT>(a, a.kq, a.ks, rows.row(pos), e,
                                            cb)
                          : 0.f;
    *reinterpret_cast<__nv_bfloat16*>(
        tile + r * ROWB + (((e >> 3) ^ (r & 7)) << 4) + 2 * (e & 7)) =
        __float2bfloat16(val);
  }
}

// the score pass over code pools: the rows' dots (tile_scores) over one
// bf16 tile that each visited tile is decoded into, while the codes of the
// next tiles are in flight in a ring of stages code stages
template <int HDP, int FMT>
__device__ __forceinline__ void quant_score_body(const Args& a) {
  constexpr int TILE = kKeys * HDP * 2;
  constexpr int STG = kKeys * (code_bytes<FMT>(HDP) + 4 * kQuantScales);
  extern __shared__ __align__(16) uint8_t dec_smem[];
  const Slot<true> sl(a);
  const int t0 = max(sl.j_lo, (int)blockIdx.x * a.chunk_tiles);
  const int t1 = min(sl.j_hi, ((int)blockIdx.x + 1) * a.chunk_tiles - 1);
  if (t0 > t1) return;  // no visible key in this chunk
  const int nt = t1 - t0 + 1;
  uint8_t* tile = dec_smem;
  float* Qs = reinterpret_cast<float*>(dec_smem + TILE);
  uint8_t* stg = dec_smem + TILE + 4 * sl.G * HDP;
  float* cb = reinterpret_cast<float*>(stg + a.stages * STG);
  if (FMT == 0 && threadIdx.x < 16) cb[threadIdx.x] = a.cb[threadIdx.x];

  // code stage n % 2 holds tile n, two in flight
  for (int n = 0; n < 2; ++n) {
    if (a.vec && n < nt)
      stage_key_codes<HDP, FMT>(a, sl.rows, stg + n * STG,
                                (t0 + n) * kKeys, sl.s_kv);
    sm90::cp_async_commit();
  }
  load_query<HDP, true>(a, sl, Qs);

  for (int n = 0; n < nt; ++n) {
    const int kv0 = (t0 + n) * kKeys;
    sm90::cp_async_wait<1>();  // tile n's codes have landed
    __syncthreads();           // and the last tile's dots are done
    fill_key_tile<HDP, FMT>(a, sl.rows, stg + (n & 1) * STG, tile, kv0,
                            sl.s_kv, cb);
    __syncthreads();  // the tile is whole; code stage n % 2 is free
    if (a.vec && n + 2 < nt)
      stage_key_codes<HDP, FMT>(a, sl.rows, stg + (n & 1) * STG,
                                kv0 + 2 * kKeys, sl.s_kv);
    sm90::cp_async_commit();
    tile_scores<HDP, true>(a, sl, Qs, tile, kv0);
  }
}

// a value block's code stage for the tile from kv0: the codes of the
// slice [d0, d0 + sd) of its 64 V rows (16-byte pieces) and the scale of
// each 8-dim chunk of it, the row's two threads taking half of each; zero
// at or past s_kv
template <int FMT>
__device__ __forceinline__ void stage_value_codes(const Args& a,
                                                  const Slot<true>& sl,
                                                  uint8_t* codes, int d0,
                                                  int sd, int kv0) {
  constexpr int CROW = code_bytes<FMT>(kDecSlice), NCH = kDecSlice / 8;
  const int rowb = code_bytes<FMT>(a.hd);
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1, pos = kv0 + r;
  const bool ok = pos < sl.s_kv;
  const long long row = ok ? sl.rows.row(pos) : 0;
  const uint32_t cs = sm90::smem_u32(codes) + r * CROW;
  const uint32_t ss = sm90::smem_u32(codes) + kKeys * CROW + 4 * r * NCH;
  const uint8_t* src = a.vq + row * rowb + code_bytes<FMT>(d0);
  for (int c = h; 16 * c < code_bytes<FMT>(sd); c += 2)
    sm90::cp_async16(cs + 16 * c, src + 16 * c, ok);
  for (int c = 2 * h; c < 2 * h + 2 && 8 * c < sd; ++c)
    sm90::cp_async4(ss + 4 * c,
                    a.vs + row * a.nsb + scale_block(d0 + 8 * c, a.qb), ok);
}

// a value stage's bf16 V slice (64 B a row) decoded from its landed code
// stage by warps 1 and 2, a row a thread: with one query row a group, PV
// runs on warp 0 and the softmax on warp 3, and the decode of the next
// tile beside them.  Rows at or past s_kv are zero.
template <int FMT>
__device__ __forceinline__ void decode_value_codes(uint8_t* vt,
                                                   const uint8_t* codes,
                                                   int sd, int kv0, int s_kv,
                                                   const float* cb) {
  constexpr int CROW = code_bytes<FMT>(kDecSlice), NCH = kDecSlice / 8;
  static_assert(kDecThreads >= 32 + kKeys, "warps 1 and 2 hold the rows");
  const float* ss = reinterpret_cast<const float*>(codes + kKeys * CROW);
  const int r = (int)threadIdx.x - 32;
  if (r < 0 || r >= kKeys) return;
  const bool ok = kv0 + r < s_kv;
  for (int c = 0; c < NCH && 8 * c < sd; ++c) {
    uint4 val = make_uint4(0, 0, 0, 0);
    if (ok)
      val = decode8<FMT>(codes + r * CROW + code_bytes<FMT>(8 * c),
                         ss[r * NCH + c], cb);
    *reinterpret_cast<uint4*>(vt + r * kDecSlice * 2 + 16 * c) = val;
  }
}

// a value stage of the code path: the codes staged (vec), else the slice
// decoded element by element into the bf16 V slice; then the scores
template <int FMT>
__device__ __forceinline__ void load_value_codes(const Args& a,
                                                 const Slot<true>& sl,
                                                 uint8_t* stage,
                                                 uint8_t* codes, int d0,
                                                 int sd, int kv0,
                                                 const float* cb) {
  if (a.vec) {
    stage_value_codes<FMT>(a, sl, codes, d0, sd, kv0);
  } else {
    for (int i = threadIdx.x; i < kKeys * kDecSlice; i += kDecThreads) {
      const int r = i / kDecSlice, e = i % kDecSlice;
      if (e >= sd) continue;
      const int pos = kv0 + r;
      const float val = pos < sl.s_kv
                            ? code_value<FMT>(a, a.vq, a.vs,
                                              sl.rows.row(pos), d0 + e, cb)
                            : 0.f;
      *reinterpret_cast<__nv_bfloat16*>(stage + r * kDecSlice * 2 + 2 * e) =
          __float2bfloat16(val);
    }
  }
  load_scores<true>(a, sl, stage, kv0);
}

// The value pass: the block's slice of the output, by attend_block's walk
// over the slot's visible tiles.  The softmax of tile n + 1 needs only the
// running max and denominator, so it runs beside the PV of tile n, on the
// last warps (rows r on warp 3 - r % 4) while PV starts from the first:
// one barrier a tile.  Stage n % VS holds tile n: while PV reads stage n
// and the softmax stage n + 1, tiles n + 2 .. n + VS - 2 are in flight and
// tile n + VS - 1 is issued into the stage PV freed last.  Over code
// pools (FMT 0 NF4, 1 int8) a stage also holds the codes of its V slice,
// decoded into its bf16 slice while PV runs on the tile before.
template <bool PAGED, int FMT = -1>
__device__ __forceinline__ void value_body(const Args& a) {
  constexpr int SLB = kDecSlice * 2, VS = kDecValueStages;
  constexpr int WARPS = kDecThreads / 32;
  static_assert(VS >= 3, "PV, softmax and the issued tile take a stage each");
  extern __shared__ __align__(16) uint8_t dec_smem[];
  const Slot<PAGED> sl(a);
  const int G = sl.G, hd = a.hd, nt = sl.j_hi - sl.j_lo + 1;
  const int d0 = blockIdx.x * kDecSlice, sd = min(kDecSlice, hd - d0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a stage: the bf16 V slice, the scores, then (codes) the code stage
  const int code_stage =
      FMT < 0 ? 0 : kKeys * (code_bytes<FMT>(kDecSlice) + 4 * (kDecSlice / 8));
  const int stage_bytes = kKeys * SLB + 4 * G * kKeys + code_stage;
  uint8_t* ring = dec_smem;
  float* Acc = reinterpret_cast<float*>(ring + VS * stage_bytes);
  float* Ms = Acc + G * kDecSlice;
  float* Ls = Ms + G;
  float* Al = Ls + G;  // (VS, G): alpha of the tile in each stage
  float* cb = Al + VS * G;  // codes: the NF4 codebook
  auto stage = [&](int n) { return ring + (n % VS) * stage_bytes; };
  auto scores = [&](int n) {
    return reinterpret_cast<float*>(stage(n) + kKeys * SLB);
  };
  auto codes = [&](int n) { return stage(n) + kKeys * SLB + 4 * G * kKeys; };
  auto load = [&](int n) {
    const int kv0 = (sl.j_lo + n) * kKeys;
    if constexpr (FMT < 0)
      load_values<PAGED>(a, sl, stage(n), d0, sd, kv0);
    else
      load_value_codes<FMT>(a, sl, stage(n), codes(n), d0, sd, kv0, cb);
  };
  // the bf16 V slice of tile n from its landed code stage
  auto decode = [&](int n) {
    if constexpr (FMT >= 0)
      if (a.vec)
        decode_value_codes<FMT>(stage(n), codes(n), sd,
                                (sl.j_lo + n) * kKeys, sl.s_kv, cb);
  };
  if constexpr (FMT == 0) {
    if (tid < 16) cb[tid] = a.cb[tid];
    __syncthreads();
  }

  // online softmax of tile n, as attend_block: p in bf16 in place
  auto softmax = [&](int n) {
    const int kv0 = (sl.j_lo + n) * kKeys;
    for (int r = WARPS - 1 - warp; r < G; r += WARPS) {
      float* pr = scores(n) + r * kKeys;
      const float s0 = kv0 + lane < sl.s_kv ? pr[lane] : kMask;
      const float s1 = kv0 + lane + 32 < sl.s_kv ? pr[lane + 32] : kMask;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      pr[lane] = __bfloat162float(__float2bfloat16(p0));
      pr[lane + 32] = __bfloat162float(__float2bfloat16(p1));
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = fmaf(alpha, Ls[r], sum);
        Al[(n % VS) * G + r] = alpha;
      }
    }
  };

  for (int n = 0; n < VS - 1; ++n) {
    if (n < nt) load(n);
    sm90::cp_async_commit();
  }
  for (int i = tid; i < G * kDecSlice; i += kDecThreads) Acc[i] = 0.f;
  for (int r = tid; r < G; r += kDecThreads) {
    Ms[r] = kMask;
    Ls[r] = 0.f;
  }
  sm90::cp_async_wait<VS - 2>();  // tile 0 has landed
  __syncthreads();
  if (nt > 0) {
    softmax(0);
    decode(0);
  }

  for (int n = 0; n < nt; ++n) {
    sm90::cp_async_wait<VS - 3>();  // tiles up to n + 1 have landed
    __syncthreads();  // softmax(n) and PV(n - 1) are done
    if (n + VS - 1 < nt) load(n + VS - 1);
    sm90::cp_async_commit();
    if (n + 1 < nt) decode(n + 1);

    // PV: one (row, dim) a thread, the accumulator rescaled, then the
    // tile's keys added in order
    const __nv_bfloat16* vt =
        reinterpret_cast<const __nv_bfloat16*>(stage(n));
    const float* P = scores(n);
    for (int i = tid; i < G * sd; i += kDecThreads) {
      const int r = i / sd, d = i - r * sd;
      const float* pr = P + r * kKeys;
      float acc = Acc[r * kDecSlice + d] * Al[(n % VS) * G + r];
#pragma unroll 16
      for (int kk = 0; kk < kKeys; ++kk)
        acc = fmaf(pr[kk], __bfloat162float(vt[kk * kDecSlice + d]), acc);
      Acc[r * kDecSlice + d] = acc;
    }
    if (n + 1 < nt) softmax(n + 1);
  }
  __syncthreads();
  for (int i = tid; i < G * sd; i += kDecThreads) {
    const int r = i / sd, d = i - r * sd;
    const float l = Ls[r];
    a.o[(sl.row0 + r) * hd + d0 + d] =
        __float2bfloat16(Acc[r * kDecSlice + d] / (l == 0.f ? 1.f : l));
  }
}

template <int HDP>
__global__ void __launch_bounds__(kDecThreads, kDecBlocksPerSm)
    dense_score_pass(Args a) {
  score_body<HDP, false>(a);
}

template <int HDP>
__global__ void __launch_bounds__(kDecThreads, kDecBlocksPerSm)
    paged_score_pass(Args a) {
  score_body<HDP, true>(a);
}

__global__ void __launch_bounds__(kDecThreads, kDecBlocksPerSm)
    dense_value_pass(Args a) {
  value_body<false>(a);
}

__global__ void __launch_bounds__(kDecThreads, kDecBlocksPerSm)
    paged_value_pass(Args a) {
  value_body<true>(a);
}

template <int HDP, int FMT>
__global__ void __launch_bounds__(kDecThreads, kDecBlocksPerSm)
    quant_score_pass(Args a) {
  quant_score_body<HDP, FMT>(a);
}

template <int FMT>
__global__ void __launch_bounds__(kDecThreads, kDecBlocksPerSm)
    quant_value_pass(Args a) {
  value_body<true, FMT>(a);
}

// the shared memory granted to one pass kernel, per device: a table for
// each kernel (a value pass serves both head-dim paddings, so it keeps one
// table for the two): 0, 1 the rows' value passes, 2-5 their score
// passes, 6-9 the code path's score passes, 10, 11 its value passes
template <int KERNEL>
int* granted() {
  static int table[kMaxDevices] = {};
  return table;
}

// the two passes' launches (geometry(): the score pass, then the value
// pass)
template <typename S, typename V>
int run(S scores, int* s_granted, V values, int* v_granted, const Args& a,
        const geom::Geometry& g, int smem_limit, cudaStream_t s) {
  const geom::Launch &ls = g.l[0], &lv = g.l[1];
  int err = allow_smem(scores, ls.smem, smem_limit, s_granted);
  if (!err) err = allow_smem(values, lv.smem, smem_limit, v_granted);
  if (err) return err;
  scores<<<ls.grid, ls.threads, ls.smem, s>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  values<<<lv.grid, lv.threads, lv.smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The two passes of B slots: the score pass of grid (splits, KV, B), the
// value pass of grid (head-dim slices, KV, B); fmt -1 over bf16 rows, 0
// NF4 or 1 int8 over codes.  Refuses a pass the block cannot hold.
int geometry(int fmt, int hd, int H, int KV, int B, int splits, int stages,
             int smem_limit, geom::Geometry* g) {
  const int G = H / KV;
  const size_t s_smem = fmt < 0 ? score_smem(hd, G, stages)
                                : quant_score_smem(hd, G, stages, fmt);
  const size_t v_smem = fmt < 0 ? value_smem(G) : quant_value_smem(G, fmt);
  if (s_smem > (size_t)smem_limit || v_smem > (size_t)smem_limit)
    return (int)cudaErrorInvalidValue;
  g->add(dim3(splits, KV, B), kDecThreads, s_smem);
  g->add(dim3((hd + kDecSlice - 1) / kDecSlice, KV, B), kDecThreads, v_smem);
  return 0;
}

template <int HDP, bool PAGED>
int launch(const Args& a, const geom::Geometry& g, int smem_limit,
           cudaStream_t s) {
  constexpr int score = 2 + 2 * PAGED + (HDP == 128);
  if constexpr (PAGED)
    return run(paged_score_pass<HDP>, granted<score>(), paged_value_pass,
               granted<1>(), a, g, smem_limit, s);
  else
    return run(dense_score_pass<HDP>, granted<score>(), dense_value_pass,
               granted<0>(), a, g, smem_limit, s);
}

// the code path over NF4 (FMT 0) or int8 (FMT 1) pools
template <int HDP, int FMT>
int launch_quant(const Args& a, const geom::Geometry& g, int smem_limit,
                 cudaStream_t s) {
  return run(quant_score_pass<HDP, FMT>,
             granted<6 + 2 * FMT + (HDP == 128)>(), quant_value_pass<FMT>,
             granted<10 + FMT>(), a, g, smem_limit, s);
}

}  // namespace dec

template <typename T, int JD>
int forward(const geom::Launch& l, const void* q, const void* k, const void* v,
            void* o, int S, int H, int KV, int hd, int window, float scale,
            int smem_limit, cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  int err =
      allow_smem(flash_forward_kernel<T, JD>, l.smem, smem_limit, granted);
  if (err) return err;
  flash_forward_kernel<T, JD><<<l.grid, l.threads, l.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, hd, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int decode(const geom::Launch& l, const void* q, const void* kc,
           const void* vc, const int* lens, void* o, int S_max, int H, int KV,
           int hd, int window, float scale, int smem_limit,
           cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  int err = allow_smem(flash_decode_kernel<T>, l.smem, smem_limit, granted);
  if (err) return err;
  flash_decode_kernel<T><<<l.grid, l.threads, l.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lens, static_cast<T*>(o), S_max, H, KV, hd,
      window, scale);
  return (int)cudaGetLastError();
}

// the paged kernel's static codebook beside its dynamic shared memory
constexpr size_t kCodebookBytes = 16 * sizeof(float);

template <typename T, int FMT>
int paged(const geom::Launch& l, const PagedArgs& a, int smem_limit,
          cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  int err = allow_smem(paged_decode_kernel<T, FMT>, l.smem + kCodebookBytes,
                       smem_limit, granted);
  if (err) return err;
  paged_decode_kernel<T, FMT><<<l.grid, l.threads, l.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool shapes_ok(int H, int KV, int hd, int max_hd = kMaxHd) {
  return hd >= 1 && hd <= max_hd && KV >= 1 && H % KV == 0 &&
         H / KV <= kRows;
}

// the plan of kernels/smem.py decode_plan for a static extent: splits
// chunks of chunk_tiles 64-key tiles, each holding a key of the extent and
// all of them covering it, a ring of min(2, chunk_tiles) tiles
bool plan_ok(int extent, int chunk_tiles, int splits, int stages) {
  const long long keys = (long long)chunk_tiles * kKeys;
  const int ring = chunk_tiles < dec::kDecStages ? chunk_tiles
                                                 : dec::kDecStages;
  return extent >= 0 && chunk_tiles >= 1 && splits >= 1 &&
         splits <= dec::kDecMaxSplits && stages == ring &&
         splits * keys >= extent &&
         (splits - 1) * keys < (extent ? extent : 1);
}

// The launch of flash_forward_launch: grid (ceil(S/64), H, B).
int forward_geometry(int dtype, int B, int S, int H, int KV, int hd,
                     int smem_limit, geom::Geometry* g) {
  if (!shapes_ok(H, KV, hd, kMaxFwdHd)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  size_t smem;
  int threads;
  if (dtype == 0) {
    smem = smem_bytes(hd);
    threads = kThreads;
  } else if (dtype == 1) {
    if (hd % 8) return (int)cudaErrorInvalidValue;
    smem = hd <= 64    ? fwd::Plan<64>::BYTES
           : hd <= 128 ? fwd::Plan<128>::BYTES
                       : fwd::Plan<256>::BYTES;
    threads = fwd::kFwdThreads;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > (size_t)smem_limit) return (int)cudaErrorInvalidValue;
  g->add(dim3((S + kRows - 1) / kRows, H, B), threads, smem);
  return 0;
}

// The launch of flash_decode_launch (float32): grid (KV, B).
int decode_geometry(int dtype, int B, int H, int KV, int hd, int smem_limit,
                    geom::Geometry* g) {
  if (!shapes_ok(H, KV, hd)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16 takes split_decode_launch
  if (smem_bytes(hd) > (size_t)smem_limit) return (int)cudaErrorInvalidValue;
  g->add(dim3(KV, B), kThreads, smem_bytes(hd));
  return 0;
}

// The launch of paged_decode_launch (float32): grid (KV, B).
int paged_geometry(int dtype, int fmt, const void* ks, const void* vs,
                   const void* codebook, int B, int n_b, int bs, int H,
                   int KV, int hd, int qb, int smem_limit,
                   geom::Geometry* g) {
  if (!shapes_ok(H, KV, hd) || bs < 1 || n_b < 1)
    return (int)cudaErrorInvalidValue;
  if (fmt >= 0 && (qb < 1 || ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (fmt == 0 && (codebook == nullptr || hd % 2))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  // bf16 takes split_decode_launch (rows) or quant_split_decode_launch
  // (codes)
  if (dtype != 0 || fmt < -1 || fmt > 1) return (int)cudaErrorInvalidValue;
  if (smem_bytes(hd) + kCodebookBytes > (size_t)smem_limit)
    return (int)cudaErrorInvalidValue;
  g->add(dim3(KV, B), kThreads, smem_bytes(hd));
  return 0;
}

// The launches of split_decode_launch (dec::geometry).
int split_geometry(const void* tables, int B, int extent, int n_b, int bs,
                   int H, int KV, int hd, int chunk_tiles, int splits,
                   int stages, const void* scores, int smem_limit,
                   geom::Geometry* g) {
  if (!shapes_ok(H, KV, hd) || !plan_ok(extent, chunk_tiles, splits, stages) ||
      scores == nullptr)
    return (int)cudaErrorInvalidValue;
  if (tables != nullptr && (bs < 1 || n_b < 1 || extent != n_b * bs))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  return dec::geometry(-1, hd, H, KV, B, splits, stages, smem_limit, g);
}

// The launches of quant_split_decode_launch (dec::geometry).
int quant_split_geometry(int fmt, const void* ks, const void* vs,
                         const void* codebook, const void* tables,
                         const void* scores, int B, int n_b, int bs, int H,
                         int KV, int hd, int qb, int chunk_tiles, int splits,
                         int stages, int smem_limit, geom::Geometry* g) {
  if (!shapes_ok(H, KV, hd) || bs < 1 || n_b < 1 || qb < 1 ||
      !plan_ok(n_b * bs, chunk_tiles, splits, stages) || scores == nullptr ||
      tables == nullptr || ks == nullptr || vs == nullptr ||
      (fmt != 0 && fmt != 1) ||
      (fmt == 0 && (codebook == nullptr || hd % 2)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  return dec::geometry(fmt, hd, H, KV, B, splits, stages, smem_limit, g);
}

}  // namespace

// q, k, v, o contiguous (B, S, H|KV, hd) in one dtype (0 float32,
// 1 bfloat16; bfloat16 needs hd % 8 == 0 and 16-byte aligned rows), hd up
// to 256;
// window < 0 means full causal attention.  smem_limit: the
// shared memory a block of this device may opt in to.
extern "C" int flash_forward_launch(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KV, int hd, int window,
                                    float scale, int smem_limit,
                                    void* stream) {
  geom::Geometry g;
  const int err = forward_geometry(dtype, B, S, H, KV, hd, smem_limit, &g);
  if (err || g.n == 0) return err;
  const geom::Launch& l = g.l[0];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hd <= 128 ? forward<float, 4>(l, q, k, v, o, S, H, KV, hd, window,
                                         scale, smem_limit, s)
                     : forward<float, 8>(l, q, k, v, o, S, H, KV, hd, window,
                                         scale, smem_limit, s);
  if (hd <= 64)
    return fwd::launch<64>(l, q, k, v, o, S, H, KV, hd, window, scale,
                           smem_limit, s);
  if (hd <= 128)
    return fwd::launch<128>(l, q, k, v, o, S, H, KV, hd, window, scale,
                            smem_limit, s);
  return fwd::launch<256>(l, q, k, v, o, S, H, KV, hd, window, scale,
                          smem_limit, s);
}

// flash_forward_launch's geometry (geometry.cuh), launching nothing.
extern "C" int flash_forward_describe(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int hd, int window,
                                      float scale, int smem_limit, int* out,
                                      int cap) {
  geom::Geometry g;
  return geom::describe(
      forward_geometry(dtype, B, S, H, KV, hd, smem_limit, &g), g, out, cap);
}

// float32: q, o contiguous (B, 1, H, hd); caches contiguous (B, S_max, KV,
// hd); lens (B,) int32 valid entries per slot, the new token included.
extern "C" int flash_decode_launch(int dtype, const void* q, const void* kc,
                                   const void* vc, const void* lens, void* o,
                                   int B, int S_max, int H, int KV, int hd,
                                   int window, float scale, int smem_limit,
                                   void* stream) {
  geom::Geometry g;
  const int err = decode_geometry(dtype, B, H, KV, hd, smem_limit, &g);
  if (err || g.n == 0) return err;
  return decode<float>(g.l[0], q, kc, vc, static_cast<const int*>(lens), o,
                       S_max, H, KV, hd, window, scale, smem_limit,
                       static_cast<cudaStream_t>(stream));
}

// flash_decode_launch's geometry (geometry.cuh), launching nothing.
extern "C" int flash_decode_describe(int dtype, const void* q, const void* kc,
                                     const void* vc, const void* lens,
                                     void* o, int B, int S_max, int H, int KV,
                                     int hd, int window, float scale,
                                     int smem_limit, int* out, int cap) {
  geom::Geometry g;
  return geom::describe(decode_geometry(dtype, B, H, KV, hd, smem_limit, &g),
                        g, out, cap);
}

// float32: q, o contiguous (B, 1, H, hd).  fmt -1: k/v pools contiguous
// (n_blocks, bs, KV, hd); fmt 0 (NF4):
// uint8 code pools (n_blocks, bs, KV, hd/2) and the 16-entry fp32
// codebook; fmt 1 (int8): int8 code pools (n_blocks, bs, KV, hd); for both,
// fp32 scale pools (n_blocks, bs, KV, ceil(hd/qb)).  tables (B, n_b) int32
// pool rows, lens (B,) int32 valid entries per slot, the new token
// included.  window < 0: full causal attention.
extern "C" int paged_decode_launch(int dtype, int fmt, const void* q,
                                   const void* k, const void* v,
                                   const void* ks, const void* vs,
                                   const void* codebook, const void* tables,
                                   const void* lens, void* o, int B, int n_b,
                                   int bs, int H, int KV, int hd, int qb,
                                   int window, float scale, int smem_limit,
                                   void* stream) {
  geom::Geometry g;
  const int err = paged_geometry(dtype, fmt, ks, vs, codebook, B, n_b, bs, H,
                                 KV, hd, qb, smem_limit, &g);
  if (err || g.n == 0) return err;
  PagedArgs a{q, o, k, v, static_cast<const float*>(ks),
              static_cast<const float*>(vs),
              static_cast<const float*>(codebook),
              static_cast<const int*>(tables), static_cast<const int*>(lens),
              n_b, bs, H, KV, hd, qb, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == -1) return paged<float, -1>(g.l[0], a, smem_limit, s);
  if (fmt == 0) return paged<float, 0>(g.l[0], a, smem_limit, s);
  return paged<float, 1>(g.l[0], a, smem_limit, s);
}

// paged_decode_launch's geometry (geometry.cuh), launching nothing.
extern "C" int paged_decode_describe(int dtype, int fmt, const void* q,
                                     const void* k, const void* v,
                                     const void* ks, const void* vs,
                                     const void* codebook, const void* tables,
                                     const void* lens, void* o, int B,
                                     int n_b, int bs, int H, int KV, int hd,
                                     int qb, int window, float scale,
                                     int smem_limit, int* out, int cap) {
  geom::Geometry g;
  return geom::describe(paged_geometry(dtype, fmt, ks, vs, codebook, B, n_b,
                                       bs, H, KV, hd, qb, smem_limit, &g),
                        g, out, cap);
}

// The bf16 split decode.  q, o contiguous (B, 1, H, hd) bfloat16; k, v a
// dense cache (B, extent, KV, hd) when tables is null, else pools (n, bs,
// KV, hd) read through tables (B, n_b) int32, extent = n_b * bs; lens (B,)
// int32 valid entries per slot, the new token included.  The plan
// (kernels/smem.py decode_plan): the score pass in splits chunks of
// chunk_tiles 64-key tiles covering the extent, a ring of stages =
// min(2, chunk_tiles) tiles.  scores: fp32 scratch of B * H * extent
// elements.  window < 0: full causal attention.
extern "C" int split_decode_launch(const void* q, const void* k,
                                   const void* v, const void* tables,
                                   const void* lens, void* o, void* scores,
                                   int B, int extent, int n_b, int bs, int H,
                                   int KV, int hd, int window,
                                   int chunk_tiles, int splits, int stages,
                                   float scale, int smem_limit,
                                   void* stream) {
  geom::Geometry g;
  const int err =
      split_geometry(tables, B, extent, n_b, bs, H, KV, hd, chunk_tiles,
                     splits, stages, scores, smem_limit, &g);
  if (err || g.n == 0) return err;
  dec::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.tables = static_cast<const int*>(tables);
  a.lens = static_cast<const int*>(lens);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.scores = static_cast<float*>(scores);
  a.extent = extent;
  a.n_b = n_b;
  a.bs = bs;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.window = window;
  a.chunk_tiles = chunk_tiles;
  a.stages = stages;
  a.vec = hd % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables != nullptr)
    return hd <= 64 ? dec::launch<64, true>(a, g, smem_limit, s)
                    : dec::launch<128, true>(a, g, smem_limit, s);
  return hd <= 64 ? dec::launch<64, false>(a, g, smem_limit, s)
                  : dec::launch<128, false>(a, g, smem_limit, s);
}

// split_decode_launch's geometry (geometry.cuh), launching nothing.
extern "C" int split_decode_describe(const void* q, const void* k,
                                     const void* v, const void* tables,
                                     const void* lens, void* o, void* scores,
                                     int B, int extent, int n_b, int bs,
                                     int H, int KV, int hd, int window,
                                     int chunk_tiles, int splits, int stages,
                                     float scale, int smem_limit, int* out,
                                     int cap) {
  geom::Geometry g;
  return geom::describe(
      split_geometry(tables, B, extent, n_b, bs, H, KV, hd, chunk_tiles,
                     splits, stages, scores, smem_limit, &g),
      g, out, cap);
}

// The bf16 split decode over code pools (kernel 6).  q, o contiguous (B, 1,
// H, hd) bfloat16; fmt 0 (NF4): uint8 code pools (n_blocks, bs, KV, hd/2)
// and the 16-entry fp32 codebook; fmt 1 (int8): int8 code pools (n_blocks,
// bs, KV, hd); for both, fp32 scale pools (n_blocks, bs, KV, ceil(hd/qb)),
// read through tables (B, n_b) int32 (extent n_b * bs); lens, the plan,
// scores and window as for split_decode_launch.
extern "C" int quant_split_decode_launch(
    int fmt, const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* codebook, const void* tables,
    const void* lens, void* o, void* scores, int B, int n_b, int bs, int H,
    int KV, int hd, int qb, int window, int chunk_tiles, int splits,
    int stages, float scale, int smem_limit, void* stream) {
  const int extent = n_b * bs;
  geom::Geometry g;
  const int err = quant_split_geometry(fmt, ks, vs, codebook, tables, scores,
                                       B, n_b, bs, H, KV, hd, qb, chunk_tiles,
                                       splits, stages, smem_limit, &g);
  if (err || g.n == 0) return err;
  dec::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kq = static_cast<const uint8_t*>(kq);
  a.vq = static_cast<const uint8_t*>(vq);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.cb = static_cast<const float*>(codebook);
  a.tables = static_cast<const int*>(tables);
  a.lens = static_cast<const int*>(lens);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.scores = static_cast<float*>(scores);
  a.extent = extent;
  a.n_b = n_b;
  a.bs = bs;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.window = window;
  a.chunk_tiles = chunk_tiles;
  a.stages = stages;
  a.qb = qb;
  a.nsb = (hd + qb - 1) / qb;
  // code rows by 16-byte cp.async, 8 elements to a scale, the scales of a
  // K row in a code stage
  a.vec = (fmt == 0 ? hd % 32 : hd % 16) == 0 && qb % 8 == 0 &&
          a.nsb <= dec::kQuantScales &&
          reinterpret_cast<uintptr_t>(kq) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(vq) % 16 == 0;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == 0)
    return hd <= 64 ? dec::launch_quant<64, 0>(a, g, smem_limit, s)
                    : dec::launch_quant<128, 0>(a, g, smem_limit, s);
  return hd <= 64 ? dec::launch_quant<64, 1>(a, g, smem_limit, s)
                  : dec::launch_quant<128, 1>(a, g, smem_limit, s);
}

// quant_split_decode_launch's geometry (geometry.cuh), launching nothing.
extern "C" int quant_split_decode_describe(
    int fmt, const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* codebook, const void* tables,
    const void* lens, void* o, void* scores, int B, int n_b, int bs, int H,
    int KV, int hd, int qb, int window, int chunk_tiles, int splits,
    int stages, float scale, int smem_limit, int* out, int cap) {
  geom::Geometry g;
  return geom::describe(
      quant_split_geometry(fmt, ks, vs, codebook, tables, scores, B, n_b, bs,
                           H, KV, hd, qb, chunk_tiles, splits, stages,
                           smem_limit, &g),
      g, out, cap);
}
