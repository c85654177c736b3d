// The whole QuanTA chain over one row tile, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quanta_apply.py
// (quanta_apply_kernel_call, body _kernel / _chain_block).
//
// What it computes: each row of x (rows, d_in) is viewed as an N-axis
// register; for every stage tensor T (om, on, im, in) on the axis pair
// (m, n), in schedule order,
//     h'[..., i_m, .., i_n, ...] = sum_{a<im, b<in} T[i_m, i_n, a, b] *
//                                  h[..., a at m, .., b at n, ...]
// with fp32 accumulation and a cast back to the activation dtype after
// every stage (the rounding of _chain_block).  Each stage is one 2-D
// product (rows * cols, K = im * in) @ (K, O = om * on), a column being
// one index of every axis outside the pair.
//
// What bounds it on the H100: on paper, memory.  Fused, the kernel reads
// x once and writes the result once, and the stage tensors (43,008
// elements for llama2-7b's 16-8-8-4 scheme) stay in L2.  Its arithmetic
// is d * sum(K) MACs per row: 1.84 M for a 4096-wide row against 16 KB
// moved in bf16, ~224 FLOP/byte, under the bf16 ridge (~295) but far over
// the fp32 one (~20).  The bf16 body keeps the plain version's bits: every
// output is the fp32 FMA chain over k = a * in + b ascending from 0, which
// the plain version's fp32 product sums in the same order.  Sums on the
// tensor cores round otherwise and a flipped bf16 rounding is carried
// through the later stages (PERF.md), so the bf16 body runs on the CUDA
// cores and is bound by their fp32 FMA rate (67 TFLOP/s: 0.17 ms for a
// 3072-row prefill wave).
//
// What the bf16 body does about it (chain_bf16_kernel): one block per row
// tile, 256 threads; the tile's rows live in shared memory for the whole
// chain, ping-ponged between two bf16 buffers, and every stage tensor is
// fetched into shared memory in bf16 by cp.async at the block's start
// (stage 0's with the rows, the others while stage 0 runs), so no stage
// waits on device memory.  Where they do not all fit, each stage's tensor
// is fetched before the stage runs; where one tensor alone does not fit
// beside the row buffers (mamba2-1.3b's widening x_proj chain: a last
// stage of 512 x 512, 512 KB), it streams in equal chunks of its rows,
// i.e. of its outputs, each chunk's outputs summed whole over k ascending
// before the next chunk is fetched, so the sums keep their order.  Each
// stage stores its outputs in the layout the next stage reads: that
// stage's pair axes minor, so every (row, column) input is K contiguous
// values (padded to a multiple of 8), and the last stage stores the
// canonical order.  The layouts are planned on the host (kernels/smem.py
// chain_plan) and the kernel does index arithmetic only: no permute
// copies.  A thread computes a TM x TO
// micro-tile of (row, column) pairs x outputs as an outer product in
// registers: per 8 values of k, TM + TO 16-byte loads of activations and
// tensor rows, converted to fp32 once and used TO or TM times, instead of
// two shared-memory words per FMA.  Tensor rows are stored with their
// 16-byte chunks XOR-swizzled by row, so the rows a warp reads at once
// fall in different banks.  8 x 8 micro-tiles for row tiles of 4 or more,
// 4 x 4 below (a decode tick: one row a block, its 4096 outputs on all
// 256 threads) and when a tensor streams.  Rows past the end of x are
// masked, with no padding copy.
//
// The float32 body (quanta_chain_kernel) is the first SIMT kernel: the
// stage tensor staged per stage in fp32, transposed, one output index for
// four (row, column) pairs per thread.  A stage tensor larger than the
// host's staging area (t_floats; yi-6b's 16-16-16 stages hold 256 x 257
// floats) is staged in chunks of whole rows a of T[o, a, b]: each output
// keeps its partial fp32 sum in its row buffer between chunks, so the FMA
// chain still runs over k = a * in + b ascending from 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "geometry.cuh"
#include "sm90.cuh"

namespace {

// The stage table travels as the kernel's parameter, which must stay under
// 4 KB: up to 8 axes, so up to 6 column axes and 28 stages (every pair).
constexpr int kMaxAxes = 8;
constexpr int kMaxCols = kMaxAxes - 2;
constexpr int kMaxStages = 28;
constexpr int kThreads = 512;
constexpr int kCols = 4;  // (row, column) pairs per thread
constexpr int kMaxDevices = 64;

// One stage, laid out by the host: the axis pair, the tensor shape, the
// strides of the pair axes in the input (sm, sn) and output (dm, dn)
// registers, and the other axes ("column" axes, slowest first) with their
// sizes and strides in both registers.
struct Stage {
  int om, on, im, in_;
  int sm, sn, dm, dn;
  int n_col;   // number of column axes
  int ncols;   // product of their sizes
  int col_dim[kMaxCols];
  int col_in[kMaxCols];
  int col_out[kMaxCols];
  const void* t;
};

struct ChainParams {
  int n_stages;
  int d_in;
  int d_out;
  int d_max;  // widest register of the chain: the row-buffer stride
  int t_floats;  // shared-memory floats of the largest staged tensor
  int max_cols;  // most columns of any stage: the offset tables' length
  long long rows;
  int rows_per_block;
  Stage st[kMaxStages];
};
static_assert(sizeof(ChainParams) <= 4096, "kernel parameters exceed 4 KB");

__global__ void __launch_bounds__(kThreads)
    quanta_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const __grid_constant__ ChainParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tens = reinterpret_cast<float*>(smem_raw);
  int* off_in = reinterpret_cast<int*>(tens + p.t_floats);
  int* off_out = off_in + p.max_cols;
  float* src = reinterpret_cast<float*>(off_out + p.max_cols);
  float* dst = src + (size_t)p.rows_per_block * p.d_max;

  const long long row0 = (long long)blockIdx.x * p.rows_per_block;
  const long long left = p.rows - row0;
  const int nrows = left < p.rows_per_block ? (int)left : p.rows_per_block;

  for (int i = threadIdx.x; i < nrows * p.d_in; i += kThreads) {
    const int r = i / p.d_in;
    const int c = i - r * p.d_in;
    src[r * p.d_max + c] = x[(row0 + r) * p.d_in + c];
  }

  for (int s = 0; s < p.n_stages; ++s) {
    const Stage& st = p.st[s];
    const int on = st.on, im = st.im, inn = st.in_;
    const int oo = st.om * on;  // outputs of one column
    const int kk = im * inn;    // contraction length
    const int ldt = oo + 1;     // padded row of the transposed tensor
    // rows a of T staged at once: all, or as many as t_floats holds
    const int a_per = im * inn * ldt <= p.t_floats
                          ? im
                          : p.t_floats / (inn * ldt);
    __syncthreads();  // rows loaded / previous stage done with the tables
    // column offsets in both registers, once per stage
    for (int c = threadIdx.x; c < st.ncols; c += kThreads) {
      int rem = c, in_off = 0, out_off = 0;
      for (int a = st.n_col - 1; a >= 0; --a) {
        const int d = st.col_dim[a];
        const int q = rem / d;
        const int ca = rem - q * d;
        rem = q;
        in_off += ca * st.col_in[a];
        out_off += ca * st.col_out[a];
      }
      off_in[c] = in_off;
      off_out[c] = out_off;
    }
    const float* tg = static_cast<const float*>(st.t);
    for (int a0 = 0; a0 < im; a0 += a_per) {
      const int a1 = a0 + a_per < im ? a0 + a_per : im;
      if (a0 > 0) __syncthreads();  // the previous chunk's sums are done
      // tens[(k - a0 * in) * ldt + o] = T[o, k] in fp32 for the chunk's k
      // (consecutive threads walk k, so the padded stride ldt spreads their
      // stores over the banks)
      const int kc = (a1 - a0) * inn;
      for (int i = threadIdx.x; i < oo * kc; i += kThreads) {
        const int o = i / kc;
        const int k = i - o * kc;
        tens[k * ldt + o] = tg[o * kk + a0 * inn + k];
      }
      __syncthreads();  // tensor chunk and offsets staged

      // item j: output index o = j % oo of the kCols (row, column) pairs
      // kCols * (j / oo) .. + kCols - 1, so a thread runs kCols independent
      // sums that share each tensor load
      const int n_rc = nrows * st.ncols;
      const int n_items = oo * ((n_rc + kCols - 1) / kCols);
      for (int j = threadIdx.x; j < n_items; j += kThreads) {
        const int o = j % oo;
        const int rc0 = (j / oo) * kCols;
        const int i_m = o / on;
        const int i_n = o - i_m * on;
        const float* h[kCols];
        int out_at[kCols];
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          // past the end: recompute the group's first pair, store nothing
          const int rc = rc0 + u < n_rc ? rc0 + u : rc0;
          const int r = rc / st.ncols;
          const int c = rc - r * st.ncols;
          h[u] = src + r * p.d_max + off_in[c];
          out_at[u] = rc0 + u < n_rc ? r * p.d_max + off_out[c] +
                                           i_m * st.dm + i_n * st.dn
                                     : -1;
        }
        // the first chunk starts each sum at 0, a later one at its partial
        float acc[kCols];
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          acc[u] = a0 > 0 && out_at[u] >= 0 ? dst[out_at[u]] : 0.f;
        const float* tr = tens + o;
        for (int a = a0; a < a1; ++a) {
          const float* ta = tr + (a - a0) * inn * ldt;
          const int ha = a * st.sm;
          for (int b = 0; b < inn; ++b) {
            const float t = ta[b * ldt];
            const int off = ha + b * st.sn;
#pragma unroll
            for (int u = 0; u < kCols; ++u)
              acc[u] = fmaf(t, h[u][off], acc[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          if (out_at[u] >= 0) dst[out_at[u]] = acc[u];
      }
    }  // chunks of a
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * p.d_out; i += kThreads) {
    const int r = i / p.d_out;
    const int c = i - r * p.d_out;
    out[(row0 + r) * p.d_out + c] = src[r * p.d_max + c];
  }
}

// Raise the kernel's dynamic shared-memory cap to `bytes` on the current
// device, once per device and size.
template <typename K>
int allow_smem(K kernel, size_t bytes, int* granted) {
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

// The float32 body's launch: a block per rows_per_block rows.
int f32_geometry(const ChainParams& p, int smem_limit, geom::Geometry* g) {
  const size_t smem = ((size_t)p.t_floats + 2 * (size_t)p.max_cols) * 4 +
                      2 * (size_t)p.rows_per_block * p.d_max * 4;
  if (smem > (size_t)smem_limit) return (int)cudaErrorInvalidValue;
  const long long blocks = (p.rows + p.rows_per_block - 1) / p.rows_per_block;
  g->add(dim3((unsigned)blocks), kThreads, smem);
  return 0;
}

int launch_f32(const geom::Launch& l, const void* x, void* out,
               const ChainParams& p, cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  const int err = allow_smem(quanta_chain_kernel, l.smem, granted);
  if (err) return err;
  quanta_chain_kernel<<<l.grid, l.threads, l.smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------ bf16 body
namespace bfc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
// the plan's wire format (kernels/smem.py chain_plan_ints): a header, the
// canonical dims of x and their strides in the first stage's layout, then
// kStageInts per stage
constexpr int kHeaderInts = 11;
constexpr int kStageInts = 16 + 2 * kMaxCols;

// One stage as the host planned it: K = im * in (padded to kp in the
// layout it reads), O = om * on, the columns (ncols of them, column axes
// slowest first with their sizes and their strides in the layout the
// stage writes), the strides dm, dn of its pair axes there, the tensor's
// element offset in the tensor area, its column and output tables'
// offsets, the XOR mask of its tensor rows' 16-byte chunks, log2(ncols)
// (-1: not a power of two), the lane mapping of its micro-tiles
// (kernels/smem.py chain_tile: lo_shift, rc_blocked), and oc, the tensor
// rows (outputs) staged at once: o, or a divisor of o when the tensor
// streams in chunks (kernels/smem.py chain_chunks).
struct BStage {
  int k, kp, o, on, ncols, n_col, dm, dn, t_off, tab_off, t_swz, otab_off,
      ncols_shift, lo_shift, rc_blocked, oc;
  int col_dim[kMaxCols];
  int col_out[kMaxCols];
  const bf16* t;
};

struct BParams {
  int n_axes, n_stages, d_in, d_out, ld, rows_per_block, resident,
      in_identity, t_elems, tab_ints, variant;
  int dims_in[kMaxAxes];
  int in_strides[kMaxAxes];
  long long rows;
  BStage st[kMaxStages];
};
static_assert(sizeof(BParams) <= 4096, "kernel parameters exceed 4 KB");

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// shared memory of a block: the column tables, the tensor area, two row
// buffers of rows_per_block x ld
__host__ __device__ inline size_t smem_bytes(const BParams& p) {
  return (size_t)align16(4 * p.tab_ints) + (size_t)align16(2 * p.t_elems) +
         4 * (size_t)p.rows_per_block * p.ld;
}

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  f[0] = lo_f(v.x); f[1] = hi_f(v.x); f[2] = lo_f(v.y); f[3] = hi_f(v.y);
  f[4] = lo_f(v.z); f[5] = hi_f(v.z); f[6] = lo_f(v.w); f[7] = hi_f(v.w);
}

// Stage rows o0 .. o0 + oc - 1 of tensor T (O, K) from device memory into
// shared memory as oc rows of kp, the 16-byte chunk c of row o (counted
// from o0) at c ^ (o & t_swz): by cp.async when K is a multiple of 8 (then
// t_swz may be non-zero), else element by element (t_swz is 0).
__device__ __forceinline__ void load_tensor(const BStage& st, bf16* dst,
                                            int o0) {
  const bool vec = st.k % 8 == 0 && (reinterpret_cast<uintptr_t>(st.t) & 15) == 0;
  const bf16* t = st.t + (size_t)o0 * st.k;
  if (vec) {
    const int per = st.k / 8;
    for (int i = threadIdx.x; i < st.oc * per; i += kThreads) {
      const int o = i / per, c = i - o * per;
      sm90::cp_async16(sm90::smem_u32(dst + o * st.kp + 8 * (c ^ (o & st.t_swz))),
                       t + (size_t)o * st.k + 8 * c, true);
    }
  } else {
    for (int i = threadIdx.x; i < st.oc * st.k; i += kThreads) {
      const int o = i / st.k, k = i - o * st.k;
      dst[o * st.kp + k] = t[i];
    }
  }
}

// One stage (or one chunk of its outputs: oc of them, otab from the
// chunk's first) over the tile's nrows rows: item j is the micro-tile of
// (row, column) pairs and outputs that kernels/smem.py chain_tile gives
// it; every sum runs over k ascending, the next 8 values of k loaded
// while the current 8 are summed.
template <int TM, int TO>
__device__ __forceinline__ void stage(const BStage& st,
                                      const bf16* __restrict__ src,
                                      bf16* __restrict__ dst,
                                      const bf16* __restrict__ tens,
                                      const int* __restrict__ tab,
                                      const int* __restrict__ otab,
                                      int nrows, int ld) {
  const int K = st.k, kp = st.kp, O = st.oc;
  const int M = nrows * st.ncols;
  const int n_mt = (M + TM - 1) / TM, n_ot = (O + TO - 1) / TO;
  const int kc_end = K / 8, lo = 1 << st.lo_shift;
  // (row, column) of pair rc
  auto split = [&](int rc, int* r, int* c) {
    if (st.ncols_shift >= 0) {
      *r = rc >> st.ncols_shift;
      *c = rc & (st.ncols - 1);
    } else {
      *r = rc / st.ncols;
      *c = rc - *r * st.ncols;
    }
  };
  for (int j = threadIdx.x; j < n_mt * n_ot; j += kThreads) {
    const int rest = j >> st.lo_shift;
    const int mt = rest % n_mt;
    const int ot = (rest / n_mt) * lo + (j & (lo - 1));
    auto rc_of = [&](int i) {
      return st.rc_blocked ? mt * TM + i : mt + i * n_mt;
    };
    const bf16* hp[TM];
    const bf16* tp[TO];
    int sw[TO];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      int r, c;
      split(min(rc_of(i), M - 1), &r, &c);   // past the end: unused
      hp[i] = src + r * ld + c * kp;
    }
#pragma unroll
    for (int jj = 0; jj < TO; ++jj) {
      const int o = min(ot + jj * n_ot, O - 1);
      tp[jj] = tens + o * kp;
      sw[jj] = o & st.t_swz;
    }
    float acc[TM][TO];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TO; ++jj) acc[i][jj] = 0.f;
    uint4 hv[TM];
    if (kc_end > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        hv[i] = *reinterpret_cast<const uint4*>(hp[i]);
    }
    for (int kc = 0; kc < kc_end; ++kc) {
      float h[TM][8];
#pragma unroll
      for (int i = 0; i < TM; ++i) unpack8(hv[i], h[i]);
      if (kc + 1 < kc_end) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
          hv[i] = *reinterpret_cast<const uint4*>(hp[i] + 8 * (kc + 1));
      }
#pragma unroll
      for (int jj = 0; jj < TO; ++jj) {
        float t[8];
        unpack8(*reinterpret_cast<const uint4*>(tp[jj] + 8 * (kc ^ sw[jj])),
                t);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int i = 0; i < TM; ++i)
            acc[i][jj] = fmaf(t[kk], h[i][kk], acc[i][jj]);
      }
    }
    for (int k = 8 * kc_end; k < K; ++k) {   // K % 8 != 0: t_swz is 0
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float hv1 = __bfloat162float(hp[i][k]);
#pragma unroll
        for (int jj = 0; jj < TO; ++jj)
          acc[i][jj] = fmaf(__bfloat162float(tp[jj][k]), hv1, acc[i][jj]);
      }
    }
    int oat[TO];
#pragma unroll
    for (int jj = 0; jj < TO; ++jj) {
      const int o = ot + jj * n_ot;
      oat[jj] = o < O ? otab[o] : -1;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rc = rc_of(i);
      if (rc >= M) continue;
      int r, c;
      split(rc, &r, &c);
      const int base = r * ld + tab[c];
#pragma unroll
      for (int jj = 0; jj < TO; ++jj)
        if (oat[jj] >= 0)
          dst[base + oat[jj]] = __float2bfloat16(acc[i][jj]);
    }
  }
}

template <int TM, int TO>
__global__ void __launch_bounds__(kThreads, 1)
    chain_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                      const __grid_constant__ BParams p) {
  extern __shared__ __align__(16) unsigned char bfc_smem[];
  int* tab = reinterpret_cast<int*>(bfc_smem);
  bf16* tens = reinterpret_cast<bf16*>(bfc_smem + align16(4 * p.tab_ints));
  bf16* src = reinterpret_cast<bf16*>(bfc_smem + align16(4 * p.tab_ints) +
                                      align16(2 * p.t_elems));
  bf16* dst = src + (size_t)p.rows_per_block * p.ld;

  const long long row0 = (long long)blockIdx.x * p.rows_per_block;
  const long long left = p.rows - row0;
  const int nrows = left < p.rows_per_block ? (int)left : p.rows_per_block;

  // group 0: the tile's rows in the first stage's layout, stage 0's tensor
  const bf16* xr = x + row0 * p.d_in;
  if (p.in_identity && p.d_in % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int per = p.d_in / 8;
    for (int i = threadIdx.x; i < nrows * per; i += kThreads) {
      const int r = i / per, c = i - r * per;
      sm90::cp_async16(sm90::smem_u32(src + r * p.ld + 8 * c),
                       xr + (size_t)r * p.d_in + 8 * c, true);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * p.d_in; i += kThreads) {
      const int r = i / p.d_in;
      int f = i - r * p.d_in, at = 0;
      for (int a = p.n_axes - 1; a >= 0; --a) {
        const int q = f / p.dims_in[a];
        at += (f - q * p.dims_in[a]) * p.in_strides[a];
        f = q;
      }
      src[r * p.ld + at] = xr[i];
    }
  }
  load_tensor(p.st[0], tens + p.st[0].t_off, 0);
  sm90::cp_async_commit();
  // group 1: the other stages' tensors, when they all fit
  if (p.resident)
    for (int s = 1; s < p.n_stages; ++s)
      load_tensor(p.st[s], tens + p.st[s].t_off, 0);
  sm90::cp_async_commit();
  // every stage's tables: where column c's outputs start in the next
  // layout, and where output o goes from there
  for (int s = 0; s < p.n_stages; ++s) {
    const BStage& st = p.st[s];
    for (int c = threadIdx.x; c < st.ncols; c += kThreads) {
      int rem = c, off = 0;
      for (int a = st.n_col - 1; a >= 0; --a) {
        const int q = rem / st.col_dim[a];
        off += (rem - q * st.col_dim[a]) * st.col_out[a];
        rem = q;
      }
      tab[st.tab_off + c] = off;
    }
    for (int o = threadIdx.x; o < st.o; o += kThreads)
      tab[st.otab_off + o] = (o / st.on) * st.dm + (o % st.on) * st.dn;
  }
  sm90::cp_async_wait<1>();
  __syncthreads();   // rows, tensor 0 and the tables in place

  for (int s = 0;;) {
    const BStage& st = p.st[s];
    // a streamed tensor: its chunks of oc rows one after another, each
    // output summed whole within its chunk
    for (int o0 = 0;;) {
      stage<TM, TO>(st, src, dst, tens + st.t_off, tab + st.tab_off,
                    tab + st.otab_off + o0, nrows, p.ld);
      o0 += st.oc;
      if (o0 >= st.o) break;
      __syncthreads();   // the chunk's sums are done with the tensor area
      load_tensor(st, tens, o0);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      __syncthreads();
    }
    bf16* tmp = src;
    src = dst;
    dst = tmp;
    if (++s == p.n_stages) break;
    if (p.resident) {
      if (s == 1) sm90::cp_async_wait<0>();
      __syncthreads();   // stage s - 1 done; at s == 1 every tensor landed
    } else {
      __syncthreads();   // stage s - 1 done with the tensor area
      load_tensor(p.st[s], tens, 0);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      __syncthreads();
    }
  }
  __syncthreads();
  // the last stage stored the canonical order
  bf16* orow = out + row0 * p.d_out;
  if (p.d_out % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int per = p.d_out / 8;
    for (int i = threadIdx.x; i < nrows * per; i += kThreads) {
      const int r = i / per, c = i - r * per;
      *reinterpret_cast<uint4*>(orow + (size_t)r * p.d_out + 8 * c) =
          *reinterpret_cast<const uint4*>(src + r * p.ld + 8 * c);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * p.d_out; i += kThreads) {
      const int r = i / p.d_out;
      orow[i] = src[r * p.ld + (i - r * p.d_out)];
    }
  }
}

// The bf16 body's launch: a block per rows_per_block rows.
int geometry(const BParams& p, int smem_limit, geom::Geometry* g) {
  const size_t smem = smem_bytes(p);
  if (smem > (size_t)smem_limit) return (int)cudaErrorInvalidValue;
  const long long blocks = (p.rows + p.rows_per_block - 1) / p.rows_per_block;
  g->add(dim3((unsigned)blocks), kThreads, smem);
  return 0;
}

template <int TM, int TO>
int launch(const geom::Launch& l, const bf16* x, bf16* out, const BParams& p,
           cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  const int err = allow_smem(chain_bf16_kernel<TM, TO>, l.smem, granted);
  if (err) return err;
  chain_bf16_kernel<TM, TO><<<l.grid, l.threads, l.smem, stream>>>(x, out, p);
  return (int)cudaGetLastError();
}

// The plan ints (kernels/smem.py chain_plan_ints) into the kernel's
// parameters; refuses a plan the kernel cannot run.
int unpack(const int* w, int n, BParams* p) {
  if (n < kHeaderInts) return 1;
  p->n_axes = w[0];
  p->n_stages = w[1];
  p->d_in = w[2];
  p->d_out = w[3];
  p->ld = w[4];
  p->rows_per_block = w[5];
  p->resident = w[6];
  p->in_identity = w[7];
  p->t_elems = w[8];
  p->tab_ints = w[9];
  p->variant = w[10];
  if (p->n_axes < 1 || p->n_axes > kMaxAxes || p->n_stages < 1 ||
      p->n_stages > kMaxStages || p->rows_per_block < 1 || p->ld % 8 ||
      p->d_in > p->ld || p->d_out > p->ld || p->t_elems < 0 ||
      p->tab_ints < 0 ||
      n != kHeaderInts + 2 * p->n_axes + kStageInts * p->n_stages)
    return 1;
  const int* a = w + kHeaderInts;
  int d = 1;
  for (int i = 0; i < p->n_axes; ++i) {
    p->dims_in[i] = a[i];
    p->in_strides[i] = a[p->n_axes + i];
    d *= a[i];
  }
  if (d != p->d_in) return 1;
  const int* sp = a + 2 * p->n_axes;
  const int to = p->variant == 0 ? 8 : 4;   // the micro-tile's outputs
  for (int s = 0; s < p->n_stages; ++s, sp += kStageInts) {
    BStage& st = p->st[s];
    st.k = sp[0];
    st.kp = sp[1];
    st.o = sp[2];
    st.on = sp[3];
    st.ncols = sp[4];
    st.n_col = sp[5];
    st.dm = sp[6];
    st.dn = sp[7];
    st.t_off = sp[8];
    st.tab_off = sp[9];
    st.t_swz = sp[10];
    st.otab_off = sp[11];
    st.ncols_shift = sp[12];
    st.lo_shift = sp[13];
    st.rc_blocked = sp[14];
    st.oc = sp[15];
    if (st.k < 1 || st.kp % 8 || st.kp < st.k || st.o < 1 || st.on < 1 ||
        st.o % st.on || st.ncols < 1 || st.n_col < 0 || st.n_col > kMaxCols ||
        (long long)st.ncols * st.kp > p->ld || st.t_off % 8 ||
        st.oc < 1 || st.o % st.oc || (p->resident && st.oc != st.o) ||
        st.t_off + st.oc * st.kp > p->t_elems ||
        st.tab_off + st.ncols > p->tab_ints ||
        st.otab_off + st.o > p->tab_ints ||
        (st.t_swz && (st.k % 8 || (st.t_swz + 1) * 8 > st.kp)) ||
        (st.ncols_shift >= 0 && st.ncols != 1 << st.ncols_shift) ||
        st.lo_shift < 0 || st.lo_shift > 5 ||
        ((st.oc + to - 1) / to) % (1 << st.lo_shift) ||
        (st.rc_blocked != 0 && st.rc_blocked != 1))
      return 1;
    int cols = 1;
    for (int c = 0; c < st.n_col; ++c) {
      st.col_dim[c] = sp[16 + c];
      st.col_out[c] = sp[16 + kMaxCols + c];
      cols *= st.col_dim[c];
    }
    if (cols != st.ncols) return 1;
  }
  return 0;
}

}  // namespace bfc

// Row-major strides of a register with dims d[0..n).
void strides(const int* d, int n, int* s) {
  int acc = 1;
  for (int a = n - 1; a >= 0; --a) {
    s[a] = acc;
    acc *= d[a];
  }
}

// The float32 body's parameters from quanta_apply_launch's meta.
int f32_params(const int* meta, const void* const* tensors, long long rows,
               int rows_per_block, ChainParams* out) {
  ChainParams& p = *out;
  const int n_axes = meta[0];
  p.n_stages = meta[1];
  if (n_axes < 1 || n_axes > kMaxAxes || p.n_stages < 1 ||
      p.n_stages > kMaxStages || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  int cur[kMaxAxes];
  p.d_in = 1;
  for (int a = 0; a < n_axes; ++a) {
    cur[a] = meta[2 + a];
    p.d_in *= cur[a];
  }
  p.d_max = p.d_in;
  int a_row = 0;  // floats of one row a of the widest stage's tensor
  const int* sp = meta + 2 + n_axes;
  for (int s = 0; s < p.n_stages; ++s) {
    const int m = sp[6 * s + 0], n = sp[6 * s + 1];
    if (m < 0 || n <= m || n >= n_axes) return (int)cudaErrorInvalidValue;
    Stage& st = p.st[s];
    st.om = sp[6 * s + 2];
    st.on = sp[6 * s + 3];
    st.im = sp[6 * s + 4];
    st.in_ = sp[6 * s + 5];
    if (st.im != cur[m] || st.in_ != cur[n]) return (int)cudaErrorInvalidValue;
    st.t = tensors[s];
    int s_in[kMaxAxes], s_out[kMaxAxes], nxt[kMaxAxes];
    for (int a = 0; a < n_axes; ++a) nxt[a] = cur[a];
    nxt[m] = st.om;
    nxt[n] = st.on;
    strides(cur, n_axes, s_in);
    strides(nxt, n_axes, s_out);
    st.sm = s_in[m];
    st.sn = s_in[n];
    st.dm = s_out[m];
    st.dn = s_out[n];
    st.n_col = 0;
    st.ncols = 1;
    for (int a = 0; a < n_axes; ++a) {
      if (a == m || a == n) continue;
      st.col_dim[st.n_col] = cur[a];
      st.col_in[st.n_col] = s_in[a];
      st.col_out[st.n_col] = s_out[a];
      st.ncols *= cur[a];
      ++st.n_col;
    }
    const int t_floats = st.im * st.in_ * (st.om * st.on + 1);
    p.t_floats = t_floats > p.t_floats ? t_floats : p.t_floats;
    a_row = st.in_ * (st.om * st.on + 1) > a_row
                ? st.in_ * (st.om * st.on + 1)
                : a_row;
    p.max_cols = st.ncols > p.max_cols ? st.ncols : p.max_cols;
    int d = 1;
    for (int a = 0; a < n_axes; ++a) {
      cur[a] = nxt[a];
      d *= cur[a];
    }
    p.d_max = d > p.d_max ? d : p.d_max;
  }
  p.d_out = 1;
  for (int a = 0; a < n_axes; ++a) p.d_out *= cur[a];
  // the staging area the host planned (kernels/smem.py chain_f32_plan):
  // every tensor whole, or at least one row a of the widest stage
  const int t_cap = sp[6 * p.n_stages];
  if (t_cap < a_row) return (int)cudaErrorInvalidValue;
  p.t_floats = t_cap < p.t_floats ? t_cap : p.t_floats;
  p.rows = rows;
  p.rows_per_block = rows_per_block;
  return 0;
}

// The launch of quanta_apply_launch: the parameters from meta, then the
// float32 body's geometry (bf16 takes quanta_chain_bf16_launch).
int apply_geometry(int dtype, const int* meta, const void* const* tensors,
                   long long rows, int rows_per_block, int smem_limit,
                   ChainParams* p, geom::Geometry* g) {
  const int err = f32_params(meta, tensors, rows, rows_per_block, p);
  if (err || rows <= 0) return err;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return f32_geometry(*p, smem_limit, g);
}

// The launch of quanta_chain_bf16_launch.
int bf16_geometry(const int* plan, int n_plan, const void* const* tensors,
                  long long rows, int smem, int smem_limit, bfc::BParams* p,
                  geom::Geometry* g) {
  if (bfc::unpack(plan, n_plan, p)) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < p->n_stages; ++s)
    p->st[s].t = static_cast<const __nv_bfloat16*>(tensors[s]);
  p->rows = rows;
  if (bfc::smem_bytes(*p) != (size_t)smem) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  if (p->variant != 0 && p->variant != 1) return (int)cudaErrorInvalidValue;
  return bfc::geometry(*p, smem_limit, g);
}

}  // namespace

// meta: n_axes, n_stages, dims_in[n_axes], then per stage m, n, om, on, im,
// in, then the tensor floats to stage at once (kernels/smem.py
// chain_f32_plan).  tensors: host array of n_stages device pointers,
// contiguous (om, on, im, in) tensors in the activation dtype.  dtype: 0
// float32 (1, bfloat16, takes quanta_chain_bf16_launch).  smem_limit: the
// shared memory a block of this device may opt in to.  Returns the
// cudaError_t of the launch.
extern "C" int quanta_apply_launch(int dtype, const void* x, void* out,
                                   long long rows, const int* meta,
                                   const void* const* tensors,
                                   int rows_per_block, int smem_limit,
                                   void* stream) {
  ChainParams p{};
  geom::Geometry g;
  const int err = apply_geometry(dtype, meta, tensors, rows, rows_per_block,
                                 smem_limit, &p, &g);
  if (err || g.n == 0) return err;
  return launch_f32(g.l[0], x, out, p, static_cast<cudaStream_t>(stream));
}

// quanta_apply_launch's geometry (geometry.cuh), launching nothing.
extern "C" int quanta_apply_describe(int dtype, const void* x, void* out,
                                     long long rows, const int* meta,
                                     const void* const* tensors,
                                     int rows_per_block, int smem_limit,
                                     int* desc, int cap) {
  ChainParams p{};
  geom::Geometry g;
  return geom::describe(apply_geometry(dtype, meta, tensors, rows,
                                       rows_per_block, smem_limit, &p, &g),
                        g, desc, cap);
}

// The bf16 chain (chain_bf16_kernel) of x (rows, d_in) into out (rows,
// d_out), both contiguous.  plan: the n_plan ints of kernels/smem.py
// chain_plan_ints; tensors: host array of the stages' device pointers,
// contiguous (om, on, im, in) bf16 tensors; smem_bytes: the plan's shared
// memory (checked against the kernel's own sum); smem_limit: what a block
// of this device may opt in to.  Returns the cudaError_t of the launch.
extern "C" int quanta_chain_bf16_launch(const void* x, void* out,
                                        long long rows, const int* plan,
                                        int n_plan,
                                        const void* const* tensors,
                                        int smem_bytes, int smem_limit,
                                        void* stream) {
  bfc::BParams p{};
  geom::Geometry g;
  const int err = bf16_geometry(plan, n_plan, tensors, rows, smem_bytes,
                                smem_limit, &p, &g);
  if (err || g.n == 0) return err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.variant == 0) return bfc::launch<8, 8>(g.l[0], xb, ob, p, s);
  return bfc::launch<4, 4>(g.l[0], xb, ob, p, s);
}

// quanta_chain_bf16_launch's geometry (geometry.cuh), launching nothing.
extern "C" int quanta_chain_bf16_describe(const void* x, void* out,
                                          long long rows, const int* plan,
                                          int n_plan,
                                          const void* const* tensors,
                                          int smem_bytes, int smem_limit,
                                          int* desc, int cap) {
  bfc::BParams p{};
  geom::Geometry g;
  return geom::describe(bf16_geometry(plan, n_plan, tensors, rows, smem_bytes,
                                      smem_limit, &p, &g),
                        g, desc, cap);
}
