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
// every stage (the rounding of _chain_block).
//
// What bounds it on the H100: on paper, memory.  Staged through device
// memory every stage would read and write the whole activation; fused, the
// kernel reads x once and writes the result once, and the stage tensors
// (43,008 elements for llama2-7b's 16-8-8-4 scheme) stay in L2.  Its
// arithmetic is d * sum_a(im*in) MACs per row: about 3.7 MFLOP per
// 4096-wide row against 16 KB moved in bf16, ~224 FLOP/byte, just under the
// card's bf16 ridge (~295).  This SIMT kernel does not reach that bound:
// shared-memory bandwidth bounds it, one activation load and one tensor
// load per fused multiply-add.
//
// What the design does about it: one block per row tile; the tile's rows
// live in shared memory for the whole chain, ping-ponged between two
// buffers in the activation dtype, so no stage touches device memory.  The
// row tile is sized by kernels/smem.py (8 rows at d=4096 in bf16: 2 x 8 x
// 4096 x 2 B = 128 KB, plus the largest stage tensor).  Each stage tensor
// is staged in shared memory in fp32, transposed to [in-index][out-index]
// with its rows padded by one word, beside a table of each column's offset
// (the column: one index of every axis outside the pair).  A thread
// computes one output index (i_m, i_n) for four (row, column) pairs, so it
// runs four independent sums that share every tensor load; the output
// index varies fastest across the threads of a warp, so at each step of
// the sum the warp reads consecutive tensor words and broadcast activation
// values: no bank conflicts, whatever the axis pair.  The axis permutes of
// the TPU version are index arithmetic here: no permute copies.  Rows past
// the end of x are masked, with no padding copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quanta_chain_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const __grid_constant__ ChainParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tens = reinterpret_cast<float*>(smem_raw);
  int* off_in = reinterpret_cast<int*>(tens + p.t_floats);
  int* off_out = off_in + p.max_cols;
  T* src = reinterpret_cast<T*>(off_out + p.max_cols);
  T* dst = src + (size_t)p.rows_per_block * p.d_max;

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
    __syncthreads();  // rows loaded / previous stage done with the tables
    // tens[k * ldt + o] = T[o, k] in fp32 (consecutive threads walk k, so
    // the padded stride ldt spreads their stores over the banks)
    const T* tg = static_cast<const T*>(st.t);
    for (int i = threadIdx.x; i < oo * kk; i += kThreads) {
      const int o = i / kk;
      const int k = i - o * kk;
      tens[k * ldt + o] = to_f(tg[i]);
    }
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
    __syncthreads();  // tensor and offsets staged

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
      const T* h[kCols];
      int out_at[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        // past the end: recompute the group's first pair, store nothing
        const int rc = rc0 + u < n_rc ? rc0 + u : rc0;
        const int r = rc / st.ncols;
        const int c = rc - r * st.ncols;
        h[u] = src + r * p.d_max + off_in[c];
        out_at[u] = rc0 + u < n_rc
                        ? r * p.d_max + off_out[c] + i_m * st.dm + i_n * st.dn
                        : -1;
      }
      float acc[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[u] = 0.f;
      const float* tr = tens + o;
      for (int a = 0; a < im; ++a) {
        const float* ta = tr + a * inn * ldt;
        const int ha = a * st.sm;
        for (int b = 0; b < inn; ++b) {
          const float t = ta[b * ldt];
          const int off = ha + b * st.sn;
#pragma unroll
          for (int u = 0; u < kCols; ++u)
            acc[u] = fmaf(t, to_f(h[u][off]), acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (out_at[u] >= 0) dst[out_at[u]] = from_f<T>(acc[u]);
    }
    T* tmp = src;
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

template <typename T>
int launch(const void* x, void* out, const ChainParams& p, int smem_limit,
           cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  const size_t smem = ((size_t)p.t_floats + 2 * (size_t)p.max_cols) * 4 +
                      2 * (size_t)p.rows_per_block * p.d_max * sizeof(T);
  if (smem > (size_t)smem_limit) return (int)cudaErrorInvalidValue;
  const int err = allow_smem(quanta_chain_kernel<T>, smem, granted);
  if (err) return err;
  const long long blocks = (p.rows + p.rows_per_block - 1) / p.rows_per_block;
  quanta_chain_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

// Row-major strides of a register with dims d[0..n).
void strides(const int* d, int n, int* s) {
  int acc = 1;
  for (int a = n - 1; a >= 0; --a) {
    s[a] = acc;
    acc *= d[a];
  }
}

}  // namespace

// meta: n_axes, n_stages, dims_in[n_axes], then per stage m, n, om, on, im,
// in.  tensors: host array of n_stages device pointers, contiguous
// (om, on, im, in) tensors in the activation dtype.  dtype: 0 float32,
// 1 bfloat16.  smem_limit: the shared memory a block of this device may
// opt in to.  Returns the cudaError_t of the launch.
extern "C" int quanta_apply_launch(int dtype, const void* x, void* out,
                                   long long rows, const int* meta,
                                   const void* const* tensors,
                                   int rows_per_block, int smem_limit,
                                   void* stream) {
  ChainParams p{};
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
  p.rows = rows;
  p.rows_per_block = rows_per_block;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, p, smem_limit, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, p, smem_limit, s);
  return (int)cudaErrorInvalidValue;
}
