// Launch geometry: what an entry point launches (grid, threads, dynamic
// shared memory), computed in one place that both the entry point and its
// `*_describe` twin use.  A describe export takes the entry point's
// arguments with the stream replaced by (int* out, int cap), launches
// nothing, and writes kInts ints a launch: grid x, y, z, the block's
// threads and its dynamic shared memory.  It returns the number of
// launches, or the negated error the entry point would return.
// kernels/smem.py's budgets and repro_torch/analysis/geometry.py model the
// same numbers on the host; `python -m repro_torch.analysis --card`
// compares the two.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace geom {

constexpr int kMaxLaunches = 4;
constexpr int kInts = 5;

struct Launch {
  dim3 grid;
  int threads;
  int smem;
};

struct Geometry {
  int n = 0;
  Launch l[kMaxLaunches];
  void add(dim3 grid, int threads, size_t smem) {
    l[n++] = Launch{grid, threads, (int)smem};
  }
};

// The describe exports' result: the geometry as ints, or -err.
inline int describe(int err, const Geometry& g, int* out, int cap) {
  if (err) return -err;
  if (g.n * kInts > cap) return -(int)cudaErrorInvalidValue;
  for (int i = 0; i < g.n; ++i) {
    const Launch& l = g.l[i];
    out[kInts * i + 0] = (int)l.grid.x;
    out[kInts * i + 1] = (int)l.grid.y;
    out[kInts * i + 2] = (int)l.grid.z;
    out[kInts * i + 3] = l.threads;
    out[kInts * i + 4] = l.smem;
  }
  return g.n;
}

}  // namespace geom
