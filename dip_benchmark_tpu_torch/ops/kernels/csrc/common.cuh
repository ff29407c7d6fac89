// Shared declarations of the port's CUDA kernel library.
//
// Every entry point is a plain C function: pointers and the stream arrive
// as void*, sizes as int or size_t. Each one launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#define DIP_API extern "C" __attribute__((visibility("default")))

namespace dip {

constexpr int kThreads = 256;

inline unsigned int blocks_for(size_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// The card takes at most 65,535 blocks on gridDim.y.
constexpr long kMaxGridY = 65535;

// For a grid whose gridDim.y counts blocks of `rows` rows over hp rows:
// launch(grid_y, row0) once for each run of at most kMaxGridY such blocks,
// row0 the run's first row, which the kernel adds to blockIdx.y * rows.
// Below the limit that is one launch with row0 = 0, the grid of old; past
// it, a few launches one after another on the stream. Returns the first
// launch's error, else 0.
template <class Launch>
int launch_row_runs(int hp, int rows, Launch launch) {
  if (hp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long blocks = (static_cast<long>(hp) + rows - 1) / rows;
  for (long b = 0; b < blocks; b += kMaxGridY) {
    launch(static_cast<unsigned int>(blocks - b < kMaxGridY ? blocks - b
                                                            : kMaxGridY),
           static_cast<int>(b * rows));
    if (const int e = launch_status()) return e;
  }
  return 0;
}

}  // namespace dip
