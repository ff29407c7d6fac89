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

}  // namespace dip
