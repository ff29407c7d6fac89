// Point kernels of the uint8 benchmark matrix: Copy, Inversion, Threshold
// and Grayscale over the planar mirror-padded (C, Hp, pitch) image.
//
// Replaces (dip_benchmark_tpu/ops/pallas/point.py):
//   copy_u8              <- _copy_dma (whole-buffer HBM->HBM DMA)
//   point_u8<Invert>     <- _inversion_kernel via _elementwise
//   point_u8<Threshold>  <- _threshold_kernel via _elementwise
//   grayscale_u8         <- _grayscale_kernel via _grayscale
//
// Bound: device-memory bandwidth. Each op reads and writes the whole
// padded buffer once (C * Hp * pitch bytes each way) and does a handful of
// integer operations per byte, far below the card's compute rate.
//
// Design: one thread per 16-byte vector, neighbouring threads on
// neighbouring addresses, so every warp moves 512 contiguous bytes per
// load and per store. The layout's pitch is a multiple of 16 bytes, so
// the buffer and every plane are whole vectors and no thread needs a tail
// case. Point ops commute with mirroring, so they run over the halo too
// and the output keeps a valid mirror halo.
#include "common.cuh"

namespace {

__global__ void copy_u8(const uint4* __restrict__ in, uint4* __restrict__ out,
                        size_t n16) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n16) out[i] = in[i];
}

struct Invert {
  // 255 - x == ~x on every byte of the word.
  __device__ static uint32_t apply(uint32_t v, uint32_t, uint32_t) {
    return ~v;
  }
};

struct Threshold {
  // __vcmpgtu4 sets each byte to 0xFF where v's byte > thr's byte and to 0
  // elsewhere; the AND turns 0xFF into the threshold's output value. The
  // threshold and output value arrive replicated into all four bytes.
  __device__ static uint32_t apply(uint32_t v, uint32_t thr4, uint32_t max4) {
    return __vcmpgtu4(v, thr4) & max4;
  }
};

template <class Op>
__global__ void point_u8(const uint4* __restrict__ in, uint4* __restrict__ out,
                         size_t n16, uint32_t a, uint32_t b) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n16) return;
  uint4 v = in[i];
  v.x = Op::apply(v.x, a, b);
  v.y = Op::apply(v.y, a, b);
  v.z = Op::apply(v.z, a, b);
  v.w = Op::apply(v.w, a, b);
  out[i] = v;
}

// Four luma bytes from four R, G and B bytes: the spec's exact fixed point
// (wr*R + wg*G + wb*B) >> shift in int32 (every product and sum < 2^24).
__device__ __forceinline__ uint32_t luma4(uint32_t r, uint32_t g, uint32_t b,
                                          int wr, int wg, int wb, int shift) {
  uint32_t y = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = 8 * k;
    const int v = (wr * static_cast<int>((r >> s) & 0xFFu) +
                   wg * static_cast<int>((g >> s) & 0xFFu) +
                   wb * static_cast<int>((b >> s) & 0xFFu)) >> shift;
    y |= (static_cast<uint32_t>(v) & 0xFFu) << s;
  }
  return y;
}

__device__ __forceinline__ uint4 luma16(uint4 r, uint4 g, uint4 b, int wr,
                                        int wg, int wb, int shift) {
  uint4 y;
  y.x = luma4(r.x, g.x, b.x, wr, wg, wb, shift);
  y.y = luma4(r.y, g.y, b.y, wr, wg, wb, shift);
  y.z = luma4(r.z, g.z, b.z, wr, wg, wb, shift);
  y.w = luma4(r.w, g.w, b.w, wr, wg, wb, shift);
  return y;
}

// in and out are (3, Hp, pitch); plane16 = Hp * pitch / 16. One value is
// computed from the three input planes and stored to all three outputs.
__global__ void grayscale_u8(const uint4* __restrict__ in,
                             uint4* __restrict__ out, size_t plane16, int wr,
                             int wg, int wb, int shift) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane16) return;
  const uint4 y = luma16(in[i], in[i + plane16], in[i + 2 * plane16], wr, wg,
                         wb, shift);
  out[i] = y;
  out[i + plane16] = y;
  out[i + 2 * plane16] = y;
}

uint32_t replicate(int byte) {
  return 0x01010101u * (static_cast<uint32_t>(byte) & 0xFFu);
}

}  // namespace

DIP_API const char* dip_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

DIP_API int dip_copy_u8(const void* in, void* out, size_t n16, void* stream) {
  copy_u8<<<dip::blocks_for(n16, dip::kThreads), dip::kThreads, 0,
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), n16);
  return dip::launch_status();
}

DIP_API int dip_inversion_u8(const void* in, void* out, size_t n16,
                             void* stream) {
  point_u8<Invert><<<dip::blocks_for(n16, dip::kThreads), dip::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), n16, 0u, 0u);
  return dip::launch_status();
}

DIP_API int dip_threshold_u8(const void* in, void* out, size_t n16,
                             int threshold, int max_value, void* stream) {
  point_u8<Threshold><<<dip::blocks_for(n16, dip::kThreads), dip::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), n16,
      replicate(threshold), replicate(max_value));
  return dip::launch_status();
}

DIP_API int dip_grayscale_u8(const void* in, void* out, size_t plane16,
                             int wr, int wg, int wb, int shift,
                             void* stream) {
  grayscale_u8<<<dip::blocks_for(plane16, dip::kThreads), dip::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), plane16, wr,
      wg, wb, shift);
  return dip::launch_status();
}
