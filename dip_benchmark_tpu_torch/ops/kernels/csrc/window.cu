// Windowed kernels of the uint8 benchmark matrix: erosions, convolutions
// and the specialised 3x3 blur, as one stencil skeleton window_u8<Body>.
//
// Replaces (dip_benchmark_tpu/ops/pallas/window.py):
//   window_u8<Body>           <- _windowed_call (the banded DMA skeleton)
//   MinPlus, MinRect          <- _make_morphology via make_erosion
//                                (body_plus, body_rect)
//   MinSep                    <- make_erosion_separated_fused
//   ConvDense<KH, KW>         <- make_convolution (body_rank1)
//   ConvSep<N>                <- make_convolution_separated_fused
//   Blur3x3                   <- make_gaussian_blur_3x3
//
// Bound: device-memory bandwidth for the compulsory traffic (the padded
// buffer is read once and written once), but this first version issues
// one byte load per tap, so what it spends is load instructions and
// L1/L2 hits on the neighbouring taps, not DRAM bytes.
//
// Design: one thread per output byte, in the same padded coordinates as
// the input (the op is shape-preserving, like the TPU kernel). The mirror
// halo is baked into the layout, so a tap never needs a boundary branch;
// the only branch is the outer ring of HY rows and HX columns, where not
// every tap is inside the buffer and the kernel writes 0. Every byte of
// the output is written, so the kernel is deterministic on the whole
// buffer. Runtime masks travel by value in the body struct (the kernel's
// parameter space is the analogue of the TPU kernel's SMEM scalars);
// Blur3x3 has its weights compiled in, because op #14 measures that
// specialisation. Shared-memory tiles and byte-SIMD are later work.
#include "common.cuh"

namespace {

struct Plane {
  const uint8_t* __restrict__ p;
  int pitch;
  __device__ __forceinline__ int at(int y, int x) const {
    return p[static_cast<size_t>(y) * pitch + x];
  }
};

__device__ __forceinline__ int half_of(int shift) {
  return shift > 0 ? 1 << (shift - 1) : 0;
}

__device__ __forceinline__ int clamp_u8(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

struct MinRect {  // 3x3 square erosion
  static constexpr int HY = 1, HX = 1;
  __device__ int operator()(const Plane& in, int y, int x) const {
    int m = 255;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) m = min(m, in.at(y + dy, x + dx));
    return m;
  }
};

struct MinPlus {  // 3x3 cross erosion
  static constexpr int HY = 1, HX = 1;
  __device__ int operator()(const Plane& in, int y, int x) const {
    int m = min(in.at(y - 1, x), in.at(y + 1, x));
    m = min(m, min(in.at(y, x - 1), in.at(y, x + 1)));
    return min(m, in.at(y, x));
  }
};

struct MinSep {  // 3x1 column min, then 1x3 min over the column mins
  static constexpr int HY = 1, HX = 1;
  __device__ int operator()(const Plane& in, int y, int x) const {
    int m = 255;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int col = min(min(in.at(y - 1, x + dx), in.at(y, x + dx)),
                          in.at(y + 1, x + dx));
      m = min(m, col);
    }
    return m;
  }
};

// Dense KH x KW correlation with a runtime integer mask: one int32 sum,
// one round-half-up (acc + half) >> shift, clamp to [0, 255]. Equal to the
// TPU kernel's rank-1 factoring, which also rounds once.
template <int KH, int KW>
struct ConvDense {
  static constexpr int HY = KH / 2, HX = KW / 2;
  int w[KH * KW];
  int shift;
  __device__ int operator()(const Plane& in, int y, int x) const {
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < KH; ++ky)
#pragma unroll
      for (int kx = 0; kx < KW; ++kx)
        acc += w[ky * KW + kx] * in.at(y + ky - HY, x + kx - HX);
    return clamp_u8((acc + half_of(shift)) >> shift);
  }
};

// 1xN pass with the row mask, rounded and clamped to u8, then an Nx1 pass
// with the column mask over those values, rounded and clamped again. The
// pass order and the rounding of the intermediate are part of the answer:
// a single rounding is not bit-exact. Each thread recomputes the N
// horizontal results it needs; the baked mirror rows make them equal to
// the mirrored intermediate of the two-pass reference.
template <int N>
struct ConvSep {
  static constexpr int HY = N / 2, HX = N / 2;
  int wr[N];
  int wc[N];
  int shift;
  __device__ int operator()(const Plane& in, int y, int x) const {
    const int half = half_of(shift);
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < N; ++ky) {
      int row = 0;
#pragma unroll
      for (int kx = 0; kx < N; ++kx)
        row += wr[kx] * in.at(y + ky - HY, x + kx - HX);
      acc += wc[ky] * clamp_u8((row + half) >> shift);
    }
    return clamp_u8((acc + half) >> shift);
  }
};

// Op #14: 1-2-1 x 1-2-1 with the weights compiled in, vertical pass first,
// one rounding (o + 8) >> 4. The sum is at most 255 * 16, so no clamp.
struct Blur3x3 {
  static constexpr int HY = 1, HX = 1;
  __device__ int operator()(const Plane& in, int y, int x) const {
    int o = 0;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int col = in.at(y - 1, x + dx) + 2 * in.at(y, x + dx) +
                      in.at(y + 1, x + dx);
      o += dx == 0 ? 2 * col : col;
    }
    return (o + 8) >> 4;
  }
};

// in and out are (C, Hp, pitch); the grid is (pitch / 32, Hp / 8, C).
template <class Body>
__global__ void window_u8(const uint8_t* __restrict__ in,
                          uint8_t* __restrict__ out, int hp, int pitch,
                          const Body body) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= pitch || y >= hp) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * pitch;
  const Plane src{in + plane, pitch};
  int v = 0;
  if (y >= Body::HY && y < hp - Body::HY && x >= Body::HX &&
      x < pitch - Body::HX)
    v = body(src, y, x);
  out[plane + static_cast<size_t>(y) * pitch + x] = static_cast<uint8_t>(v);
}

template <class Body>
int launch_window(const void* in, void* out, int channels, int hp, int pitch,
                  const Body& body, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((pitch + block.x - 1) / block.x,
                  (hp + block.y - 1) / block.y, channels);
  window_u8<Body><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), hp, pitch,
      body);
  return dip::launch_status();
}

template <int KH, int KW>
int launch_conv_dense(const void* in, void* out, int channels, int hp,
                      int pitch, const int* w, int shift, void* stream) {
  ConvDense<KH, KW> body;
  for (int i = 0; i < KH * KW; ++i) body.w[i] = w[i];
  body.shift = shift;
  return launch_window(in, out, channels, hp, pitch, body, stream);
}

template <int N>
int launch_conv_sep(const void* in, void* out, int channels, int hp,
                    int pitch, const int* wr, const int* wc, int shift,
                    void* stream) {
  ConvSep<N> body;
  for (int i = 0; i < N; ++i) {
    body.wr[i] = wr[i];
    body.wc[i] = wc[i];
  }
  body.shift = shift;
  return launch_window(in, out, channels, hp, pitch, body, stream);
}

}  // namespace

DIP_API int dip_erosion_rect_u8(const void* in, void* out, int channels,
                                int hp, int pitch, void* stream) {
  return launch_window(in, out, channels, hp, pitch, MinRect{}, stream);
}

DIP_API int dip_erosion_plus_u8(const void* in, void* out, int channels,
                                int hp, int pitch, void* stream) {
  return launch_window(in, out, channels, hp, pitch, MinPlus{}, stream);
}

DIP_API int dip_erosion_sep_u8(const void* in, void* out, int channels,
                               int hp, int pitch, void* stream) {
  return launch_window(in, out, channels, hp, pitch, MinSep{}, stream);
}

DIP_API int dip_blur3x3_u8(const void* in, void* out, int channels, int hp,
                           int pitch, void* stream) {
  return launch_window(in, out, channels, hp, pitch, Blur3x3{}, stream);
}

// kh x kw is 3x3 or 5x5, the masks of the op matrix; w holds kh * kw
// weights in row-major order.
DIP_API int dip_conv_dense_u8(const void* in, void* out, int channels, int hp,
                              int pitch, int kh, int kw, const int* w,
                              int shift, void* stream) {
  if (kh == 3 && kw == 3)
    return launch_conv_dense<3, 3>(in, out, channels, hp, pitch, w, shift,
                                   stream);
  if (kh == 5 && kw == 5)
    return launch_conv_dense<5, 5>(in, out, channels, hp, pitch, w, shift,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// n in {3, 5}; wr is the 1xN row mask, wc the Nx1 column mask.
DIP_API int dip_conv_sep_u8(const void* in, void* out, int channels, int hp,
                            int pitch, int n, const int* wr, const int* wc,
                            int shift, void* stream) {
  if (n == 3)
    return launch_conv_sep<3>(in, out, channels, hp, pitch, wr, wc, shift,
                              stream);
  if (n == 5)
    return launch_conv_sep<5>(in, out, channels, hp, pitch, wr, wc, shift,
                              stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
