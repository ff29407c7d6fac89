// Kernels of the float32 data model (planar (C, Hp, pitch) float32 in
// [0, 1], the same mirror-padded layout as the uint8 model): the point ops,
// the luma, the windowed ops and the fused pipeline.
//
// Replaces (dip_benchmark_tpu/ops/pallas/f32.py):
//   point_f32<Copy>            <- point.py _copy_dma(dtype=f32)
//   point_f32<Invert>          <- _inversion_kernel via point.py _elementwise
//   point_f32<Threshold>       <- _threshold_kernel via point.py _elementwise
//   grayscale_f32              <- _grayscale
//   window_f32<Body>           <- window.py _windowed_call (dtype=f32)
//     MinRect, MinPlus         <- _make_erosion (body_rect, body_plus)
//     Taps                     <- _make_erosion (body_generic)
//     MinSep                   <- _make_erosion_sep
//     ConvDense<KH, KW>        <- _make_conv
//     ConvSep<N>               <- _make_conv_sep
//     Blur3x3                  <- _make_blur
//   pipeline_f32               <- _make_pipeline (single image and batch=B)
//
// Bound: device-memory bandwidth. Each op reads and writes the whole padded
// buffer once (4 * C * Hp * pitch bytes each way, 197.7 MB in all at
// 3504x2336); the 5x5 convolution's 75 multiplies and 72 adds a position
// are about a third of that time at the FP32 rate.
//
// Rounding: every multiply and add is __fmul_rn / __fadd_rn. nvcc contracts
// a * b + c into one FMA, which rounds once where NumPy, the JAX kernels'
// interpret run and the plain PyTorch versions round twice; the _rn
// intrinsics are never contracted, so each kernel rounds exactly as its
// plain version does and the two are equal bit for bit on the whole buffer.
// The sums run in the JAX kernels' order (f32.py): the luma as
// (wr*R + wg*G) + wb*B; a dense convolution as column sums over ky, added
// over kx; a separable one horizontal first, then vertical, unrounded
// between; the blur vertical first, each pass (q*a + h*b) + q*c.
//
// Design: point_f32 and grayscale_f32 move one float4 (16 bytes) a thread
// over the whole buffer, halo included, since point ops commute with the
// mirror. window_f32 is window_u8's skeleton (csrc/window.cu): one thread
// per output element in the padded coordinates of the input, 0.0f in the
// outer ring of HY rows and HX columns, so every element of the output is
// written; masks travel by value in the body. pipeline_f32 keeps
// pipeline_u8's shared-memory tile: after the threshold every value is 0 or
// 1, so the 3x3 min is an AND of bytes and the 1-2-1 blur is s / 16 with s
// an integer in [0, 16], exact in float32 in any order; only the luma is
// order-sensitive and it is computed as grayscale_f32 computes it.
// Shared-memory tiles for window_f32, TMA and wgmma are later work.
#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// The luma in the JAX kernel's order, each operation rounded once.
__device__ __forceinline__ float luma(float r, float g, float b, float wr,
                                      float wg, float wb) {
  return add(add(mul(wr, r), mul(wg, g)), mul(wb, b));
}

struct Copy {
  __device__ static float apply(float x) { return x; }
};

struct Invert {
  __device__ static float apply(float x) { return __fsub_rn(1.0f, x); }
};

struct Threshold {
  __device__ static float apply(float x) { return x > 0.5f ? 1.0f : 0.0f; }
};

template <class Op>
__global__ void point_f32(const float4* __restrict__ in,
                          float4* __restrict__ out, size_t n4) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 v = in[i];
  v.x = Op::apply(v.x);
  v.y = Op::apply(v.y);
  v.z = Op::apply(v.z);
  v.w = Op::apply(v.w);
  out[i] = v;
}

// in and out are (3, Hp, pitch); plane4 = Hp * pitch / 4. Four lumas from
// the three input planes, stored to all three outputs.
__global__ void grayscale_f32(const float4* __restrict__ in,
                              float4* __restrict__ out, size_t plane4,
                              float wr, float wg, float wb) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane4) return;
  const float4 r = in[i], g = in[i + plane4], b = in[i + 2 * plane4];
  float4 y;
  y.x = luma(r.x, g.x, b.x, wr, wg, wb);
  y.y = luma(r.y, g.y, b.y, wr, wg, wb);
  y.z = luma(r.z, g.z, b.z, wr, wg, wb);
  y.w = luma(r.w, g.w, b.w, wr, wg, wb);
  out[i] = y;
  out[i + plane4] = y;
  out[i + 2 * plane4] = y;
}

struct Plane {
  const float* __restrict__ p;
  int pitch;
  __device__ __forceinline__ float at(int y, int x) const {
    return p[static_cast<size_t>(y) * pitch + x];
  }
};

struct MinRect {  // 3x3 square erosion; min is exact in any order
  static constexpr int HY = 1, HX = 1;
  __device__ float operator()(const Plane& in, int y, int x) const {
    float m = in.at(y, x);
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) m = fminf(m, in.at(y + dy, x + dx));
    return m;
  }
};

struct MinPlus {  // 3x3 cross erosion
  static constexpr int HY = 1, HX = 1;
  __device__ float operator()(const Plane& in, int y, int x) const {
    float m = fminf(in.at(y - 1, x), in.at(y + 1, x));
    m = fminf(m, fminf(in.at(y, x - 1), in.at(y, x + 1)));
    return fminf(m, in.at(y, x));
  }
};

struct MinSep {  // 3x1 column min, then 1x3 min over the column mins
  static constexpr int HY = 1, HX = 1;
  __device__ float operator()(const Plane& in, int y, int x) const {
    float m = 0.0f;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float col = fminf(fminf(in.at(y - 1, x + dx), in.at(y, x + dx)),
                              in.at(y + 1, x + dx));
      m = dx == -1 ? col : fminf(m, col);
    }
    return m;
  }
};

// Erosion by any structuring element of radius <= kMaxTapRadius, by value:
// bit dx + kMaxTapRadius of rows[dy + kMaxTapRadius] is set for each tap
// (dy, dx), visited row by row in ascending dx as body_generic visits them
// (a min is exact in any order). Its ring, the element's largest |dy| and
// |dx|, is known only at run time.
constexpr int kMaxTapRadius = 8;
struct Taps {
  int hy, hx;
  uint32_t rows[2 * kMaxTapRadius + 1];
  __device__ float operator()(const Plane& in, int y, int x) const {
    float m = __int_as_float(0x7f800000);  // +inf
#pragma unroll
    for (int r = 0; r < 2 * kMaxTapRadius + 1; ++r) {
      for (uint32_t b = rows[r]; b != 0; b &= b - 1)
        m = fminf(m, in.at(y + r - kMaxTapRadius,
                           x + __ffs(b) - 1 - kMaxTapRadius));
    }
    return m;
  }
};

// The ring of HY rows and HX columns where a body writes 0: compiled in,
// or for Taps the element's own.
template <class Body>
__device__ int ring_y(const Body&) { return Body::HY; }
template <class Body>
__device__ int ring_x(const Body&) { return Body::HX; }
__device__ int ring_y(const Taps& b) { return b.hy; }
__device__ int ring_x(const Taps& b) { return b.hx; }

// Dense KH x KW correlation with a runtime float mask (row-major): for each
// mask column kx, col = sum over ky ascending of x[ky][kx] * m[ky][kx],
// then acc = sum over kx ascending of col. No rounding to u8.
template <int KH, int KW>
struct ConvDense {
  static constexpr int HY = KH / 2, HX = KW / 2;
  float w[KH * KW];
  __device__ float operator()(const Plane& in, int y, int x) const {
    float acc = 0.0f;
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) {
      float col = mul(in.at(y - HY, x + kx - HX), w[kx]);
#pragma unroll
      for (int ky = 1; ky < KH; ++ky)
        col = add(col, mul(in.at(y + ky - HY, x + kx - HX), w[ky * KW + kx]));
      acc = kx == 0 ? col : add(acc, col);
    }
    return acc;
  }
};

// 1xN pass with the row mask, then Nx1 pass with the column mask over those
// sums, with no rounding between (unlike the uint8 ConvSep). Each thread
// recomputes the N horizontal sums it needs; the baked mirror rows make them
// equal to the mirrored intermediate of the two-pass reference.
template <int N>
struct ConvSep {
  static constexpr int HY = N / 2, HX = N / 2;
  float wr[N];
  float wc[N];
  __device__ float operator()(const Plane& in, int y, int x) const {
    float acc = 0.0f;
#pragma unroll
    for (int ky = 0; ky < N; ++ky) {
      float row = mul(in.at(y + ky - HY, x - HX), wr[0]);
#pragma unroll
      for (int kx = 1; kx < N; ++kx)
        row = add(row, mul(in.at(y + ky - HY, x + kx - HX), wr[kx]));
      const float t = mul(row, wc[ky]);
      acc = ky == 0 ? t : add(acc, t);
    }
    return acc;
  }
};

// 0.25 / 0.5 / 0.25 compiled in: a vertical pass, then a horizontal one,
// each (q * a + h * b) + q * c.
struct Blur3x3 {
  static constexpr int HY = 1, HX = 1;
  __device__ float operator()(const Plane& in, int y, int x) const {
    const float q = 0.25f, h = 0.5f;
    float col[3];
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
      col[dx + 1] = add(add(mul(q, in.at(y - 1, x + dx)),
                            mul(h, in.at(y, x + dx))),
                        mul(q, in.at(y + 1, x + dx)));
    return add(add(mul(q, col[0]), mul(h, col[1])), mul(q, col[2]));
  }
};

// in and out are (C, Hp, pitch); the grid is (pitch / 32, Hp / 8, C).
template <class Body>
__global__ void window_f32(const float* __restrict__ in,
                           float* __restrict__ out, int hp, int pitch,
                           const Body body) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= pitch || y >= hp) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * pitch;
  const Plane src{in + plane, pitch};
  const int hy = ring_y(body), hx = ring_x(body);
  float v = 0.0f;
  if (y >= hy && y < hp - hy && x >= hx && x < pitch - hx)
    v = body(src, y, x);
  out[plane + static_cast<size_t>(y) * pitch + x] = v;
}

template <class Body>
int launch_window(const void* in, void* out, int channels, int hp, int pitch,
                  const Body& body, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((pitch + block.x - 1) / block.x,
                  (hp + block.y - 1) / block.y, channels);
  window_f32<Body><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), hp, pitch,
      body);
  return dip::launch_status();
}

template <int KH, int KW>
int launch_conv_dense(const void* in, void* out, int channels, int hp,
                      int pitch, const float* w, void* stream) {
  ConvDense<KH, KW> body;
  for (int i = 0; i < KH * KW; ++i) body.w[i] = w[i];
  return launch_window(in, out, channels, hp, pitch, body, stream);
}

template <int N>
int launch_conv_sep(const void* in, void* out, int channels, int hp,
                    int pitch, const float* wr, const float* wc,
                    void* stream) {
  ConvSep<N> body;
  for (int i = 0; i < N; ++i) {
    body.wr[i] = wr[i];
    body.wc[i] = wc[i];
  }
  return launch_window(in, out, channels, hp, pitch, body, stream);
}

template <class Op>
int launch_point(const void* in, void* out, size_t n4, void* stream) {
  point_f32<Op><<<dip::blocks_for(n4, dip::kThreads), dip::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(in), static_cast<float4*>(out), n4);
  return dip::launch_status();
}

// The fused pipeline's tile, as in pipeline_u8 (csrc/pipeline.cu).
constexpr int kRing = 2;        // erosion radius 1 + blur radius 1
constexpr int kTileW = 128;     // output columns of a block, a multiple of 4
constexpr int kTileH = 32;      // output rows of a block
constexpr int kBlock = 256;     // threads of a block
// Mask tile: padded rows y0-2 .. y0+kTileH+1 and columns x0-4 ..
// x0+kTileW+3, one byte (0 or 1) a pixel, four to a word, so every global
// load is an aligned float4 of each plane.
constexpr int kMaskH = kTileH + 4;
constexpr int kMaskWords = (kTileW + 8) / 4;
constexpr int kMaskW = 4 * kMaskWords;
// Eroded tile: padded rows y0-1 .. y0+kTileH, columns x0-1 .. x0+kTileW.
constexpr int kEroH = kTileH + 2;
constexpr int kEroW = kTileW + 2;

// Four mask bytes from four R, G and B values: luma > 0.5.
__device__ __forceinline__ uint32_t mask4(float4 r, float4 g, float4 b,
                                          float wr, float wg, float wb) {
  uint32_t m = 0;
  m |= luma(r.x, g.x, b.x, wr, wg, wb) > 0.5f ? 1u : 0u;
  m |= luma(r.y, g.y, b.y, wr, wg, wb) > 0.5f ? 1u << 8 : 0u;
  m |= luma(r.z, g.z, b.z, wr, wg, wb) > 0.5f ? 1u << 16 : 0u;
  m |= luma(r.w, g.w, b.w, wr, wg, wb) > 0.5f ? 1u << 24 : 0u;
  return m;
}

// in and out are (batch, 3, hp, pitch); the grid is
// (ceil(pitch / kTileW), ceil(hp / kTileH), batch).
__global__ void __launch_bounds__(kBlock)
    pipeline_f32(const float* __restrict__ in, float* __restrict__ out,
                 int hp, int pitch, float wr, float wg, float wb) {
  __shared__ uint32_t mask_words[kMaskH][kMaskWords];
  __shared__ uint8_t ero[kEroH][kEroW];

  const size_t plane = static_cast<size_t>(hp) * pitch;
  const size_t image = static_cast<size_t>(blockIdx.z) * 3 * plane;
  const float* src = in + image;
  float* dst = out + image;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;

  // 1. Grayscale and threshold. A group of four outside the buffer gets
  //    mask 0: it only reaches outputs in the ring, which are written 0. A
  //    group that starts inside the buffer ends inside it (pitch % 4 == 0).
  for (int i = threadIdx.x; i < kMaskH * kMaskWords; i += kBlock) {
    const int r = i / kMaskWords, w = i % kMaskWords;
    const int gy = y0 - 2 + r, gx = x0 - 4 + 4 * w;
    uint32_t m = 0;
    if (gy >= 0 && gy < hp && gx >= 0 && gx < pitch) {
      const float* p = src + static_cast<size_t>(gy) * pitch + gx;
      m = mask4(*reinterpret_cast<const float4*>(p),
                *reinterpret_cast<const float4*>(p + plane),
                *reinterpret_cast<const float4*>(p + 2 * plane), wr, wg, wb);
    }
    mask_words[r][w] = m;
  }
  __syncthreads();
  const uint8_t* mask = reinterpret_cast<const uint8_t*>(mask_words);

  // 2. Erosion: the min of 0/1 values is their AND. Eroded (r, e) is padded
  //    pixel (y0 - 1 + r, x0 - 1 + e); its taps are mask rows r .. r + 2
  //    and mask columns e + 2 .. e + 4.
  for (int i = threadIdx.x; i < kEroH * kEroW; i += kBlock) {
    const int r = i / kEroW, e = i % kEroW;
    uint32_t v = 1u;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 2; dx < 5; ++dx) v &= mask[(r + dy) * kMaskW + e + dx];
    ero[r][e] = static_cast<uint8_t>(v);
  }
  __syncthreads();

  // 3. Blur. Output (s, t .. t + 3) is padded row y0 + s, columns
  //    x0 + t .. x0 + t + 3; its taps are eroded rows s .. s + 2 and eroded
  //    columns t .. t + 5. The 1-2-1 x 1-2-1 sum of 0/1 values is an
  //    integer in [0, 16]; times 1/16 it is the float blur, exactly.
  for (int i = threadIdx.x; i < kTileH * (kTileW / 4); i += kBlock) {
    const int s = i / (kTileW / 4), t = 4 * (i % (kTileW / 4));
    const int gy = y0 + s, gx = x0 + t;
    if (gy >= hp || gx >= pitch) continue;
    int col[6];
#pragma unroll
    for (int c = 0; c < 6; ++c)
      col[c] = ero[s][t + c] + 2 * ero[s + 1][t + c] + ero[s + 2][t + c];
    const bool row_in = gy >= kRing && gy < hp - kRing;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = gx + k;
      v[k] = 0.0f;
      if (row_in && x >= kRing && x < pitch - kRing)
        v[k] = static_cast<float>(col[k] + 2 * col[k + 1] + col[k + 2]) *
               0.0625f;
    }
    const float4 word = make_float4(v[0], v[1], v[2], v[3]);
    float* q = dst + static_cast<size_t>(gy) * pitch + gx;
    *reinterpret_cast<float4*>(q) = word;
    *reinterpret_cast<float4*>(q + plane) = word;
    *reinterpret_cast<float4*>(q + 2 * plane) = word;
  }
}

}  // namespace

// Point ops: in and out hold n4 float4 vectors (the whole buffer).
DIP_API int dip_copy_f32(const void* in, void* out, size_t n4, void* stream) {
  return launch_point<Copy>(in, out, n4, stream);
}

DIP_API int dip_inversion_f32(const void* in, void* out, size_t n4,
                              void* stream) {
  return launch_point<Invert>(in, out, n4, stream);
}

DIP_API int dip_threshold_f32(const void* in, void* out, size_t n4,
                              void* stream) {
  return launch_point<Threshold>(in, out, n4, stream);
}

// in and out are (3, Hp, pitch); plane4 = Hp * pitch / 4.
DIP_API int dip_grayscale_f32(const void* in, void* out, size_t plane4,
                              float wr, float wg, float wb, void* stream) {
  grayscale_f32<<<dip::blocks_for(plane4, dip::kThreads), dip::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(in), static_cast<float4*>(out), plane4, wr,
      wg, wb);
  return dip::launch_status();
}

DIP_API int dip_erosion_rect_f32(const void* in, void* out, int channels,
                                 int hp, int pitch, void* stream) {
  return launch_window(in, out, channels, hp, pitch, MinRect{}, stream);
}

DIP_API int dip_erosion_plus_f32(const void* in, void* out, int channels,
                                 int hp, int pitch, void* stream) {
  return launch_window(in, out, channels, hp, pitch, MinPlus{}, stream);
}

DIP_API int dip_erosion_sep_f32(const void* in, void* out, int channels,
                                int hp, int pitch, void* stream) {
  return launch_window(in, out, channels, hp, pitch, MinSep{}, stream);
}

DIP_API int dip_blur3x3_f32(const void* in, void* out, int channels, int hp,
                            int pitch, void* stream) {
  return launch_window(in, out, channels, hp, pitch, Blur3x3{}, stream);
}

// Any structuring element: rows holds 2 * 8 + 1 row bitmasks (Taps), hy and
// hx its largest |dy| and |dx|.
DIP_API int dip_erosion_taps_f32(const void* in, void* out, int channels,
                                 int hp, int pitch, int hy, int hx,
                                 const unsigned* rows, void* stream) {
  if (hy < 0 || hy > kMaxTapRadius || hx < 0 || hx > kMaxTapRadius)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps body;
  body.hy = hy;
  body.hx = hx;
  for (int r = 0; r < 2 * kMaxTapRadius + 1; ++r) body.rows[r] = rows[r];
  return launch_window(in, out, channels, hp, pitch, body, stream);
}

// kh x kw is 3x3 or 5x5; w holds kh * kw float weights in row-major order.
DIP_API int dip_conv_dense_f32(const void* in, void* out, int channels,
                               int hp, int pitch, int kh, int kw,
                               const float* w, void* stream) {
  if (kh == 3 && kw == 3)
    return launch_conv_dense<3, 3>(in, out, channels, hp, pitch, w, stream);
  if (kh == 5 && kw == 5)
    return launch_conv_dense<5, 5>(in, out, channels, hp, pitch, w, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// n in {3, 5}; wr is the 1xN row mask, wc the Nx1 column mask, as floats.
DIP_API int dip_conv_sep_f32(const void* in, void* out, int channels, int hp,
                             int pitch, int n, const float* wr,
                             const float* wc, void* stream) {
  if (n == 3)
    return launch_conv_sep<3>(in, out, channels, hp, pitch, wr, wc, stream);
  if (n == 5)
    return launch_conv_sep<5>(in, out, channels, hp, pitch, wr, wc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// in and out are (batch, 3, hp, pitch) float32, pitch a multiple of 4
// elements and both base addresses 16-byte aligned; wr, wg, wb are the
// luma weights.
DIP_API int dip_pipeline_f32(const void* in, void* out, int batch, int hp,
                             int pitch, float wr, float wg, float wb,
                             void* stream) {
  if (batch < 1 || batch > 65535 || hp < 1 || pitch < 4 || pitch % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((pitch + kTileW - 1) / kTileW, (hp + kTileH - 1) / kTileH,
                  batch);
  pipeline_f32<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), hp, pitch, wr,
      wg, wb);
  return dip::launch_status();
}
