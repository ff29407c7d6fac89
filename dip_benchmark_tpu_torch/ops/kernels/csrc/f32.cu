// Kernels of the float32 data model (planar (C, Hp, pitch) float32 in
// [0, 1], the same mirror-padded layout as the uint8 model): the point ops,
// the luma, the windowed ops and the fused pipeline.
//
// Replaces (dip_benchmark_tpu/ops/pallas/f32.py):
//   point_f32<Copy>            <- point.py _copy_dma(dtype=f32)
//   point_f32<Invert>          <- _inversion_kernel via point.py _elementwise
//   point_f32<Threshold>       <- _threshold_kernel via point.py _elementwise
//   grayscale_f32              <- _grayscale
//   window_f32_strip<Body>     <- window.py _windowed_call (dtype=f32)
//     MinRect, MinPlus         <- _make_erosion (body_rect, body_plus)
//     MinSep                   <- _make_erosion_sep
//     ConvDense<KH, KW>        <- _make_conv
//     ConvSep<N>               <- _make_conv_sep
//     Blur3x3                  <- _make_blur
//   window_taps<F32Min>        <- _make_erosion (body_generic), taps.cuh
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
// mirror. Every 3x3 and 5x5 window body (the convolutions, the blur and the
// 3x3 min bodies) runs on window_f32_strip: a thread owns one float4 of a
// row and walks a strip of rows, loading each input row once, 16 bytes a
// lane, a few rows ahead, the HX floats on each side from the neighbouring
// lanes by shuffle, 0.0f in the outer ring of HY rows and HX columns, so
// every element of the output is written. Each op streams the buffer once,
// so its time is set by the loads it issues and keeps in flight: the first
// skeleton, one thread an output with a 4-byte load a tap, issued nine loads
// an output of a 3x3 window where the strip issues a quarter of one and
// loads no row twice. A body keeps a register ring of the last rows: raw
// rows where every tap has its own weight (ConvDense, Blur3x3 vertical
// first, MinPlus), per-row partials where a row pass comes first (ConvSep,
// 2N operations an output instead of 2N^2; MinRect and MinSep, the
// horizontal 3-min). The bodies keep the JAX order of every sum, so no
// rank-1 shortcut applies to ConvDense: that would change the float result;
// fminf over values in [0, 1] is exact in any order, so the square erosion
// and the separated one are the same function and share a body. Any other
// structuring element runs the program of taps.cuh (horizontal run tables,
// then a vertical pass, over a tile of floats in shared memory; launches
// counted as window_f32<Taps<Min>>). benchmarks/h100/chain_lab.py times the
// strip settings and counts the SASS an output. pipeline_f32 keeps
// pipeline_u8's shared-memory tile: after the threshold every value is 0 or
// 1, so the 3x3 min is an AND of bytes and the 1-2-1 blur is s / 16 with s
// an integer in [0, 16], exact in float32 in any order; only the luma is
// order-sensitive and it is computed as grayscale_f32 computes it.
#include "common.cuh"
#include "taps.cuh"

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

// -- window_f32_strip: every window body --------------------------------------
//
// A thread owns kF32Vecs float4 of a row and walks a strip of kF32StripRows
// output rows: each input row is loaded once per strip, 16 bytes a lane,
// kF32PrefetchRows rows before its use; the HX <= 2 floats on either side
// come from the neighbouring lanes by warp shuffle, and the warp's edge
// lanes load those two floats themselves. A body keeps the last 2 HY + 1
// rows (raw, or reduced to per-row partials) in a register ring that the
// unrolled walk renames. The settings are the fastest on the H100 that
// benchmarks/h100/chain_lab.py timed.
constexpr int kF32StripRows = 4;
constexpr int kF32PrefetchRows = 4;
constexpr int kF32Vecs = 1;
constexpr int kF32StripThreads = 128;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kSpan = 4 * kF32Vecs;  // output floats of a thread's row

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Bodies: HY, HX; a Row made by row(x) from the thread's view of an input
// row, x[0 .. kSpan + 2 HX): its own floats at x[HX ..] and HX floats on
// either side; out(ring, o), the kSpan outputs of the row whose 2 HY + 1
// input rows are ring[0] (topmost) .. ring[2 HY].

// Dense KH x KW correlation with a runtime float mask (row-major), vertical
// first as _make_conv sums: for each mask column kx, col = the sum over ky
// ascending of x[ky][kx] * m[ky][kx]; then acc = the sum over kx ascending
// of col. The ring holds raw rows: each tap has its own weight, so no
// partial is shared between outputs. No rounding to u8.
template <int KH, int KW>
struct ConvDense {
  static constexpr int HY = KH / 2, HX = KW / 2;
  float w[KH * KW];
  struct Row {
    float f[kSpan + 2 * HX];
  };
  __device__ __forceinline__ Row row(const float (&x)[kSpan + 2 * HX]) const {
    Row r;
#pragma unroll
    for (int c = 0; c < kSpan + 2 * HX; ++c) r.f[c] = x[c];
    return r;
  }
  __device__ __forceinline__ void out(const Row (&ring)[KH],
                                      float (&o)[kSpan]) const {
#pragma unroll
    for (int i = 0; i < kSpan; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int kx = 0; kx < KW; ++kx) {
        float col = mul(ring[0].f[i + kx], w[kx]);
#pragma unroll
        for (int ky = 1; ky < KH; ++ky)
          col = add(col, mul(ring[ky].f[i + kx], w[ky * KW + kx]));
        acc = kx == 0 ? col : add(acc, col);
      }
      o[i] = acc;
    }
  }
};

// 1xN pass with the row mask, then Nx1 pass with the column mask over
// those sums, unrounded between (unlike the uint8 ConvSep), horizontal
// first as _make_conv_sep sums: the ring holds each input row's N-tap
// partials, made once. The baked mirror rows make them equal to the
// mirrored intermediate of the two-pass reference.
template <int N>
struct ConvSep {
  static constexpr int HY = N / 2, HX = N / 2;
  float wr[N], wc[N];
  struct Row {
    float p[kSpan];
  };
  __device__ __forceinline__ Row row(const float (&x)[kSpan + 2 * HX]) const {
    Row r;
#pragma unroll
    for (int i = 0; i < kSpan; ++i) {
      float acc = mul(x[i], wr[0]);
#pragma unroll
      for (int kx = 1; kx < N; ++kx) acc = add(acc, mul(x[i + kx], wr[kx]));
      r.p[i] = acc;
    }
    return r;
  }
  __device__ __forceinline__ void out(const Row (&ring)[N],
                                      float (&o)[kSpan]) const {
#pragma unroll
    for (int i = 0; i < kSpan; ++i) {
      float acc = mul(ring[0].p[i], wc[0]);
#pragma unroll
      for (int ky = 1; ky < N; ++ky) acc = add(acc, mul(ring[ky].p[i], wc[ky]));
      o[i] = acc;
    }
  }
};

// The ring of a 3x3 body that reads its taps from the raw rows.
struct RawRows3 {
  static constexpr int HY = 1, HX = 1;
  struct Row {
    float f[kSpan + 2];
  };
  __device__ __forceinline__ Row row(const float (&x)[kSpan + 2]) const {
    Row r;
#pragma unroll
    for (int c = 0; c < kSpan + 2; ++c) r.f[c] = x[c];
    return r;
  }
};

// 0.25 / 0.5 / 0.25 compiled in, the ring of ConvDense<3, 3>: a vertical
// pass per column over the three raw rows, then a horizontal pass, each
// (q * a + h * b) + q * c, as _make_blur sums.
struct Blur3x3 : RawRows3 {
  __device__ __forceinline__ void out(const Row (&ring)[3],
                                      float (&o)[kSpan]) const {
    const float q = 0.25f, h = 0.5f;
    float col[kSpan + 2];
#pragma unroll
    for (int c = 0; c < kSpan + 2; ++c)
      col[c] = add(add(mul(q, ring[0].f[c]), mul(h, ring[1].f[c])),
                   mul(q, ring[2].f[c]));
#pragma unroll
    for (int i = 0; i < kSpan; ++i)
      o[i] = add(add(mul(q, col[i]), mul(h, col[i + 1])), mul(q, col[i + 2]));
  }
};

// The 3x3 square erosion, as ConvSep<3> with fminf for the sums: the
// ring holds each input row's horizontal 3-min, made once, and an output
// is the min of three ring entries. fminf over values in [0, 1] is exact
// in any order, so this is also the 3x1 then 1x3 min of _make_erosion_sep.
struct MinRect {
  static constexpr int HY = 1, HX = 1;
  struct Row {
    float m[kSpan];
  };
  __device__ __forceinline__ Row row(const float (&x)[kSpan + 2]) const {
    Row r;
#pragma unroll
    for (int i = 0; i < kSpan; ++i)
      r.m[i] = fminf(fminf(x[i], x[i + 1]), x[i + 2]);
    return r;
  }
  __device__ __forceinline__ void out(const Row (&ring)[3],
                                      float (&o)[kSpan]) const {
#pragma unroll
    for (int i = 0; i < kSpan; ++i)
      o[i] = fminf(fminf(ring[0].m[i], ring[1].m[i]), ring[2].m[i]);
  }
};

// The same body under its own name, so that the device trace tells the
// separated erosion's launches from the square one's.
struct MinSep : MinRect {};

// The 3x3 cross erosion, on raw rows as Blur3x3: the centre row's three
// taps and the centre tap of the rows above and below.
struct MinPlus : RawRows3 {
  __device__ __forceinline__ void out(const Row (&ring)[3],
                                      float (&o)[kSpan]) const {
#pragma unroll
    for (int i = 0; i < kSpan; ++i)
      o[i] = fminf(fminf(fminf(ring[1].f[i], ring[1].f[i + 1]),
                         ring[1].f[i + 2]),
                   fminf(ring[0].f[i + 1], ring[2].f[i + 1]));
  }
};

// One input row as a thread loads it: its float4s, and for the warp's edge
// lanes the two floats beyond the warp's span.
struct RowLoad4 {
  float4 own[kF32Vecs];
  float2 edge;
};

// Row y of the plane (pitch floats a row): the float4s from float4 column
// at, and on an edge lane the two floats from float column beyond. A lane
// past the row's end loads the row's last float4s, and an edge lane at the
// row's ends its own; what they load reaches only the zero ring's columns.
// kChecked strips load nothing for a row outside [0, hp), and give zeros.
template <bool kChecked>
__device__ __forceinline__ RowLoad4 fetch_row4(const float* __restrict__ plane,
                                               int y, int hp, int pitch,
                                               int at, int beyond,
                                               bool edge_lane) {
  RowLoad4 r;
  if (kChecked && (y < 0 || y >= hp)) {
#pragma unroll
    for (int i = 0; i < kF32Vecs; ++i) r.own[i] = make_float4(0, 0, 0, 0);
    r.edge = make_float2(0, 0);
    return r;
  }
  const float* row = plane + static_cast<size_t>(y) * pitch;
#pragma unroll
  for (int i = 0; i < kF32Vecs; ++i)
    r.own[i] = reinterpret_cast<const float4*>(row)[at + i];
  r.edge = edge_lane ? *reinterpret_cast<const float2*>(row + beyond)
                     : make_float2(0, 0);
  return r;
}

// The loaded row as the thread's view x (see the bodies): the HX floats on
// either side from the adjacent lanes, the edge lanes' from their own
// load. Every lane of the warp calls this.
template <int HX>
__device__ __forceinline__ void spread_row4(const RowLoad4& r, int lane,
                                            float (&x)[kSpan + 2 * HX]) {
#pragma unroll
  for (int i = 0; i < kF32Vecs; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[HX + 4 * i + c] = lane_of(r.own[i], c);
  const float4& first = r.own[0];
  const float4& last = r.own[kF32Vecs - 1];
  const float l1 = __shfl_up_sync(kFullWarp, last.w, 1);
  const float r1 = __shfl_down_sync(kFullWarp, first.x, 1);
  x[HX - 1] = lane == 0 ? r.edge.y : l1;
  x[HX + kSpan] = lane == 31 ? r.edge.x : r1;
  if constexpr (HX == 2) {
    const float l2 = __shfl_up_sync(kFullWarp, last.z, 1);
    const float r2 = __shfl_down_sync(kFullWarp, first.y, 1);
    x[0] = lane == 0 ? r.edge.x : l2;
    x[kSpan + 3] = lane == 31 ? r.edge.y : r2;
  }
}

// One strip: output rows [y0, y0 + kF32StripRows) of the thread's columns,
// from input rows [y0 - HY, y0 + kF32StripRows + HY), each loaded once and
// kF32PrefetchRows rows ahead of its use. An interior strip (kChecked
// false) reads and writes only rows inside the plane and no row of the
// zero ring; the others check.
template <class Body, bool kChecked>
__device__ __forceinline__ void strip_walk4(const Body& body,
                                            const float* __restrict__ src,
                                            float* __restrict__ dst, int hp,
                                            int pitch, int v0, int lane,
                                            int y0) {
  constexpr int HY = Body::HY, HX = Body::HX;
  constexpr int K = 2 * HY + 1, R = kF32StripRows + 2 * HY;
  constexpr int D = kF32PrefetchRows < R ? kF32PrefetchRows : R;
  using Row = typename Body::Row;
  const int vecs = pitch >> 2;
  const bool live = v0 < vecs;
  const int at = live ? v0 : vecs - kF32Vecs;
  const bool edge_lane = lane == 0 || lane == 31;
  const int beyond =
      min(max(lane == 0 ? 4 * at - 2 : 4 * (at + kF32Vecs), 0), pitch - 2);
  // The zero ring's columns: the first HX floats of a row, the last HX.
  bool keep[kSpan];
#pragma unroll
  for (int c = 0; c < kSpan; ++c)
    keep[c] = 4 * v0 + c >= HX && 4 * v0 + c < pitch - HX;

  RowLoad4 q[R];
#pragma unroll
  for (int i = 0; i < D; ++i)
    q[i] = fetch_row4<kChecked>(src, y0 - HY + i, hp, pitch, at, beyond,
                                edge_lane);
  Row ring[K];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i + D < R)
      q[i + D] = fetch_row4<kChecked>(src, y0 - HY + i + D, hp, pitch, at,
                                      beyond, edge_lane);
    float x[kSpan + 2 * HX];
    spread_row4<HX>(q[i], lane, x);
    ring[i < K - 1 ? i : K - 1] = body.row(x);
    if (i < K - 1) continue;
    const int y = y0 + i - (K - 1);
    float o[kSpan];
    body.out(ring, o);
    const bool ring_row = kChecked && (y < HY || y >= hp - HY);
#pragma unroll
    for (int c = 0; c < kSpan; ++c) o[c] = ring_row || !keep[c] ? 0.0f : o[c];
    if (live && (!kChecked || y < hp)) {
      float4* p = reinterpret_cast<float4*>(dst + static_cast<size_t>(y) *
                                                      pitch) + v0;
#pragma unroll
      for (int i = 0; i < kF32Vecs; ++i)
        p[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
    }
#pragma unroll
    for (int r = 0; r < K - 1; ++r) ring[r] = ring[r + 1];
  }
}

// in and out are (C, Hp, pitch), pitch a multiple of 4 kF32Vecs; the grid
// is (pitch / (4 kF32Vecs kF32StripThreads), Hp / kF32StripRows, C),
// rounded up, in runs of at most 65,535 strips from row row0.
template <class Body>
__global__ void __launch_bounds__(kF32StripThreads)
    window_f32_strip(const float* __restrict__ in, float* __restrict__ out,
                     int hp, int pitch, int row0, const Body body) {
  static_assert(Body::HX >= 1 && Body::HX <= 2,
                "the neighbour lanes give 1 or 2 floats a side");
  const int lane = threadIdx.x & 31;
  const int v0 = (blockIdx.x * kF32StripThreads + threadIdx.x) * kF32Vecs;
  const int y0 = row0 + blockIdx.y * kF32StripRows;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * pitch;
  if (y0 >= Body::HY && y0 + kF32StripRows + Body::HY <= hp)
    strip_walk4<Body, false>(body, in + plane, out + plane, hp, pitch, v0,
                             lane, y0);
  else
    strip_walk4<Body, true>(body, in + plane, out + plane, hp, pitch, v0,
                            lane, y0);
}

template <class Body>
int launch_strip(const void* in, void* out, int channels, int hp, int pitch,
                 const Body& body, void* stream) {
  if (pitch % kSpan != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kF32StripThreads * kF32Vecs;
  const unsigned int gx = (pitch / 4 + per_block - 1) / per_block;
  return dip::launch_row_runs(
      hp, kF32StripRows, [&](unsigned int gy, int row0) {
        window_f32_strip<Body><<<dim3(gx, gy, channels), kF32StripThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(in), static_cast<float*>(out), hp,
            pitch, row0, body);
      });
}

template <int KH, int KW>
int launch_conv_dense(const void* in, void* out, int channels, int hp,
                      int pitch, const float* w, void* stream) {
  ConvDense<KH, KW> body;
  for (int i = 0; i < KH * KW; ++i) body.w[i] = w[i];
  return launch_strip(in, out, channels, hp, pitch, body, stream);
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
  return launch_strip(in, out, channels, hp, pitch, body, stream);
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
// (ceil(pitch / kTileW), ceil(hp / kTileH), batch), in runs of at most
// 65,535 tile rows from row row0.
__global__ void __launch_bounds__(kBlock)
    pipeline_f32(const float* __restrict__ in, float* __restrict__ out,
                 int hp, int pitch, int row0, float wr, float wg, float wb) {
  __shared__ uint32_t mask_words[kMaskH][kMaskWords];
  __shared__ uint8_t ero[kEroH][kEroW];

  const size_t plane = static_cast<size_t>(hp) * pitch;
  const size_t image = static_cast<size_t>(blockIdx.z) * 3 * plane;
  const float* src = in + image;
  float* dst = out + image;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = row0 + blockIdx.y * kTileH;

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
  return launch_strip(in, out, channels, hp, pitch, MinRect{}, stream);
}

DIP_API int dip_erosion_plus_f32(const void* in, void* out, int channels,
                                 int hp, int pitch, void* stream) {
  return launch_strip(in, out, channels, hp, pitch, MinPlus{}, stream);
}

DIP_API int dip_erosion_sep_f32(const void* in, void* out, int channels,
                                int hp, int pitch, void* stream) {
  return launch_strip(in, out, channels, hp, pitch, MinSep{}, stream);
}

DIP_API int dip_blur3x3_f32(const void* in, void* out, int channels, int hp,
                            int pitch, void* stream) {
  return launch_strip(in, out, channels, hp, pitch, Blur3x3{}, stream);
}

// Any structuring element: program holds the n int32 words of its program
// (ops/window.py TapsProgram.encode), parsed and checked in taps.cuh.
DIP_API int dip_erosion_taps_f32(const void* in, void* out, int channels,
                                 int hp, int pitch, const int* program, int n,
                                 void* stream) {
  return dip::taps::launch<dip::taps::F32Min>(in, out, channels, hp, pitch,
                                              program, n, stream);
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
  const unsigned int gx = (pitch + kTileW - 1) / kTileW;
  return dip::launch_row_runs(hp, kTileH, [&](unsigned int gy, int row0) {
    pipeline_f32<<<dim3(gx, gy, batch), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(in), static_cast<float*>(out), hp, pitch,
        row0, wr, wg, wb);
  });
}
