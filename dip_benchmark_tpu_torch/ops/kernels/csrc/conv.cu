// Convolutions of every mask shape the JAX package builds, in both data
// models: a dense kh x kw correlation and a two-pass one (a row pass, then
// a column pass), 1 to 17 taps a side, the mask's size and weights given at
// run time. The strip bodies of window.cu and f32.cu keep the 3x3 and 5x5
// masks (N 3 and 5) that they compile in; these kernels take every other
// shape, and the uint8 masks whose int32 sums can wrap.
//
// Replaces (dip_benchmark_tpu/ops/pallas/):
//   conv_tile_dense_u8     <- window.py make_convolution (body_packed,
//                             body_i32; any acc_dtype)
//   conv_tile_two_pass_u8  <- window.py make_convolution (body_rank1:
//                             unrounded between the passes) and
//                             make_convolution_separated_fused (body_packed,
//                             body_i32: rounded to u8 between them)
//   conv_tile_dense_f32    <- f32.py _make_conv
//   conv_tile_sep_f32      <- f32.py _make_conv_sep
//
// The anchor is (kh / 2, kw / 2), as the JAX kernels place it, so an even
// side reaches one tap further up (left) than down (right). The output has
// the input's (C, Hp, pitch) shape and every element is written: the
// correlation wherever all its taps lie in the buffer, 0 in the outer kh / 2
// rows and kw / 2 columns on each side.
//
// Arithmetic. uint8: the JAX kernels' int32 sums wrap on overflow, so every
// sum here runs in uint32 (two's complement: the same bits); then
// (acc + half) >> shift, arithmetic, and a clamp to [0, 255] where the JAX
// quantizer clamps (a negative weight, or a sum that can round past 255:
// the host's `clamp` flags), else the low byte, as astype(uint8) takes it.
// Between the two passes of K9 the same rounding, the clamp by the row
// mask's flag, the value kept whole where it does not clamp. float32: every
// multiply and add is __fmul_rn / __fadd_rn (never contracted into an FMA),
// each sum in the JAX order: dense, for each kx the column sum over ky
// ascending, then those sums over kx ascending; separable, the row pass
// over kx, then the column pass over ky. A sum starts from -0.0f, the
// identity of IEEE addition (x + -0 == x for every x, the sign of 0
// included), so it equals the JAX sum that starts from its first term.
// The plain versions in ops/window.py and ops/f32.py compute the same, and
// on the card the two are equal bit for bit.
//
// Design: one block of 256 threads a tile of 32 output rows by 64 columns.
// The block loads the tile's frame, its rows and columns with a halo of 8
// on each side whatever the mask (48 x 80 values), into shared memory as
// int (uint8 widened) or float, 16 bytes a store; the weights go to shared
// memory too, each row of the mask padded to 20 and placed at the tap
// offset d = kx - kw / 2 + 8, so that a thread's loop over d in [0, 17) is
// unrolled and reads its registers at constant indices. A thread owns 4
// adjacent outputs of a row: for each mask row it reads the 20 frame values
// they need (five 16-byte loads) and the weight row (five more), then does
// 4 kw multiply-adds; the d outside the mask are skipped by a branch that
// is the same in every thread. The float32 dense kernel keeps one column
// sum for each d of its 4 outputs in registers until the mask's last row,
// to keep the JAX order. The two-pass kernels run the row pass over the
// frame rows the column pass reads into a second shared array, then the
// column pass.
//
// Bound: for large masks, the multiply-adds (kh kw an output: a 17x17 mask
// is 289 IMAD in uint8, 289 FMUL and 288 FADD in float32); for small ones
// the compulsory traffic, the buffer read once and written once. What the
// kernel spends beyond it: the frame's halo (48 x 80 loads for 32 x 64
// outputs, from L2 mostly), two shared-memory loads of 16 bytes a mask row
// for 4 outputs, the skipped d. A first version: making it fast is later
// work (PERF.md).
#include "common.cuh"
#include "words.cuh"

namespace {

constexpr int kMaxSide = 17;                 // taps a side of a mask
constexpr int kHalo = kMaxSide / 2;          // the frame's halo, 8
constexpr int kTileRows = 32;
constexpr int kTileCols = 64;
constexpr int kConvThreads = 256;
constexpr int kFrameRows = kTileRows + 2 * kHalo;   // 48
constexpr int kFrameCols = kTileCols + 2 * kHalo;   // 80
constexpr int kSeg = 4 + 2 * kHalo;  // frame values 4 outputs read: 20
constexpr int kGroups = kTileCols / 4;              // 4 outputs a group
constexpr int kRowStep = kConvThreads / kGroups;    // 16
constexpr int kMaxGridZ = 65535;                    // gridDim.z
static_assert(kTileRows % kRowStep == 0, "every thread has whole rows");
static_assert(kSeg % 4 == 0, "a segment is whole 16-byte loads");

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

template <class T>
struct Vec4;
template <>
struct Vec4<int> {
  using type = int4;
};
template <>
struct Vec4<float> {
  using type = float4;
};

// n values (a multiple of 4) from shared memory at p, 16-byte aligned.
template <class T, int N>
__device__ __forceinline__ void load_vec(const T* p, T (&s)[N]) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const auto v = *reinterpret_cast<const typename Vec4<T>::type*>(p + 4 * k);
    s[4 * k] = v.x, s[4 * k + 1] = v.y, s[4 * k + 2] = v.z,
    s[4 * k + 3] = v.w;
  }
}

// Where the block's tile lies: output rows y0 .., columns x0 .., plane z.
struct Tile {
  int y0, x0;
  size_t plane;
};

__device__ __forceinline__ Tile block_tile(int hp, int pitch, int row0) {
  return {row0 + static_cast<int>(blockIdx.y) * kTileRows,
          static_cast<int>(blockIdx.x) * kTileCols,
          static_cast<size_t>(blockIdx.z) * hp * pitch};
}

// The frame: frame[r][c] is the plane at row y0 - kHalo + r, column
// x0 - kHalo + c, 0 outside the plane. x0 - kHalo is a multiple of 4 and
// the pitch one of 4 (uint8: 16), so each load of 4 values lies wholly
// inside a row or wholly outside.
__device__ __forceinline__ void load_frame(const uint8_t* __restrict__ in,
                                           int hp, int pitch, const Tile& t,
                                           int* frame) {
  constexpr int kLoads = kFrameCols / 4;
  for (int i = threadIdx.x; i < kFrameRows * kLoads; i += kConvThreads) {
    const int r = i / kLoads, c = 4 * (i % kLoads);
    const int y = t.y0 - kHalo + r, x = t.x0 - kHalo + c;
    uint32_t w = 0;
    if (y >= 0 && y < hp && x >= 0 && x < pitch)
      w = *reinterpret_cast<const uint32_t*>(
          in + t.plane + static_cast<size_t>(y) * pitch + x);
    *reinterpret_cast<int4*>(frame + r * kFrameCols + c) =
        make_int4(w & 255u, (w >> 8) & 255u, (w >> 16) & 255u, w >> 24);
  }
}

__device__ __forceinline__ void load_frame(const float* __restrict__ in,
                                           int hp, int pitch, const Tile& t,
                                           float* frame) {
  constexpr int kLoads = kFrameCols / 4;
  for (int i = threadIdx.x; i < kFrameRows * kLoads; i += kConvThreads) {
    const int r = i / kLoads, c = 4 * (i % kLoads);
    const int y = t.y0 - kHalo + r, x = t.x0 - kHalo + c;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (y >= 0 && y < hp && x >= 0 && x < pitch)
      v = *reinterpret_cast<const float4*>(
          in + t.plane + static_cast<size_t>(y) * pitch + x);
    *reinterpret_cast<float4*>(frame + r * kFrameCols + c) = v;
  }
}

// The mask's rows into ws, each padded to kSeg and placed at the tap
// offset d = kx - kw / 2 + kHalo, zero elsewhere.
template <class T>
__device__ __forceinline__ void put_weights(const T* w, int kh, int kw,
                                            T* ws) {
  for (int i = threadIdx.x; i < kh * kSeg; i += kConvThreads) {
    const int ky = i / kSeg, kx = i % kSeg - kHalo + kw / 2;
    ws[i] = kx >= 0 && kx < kw ? w[ky * kw + kx] : T(0);
  }
}

// (acc + half) >> shift as the JAX quantizer rounds an int32 sum: clamped
// to [0, 255] where clamp is set, else kept whole.
__device__ __forceinline__ int quantize(uint32_t acc, uint32_t half,
                                        int shift, bool clamp) {
  const int v = static_cast<int>(acc + half) >> shift;
  return clamp ? min(max(v, 0), 255) : v;
}

// Whether output row y, column x is outside the zero ring.
struct Ring {
  int hp, pitch, hy, hx;
  __device__ __forceinline__ bool row_in(int y) const {
    return y >= hy && y < hp - hy;
  }
  __device__ __forceinline__ bool col_in(int x) const {
    return x >= hx && x < pitch - hx;
  }
};

// Four outputs of row y from column x on: their low bytes, 0 in the ring.
__device__ __forceinline__ void store_u8(uint8_t* __restrict__ out,
                                         const Tile& t, const Ring& g, int y,
                                         int x, const int (&v)[4]) {
  if (y >= g.hp || x >= g.pitch) return;
  uint32_t word = 0;
  if (g.row_in(y)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (g.col_in(x + j)) word |= (static_cast<uint32_t>(v[j]) & 255u)
                                   << (8 * j);
  }
  *reinterpret_cast<uint32_t*>(out + t.plane +
                               static_cast<size_t>(y) * g.pitch + x) = word;
}

__device__ __forceinline__ void store_f32(float* __restrict__ out,
                                          const Tile& t, const Ring& g, int y,
                                          int x, const float (&v)[4]) {
  if (y >= g.hp || x >= g.pitch) return;
  const bool row = g.row_in(y);
  const float4 o = make_float4(row && g.col_in(x) ? v[0] : 0.0f,
                               row && g.col_in(x + 1) ? v[1] : 0.0f,
                               row && g.col_in(x + 2) ? v[2] : 0.0f,
                               row && g.col_in(x + 3) ? v[3] : 0.0f);
  *reinterpret_cast<float4*>(out + t.plane +
                             static_cast<size_t>(y) * g.pitch + x) = o;
}

// -- the kernels' arguments, by value -----------------------------------------

struct DenseU8 {
  int kh, kw, shift, clamp;
  int w[kMaxSide * kMaxSide];  // row-major
};

// The mask outer(u, v) as two passes: v (kw taps) along the rows, then u
// (kh taps) down the columns.
struct TwoPassU8 {
  int kh, kw, shift, round_between, clamp_rows, clamp_out;
  int u[kMaxSide], v[kMaxSide];
};

struct DenseF32 {
  int kh, kw;
  float w[kMaxSide * kMaxSide];  // row-major
};

struct SepF32 {
  int n;
  float wr[kMaxSide], wc[kMaxSide];
};

// -- dense ------------------------------------------------------------------

__global__ void __launch_bounds__(kConvThreads)
    conv_tile_dense_u8(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int hp, int pitch, int row0,
                       const __grid_constant__ DenseU8 a) {
  __shared__ __align__(16) int frame[kFrameRows * kFrameCols];
  __shared__ __align__(16) int ws[kMaxSide * kSeg];
  const Tile t = block_tile(hp, pitch, row0);
  const Ring g{hp, pitch, a.kh / 2, a.kw / 2};
  put_weights(a.w, a.kh, a.kw, ws);
  load_frame(in, hp, pitch, t, frame);
  __syncthreads();
  const int col = 4 * (threadIdx.x % kGroups);
  const int d0 = kHalo - g.hx, d1 = d0 + a.kw;
  const uint32_t half = static_cast<uint32_t>(dip::half_of(a.shift));
  for (int o = threadIdx.x / kGroups; o < kTileRows; o += kRowStep) {
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    for (int ky = 0; ky < a.kh; ++ky) {
      int s[kSeg], w[kSeg];
      load_vec(frame + (o + kHalo - g.hy + ky) * kFrameCols + col, s);
      load_vec(ws + ky * kSeg, w);
#pragma unroll
      for (int d = 0; d < kMaxSide; ++d) {
        if (d < d0 || d >= d1) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] += static_cast<uint32_t>(w[d]) *
                    static_cast<uint32_t>(s[j + d]);
      }
    }
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = quantize(acc[j], half, a.shift, a.clamp);
    store_u8(out, t, g, t.y0 + o, t.x0 + col, v);
  }
}

__global__ void __launch_bounds__(kConvThreads)
    conv_tile_dense_f32(const float* __restrict__ in, float* __restrict__ out,
                        int hp, int pitch, int row0,
                        const __grid_constant__ DenseF32 a) {
  __shared__ __align__(16) float frame[kFrameRows * kFrameCols];
  __shared__ __align__(16) float ws[kMaxSide * kSeg];
  const Tile t = block_tile(hp, pitch, row0);
  const Ring g{hp, pitch, a.kh / 2, a.kw / 2};
  put_weights(a.w, a.kh, a.kw, ws);
  load_frame(in, hp, pitch, t, frame);
  __syncthreads();
  const int col = 4 * (threadIdx.x % kGroups);
  const int d0 = kHalo - g.hx, d1 = d0 + a.kw;
  for (int o = threadIdx.x / kGroups; o < kTileRows; o += kRowStep) {
    float colsum[kMaxSide][4];
#pragma unroll
    for (int d = 0; d < kMaxSide; ++d)
#pragma unroll
      for (int j = 0; j < 4; ++j) colsum[d][j] = -0.0f;
    for (int ky = 0; ky < a.kh; ++ky) {
      float s[kSeg], w[kSeg];
      load_vec(frame + (o + kHalo - g.hy + ky) * kFrameCols + col, s);
      load_vec(ws + ky * kSeg, w);
#pragma unroll
      for (int d = 0; d < kMaxSide; ++d) {
        if (d < d0 || d >= d1) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          colsum[d][j] = add(colsum[d][j], mul(s[j + d], w[d]));
      }
    }
    float v[4] = {-0.0f, -0.0f, -0.0f, -0.0f};
#pragma unroll
    for (int d = 0; d < kMaxSide; ++d) {
      if (d < d0 || d >= d1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = add(v[j], colsum[d][j]);
    }
    store_f32(out, t, g, t.y0 + o, t.x0 + col, v);
  }
}

// -- two passes -------------------------------------------------------------

__global__ void __launch_bounds__(kConvThreads)
    conv_tile_two_pass_u8(const uint8_t* __restrict__ in,
                          uint8_t* __restrict__ out, int hp, int pitch,
                          int row0, const __grid_constant__ TwoPassU8 a) {
  __shared__ __align__(16) int frame[kFrameRows * kFrameCols];
  __shared__ __align__(16) int rows[kFrameRows * kTileCols];
  __shared__ __align__(16) int vs[kSeg];
  __shared__ int us[kMaxSide];
  const Tile t = block_tile(hp, pitch, row0);
  const Ring g{hp, pitch, a.kh / 2, a.kw / 2};
  put_weights(a.v, 1, a.kw, vs);
  if (threadIdx.x < a.kh) us[threadIdx.x] = a.u[threadIdx.x];
  load_frame(in, hp, pitch, t, frame);
  __syncthreads();
  const int d0 = kHalo - g.hx, d1 = d0 + a.kw;
  const uint32_t half = static_cast<uint32_t>(dip::half_of(a.shift));
  // The row pass over the frame rows the column pass reads.
  const int r0 = kHalo - g.hy, r1 = kHalo + kTileRows + g.hy;
  int w[kSeg];
  load_vec(vs, w);
  for (int i = threadIdx.x; i < (r1 - r0) * kGroups; i += kConvThreads) {
    const int r = r0 + i / kGroups, col = 4 * (i % kGroups);
    int s[kSeg];
    load_vec(frame + r * kFrameCols + col, s);
    uint32_t p[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int d = 0; d < kMaxSide; ++d) {
      if (d < d0 || d >= d1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[j] += static_cast<uint32_t>(w[d]) * static_cast<uint32_t>(s[j + d]);
    }
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = a.round_between ? quantize(p[j], half, a.shift, a.clamp_rows)
                             : static_cast<int>(p[j]);
    *reinterpret_cast<int4*>(rows + r * kTileCols + col) =
        make_int4(q[0], q[1], q[2], q[3]);
  }
  __syncthreads();
  const int col = 4 * (threadIdx.x % kGroups);
  for (int o = threadIdx.x / kGroups; o < kTileRows; o += kRowStep) {
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    for (int ky = 0; ky < a.kh; ++ky) {
      const int4 m = *reinterpret_cast<const int4*>(
          rows + (o + kHalo - g.hy + ky) * kTileCols + col);
      const uint32_t u = static_cast<uint32_t>(us[ky]);
      acc[0] += u * static_cast<uint32_t>(m.x);
      acc[1] += u * static_cast<uint32_t>(m.y);
      acc[2] += u * static_cast<uint32_t>(m.z);
      acc[3] += u * static_cast<uint32_t>(m.w);
    }
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = quantize(acc[j], half, a.shift, a.clamp_out);
    store_u8(out, t, g, t.y0 + o, t.x0 + col, v);
  }
}

__global__ void __launch_bounds__(kConvThreads)
    conv_tile_sep_f32(const float* __restrict__ in, float* __restrict__ out,
                      int hp, int pitch, int row0,
                      const __grid_constant__ SepF32 a) {
  __shared__ __align__(16) float frame[kFrameRows * kFrameCols];
  __shared__ __align__(16) float rows[kFrameRows * kTileCols];
  __shared__ __align__(16) float vs[kSeg];
  __shared__ float us[kMaxSide];
  const Tile t = block_tile(hp, pitch, row0);
  const Ring g{hp, pitch, a.n / 2, a.n / 2};
  put_weights(a.wr, 1, a.n, vs);
  if (threadIdx.x < a.n) us[threadIdx.x] = a.wc[threadIdx.x];
  load_frame(in, hp, pitch, t, frame);
  __syncthreads();
  const int d0 = kHalo - g.hx, d1 = d0 + a.n;
  const int r0 = kHalo - g.hy, r1 = kHalo + kTileRows + g.hy;
  float w[kSeg];
  load_vec(vs, w);
  for (int i = threadIdx.x; i < (r1 - r0) * kGroups; i += kConvThreads) {
    const int r = r0 + i / kGroups, col = 4 * (i % kGroups);
    float s[kSeg];
    load_vec(frame + r * kFrameCols + col, s);
    float p[4] = {-0.0f, -0.0f, -0.0f, -0.0f};
#pragma unroll
    for (int d = 0; d < kMaxSide; ++d) {
      if (d < d0 || d >= d1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = add(p[j], mul(s[j + d], w[d]));
    }
    *reinterpret_cast<float4*>(rows + r * kTileCols + col) =
        make_float4(p[0], p[1], p[2], p[3]);
  }
  __syncthreads();
  const int col = 4 * (threadIdx.x % kGroups);
  for (int o = threadIdx.x / kGroups; o < kTileRows; o += kRowStep) {
    float v[4] = {-0.0f, -0.0f, -0.0f, -0.0f};
    for (int ky = 0; ky < a.n; ++ky) {
      const float4 m = *reinterpret_cast<const float4*>(
          rows + (o + kHalo - g.hy + ky) * kTileCols + col);
      const float u = us[ky];
      v[0] = add(v[0], mul(m.x, u));
      v[1] = add(v[1], mul(m.y, u));
      v[2] = add(v[2], mul(m.z, u));
      v[3] = add(v[3], mul(m.w, u));
    }
    store_f32(out, t, g, t.y0 + o, t.x0 + col, v);
  }
}

// -- launch -----------------------------------------------------------------

// The columns of tiles of a buffer (gridDim.x), or 0 for one the tiles
// cannot cover: a pitch the 16-byte frame loads do not take (uint8: a
// multiple of 16 bytes; float32: of 4 floats), or more planes than
// gridDim.z holds. Its rows of tiles go on gridDim.y in runs of at most
// 65,535 (dip::launch_row_runs), so any height is covered.
unsigned int tile_cols(int channels, int hp, int pitch, int align) {
  if (channels < 1 || channels > kMaxGridZ || hp < 1 || pitch < align ||
      pitch % align != 0)
    return 0;
  return (pitch + kTileCols - 1) / kTileCols;
}

bool side_ok(int n) { return n >= 1 && n <= kMaxSide; }

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Dense kh x kw correlation, w the kh * kw weights row-major; clamp as the
// JAX quantizer clamps (see the top of this file).
DIP_API int dip_conv_tile_dense_u8(const void* in, void* out, int channels,
                                   int hp, int pitch, int kh, int kw,
                                   const int* w, int shift, int clamp,
                                   void* stream) {
  const unsigned int gx = tile_cols(channels, hp, pitch, 16);
  if (!side_ok(kh) || !side_ok(kw) || shift < 0 || shift > 31 || gx == 0)
    return kInvalid;
  DenseU8 a{kh, kw, shift, clamp != 0, {}};
  for (int i = 0; i < kh * kw; ++i) a.w[i] = w[i];
  return dip::launch_row_runs(hp, kTileRows, [&](unsigned int gy, int row0) {
    conv_tile_dense_u8<<<dim3(gx, gy, channels), kConvThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), hp, pitch,
        row0, a);
  });
}

// The correlation with outer(u, v): a row pass with v (kw taps), rounded
// between the passes where round_between is set (clamped by clamp_rows),
// then a column pass with u (kh taps), rounded and clamped by clamp_out.
DIP_API int dip_conv_tile_two_pass_u8(const void* in, void* out, int channels,
                                      int hp, int pitch, int kh, int kw,
                                      const int* u, const int* v, int shift,
                                      int round_between, int clamp_rows,
                                      int clamp_out, void* stream) {
  const unsigned int gx = tile_cols(channels, hp, pitch, 16);
  if (!side_ok(kh) || !side_ok(kw) || shift < 0 || shift > 31 || gx == 0)
    return kInvalid;
  TwoPassU8 a{kh, kw, shift, round_between != 0, clamp_rows != 0,
              clamp_out != 0, {}, {}};
  for (int i = 0; i < kh; ++i) a.u[i] = u[i];
  for (int i = 0; i < kw; ++i) a.v[i] = v[i];
  return dip::launch_row_runs(hp, kTileRows, [&](unsigned int gy, int row0) {
    conv_tile_two_pass_u8<<<dim3(gx, gy, channels), kConvThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), hp, pitch,
        row0, a);
  });
}

// Dense kh x kw correlation with the float weights w, row-major.
DIP_API int dip_conv_tile_dense_f32(const void* in, void* out, int channels,
                                    int hp, int pitch, int kh, int kw,
                                    const float* w, void* stream) {
  const unsigned int gx = tile_cols(channels, hp, pitch, 4);
  if (!side_ok(kh) || !side_ok(kw) || gx == 0) return kInvalid;
  DenseF32 a{kh, kw, {}};
  for (int i = 0; i < kh * kw; ++i) a.w[i] = w[i];
  return dip::launch_row_runs(hp, kTileRows, [&](unsigned int gy, int row0) {
    conv_tile_dense_f32<<<dim3(gx, gy, channels), kConvThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(in), static_cast<float*>(out), hp, pitch,
        row0, a);
  });
}

// 1xN pass with wr, then Nx1 pass with wc, unrounded between.
DIP_API int dip_conv_tile_sep_f32(const void* in, void* out, int channels,
                                  int hp, int pitch, int n, const float* wr,
                                  const float* wc, void* stream) {
  const unsigned int gx = tile_cols(channels, hp, pitch, 4);
  if (!side_ok(n) || gx == 0) return kInvalid;
  SepF32 a{n, {}, {}};
  for (int i = 0; i < n; ++i) {
    a.wr[i] = wr[i];
    a.wc[i] = wc[i];
  }
  return dip::launch_row_runs(hp, kTileRows, [&](unsigned int gy, int row0) {
    conv_tile_sep_f32<<<dim3(gx, gy, channels), kConvThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(in), static_cast<float*>(out), hp, pitch,
        row0, a);
  });
}
