// Convolutions of every mask shape the JAX package builds, in both data
// models: a dense kh x kw correlation and a two-pass one (a row pass, then
// a column pass), 1 to 17 taps a side, the mask's size and weights given at
// run time. The strip bodies of window.cu and f32.cu keep the 3x3 and 5x5
// masks (N 3 and 5) that they compile in; these kernels take every other
// shape, and the uint8 masks whose int32 sums can wrap.
//
// Replaces (dip_benchmark_tpu/ops/pallas/):
//   conv_tile_dense_u8,    <- window.py make_convolution (body_packed,
//   conv_tile_dense_mma_u8    body_i32; any acc_dtype): the mma body for
//                             masks whose weights fit int8, the other for
//                             the rest
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
// Design of the two-pass kernels: one block of 256 threads a tile of 32
// output rows by 64 columns. The block loads the tile's frame, its rows and
// columns with a halo of 8 on each side whatever the mask (48 x 80 values),
// into shared memory as int (uint8 widened) or float, 16 bytes a store; the
// weights go to shared memory too, each row of the mask padded to 20 and
// placed at the tap offset d = kx - kw / 2 + 8, so that a thread's loop
// over d in [0, 17) is unrolled and reads its registers at constant
// indices. A thread owns 4 adjacent outputs of a row; the d outside the
// mask are skipped by a branch that is the same in every thread. The
// two-pass kernels run the row pass over the frame rows the column pass
// reads into a second shared array, then the column pass.
//
// Design of the dense kernels: a block a tile of 64 x 64 outputs; its
// frame holds only the rows the mask reaches (64 + kh - 1), anchored so
// that output row o reads frame row o + ky. Each kernel is compiled for
// every mask height (the IMAD body: width), so its tap loops are unrolled
// over the mask's taps only, with no branch a tap; each thread owns a
// register block, so that one value read from shared memory feeds many
// products.
// - conv_tile_dense_f32: a thread walks 16 rows of one column; for each
//   mask column kx (outer) it reads its 16 + kh - 1 frame values once and
//   takes the 16 column sums over ky (inner), then adds them to its 16
//   totals: one column sum and one total live an output (the JAX order,
//   no column sums held across kx), 31 to 64 registers. Bound: FP32
//   issue, kh kw FMUL and kh kw - 1 FADD an output (at 17x17 every issue
//   slot but the 49 shared loads of 561 instructions a column step is
//   one); for a 1xN mask the bytes, where the 17 scalar shared loads an
//   output and the frame's load before the block computes stand between
//   it and the copy floor.
// - conv_tile_dense_u8 (IMAD, any int32 weights): a thread owns one word
//   of 4 outputs in each of 4 rows; the frame is bytes, shifted on load
//   so that output column c and tap kx read frame byte c + kx, so a mask
//   row's taps are the bytes of up to 5 words (one PRMT a byte) at
//   constant register indices. Bound: IMAD issue, kh kw an output at 64 a
//   clock an SM, half the issue rate, so the loads and byte extractions
//   fit in the other half at large masks.
// - conv_tile_dense_mma_u8 (weights in [-128, 127]): the int8 tensor
//   cores (mma.sync m16n8k32, A the mask row's banded Toeplitz matrix in
//   registers for the whole kernel, B four bytes of a frame row a
//   register; see the kernel). A warp reads each frame row it needs once
//   (two 32-bit shared loads a lane) for up to 4 products. Resident
//   blocks take tile after tile with a ring of 3 frames filled by
//   cp.async, and store each tile's staged outputs in whole sectors.
//   Bound: the bytes, the buffer read once and written once; the
//   products are 4096 multiply-adds an instruction, so what is left is
//   each tile's fixed work (its copies, barrier, quantizer and stores)
//   against few warps an SM, and at tall masks kh mma.sync a warp's
//   block of 8 rows.
//
// Bound of the two-pass kernels: for large masks, the multiply-adds; for
// small ones the compulsory traffic, the buffer read once and written
// once. What they spend beyond it: the frame's halo (48 x 80 loads for 32 x
// 64 outputs, from L2 mostly), two shared-memory loads of 16 bytes a mask
// row for 4 outputs, the skipped d. A first version: making them fast is
// later work (PERF.md).
#include <cuda_pipeline.h>

#include <atomic>
#include <climits>

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
//
// A block takes a tile of kDenseRows x kDenseCols outputs. Its frame holds
// the plane rows the tile's taps reach, anchored at the mask: frame row fr is
// plane row y0 - hy + fr (kDenseRows + kh - 1 rows are loaded), so that
// output row o reads frame row o + ky for mask row ky. Each kernel is
// compiled for every mask height (the IMAD body: width), so its tap loops
// are unrolled over the mask's taps only, and the host picks the one of
// the mask (kernel_for).

constexpr int kDenseRows = 64;
constexpr int kDenseCols = 64;
static_assert(kDenseCols == kTileCols, "tile_cols counts dense tiles too");

// The instantiation Of<n>::get() for a side n of 1..kMaxSide (host).
template <template <int> class Of, int N = 1>
auto kernel_for(int n) -> decltype(Of<1>::get()) {
  if constexpr (N == kMaxSide)
    return Of<N>::get();
  else
    return n == N ? Of<N>::get() : kernel_for<Of, N + 1>(n);
}

// A resident block's walk over the tiles first, first + step, ...: the
// plane z and the tile's row and column of tiles (tiles_y x tiles_x a
// plane), advanced without a division.
struct TileWalk {
  int tile, z, ty, tx, dz, dy, dx, tiles_x, tiles_y;
  __device__ TileWalk(int tiles_x_, int tiles_y_, int first, int step)
      : tiles_x(tiles_x_), tiles_y(tiles_y_) {
    const int per_plane = tiles_x * tiles_y;
    tile = first;
    z = first / per_plane;
    ty = (first - z * per_plane) / tiles_x;
    tx = first - z * per_plane - ty * tiles_x;
    dz = step / per_plane;
    dy = (step - dz * per_plane) / tiles_x;
    dx = step - dz * per_plane - dy * tiles_x;
  }
  __device__ void next(int step) {
    tile += step;
    tx += dx;
    ty += dy + (tx >= tiles_x);
    tx -= tx >= tiles_x ? tiles_x : 0;
    z += dz + (ty >= tiles_y);
    ty -= ty >= tiles_y ? tiles_y : 0;
  }
};

// uint8, IMAD: a thread owns one 32-bit word (4 outputs) of kU8Run rows.
// The frame is bytes, shifted on load so that frame column fc is plane
// column x0 - hx + fc: output column c and tap kx read frame byte c + kx,
// so a mask row's taps are the bytes of 5 frame words at constant register
// indices, whatever hx is.
constexpr int kU8Run = 4;
constexpr int kU8Words = (kDenseCols + kMaxSide - 1 + 3) / 4;   // 20 a row
static_assert(kConvThreads == (kDenseCols / 4) * (kDenseRows / kU8Run),
              "a thread a word of kU8Run rows");

template <int KW>
__global__ void __launch_bounds__(kConvThreads)
    conv_tile_dense_u8(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int hp, int pitch, int row0,
                       const __grid_constant__ DenseU8 a) {
  constexpr int kSeg = (KW + 6) / 4;   // the words of 4 + KW - 1 bytes
  constexpr int kBytes = KW + 3;
  constexpr int kLoads =               // frame words a thread loads, at most
      ((kDenseRows + kMaxSide - 1) * kU8Words + kConvThreads - 1) /
      kConvThreads;
  __shared__ uint32_t frame[(kDenseRows + kMaxSide - 1) * kU8Words];
  __shared__ int ws[kMaxSide * KW];
  constexpr int hx = KW / 2;
  const int hy = a.kh / 2;
  const int y0 = row0 + static_cast<int>(blockIdx.y) * kDenseRows;
  const int x0 = static_cast<int>(blockIdx.x) * kDenseCols;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * pitch;
  for (int i = threadIdx.x; i < a.kh * KW; i += kConvThreads) ws[i] = a.w[i];
  // Frame word k of a row: plane bytes x0 - hx + 4k .. + 3, which lie sh
  // bytes into an aligned word; each aligned word lies wholly inside or
  // outside the row (the pitch is a multiple of 16). A thread issues all
  // its loads before its first store, so that their latencies overlap.
  constexpr int sh = -hx & 3;
  const int n_frame = (kDenseRows + a.kh - 1) * kU8Words;
  uint32_t lo[kLoads], hi[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kConvThreads;
    const int y = y0 - hy + i / kU8Words;
    const int xa = x0 - hx + 4 * (i % kU8Words) - sh;
    lo[k] = hi[k] = 0u;
    if (i < n_frame && y >= 0 && y < hp) {
      const uint8_t* row = in + plane + static_cast<size_t>(y) * pitch;
      if (xa >= 0 && xa < pitch)
        lo[k] = *reinterpret_cast<const uint32_t*>(row + xa);
      if (sh != 0 && xa + 4 >= 0 && xa + 4 < pitch)
        hi[k] = *reinterpret_cast<const uint32_t*>(row + xa + 4);
    }
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kConvThreads;
    if (i < n_frame) frame[i] = __funnelshift_r(lo[k], hi[k], 8 * sh);
  }
  __syncthreads();
  const int tc = threadIdx.x % (kDenseCols / 4);
  const int o0 = threadIdx.x / (kDenseCols / 4) * kU8Run;
  uint32_t acc[kU8Run][4] = {};
  for (int ky = 0; ky < a.kh; ++ky) {
    int w[KW];
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) w[kx] = ws[ky * KW + kx];
#pragma unroll
    for (int r = 0; r < kU8Run; ++r) {
      const uint32_t* src = frame + (o0 + r + ky) * kU8Words + tc;
      uint32_t seg[kSeg], b[kBytes];
#pragma unroll
      for (int k = 0; k < kSeg; ++k) seg[k] = src[k];
#pragma unroll
      for (int i = 0; i < kBytes; ++i)
        b[i] = __byte_perm(seg[i / 4], 0u, 0x4440 | (i % 4));
#pragma unroll
      for (int kx = 0; kx < KW; ++kx)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][j] += static_cast<uint32_t>(w[kx]) * b[j + kx];
    }
  }
  const int x = x0 + 4 * tc;
  if (x >= pitch) return;
  const Ring g{hp, pitch, hy, hx};
  const uint32_t half = static_cast<uint32_t>(dip::half_of(a.shift));
#pragma unroll
  for (int r = 0; r < kU8Run; ++r) {
    const int y = y0 + o0 + r;
    if (y >= hp) break;
    uint32_t word = 0u;
    if (g.row_in(y)) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (g.col_in(x + j))
          word |= (static_cast<uint32_t>(
                       quantize(acc[r][j], half, a.shift, a.clamp)) &
                   255u)
                  << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(out + plane +
                                 static_cast<size_t>(y) * pitch + x) = word;
  }
}

using DenseU8Kernel = void (*)(const uint8_t*, uint8_t*, int, int, int,
                               const DenseU8);
template <int N>
struct DenseU8Of {
  static DenseU8Kernel get() { return conv_tile_dense_u8<N>; }
};

// uint8, int8 tensor cores, for masks whose weights all lie in
// [-128, 127]: mma.sync m16n8k32 with A the mask row's band, B the frame.
// For mask row ky, a product takes 16 output columns m of 8 output rows n:
//   D[m][n] += sum over k < 32 of A[m][k] * B[k][n],
//   A[m][k] = w[ky][k - m - 8 + hx] (0 off the mask: a banded Toeplitz
//   matrix, kw of its 32 columns nonzero a row),
//   B[k][n] = the frame byte of row n + ky, 8 columns left of the 16
//   outputs plus k: one aligned 32-bit word a register.
// A warp owns 16 columns of kMmaWarpRows rows (kMmaBlocks products a mask
// row); lane (g, t) reads frame row g + s once for every s and feeds it to
// each block i with ky = s - 8 i. A's registers hold every mask row's band
// for the whole kernel: the host packs each row's 4-byte windows
// (window.mma_windows), a lane takes the four it needs. Blocks are
// resident (grid = SMs x blocks an SM) and take tile after tile, the next
// kMmaStages - 1 tiles' frames arriving by cp.async while one computes.
// The block stages a tile's outputs in shared memory (two buffers) and
// stores them after the next tile's barrier, a 64-byte row for 4 threads:
// whole sectors (16-byte stores of a lane each to its own row took 13 us
// more at 1x17 on the H100). Masks of up to 9 rows hold few enough
// registers for 3 blocks an SM, and the kernel is latency-bound there.
constexpr int kMmaWarpRows = 32;
constexpr int kMmaBlocks = kMmaWarpRows / 8;
constexpr int kMmaStride = 112;   // frame row bytes (96 used), bank-spread
constexpr int kMmaChunks = 6;     // 16-byte copies a frame row: x0 - 16 ..
constexpr int kWindows = 44;      // 4-byte windows of a mask row's band
constexpr int kMmaStages = 3;     // frames a block holds: 2 ahead
constexpr int kMmaOutStride = 80;  // staged output row bytes (64 used)
static_assert(kConvThreads / 32 ==
                  (kDenseCols / 16) * (kDenseRows / kMmaWarpRows),
              "eight warps of 16 columns x kMmaWarpRows rows");

struct DenseMmaU8 {
  int kh, kw, shift, clamp, tiles_x, tiles_y, n_tiles;
  // win[ky * kWindows + e]: bytes b = 0..3 of w[ky][e - 23 + hx + b], 0
  // off the row; lane (g, t) takes e = 4t + 16 (j / 2) - g - 8 (j % 2) + 15
  // for its register j of A.
  uint32_t win[kMaxSide * kWindows];
};

// Start copying the frame of the walk's tile into buf (16 bytes a copy, 0
// outside the plane), or nothing past the last tile; one commit either way.
template <int KH>
__device__ __forceinline__ void mma_prefetch(const uint8_t* __restrict__ in,
                                             int hp, int pitch,
                                             const DenseMmaU8& a,
                                             const TileWalk& t,
                                             uint8_t* buf) {
  if (t.tile < a.n_tiles) {
    const uint8_t* src = in + static_cast<size_t>(t.z) * hp * pitch;
    const int y0 = t.ty * kDenseRows - KH / 2, x0 = t.tx * kDenseCols - 16;
    for (int i = threadIdx.x; i < (kDenseRows + KH - 1) * kMmaChunks;
         i += kConvThreads) {
      const int fr = i / kMmaChunks, q = i % kMmaChunks;
      const int y = y0 + fr, x = x0 + 16 * q;
      const bool ok = y >= 0 && y < hp && x >= 0 && x < pitch;
      __pipeline_memcpy_async(
          buf + fr * kMmaStride + 16 * q,
          ok ? src + static_cast<size_t>(y) * pitch + x : in, 16,
          ok ? 0 : 16);
    }
  }
  __pipeline_commit();
}

// The staged outputs of tile t (none for t.tile < 0) to the plane, 16
// bytes a thread: a row of the tile is 4 threads, 64 bytes, whole sectors.
__device__ __forceinline__ void store_staged(uint8_t* __restrict__ out,
                                             int hp, int pitch,
                                             const TileWalk& t,
                                             const uint8_t* staged) {
  const int row = threadIdx.x / 4, c16 = 16 * (threadIdx.x % 4);
  const int y = t.ty * kDenseRows + row, x = t.tx * kDenseCols + c16;
  if (t.tile >= 0 && y < hp && x < pitch)
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(t.z) * hp * pitch +
                              static_cast<size_t>(y) * pitch + x) =
        *reinterpret_cast<const uint4*>(staged + row * kMmaOutStride + c16);
}

__device__ __forceinline__ void mma_s8u8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KH>
__global__ void __launch_bounds__(kConvThreads, KH <= 9 ? 3 : 2)
    conv_tile_dense_mma_u8(const uint8_t* __restrict__ in,
                           uint8_t* __restrict__ out, int hp, int pitch,
                           const __grid_constant__ DenseMmaU8 a) {
  constexpr int kFrameBytes = (kDenseRows + KH - 1) * kMmaStride;
  __shared__ __align__(16) uint8_t frame[kMmaStages][kFrameBytes];
  __shared__ __align__(16) uint8_t staged[2][kDenseRows * kMmaOutStride];
  __shared__ uint32_t win[KH * kWindows];
  const int grid = static_cast<int>(gridDim.x);
  TileWalk walk(a.tiles_x, a.tiles_y, static_cast<int>(blockIdx.x), grid);
  TileWalk ahead = walk;
#pragma unroll
  for (int k = 0; k < kMmaStages - 1; ++k) {
    mma_prefetch<KH>(in, hp, pitch, a, ahead, frame[k]);
    ahead.next(grid);
  }
  for (int i = threadIdx.x; i < KH * kWindows; i += kConvThreads)
    win[i] = a.win[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc = warp % (kDenseCols / 16), wr = warp / (kDenseCols / 16);
  uint32_t band[KH][4];
#pragma unroll
  for (int ky = 0; ky < KH; ++ky)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      band[ky][j] =
          win[ky * kWindows + 4 * t4 + 16 * (j >> 1) - g - 8 * (j & 1) + 15];
  constexpr int hy = KH / 2;
  const int hx = a.kw / 2;
  const uint32_t half = static_cast<uint32_t>(dip::half_of(a.shift));
  // The tile before, whose outputs wait in staged[odd ^ 1]; tile -1 none.
  TileWalk prev = walk;
  prev.tile = -1;
  int odd = 0;
  for (int stage = 0; walk.tile < a.n_tiles;
       prev = walk, walk.next(grid), stage = (stage + 1) % kMmaStages,
           odd ^= 1) {
    __pipeline_wait_prior(kMmaStages - 2);
    // Every warp is past the previous tile: its outputs are staged, and its
    // frame takes the tile kMmaStages - 1 on.
    __syncthreads();
    store_staged(out, hp, pitch, prev, staged[odd ^ 1]);
    mma_prefetch<KH>(in, hp, pitch, a, ahead,
                     frame[(stage + kMmaStages - 1) % kMmaStages]);
    ahead.next(grid);
    const uint8_t* fb = frame[stage] +
                        (kMmaWarpRows * wr + g) * kMmaStride + 16 * wc + 8 +
                        4 * t4;
    int acc[kMmaBlocks][4] = {};
#pragma unroll
    for (int s = 0; s < 8 * (kMmaBlocks - 1) + KH; ++s) {
      if (KH < 8 && s % 8 >= KH) continue;   // no block reads row s
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(fb + s * kMmaStride);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(fb + s * kMmaStride + 16);
#pragma unroll
      for (int i = 0; i < kMmaBlocks; ++i) {
        const int ky = s - 8 * i;
        if (ky >= 0 && ky < KH) mma_s8u8(acc[i], band[ky], b0, b1);
      }
    }
    // acc[i][e] is output row 8 i + 2 t + e % 2, column g + 8 (e / 2) of
    // the warp's 32 x 16, staged at row r0 + that, column c0 + that.
    const int r0 = kMmaWarpRows * wr, c0 = 16 * wc;
    const int y0 = walk.ty * kDenseRows + r0, x0 = walk.tx * kDenseCols + c0;
    uint8_t* mine = staged[odd] + r0 * kMmaOutStride + c0;
    if (y0 >= hy && y0 + kMmaWarpRows <= hp - hy && x0 >= hx &&
        x0 + 16 <= pitch - hx) {   // no output of the warp in the ring
#pragma unroll
      for (int i = 0; i < kMmaBlocks; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(8 * i + 2 * t4 + (e & 1)) * kMmaOutStride + g +
               8 * (e >> 1)] =
              static_cast<uint8_t>(quantize(static_cast<uint32_t>(acc[i][e]),
                                            half, a.shift, a.clamp));
    } else {
      const Ring ring{hp, pitch, hy, hx};
#pragma unroll
      for (int i = 0; i < kMmaBlocks; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * i + 2 * t4 + (e & 1), col = g + 8 * (e >> 1);
          mine[row * kMmaOutStride + col] =
              ring.row_in(y0 + row) && ring.col_in(x0 + col)
                  ? static_cast<uint8_t>(quantize(
                        static_cast<uint32_t>(acc[i][e]), half, a.shift,
                        a.clamp))
                  : 0;
        }
    }
  }
  __syncthreads();
  store_staged(out, hp, pitch, prev, staged[odd ^ 1]);
  __pipeline_wait_prior(0);
}

using DenseMmaKernel = void (*)(const uint8_t*, uint8_t*, int, int,
                                const DenseMmaU8);
template <int N>
struct DenseMmaOf {
  static DenseMmaKernel get() { return conv_tile_dense_mma_u8<N>; }
};

// float32: a thread walks kF32Run rows down one column. For each mask
// column kx (outer), it reads the kF32Run + KH - 1 frame values of its
// column at kx once into registers and takes the column sums of its rows
// over ky (inner), then adds them to its totals: one column sum and one
// total live an output, the JAX order kept. The frame is the plane from
// column x0 - 8, every 16-byte copy in flight at once (cp.async); the
// weights lie column by column.
constexpr int kF32Run = 16;
constexpr int kF32FrameCols = kDenseCols + 2 * kHalo;   // 80
static_assert(kConvThreads == kDenseCols * (kDenseRows / kF32Run),
              "a thread a column of kF32Run rows");

template <int KH>
__global__ void __launch_bounds__(kConvThreads)
    conv_tile_dense_f32(const float* __restrict__ in, float* __restrict__ out,
                        int hp, int pitch, int row0,
                        const __grid_constant__ DenseF32 a) {
  constexpr int kRows = kDenseRows + KH - 1;
  __shared__ __align__(16) float frame[kRows * kF32FrameCols];
  __shared__ float ws[kMaxSide * KH];   // ws[kx * KH + ky]
  constexpr int hy = KH / 2;
  const int hx = a.kw / 2;
  const int y0 = row0 + static_cast<int>(blockIdx.y) * kDenseRows;
  const int x0 = static_cast<int>(blockIdx.x) * kDenseCols;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * pitch;
  constexpr int kLoads = kF32FrameCols / 4;
  for (int i = threadIdx.x; i < kRows * kLoads; i += kConvThreads) {
    const int c = 4 * (i % kLoads);
    const int y = y0 - hy + i / kLoads, x = x0 - kHalo + c;
    const bool ok = y >= 0 && y < hp && x >= 0 && x < pitch;
    __pipeline_memcpy_async(
        frame + i / kLoads * kF32FrameCols + c,
        ok ? in + plane + static_cast<size_t>(y) * pitch + x : in, 16,
        ok ? 0 : 16);
  }
  __pipeline_commit();
  for (int i = threadIdx.x; i < KH * a.kw; i += kConvThreads)
    ws[i % a.kw * KH + i / a.kw] = a.w[i];
  __pipeline_wait_prior(0);
  __syncthreads();
  const int c = threadIdx.x % kDenseCols;
  const int o0 = threadIdx.x / kDenseCols * kF32Run;
  const float* col = frame + o0 * kF32FrameCols + c + kHalo - hx;
  float total[kF32Run];
#pragma unroll
  for (int r = 0; r < kF32Run; ++r) total[r] = -0.0f;
  for (int kx = 0; kx < a.kw; ++kx, ++col) {
    const float* wk = ws + kx * KH;
    float v[kF32Run + KH - 1];
#pragma unroll
    for (int j = 0; j < kF32Run + KH - 1; ++j) v[j] = col[j * kF32FrameCols];
    // The column sum starts from its first product: -0.0f + p == p.
    float sum[kF32Run];
#pragma unroll
    for (int ky = 0; ky < KH; ++ky) {
      const float w = wk[ky];
#pragma unroll
      for (int r = 0; r < kF32Run; ++r)
        sum[r] = ky == 0 ? mul(v[r], w) : add(sum[r], mul(v[r + ky], w));
    }
#pragma unroll
    for (int r = 0; r < kF32Run; ++r) total[r] = add(total[r], sum[r]);
  }
  const int x = x0 + c;
  if (x >= pitch) return;
  const Ring g{hp, pitch, hy, hx};
  const bool col_in = g.col_in(x);
#pragma unroll
  for (int r = 0; r < kF32Run; ++r) {
    const int y = y0 + o0 + r;
    if (y >= hp) break;
    out[plane + static_cast<size_t>(y) * pitch + x] =
        col_in && g.row_in(y) ? total[r] : 0.0f;
  }
}

using DenseF32Kernel = void (*)(const float*, float*, int, int, int,
                                const DenseF32);
template <int N>
struct DenseF32Of {
  static DenseF32Kernel get() { return conv_tile_dense_f32<N>; }
};

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

// The blocks of the mma body of mask height kh resident on the current
// device at once (SMs x blocks an SM), into *grid; asked of the runtime
// once per device and height, then read from a table.
cudaError_t mma_grid(int kh, int* grid) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices][kMaxSide + 1];
  int device, sms, per_sm;
  if (const cudaError_t e = cudaGetDevice(&device)) return e;
  std::atomic<int>* slot = device < kDevices ? &known[device][kh] : nullptr;
  if (slot && (*grid = slot->load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  if (const cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device))
    return e;
  if (const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel_for<DenseMmaOf>(kh), kConvThreads, 0))
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  if (slot) slot->store(*grid, std::memory_order_relaxed);
  return cudaSuccess;
}

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
  const DenseU8Kernel kernel = kernel_for<DenseU8Of>(kw);
  return dip::launch_row_runs(hp, kDenseRows, [&](unsigned int gy, int row0) {
    kernel<<<dim3(gx, gy, channels), kConvThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), hp, pitch,
        row0, a);
  });
}

// The same correlation on the int8 tensor cores, for a mask whose weights
// all lie in [-128, 127]; win holds its rows' windows (DenseMmaU8::win, kh
// * kWindows words). Resident blocks take the tiles in turn, so one launch
// covers any height.
DIP_API int dip_conv_tile_dense_mma_u8(const void* in, void* out,
                                       int channels, int hp, int pitch, int kh,
                                       int kw, const unsigned int* win,
                                       int shift, int clamp, void* stream) {
  // Up to INT_MAX / 2 tiles (4 TB of planes), so that a block's tile
  // index cannot overflow.
  const unsigned int gx = tile_cols(channels, hp, pitch, 16);
  const long long gy = (static_cast<long long>(hp) + kDenseRows - 1) /
                       kDenseRows;
  const long long n_tiles = gy * gx * channels;
  if (!side_ok(kh) || !side_ok(kw) || shift < 0 || shift > 31 || gx == 0 ||
      n_tiles > INT_MAX / 2)
    return kInvalid;
  const int n = static_cast<int>(n_tiles);
  DenseMmaU8 a{kh, kw, shift, clamp != 0, static_cast<int>(gx),
               static_cast<int>(gy), n, {}};
  for (int i = 0; i < kh * kWindows; ++i) a.win[i] = win[i];
  // One block for each resident slot of the card, each taking every
  // grid-th tile.
  const DenseMmaKernel kernel = kernel_for<DenseMmaOf>(kh);
  int grid;
  if (const cudaError_t e = mma_grid(kh, &grid)) return static_cast<int>(e);
  kernel<<<n < grid ? n : grid, kConvThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), hp, pitch,
      a);
  return dip::launch_status();
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
  const DenseF32Kernel kernel = kernel_for<DenseF32Of>(kh);
  return dip::launch_row_runs(hp, kDenseRows, [&](unsigned int gy, int row0) {
    kernel<<<dim3(gx, gy, channels), kConvThreads, 0,
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
