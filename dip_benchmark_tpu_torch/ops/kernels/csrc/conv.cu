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
// Design of the two-pass kernels: a warp owns 128 output columns of a
// tile a.rows tall (the height cut at launch so that the blocks fill the
// card once) and walks down it, each lane 4 adjacent columns (a 32-bit
// word of bytes, or a float4). Its frame is the plane rows the mask
// reaches (a.rows + kh - 1, anchored at the mask), each row with the 16
// bytes (8 floats) left and right of the warp's columns that a tap can
// read; the warp copies them by cp.async into a ring of rows in shared
// memory of its own, kSepAhead groups of rows ahead of the row it reads,
// and syncs with __syncwarp only: no block barrier. For each frame row a
// lane takes the row pass of its 4 columns once, then feeds it to the
// column sums of the kh outputs that row reaches, held in registers:
// part[k] is the sum of output row j - kh + 2 + k after frame row j, and
// frame row j + 1 adds its term with weight u[kh - 2 - k] while moving it
// to part[k - 1] (the moves are register names, no instruction), so each
// output takes its terms in ky order, which the float32 order needs, and
// the column pass reads no shared memory. A row's step has no branch, so
// that the compiler interleaves the rows of a group. Each kernel is
// compiled for every mask height kh (the column pass's ring); no branch a
// tap.
// - conv_tile_two_pass_u8: the row pass as dp4a (4 byte products an
//   instruction): for each output the frame bytes of 4 taps as one word
//   (a funnel shift of two aligned words), against the row weights split
//   on the host into D balanced base-256 digits (w = sum of d_i 256^i,
//   d_i in [-128, 127], exact modulo 2^32), one dp4a a digit, the digit
//   sums shifted and added. The row pass is compiled for kw where kw ==
//   kh (every separable N, the square rank-1 masks), else for 17 taps with
//   the weights at the anchor (0 elsewhere). Then the rounding between
//   (an identity where there is none: no branch), and the column pass:
//   FFMA on floats where the host proves every column sum an integer below
//   2^24 (exact; the FP32 pipe has twice the IMAD pipe's rate, and the
//   IMAD pipe has the dp4a), else IMAD in uint32. Bodies: D 1 or 2 with
//   the float column pass, or D 4 with the uint32 one (every other mask);
//   six a mask height, 102 instantiations, chosen by the host.
// - conv_tile_sep_f32: the row pass over kx ascending (FMUL, FADD), the
//   column pass from the ring; 17 instantiations.
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
// Bound of the two-pass kernels: the bytes, the buffer read once and
// written once; the arithmetic a lane issues is below it at small masks
// and near it at large ones: uint8, for each output about ceil(kw / 4) D
// dp4a (times 1 + (kh - 1) / a.rows, the halo rows the warp below takes
// again) beside kh FFMA or IMAD; float32, (2 kw - 1) (1 + (kh - 1) /
// a.rows) + 2 kh - 1 FMUL and FADD at 128 a clock an SM.
#include <cuda_pipeline.h>

#include <atomic>
#include <climits>
#include <type_traits>

#include "common.cuh"
#include "words.cuh"

namespace {

constexpr int kMaxSide = 17;                 // taps a side of a mask
constexpr int kHalo = kMaxSide / 2;          // taps past the anchor, 8
constexpr int kConvThreads = 256;
constexpr int kMaxGridZ = 65535;                    // gridDim.z

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
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

// -- the kernels' arguments, by value -----------------------------------------

struct DenseU8 {
  int kh, kw, shift, clamp;
  int w[kMaxSide * kMaxSide];  // row-major
};

// The mask outer(u, v) as two passes: v (kw taps) along the rows, then u
// (kh taps) down the columns; v as base-256 digits, 4 taps a word, 0 past
// the mask. Each pass ends in min(max((acc + half) >> shift, lo), hi): the
// row pass's is the identity (0, 0, INT_MIN, INT_MAX) where the passes are
// not rounded between, a clamp is lo 0, hi 255.
constexpr int kMaxTaps4 = (kMaxSide + 3) / 4 * 4;   // 20
constexpr int kDigits = 4;   // base-256 digits of an int32 weight
struct PassEnd {
  int half, shift, lo, hi;
};
struct TwoPassU8 {
  int kh, kw, rows;
  PassEnd rows_end, out_end;
  int u[kMaxSide];
  float uf[kMaxSide];   // u as floats, for the float column pass
  // vd[i][g]: byte t of digit i of the row weight of tap 4 g + t, the taps
  // placed at the row pass's anchor (see conv_tile_two_pass_u8).
  uint32_t vd[kDigits][kMaxTaps4 / 4];
};

struct DenseF32 {
  int kh, kw;
  float w[kMaxSide * kMaxSide];  // row-major
};

struct SepF32 {
  int n, rows;
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
//
// A warp takes kSepCols output columns (a lane 4) of a.rows rows. Its
// frame row fr is plane row y0 - kh / 2 + fr, a.rows + kh - 1 of them,
// each the plane from 16 bytes (8 floats) left of the warp's columns on (0
// outside the plane). The warp copies them a group of rows at a time
// (kU8Group, kF32Group) into its ring of kSepAhead + 1 groups, kSepAhead
// groups ahead of the one it reads. The rows a warp walks are chosen at
// launch (a.rows, sep_rows): the buffer's height cut so that the blocks
// fill the card's resident slots once (on the H100, 64-row tiles in 1.47
// waves took 94.9 us at N 17 where these took 91.3).

constexpr int kSepMinRows = 32;            // the least rows a warp walks
constexpr int kSepWarps = 4;               // a block's warps, side by side
constexpr int kSepThreads = 32 * kSepWarps;
constexpr int kSepCols = 128;              // output columns a warp
constexpr int kSepAhead = 3;               // groups copied ahead
// uint8: a ring row holds the plane bytes x0 - 16 .. x0 + 143 (the row
// pass reads up to byte 155 of it: taps of weight 0 past the mask).
constexpr int kU8Left = 16, kU8Chunks = (kSepCols + 2 * kU8Left) / 16;
constexpr int kU8Stride = 16 * kU8Chunks;        // 160
constexpr int kU8Group = 8;
// float32: the plane floats x0 - 8 .. x0 + 135.
constexpr int kF32Left = 8, kF32Chunks = (kSepCols + 2 * kF32Left) / 4;
constexpr int kF32Stride = 4 * kF32Chunks;       // 144 floats
constexpr int kF32Group = 4;
static_assert(kSepCols == 4 * 32, "a lane owns 4 columns");
static_assert(kU8Left >= kHalo && kF32Left >= kHalo, "the taps lie in a row");

// Copy frame rows g * G .. g * G + G - 1 of the warp into ring slot
// g % (kSepAhead + 1) (nothing for a group past the frame), 16 bytes a
// copy, 0 outside the plane; one commit either way. Lane l copies chunks
// l, l + 32, ... of the group's G * kChunks, chunk i being chunk i %
// kChunks of row i / kChunks.
template <int G, int kChunks, int kStride, class T>
__device__ __forceinline__ void sep_prefetch(const T* __restrict__ in,
                                             size_t plane, int hp, int pitch,
                                             int fy0, int x_left, int g,
                                             int groups, int lane, T* ring) {
  constexpr int kPer = 16 / sizeof(T);   // values a copy
  constexpr int kCopies = (G * kChunks + 31) / 32;
  if (g < groups) {
    T* slot = ring + (g % (kSepAhead + 1)) * G * kStride;
    const int y_g = fy0 + g * G;
    int r = lane / kChunks, c = lane % kChunks;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      if (k + 1 < kCopies || r < G) {
        const int y = y_g + r, x = x_left + kPer * c;
        const bool ok = static_cast<unsigned>(y) < static_cast<unsigned>(hp) &&
                        static_cast<unsigned>(x) < static_cast<unsigned>(pitch);
        __pipeline_memcpy_async(
            slot + r * kStride + kPer * c,
            ok ? in + plane + static_cast<size_t>(y) * pitch + x : in, 16,
            ok ? 0 : 16);
      }
      c += 32 % kChunks;
      r += 32 / kChunks;
      if (c >= kChunks) c -= kChunks, ++r;
    }
  }
  __pipeline_commit();
}

// The walk of a warp, common to both data models: step(row, j) for each
// frame row j, in order, with the ring row that holds it, in whole groups
// of G rows: up to G - 1 rows past the frame (step stores no output for
// them; their copies are real rows or 0).
template <int G, int kChunks, int kStride, class T, class Step>
__device__ __forceinline__ void sep_walk(const T* __restrict__ in,
                                         size_t plane, int hp, int pitch,
                                         int frame, int fy0, int x_left,
                                         int lane, T* ring, Step step) {
  const int groups = (frame + G - 1) / G;
#pragma unroll
  for (int g = 0; g < kSepAhead; ++g)
    sep_prefetch<G, kChunks, kStride>(in, plane, hp, pitch, fy0, x_left, g,
                                      groups, lane, ring);
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    __pipeline_wait_prior(kSepAhead - 1);
    // Every lane is past group g - 1, whose slot takes group g + kSepAhead,
    // and sees the rows of group g.
    __syncwarp();
    sep_prefetch<G, kChunks, kStride>(in, plane, hp, pitch, fy0, x_left,
                                      g + kSepAhead, groups, lane, ring);
    const T* rows = ring + (g % (kSepAhead + 1)) * G * kStride;
#pragma unroll 4
    for (int r = 0; r < G; ++r) step(rows + r * kStride, g * G + r);
  }
  __pipeline_wait_prior(0);
}

// d = c + the four products of a's bytes (unsigned) and b's (signed).
__device__ __forceinline__ uint32_t dp4a_us(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// uint8 row pass of the lane's 4 columns on one ring row, KW taps compiled
// in (the anchor KW / 2): for output j and taps 4 g .. 4 g + 3, the frame
// bytes kU8Left - KW / 2 + 4 lane + j + 4 g .. + 3 as one word (a funnel
// shift of two aligned words), one dp4a for each of the D base-256 digits
// of the weights (w = sum of d_i 256^i, each d_i in [-128, 127], exact
// modulo 2^32), the digit sums shifted and added.
template <int KW, int D>
__device__ __forceinline__ void row_pass_u8(const uint8_t* row, int lane,
                                            const TwoPassU8& a,
                                            uint32_t (&p)[4]) {
  constexpr int off = kU8Left - KW / 2, sh = off & 3;
  constexpr int kG = (KW + 3) / 4;              // groups of 4 taps
  constexpr int kWords = (sh + 4 * kG + 6) / 4;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(row) + lane +
                        (off >> 2);
  uint32_t seg[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) seg[k] = src[k];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t win[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int q = (sh + j) / 4 + g, r = (sh + j) % 4;
      win[g] = r ? __funnelshift_r(seg[q], seg[q + 1], 8 * r) : seg[q];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      uint32_t d = 0u;
#pragma unroll
      for (int g = 0; g < kG; ++g) d = dp4a_us(win[g], a.vd[i][g], d);
      p[j] = i == 0 ? d : p[j] + (d << (8 * i));
    }
  }
}

// min(max((acc + half) >> shift, lo), hi) of four sums in place.
__device__ __forceinline__ void pass_end(uint32_t (&v)[4], const PassEnd& e) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = static_cast<uint32_t>(
        min(max(static_cast<int>(v[c] + static_cast<uint32_t>(e.half)) >>
                    e.shift,
                e.lo),
            e.hi));
}

// KW == KH: the row pass compiled for the width too (every separable N,
// the square rank-1 masks); KW == 0: any width, the row pass compiled for
// kMaxSide taps with the weights placed at the anchor kMaxSide / 2 (0
// elsewhere; the host places them). D: the digits of the row weights.
// kFloat: the column pass as FFMA on float values, which the host chooses
// where every column sum is an integer below 2^24 in magnitude, so that
// each is exact: the FP32 pipe has twice the IMAD pipe's rate, and the
// IMAD pipe has the dp4a. A frame row's step has no branch (the output
// row's store is predicated), so that the compiler may interleave the rows
// of a group.
template <int KH, int KW, int D, bool kFloat>
__global__ void __launch_bounds__(kSepThreads, 4)
    conv_tile_two_pass_u8(const uint8_t* __restrict__ in,
                          uint8_t* __restrict__ out, int hp, int pitch,
                          int row0, const __grid_constant__ TwoPassU8 a) {
  using Acc = std::conditional_t<kFloat, float, uint32_t>;
  __shared__ __align__(16) uint8_t
      ring[kSepWarps][(kSepAhead + 1) * kU8Group * kU8Stride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = (static_cast<int>(blockIdx.x) * kSepWarps + warp) * kSepCols;
  if (x0 >= pitch) return;
  const int y0 = row0 + static_cast<int>(blockIdx.y) * a.rows;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * pitch;
  constexpr int hy = KH / 2;
  const int x = x0 + 4 * lane;
  const Ring g{hp, pitch, hy, a.kw / 2};
  uint32_t keep = 0u;   // the lane's bytes outside the zero ring
#pragma unroll
  for (int j = 0; j < 4; ++j) keep |= g.col_in(x + j) ? 0xFFu << (8 * j) : 0u;
  const bool mine = x < pitch;
  const int outputs = a.rows < hp - y0 ? a.rows : hp - y0;
  uint8_t* dst = out + plane + static_cast<size_t>(y0) * pitch + x;
  Acc part[KH > 1 ? KH - 1 : 1][4] = {};
  // acc + w q: IMAD, or an FFMA exact on integers below 2^24.
  const auto mad = [&](int k, Acc q, Acc acc) -> Acc {
    if constexpr (kFloat)
      return fmaf(q, a.uf[k], acc);
    else
      return acc + static_cast<uint32_t>(a.u[k]) * q;
  };
  sep_walk<kU8Group, kU8Chunks, kU8Stride>(
      in, plane, hp, pitch, outputs + KH - 1, y0 - hy, x0 - kU8Left, lane,
      ring[warp], [&](const uint8_t* row, int j) {
        uint32_t p[4];
        row_pass_u8<KW == 0 ? kMaxSide : KW, D>(row, lane, a, p);
        pass_end(p, a.rows_end);
        Acc q[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (kFloat)   // |p| < 2^22: the float of the int
            q[c] = __int_as_float(static_cast<int>(p[c]) + 0x4B400000) -
                   12582912.0f;
          else
            q[c] = p[c];
        }
        // Frame row j completes output row j - KH + 1 and adds to the
        // KH - 1 after it; part[k] moves to part[k - 1].
        Acc sum[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sum[c] = mad(KH - 1, q[c], KH > 1 ? part[0][c] : Acc(0));
#pragma unroll
        for (int k = 0; k + 1 < KH - 1; ++k)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[k][c] = mad(KH - 2 - k, q[c], part[k + 1][c]);
        if constexpr (KH > 1) {
#pragma unroll
          for (int c = 0; c < 4; ++c) part[KH - 2][c] = mad(0, q[c], Acc(0));
        }
        uint32_t done[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          done[c] = kFloat ? static_cast<uint32_t>(__float2int_rn(sum[c]))
                           : static_cast<uint32_t>(sum[c]);
        pass_end(done, a.out_end);
        const int o = j - (KH - 1);
        // The low bytes of the four (the clamp, or astype(uint8)).
        const uint32_t word =
            __byte_perm(__byte_perm(done[0], done[1], 0x0040),
                        __byte_perm(done[2], done[3], 0x0040), 0x5410) &
            (g.row_in(y0 + o) ? keep : 0u);
        if (mine && o >= 0 && o < outputs)
          *reinterpret_cast<uint32_t*>(dst + static_cast<ptrdiff_t>(o) *
                                                 pitch) = word;
      });
}

using TwoPassU8Kernel = void (*)(const uint8_t*, uint8_t*, int, int, int,
                                 const TwoPassU8);
// The instantiation of mask height N: the row pass of width N (kSquare)
// or of any width; 1 or 2 digits with the float column pass, or 4 digits
// with the integer one (every other mask).
template <bool kSquare, int D>
struct TwoPass {
  template <int N>
  struct Of {
    static TwoPassU8Kernel get() {
      return conv_tile_two_pass_u8<N, kSquare ? N : 0, D, D < 4>;
    }
  };
};

// float32, N taps a side: the row pass over kx ascending, then the column
// pass over ky ascending, each from its first product (-0.0f + p == p).
template <int N>
__global__ void __launch_bounds__(kSepThreads, 4)
    conv_tile_sep_f32(const float* __restrict__ in, float* __restrict__ out,
                      int hp, int pitch, int row0,
                      const __grid_constant__ SepF32 a) {
  __shared__ __align__(16) float
      ring[kSepWarps][(kSepAhead + 1) * kF32Group * kF32Stride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = (static_cast<int>(blockIdx.x) * kSepWarps + warp) * kSepCols;
  if (x0 >= pitch) return;
  const int y0 = row0 + static_cast<int>(blockIdx.y) * a.rows;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * pitch;
  constexpr int h = N / 2;
  constexpr int off = kF32Left - h, sh = off & 3;
  constexpr int kVecs = (sh + N + 3 + 3) / 4;
  const int x = x0 + 4 * lane;
  const Ring g{hp, pitch, h, h};
  bool keep[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) keep[c] = g.col_in(x + c);
  const bool mine = x < pitch;
  const int outputs = a.rows < hp - y0 ? a.rows : hp - y0;
  float* dst = out + plane + static_cast<size_t>(y0) * pitch + x;
  float part[N > 1 ? N - 1 : 1][4] = {};
  sep_walk<kF32Group, kF32Chunks, kF32Stride>(
      in, plane, hp, pitch, outputs + N - 1, y0 - h, x0 - kF32Left, lane,
      ring[warp], [&](const float* row, int j) {
        const float4* src = reinterpret_cast<const float4*>(row) + lane +
                            (off >> 2);
        float s[4 * kVecs];
#pragma unroll
        for (int k = 0; k < kVecs; ++k) {
          const float4 v = src[k];
          s[4 * k] = v.x, s[4 * k + 1] = v.y, s[4 * k + 2] = v.z,
                s[4 * k + 3] = v.w;
        }
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) p[c] = mul(s[sh + c], a.wr[0]);
#pragma unroll
        for (int kx = 1; kx < N; ++kx)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            p[c] = add(p[c], mul(s[sh + c + kx], a.wr[kx]));
        float done[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          done[c] = N > 1 ? add(part[0][c], mul(p[c], a.wc[N - 1]))
                          : mul(p[c], a.wc[0]);
#pragma unroll
        for (int k = 0; k + 1 < N - 1; ++k)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[k][c] = add(part[k + 1][c], mul(p[c], a.wc[N - 2 - k]));
        if constexpr (N > 1) {
#pragma unroll
          for (int c = 0; c < 4; ++c) part[N - 2][c] = mul(p[c], a.wc[0]);
        }
        const int o = j - (N - 1);
        const bool in = g.row_in(y0 + o);
        if (mine && o >= 0 && o < outputs)
          *reinterpret_cast<float4*>(dst + static_cast<ptrdiff_t>(o) *
                                               pitch) =
              make_float4(in && keep[0] ? done[0] : 0.0f,
                          in && keep[1] ? done[1] : 0.0f,
                          in && keep[2] ? done[2] : 0.0f,
                          in && keep[3] ? done[3] : 0.0f);
      });
}

using SepF32Kernel = void (*)(const float*, float*, int, int, int,
                              const SepF32);
template <int N>
struct SepF32Of {
  static SepF32Kernel get() { return conv_tile_sep_f32<N>; }
};

// -- launch -----------------------------------------------------------------

// The blocks of `cols` columns across a buffer (gridDim.x), or 0 for one
// the tiles cannot cover: a pitch the 16-byte frame loads do not take
// (uint8: a multiple of 16 bytes; float32: of 4 floats), or more planes
// than gridDim.z holds. Its rows of tiles go on gridDim.y in runs of at
// most 65,535 (dip::launch_row_runs), so any height is covered.
unsigned int tile_cols(int channels, int hp, int pitch, int align,
                       int cols = kDenseCols) {
  if (channels < 1 || channels > kMaxGridZ || hp < 1 || pitch < align ||
      pitch % align != 0)
    return 0;
  return (pitch + cols - 1) / cols;
}

bool side_ok(int n) { return n >= 1 && n <= kMaxSide; }

constexpr int kDevices = 64;   // devices whose resident blocks are kept

// SMs x the blocks of `kernel` (`threads` threads) an SM holds at once on
// the current device, into *blocks: asked of the runtime once per device,
// then read from known[device].
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads,
                            std::atomic<int> (&known)[kDevices],
                            int* blocks) {
  int device, sms, per_sm;
  if (const cudaError_t e = cudaGetDevice(&device)) return e;
  std::atomic<int>* slot = device < kDevices ? &known[device] : nullptr;
  if (slot && (*blocks = slot->load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  if (const cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device))
    return e;
  if (const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, 0))
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (slot) slot->store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// The blocks of the mma body of mask height kh resident on the device.
cudaError_t mma_grid(int kh, int* grid) {
  static std::atomic<int> known[kMaxSide + 1][kDevices];
  return resident_blocks(kernel_for<DenseMmaOf>(kh), kConvThreads,
                         known[kh], grid);
}

// The rows a warp of a two-pass kernel walks on a buffer of hp rows, gx
// blocks across, `channels` planes: the height cut into as many runs as
// the card's resident blocks (`known`, one table a kernel) hold at once,
// so that every block starts in the first wave, at least kSepMinRows.
template <class Kernel>
cudaError_t sep_rows(Kernel kernel, std::atomic<int> (&known)[kDevices],
                     int hp, unsigned int gx, int channels, int* rows) {
  int slots;
  if (const cudaError_t e = resident_blocks(kernel, kSepThreads, known,
                                            &slots))
    return e;
  const long long strips = static_cast<long long>(gx) * channels;
  const long long runs = slots / strips > 1 ? slots / strips : 1;
  const long long r = (hp + runs - 1) / runs;
  *rows = static_cast<int>(r > kSepMinRows ? r : kSepMinRows);
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
  const unsigned int gx =
      tile_cols(channels, hp, pitch, 16, kSepWarps * kSepCols);
  if (!side_ok(kh) || !side_ok(kw) || shift < 0 || shift > 31 || gx == 0)
    return kInvalid;
  // The passes' ends: the row pass's the identity unless rounded between.
  const int half = dip::half_of(shift);
  const PassEnd identity{0, 0, INT_MIN, INT_MAX};
  const PassEnd rows_end{half, shift, clamp_rows ? 0 : INT_MIN,
                         clamp_rows ? 255 : INT_MAX};
  TwoPassU8 a{kh, kw, 0, round_between ? rows_end : identity,
              {half, shift, clamp_out ? 0 : INT_MIN, clamp_out ? 255 : INT_MAX},
              {}, {}};
  for (int i = 0; i < kh; ++i) a.u[i] = u[i];
  // Row tap kx at the row pass's tap first + kx: from 0 where kw == kh,
  // else at the anchor kMaxSide / 2 of the any-width pass. Each weight as
  // balanced base-256 digits modulo 2^32: d = the low byte as a signed
  // one, then (w - d) / 256.
  const int first = kh == kw ? 0 : kMaxSide / 2 - kw / 2;
  int digits = 1;
  for (int i = 0; i < kw; ++i) {
    uint32_t w = static_cast<uint32_t>(v[i]);
    const int t = first + i;
    for (int d = 0; d < kDigits && w != 0u; ++d) {
      const int digit = static_cast<int8_t>(w & 255u);
      a.vd[d][t / 4] |= (static_cast<uint32_t>(digit) & 255u) << (8 * (t % 4));
      w = (w - static_cast<uint32_t>(digit)) >> 8;
      if (d + 1 > digits) digits = d + 1;
    }
  }
  // The float column pass where every value it takes is an integer below
  // 2^22 and every column sum, the rounding's half included, below 2^24:
  // the row sums lie in [p_lo, p_hi], the values the column pass takes
  // (rounded, or clamped) in [-q_max, q_max].
  long long p_lo = 0, p_hi = 0, u_sum = 0;
  for (int i = 0; i < kw; ++i) (v[i] < 0 ? p_lo : p_hi) += 255LL * v[i];
  for (int i = 0; i < kh; ++i) {
    u_sum += u[i] < 0 ? -1LL * u[i] : u[i];
    a.uf[i] = static_cast<float>(u[i]);
  }
  const long long rh = a.rows_end.half;
  const long long q_lo = round_between ? (p_lo + rh) >> shift : p_lo;
  const long long q_hi = round_between ? (p_hi + rh) >> shift : p_hi;
  const long long q_max =
      round_between && clamp_rows ? 255 : (q_hi > -q_lo ? q_hi : -q_lo);
  const bool float_cols = p_hi + rh < (1LL << 31) && p_lo >= -(1LL << 31) &&
                          q_max < (1LL << 22) &&
                          q_max * u_sum + half <= (1LL << 24);
  // Any other mask, or 3 digits, takes the 4-digit kernel (its weights' high
  // digits 0) with the integer column pass.
  const int d = float_cols && digits <= 2 ? digits - 1 : 2;
  const int body = (kh == kw ? 0 : 3) + d;
  static std::atomic<int> known[6][kMaxSide + 1][kDevices];
  const TwoPassU8Kernel kernel =
      body == 0   ? kernel_for<TwoPass<true, 1>::Of>(kh)
      : body == 1 ? kernel_for<TwoPass<true, 2>::Of>(kh)
      : body == 2 ? kernel_for<TwoPass<true, 4>::Of>(kh)
      : body == 3 ? kernel_for<TwoPass<false, 1>::Of>(kh)
      : body == 4 ? kernel_for<TwoPass<false, 2>::Of>(kh)
                  : kernel_for<TwoPass<false, 4>::Of>(kh);
  if (const cudaError_t e = sep_rows(kernel, known[body][kh], hp, gx,
                                     channels, &a.rows))
    return static_cast<int>(e);
  return dip::launch_row_runs(hp, a.rows, [&](unsigned int gy, int row0) {
    kernel<<<dim3(gx, gy, channels), kSepThreads, 0,
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
  const unsigned int gx =
      tile_cols(channels, hp, pitch, 4, kSepWarps * kSepCols);
  if (!side_ok(n) || gx == 0) return kInvalid;
  SepF32 a{n, 0, {}, {}};
  for (int i = 0; i < n; ++i) {
    a.wr[i] = wr[i];
    a.wc[i] = wc[i];
  }
  static std::atomic<int> known[kMaxSide + 1][kDevices];
  const SepF32Kernel kernel = kernel_for<SepF32Of>(n);
  if (const cudaError_t e = sep_rows(kernel, known[n], hp, gx, channels,
                                     &a.rows))
    return static_cast<int>(e);
  return dip::launch_row_runs(hp, a.rows, [&](unsigned int gy, int row0) {
    kernel<<<dim3(gx, gy, channels), kSepThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(in), static_cast<float*>(out), hp, pitch,
        row0, a);
  });
}
