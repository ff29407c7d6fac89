// The generic structuring element's min or max (window.cu's Taps<Min> and
// Taps<Max> on uint8, f32.cu's Taps on float32): a small program, built on
// the host once for the element (ops/window.py taps_program), run over a
// tile of the plane held in shared memory.
//
// A tile is E::kRows output rows by kTapsFrame - 2 * margin output
// columns. Its frame holds the input rows that reach them (hy more above
// and below) and margin columns (4 or 8, at least the element's hx) on
// either side, loaded once into slot 0; uint8 as 16-bit fields, two
// positions a word, so that one VIMNMX.U16x2 does two outputs. A table is
// a frame-sized array in a slot; H_L holds, at each position p of each
// row, the min (max) of the L inputs p .. p + L - 1 of that row. Each
// instruction makes one table for the frame rows [r0, r1) as the min (max)
// over its terms (slot, dy, dx) of that slot's rows shifted by dy and
// positions shifted by dx; the last instruction is the output, the min
// (max) over the element's rows of the run tables each row needs (a 5x5
// diamond: H_1 and H_3, its run of five as two copies of H_3; a 17x17
// square: H_17 built by doubling, then 17 rows). The block syncs between
// instructions; the output is staged in slot 0 and stored 8 (uint8) or 16
// (float32) bytes a thread.
//
// Positions past the frame's valid columns hold garbage that no stored
// output reads: the program keeps every run inside [-margin, margin]
// (ops/window.py builds the row ranges; the C entry checks that every read
// and write lies inside the slots).
//
// Bound: the compulsory traffic, each input byte read once and each output
// byte written once. What the kernel spends beyond it: a fixed cost for
// the tile (its loads, the stores, the indexing), then the program's
// terms, a shared-memory read each an output (2 bytes for uint8, 4 for
// float32; ops/window.py TapsProgram.stats counts them). Tried and dropped
// (benchmarks/h100/window_lab.py): per-row predicates in one pass of all
// rows, items of two or four words (bank conflicts), resident blocks
// fetching the next tile into registers.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace dip {
namespace taps {

constexpr int kTapsMaxRadius = 8;
constexpr int kTapsRowsU8 = 64;    // output rows of a uint8 tile
constexpr int kTapsRowsF32 = 32;   // output rows of a float32 tile
constexpr int kTapsChunk = 16;     // rows a thread reduces at once
constexpr int kTapsFrame = 128;    // positions of a frame row
constexpr int kTapsThreads = 256;
constexpr int kTapsMaxSlots = 8;
constexpr int kTapsMaxInstrs = 40;
constexpr int kTapsMaxTerms = 400;
constexpr int kTapsGuard = 16;     // words before the slots and after them

// The program, by value in the kernel's arguments (under 2.5 KB; a
// __grid_constant__ parameter, so that the runtime-indexed terms are read
// from the parameter bank and not copied to each thread's local memory).
// A term is the word offset of its source, slot * slot words + dy * row
// words + the position offset in words, times two, plus 1 where a uint8
// read takes the high field of one word and the low field of the next.
struct Program {
  int hy, hx, margin, slots, instrs;
  short dst[kTapsMaxInstrs], r0[kTapsMaxInstrs], r1[kTapsMaxInstrs];
  short first[kTapsMaxInstrs], count[kTapsMaxInstrs];
  int term[kTapsMaxTerms];
};

// The int32 words of ops/window.py TapsProgram.encode as a Program for
// data E, or false if they are malformed or would read or write outside
// the slots.
template <class E>
bool parse_program(const int* w, int n, Program& p) {
  if (n < 5) return false;
  p.hy = w[0], p.hx = w[1], p.margin = w[2], p.slots = w[3];
  p.instrs = w[4];
  if (p.hy < 0 || p.hy > kTapsMaxRadius || p.hx < 0 || p.hx > p.margin ||
      (p.margin != 4 && p.margin != 8) || p.slots < 1 ||
      p.slots > kTapsMaxSlots || p.instrs < 1 || p.instrs > kTapsMaxInstrs)
    return false;
  const int fr = E::kRows + 2 * p.hy;
  int at = 5, terms = 0;
  for (int i = 0; i < p.instrs; ++i) {
    if (at + 4 > n) return false;
    const int dst = w[at], r0 = w[at + 1], r1 = w[at + 2], c = w[at + 3];
    at += 4;
    const bool last = i + 1 == p.instrs;
    if ((last ? dst != -1 : dst < 0 || dst >= p.slots) || r0 < 0 ||
        r1 > fr || r0 >= r1 || c < 1 || terms + c > kTapsMaxTerms ||
        at + 3 * c > n)
      return false;
    if (last && (r0 != p.hy || r1 != p.hy + E::kRows)) return false;
    p.dst[i] = static_cast<short>(dst);
    p.r0[i] = static_cast<short>(r0);
    p.r1[i] = static_cast<short>(r1);
    p.first[i] = static_cast<short>(terms);
    p.count[i] = static_cast<short>(c);
    for (int t = 0; t < c; ++t, at += 3) {
      const int slot = w[at], dy = w[at + 1], dx = w[at + 2];
      if (slot < 0 || slot >= p.slots || (!last && slot == dst) ||
          r0 + dy < 0 || r1 + dy > fr || dx < -kTapsMaxRadius ||
          dx > kTapsMaxRadius)
        return false;
      p.term[terms++] = E::term(slot * fr * E::kCols + dy * E::kCols, dx);
    }
  }
  return at == n;
}

// Where a tile lies: frame row f is image row y0 - hy + f of the plane at
// src (in) and dst (out), frame position q is column xf + q.
template <class Pixel>
struct Tile {
  const Pixel* src;
  Pixel* dst;
  int y0, xf;
};

// The plane's geometry and the program's ring and margin.
struct Geometry {
  int hp, pitch, hy, hx, margin, fr;
};

// The tile of this block: blockIdx (column of tiles, row of tiles from row
// row0, plane).
template <int kRows, class Pixel>
__device__ Tile<Pixel> block_tile(const Pixel* in, Pixel* out,
                                  const Geometry& g, int row0) {
  const size_t plane = static_cast<size_t>(blockIdx.z) * g.hp * g.pitch;
  return {in + plane, out + plane,
          row0 + static_cast<int>(blockIdx.y) * kRows,
          static_cast<int>(blockIdx.x) * (kTapsFrame - 2 * g.margin) -
              g.margin};
}

// The frame's input rows, kPerRow loads of 16 bytes or fewer a row: a
// thread keeps one column of loads and takes every kRowsPerPass-th row.
// fetch starts them all (0 outside the buffer), put stores them.
template <class Load, int kPerRow, int kRows>
struct FrameLoads {
  using Value = Load;
  static constexpr int kRowsPerPass = kTapsThreads / kPerRow;
  static constexpr int kLoads =
      (kRows + 2 * kTapsMaxRadius + kRowsPerPass - 1) / kRowsPerPass;
  static constexpr int kWidth = kTapsFrame / kPerRow;  // pixels a load
  template <class Pixel>
  __device__ static void fetch(const Tile<Pixel>& t, const Geometry& g,
                               Load (&v)[kLoads]) {
    const int w = threadIdx.x % kPerRow, f0 = threadIdx.x / kPerRow;
    const int x = t.xf + kWidth * w;
    const bool col_in = x >= 0 && x < g.pitch;
    const Pixel* src = t.src + x;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int f = f0 + k * kRowsPerPass, y = t.y0 - g.hy + f;
      v[k] = Load{};
      if (col_in && f < g.fr && y >= 0 && y < g.hp)
        v[k] = *reinterpret_cast<const Load*>(
            src + static_cast<ptrdiff_t>(y) * g.pitch);
    }
  }
  template <class Put>
  __device__ static void put(const Load (&v)[kLoads], const Geometry& g,
                             Put put) {
    const int w = threadIdx.x % kPerRow, f0 = threadIdx.x / kPerRow;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int f = f0 + k * kRowsPerPass;
      if (f < g.fr) put(f * kPerRow + w, v[k]);
    }
  }
};

// uint8 data as two 16-bit fields a word: word w of a frame row holds
// positions 2w (low field) and 2w + 1 (high field), so min and max are one
// VIMNMX.U16x2 for two outputs (words.cuh); a read at an odd dx takes the
// high field of one word and the low field of the next.
template <class FieldOp>
struct U8 {
  using Pixel = uint8_t;
  using Word = uint32_t;
  static constexpr int kRows = kTapsRowsU8;        // output rows of a tile
  using Loads = FrameLoads<uint32_t, kTapsFrame / 4, kRows>;
  static constexpr int kCols = kTapsFrame / 2;   // words of a frame row
  static int term(int offset, int dx) {
    return (offset + (dx >> 1)) * 2 + (dx & 1);
  }
  __device__ static Word identity() { return FieldOp::kIdentity; }
  // acc[j] op= the word at p + (term >> 1) + j rows, shifted a position
  // where the term says so.
  __device__ static void accumulate(Word (&acc)[kTapsChunk], const Word* p,
                                    int term) {
    p += term >> 1;
    if (term & 1) {
#pragma unroll
      for (int j = 0; j < kTapsChunk; ++j)
        acc[j] = FieldOp::apply(
            acc[j], __byte_perm(p[j * kCols], p[j * kCols + 1], 0x5432));
    } else {
#pragma unroll
      for (int j = 0; j < kTapsChunk; ++j)
        acc[j] = FieldOp::apply(acc[j], p[j * kCols]);
    }
  }
  // The fetched bytes into slot 0 as fields.
  __device__ static void put(const uint32_t (&v)[Loads::kLoads], Word* slot,
                             const Geometry& g) {
    Loads::put(v, g, [slot](int i, uint32_t b) {
      *reinterpret_cast<uint2*>(slot + 2 * i) =
          make_uint2(__byte_perm(b, 0, 0x4140), __byte_perm(b, 0, 0x4342));
    });
  }
  // The output rows staged in slot 0 (frame rows hy .., fields) to the
  // plane, 8 bytes a thread and row, with the ring zeroed: the tile's
  // columns from margin on in chunks of 8, 16 chunk places a row.
  __device__ static void store(const Word* staged, const Tile<uint8_t>& t,
                               const Geometry& g) {
    const int chunks = (kTapsFrame - 2 * g.margin) / 8;
    for (int i = threadIdx.x; i < kRows * 16; i += kTapsThreads) {
      const int row = i >> 4, k = i & 15, y = t.y0 + row;
      const int x = t.xf + g.margin + 8 * k;
      if (k >= chunks || y >= g.hp || x >= g.pitch) continue;
      const Word* p = staged + (g.hy + row) * kCols + g.margin / 2 + 4 * k;
      const uint2 lo = *reinterpret_cast<const uint2*>(p);
      const uint2 hi = *reinterpret_cast<const uint2*>(p + 2);
      uint2 v = make_uint2(__byte_perm(lo.x, lo.y, 0x6420),
                           __byte_perm(hi.x, hi.y, 0x6420));
      if (y < g.hy || y >= g.hp - g.hy) {
        v = make_uint2(0, 0);
      } else if (x < g.hx || x + 8 > g.pitch - g.hx) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (x + j < g.hx || x + j >= g.pitch - g.hx) {
            if (j < 4) v.x &= ~(0xffu << (8 * j));
            else v.y &= ~(0xffu << (8 * (j - 4)));
          }
      }
      *reinterpret_cast<uint2*>(t.dst + static_cast<ptrdiff_t>(y) * g.pitch +
                                x) = v;
    }
  }
};

// float32 data, one float a word.
struct F32Min {
  using Pixel = float;
  using Word = float;
  static constexpr int kRows = kTapsRowsF32;
  using Loads = FrameLoads<float4, kTapsFrame / 4, kRows>;
  static constexpr int kCols = kTapsFrame;
  static int term(int offset, int dx) { return (offset + dx) * 2; }
  __device__ static Word identity() { return __int_as_float(0x7f800000); }
  __device__ static void accumulate(Word (&acc)[kTapsChunk], const Word* p,
                                    int term) {
    p += term >> 1;
#pragma unroll
    for (int j = 0; j < kTapsChunk; ++j) acc[j] = fminf(acc[j], p[j * kCols]);
  }
  __device__ static void put(const float4 (&v)[Loads::kLoads], Word* slot,
                             const Geometry& g) {
    Loads::put(v, g, [slot](int i, float4 f) {
      reinterpret_cast<float4*>(slot)[i] = f;
    });
  }
  // The output rows staged in slot 0 to the plane, a float4 a thread and
  // row, with the ring zeroed: 32 chunk places a row.
  __device__ static void store(const Word* staged, const Tile<float>& t,
                               const Geometry& g) {
    const int chunks = (kTapsFrame - 2 * g.margin) / 4;
    for (int i = threadIdx.x; i < kRows * 32; i += kTapsThreads) {
      const int row = i >> 5, k = i & 31, y = t.y0 + row;
      const int x = t.xf + g.margin + 4 * k;
      if (k >= chunks || y >= g.hp || x >= g.pitch) continue;
      float4 v = *reinterpret_cast<const float4*>(
          staged + (g.hy + row) * kCols + g.margin + 4 * k);
      if (y < g.hy || y >= g.hp - g.hy) {
        v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else if (x < g.hx || x + 4 > g.pitch - g.hx) {
        if (x < g.hx || x >= g.pitch - g.hx) v.x = 0.0f;
        if (x + 1 < g.hx || x + 1 >= g.pitch - g.hx) v.y = 0.0f;
        if (x + 2 < g.hx || x + 2 >= g.pitch - g.hx) v.z = 0.0f;
        if (x + 3 < g.hx || x + 3 >= g.pitch - g.hx) v.w = 0.0f;
      }
      *reinterpret_cast<float4*>(t.dst + static_cast<ptrdiff_t>(y) * g.pitch +
                                 x) = v;
    }
  }
};

// in and out are (C, Hp, pitch); the grid is one block a tile (the tiles
// across a row of tiles first, then down, then the planes), in runs of at
// most 65,535 rows of tiles from row row0; dynamic shared memory
// smem_bytes<E>. Each instruction's rows are cut into chunks of
// kTapsChunk rows; a thread takes a chunk of one word column at a time and
// reduces its rows together (independent loads in flight), reading past
// the instruction's last row into the guard (never stored).
template <class E>
__global__ void __launch_bounds__(kTapsThreads)
    window_taps(const typename E::Pixel* __restrict__ in,
                typename E::Pixel* __restrict__ out, int hp, int pitch,
                int row0, const __grid_constant__ Program prog) {
  using Word = typename E::Word;
  using Loads = typename E::Loads;
  constexpr int C = E::kCols, RC = kTapsChunk;
  static_assert(E::kRows / RC * C == kTapsThreads,
                "the output instruction has one item a thread");
  extern __shared__ __align__(16) uint32_t smem_words[];
  Word* slots = reinterpret_cast<Word*>(smem_words) + kTapsGuard;
  // The terms are read by every thread at every chunk: from shared
  // memory, not the parameter bank.
  __shared__ int terms[kTapsMaxTerms];
  const int n_terms =
      prog.first[prog.instrs - 1] + prog.count[prog.instrs - 1];
  for (int t = threadIdx.x; t < n_terms; t += kTapsThreads)
    terms[t] = prog.term[t];
  const Geometry g{hp, pitch, prog.hy, prog.hx, prog.margin,
                   E::kRows + 2 * prog.hy};
  const int fr = g.fr;
  const auto tile = block_tile<E::kRows>(in, out, g, row0);
  {
    typename Loads::Value v[Loads::kLoads];
    Loads::fetch(tile, g, v);
    E::put(v, slots, g);
  }
  __syncthreads();
  for (int i = 0; i < prog.instrs; ++i) {
    const int r0 = prog.r0[i], r1 = prog.r1[i];
    const int first = prog.first[i], end = first + prog.count[i];
    const int items = (r1 - r0 + RC - 1) / RC * C;
    const bool last = i + 1 == prog.instrs;
    // items is a multiple of C, and C of the warp: a warp's lanes take
    // items of one chunk together.
    for (int item = threadIdx.x; item < items; item += kTapsThreads) {
      const int col = item % C, row = r0 + item / C * RC;
      const Word* at = slots + row * C + col;
      Word acc[RC];
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[j] = E::identity();
      for (int t = first; t < end; ++t) E::accumulate(acc, at, terms[t]);
      // The output instruction has one item a thread; its rows go to
      // slot 0 once every thread is done reading the slots.
      if (last) __syncthreads();
      Word* d = slots + (last ? 0 : prog.dst[i] * fr * C) + row * C + col;
#pragma unroll
      for (int j = 0; j < RC; ++j)
        if (row + j < r1) d[j * C] = acc[j];
    }
    __syncthreads();
  }
  E::store(slots, tile, g);
}

// The guard after the slots takes the reads of a last chunk past its
// instruction's rows.
template <class E>
size_t smem_bytes(const Program& p) {
  return sizeof(uint32_t) *
         (2 * kTapsGuard + (kTapsChunk - 1) * E::kCols +
          static_cast<size_t>(p.slots) * (E::kRows + 2 * p.hy) * E::kCols);
}

// Parse the program and launch; cudaErrorInvalidValue for a malformed program or a pitch the
// frame's 16-byte loads do not take.
template <class E>
int launch(const void* in, void* out, int channels, int hp, int pitch,
           const int* words, int n, void* stream) {
  Program prog;
  if (!parse_program<E>(words, n, prog) || channels < 1 || hp < 1 ||
      pitch < 16 ||
      pitch % (16 / static_cast<int>(sizeof(typename E::Pixel))) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes<E>(prog);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_taps<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int cols = kTapsFrame - 2 * prog.margin;
  const unsigned int gx = (pitch + cols - 1) / cols;
  return launch_row_runs(hp, E::kRows, [&](unsigned int gy, int row0) {
    window_taps<E><<<dim3(gx, gy, channels), kTapsThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const typename E::Pixel*>(in),
        static_cast<typename E::Pixel*>(out), hp, pitch, row0, prog);
  });
}

}  // namespace taps
}  // namespace dip
