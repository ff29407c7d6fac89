// Windowed kernels of the uint8 benchmark matrix: erosions, convolutions
// and the specialised 3x3 blur on one stencil skeleton,
// window_u8_strip<Body>; and the library surface's morphology: dilation by
// the 3x3 elements on the same skeleton, any other structuring element on
// window_taps<U8<TapsMin|TapsMax>> (taps.cuh: a program of horizontal run
// tables and a vertical pass over a tile in shared memory, built on the
// host for the element; launches counted as window_u8<Taps<Min|Max>>).
//
// Replaces (dip_benchmark_tpu/ops/pallas/window.py):
//   window_u8_strip<Body>     <- _windowed_call (the banded DMA skeleton)
//   MinPlus, MinRect          <- _make_morphology via make_erosion
//                                (body_plus, body_rect)
//   MaxPlus, MaxRect          <- _make_morphology via make_dilation
//                                (body_plus, body_rect with max)
//   MinSep                    <- make_erosion_separated_fused
//   ConvRank1<KH, KW>         <- make_convolution (body_rank1)
//   ConvDense<KH, KW>         <- make_convolution (body_packed, body_i32)
//   ConvSep<N>                <- make_convolution_separated_fused
//   Blur3x3                   <- make_gaussian_blur_3x3
//   window_taps<U8<TapsMin>>, <- body_generic of _make_morphology, via
//   window_taps<U8<TapsMax>>     make_erosion and make_dilation
//
// Bound: device-memory bandwidth for the compulsory traffic, the padded
// buffer read once and written once (14.75 us for the 3504x2336 planar on
// an H100), and, close behind it, integer issue: at that time the card has
// about ten integer instructions per output byte.
//
// Design of window_u8_strip. The first version gave one thread each output
// byte and issued one byte load per tap, so its time tracked the taps (6 to
// 10.5x the byte bound). Here a thread owns kWords aligned 32-bit words of
// a row and walks down a strip of kStripRows output rows:
// - each input row is read once per strip, one load per thread, issued
//   kPrefetchRows rows before its use so that several are in flight; the
//   words on either side come from the neighbouring lanes by warp shuffle,
//   and the warp's edge lanes load the one word beyond. No lane branches
//   around a load: a lane past the row's end, or at its ends, loads a word
//   of the row whose bytes reach only the zero ring, which a byte mask
//   writes as 0. Rows outside [0, Hp) are never loaded;
// - a body reduces each input row once to a per-row partial (a horizontal
//   min, a horizontal pass of a convolution) and keeps the last 2 * HY + 1
//   of them in registers, a ring that the unrolled strip loop renames
//   rather than moves; the output row is a vertical pass over the ring;
// - the morphology bodies, the blur and the rank-1 convolutions split each
//   word's bytes into two registers of 16-bit fields (even and odd bytes,
//   one PRMT each; the neighbours' by funnel shift) and work on two outputs
//   an instruction: min and max are one VIMNMX.U16x2 (__vminu4/__vmaxu4 on
//   four bytes compile to a sequence of logic ops on sm_90a), and the
//   convolutions' fields never carry into each other (the JAX package's
//   packed-16 proof: nonnegative weights, 255 * sum(mask) < 2^16), at
//   KH + KW multiply-adds an output pair for ConvRank1; ConvSep and the
//   general ConvDense, whose masks may be negative, use one int32 an
//   output;
// - an interior strip, whose rows all lie inside the plane and outside
//   the zero ring, runs a copy of the walk with no row checks.
// What is left is integer issue: the field bodies spend 7 to 15 SASS
// instructions an output byte (benchmarks/h100/window_lab.py --sass).
//
// The output has the input's (C, Hp, pitch) shape and every byte is
// written: the body's value wherever all taps lie in the buffer, 0 in the
// outer HY rows and HX columns. Runtime masks travel by value in the body
// struct (the analogue of the TPU kernel's SMEM scalars); Blur3x3 has its
// weights compiled in, because op #14 measures that specialisation.
#include "common.cuh"
#include "words.cuh"
#include "taps.cuh"

namespace {

// The strip's output rows, the rows a load runs ahead of its use, and the
// words a thread of the 16-bit-field bodies (morphology, Blur3x3,
// ConvRank1) and of the int32 bodies (ConvSep, ConvDense) owns: the
// fastest settings on the H100 (benchmarks/h100/window_lab.py times
// others).
constexpr int kStripRows = 16;
constexpr int kPrefetchRows = 4;
constexpr int kFieldWords = 2;
constexpr int kIntWords = 1;
constexpr int kStripThreads = 128;
constexpr unsigned kFullWarp = 0xffffffffu;

// -- word helpers: words.cuh ------------------------------------------------

using dip::byte_at;
using dip::clamp_u8;
using dip::even_bytes;
using dip::field_pair;
using dip::FieldMax;
using dip::FieldMin;
using dip::half_of;
using dip::odd_bytes;
using dip::pack_bytes;
using dip::pack_fields;

// -- bodies -----------------------------------------------------------------
//
// A body has HY, HX and kWords; a Row type, the per-input-row partial of
// the thread's span; row(x), which makes it; and out(ring, o), which makes
// the span's output words from the 2 * HY + 1 rows around the output row,
// ring[0] the topmost. The bodies that carry fields keep, for each word,
// one register for its even output bytes (0, 2) and one for its odd ones.

// 3x3 square: the min (max) of three taps per row, then of three rows.
template <class Op>
struct Rect {
  static constexpr int HY = 1, HX = 1, kWords = kFieldWords;
  static constexpr int W = kWords;
  struct Row {
    uint32_t e[W], o[W];
  };
  __device__ __forceinline__ Row row(const uint32_t (&x)[W + 2]) const {
    Row r;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t f0 = field_pair<W>(x, i, 0), f1 = field_pair<W>(x, i, 1);
      r.e[i] = Op::apply(Op::apply(field_pair<W>(x, i, -1), f0), f1);
      r.o[i] = Op::apply(Op::apply(f0, f1), field_pair<W>(x, i, 2));
    }
    return r;
  }
  __device__ __forceinline__ void out(const Row (&ring)[3],
                                      uint32_t (&o)[W]) const {
#pragma unroll
    for (int i = 0; i < W; ++i)
      o[i] = pack_fields(
          Op::apply(Op::apply(ring[0].e[i], ring[1].e[i]), ring[2].e[i]),
          Op::apply(Op::apply(ring[0].o[i], ring[1].o[i]), ring[2].o[i]));
  }
};

// 3x3 cross: the centre row's horizontal min (max) against the centre
// column of the rows above and below.
template <class Op>
struct Plus {
  static constexpr int HY = 1, HX = 1, kWords = kFieldWords;
  static constexpr int W = kWords;
  struct Row {
    uint32_t ce[W], co[W], he[W], ho[W];
  };
  __device__ __forceinline__ Row row(const uint32_t (&x)[W + 2]) const {
    Row r;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      r.ce[i] = field_pair<W>(x, i, 0);
      r.co[i] = field_pair<W>(x, i, 1);
      r.he[i] = Op::apply(Op::apply(field_pair<W>(x, i, -1), r.ce[i]),
                          r.co[i]);
      r.ho[i] = Op::apply(Op::apply(r.ce[i], r.co[i]),
                          field_pair<W>(x, i, 2));
    }
    return r;
  }
  __device__ __forceinline__ void out(const Row (&ring)[3],
                                      uint32_t (&o)[W]) const {
#pragma unroll
    for (int i = 0; i < W; ++i)
      o[i] = pack_fields(
          Op::apply(Op::apply(ring[0].ce[i], ring[2].ce[i]), ring[1].he[i]),
          Op::apply(Op::apply(ring[0].co[i], ring[2].co[i]), ring[1].ho[i]));
  }
};

struct MinRect : Rect<FieldMin> {};
struct MinPlus : Plus<FieldMin> {};
struct MaxRect : Rect<FieldMax> {};
struct MaxPlus : Plus<FieldMax> {};
// 3x1 column min, then 1x3 min over the column mins: the 3x3 square's min,
// which is exact in any order, so the row-then-column walk of Rect.
struct MinSep : Rect<FieldMin> {};

// Op #14: 1-2-1 x 1-2-1 with the weights compiled in, one rounding
// (o + 8) >> 4, on two outputs a register: the horizontal sums are at most
// 1020 and the full sum 4080 + 8 < 2^16, so the fields never carry and the
// result never needs a clamp.
struct Blur3x3 {
  static constexpr int HY = 1, HX = 1, kWords = kFieldWords;
  static constexpr int W = kWords;
  struct Row {
    uint32_t e[W], o[W];
  };
  __device__ __forceinline__ Row row(const uint32_t (&x)[W + 2]) const {
    Row r;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t f0 = field_pair<W>(x, i, 0), f1 = field_pair<W>(x, i, 1);
      r.e[i] = field_pair<W>(x, i, -1) + (f0 << 1) + f1;
      r.o[i] = f0 + (f1 << 1) + field_pair<W>(x, i, 2);
    }
    return r;
  }
  __device__ __forceinline__ void out(const Row (&ring)[3],
                                      uint32_t (&o)[W]) const {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t e = ring[0].e[i] + (ring[1].e[i] << 1) + ring[2].e[i];
      const uint32_t d = ring[0].o[i] + (ring[1].o[i] << 1) + ring[2].o[i];
      o[i] = pack_fields(((e + 0x00080008u) >> 4) & 0x0fff0fffu,
                         ((d + 0x00080008u) >> 4) & 0x0fff0fffu);
    }
  }
};

// A rank-1 mask outer(u, v) with nonnegative integer factors and
// 255 * sum(mask) < 2^16 (the routing in ops/window.py guarantees both): an
// unrounded row pass with v, a column pass with u over the ring, then one
// (acc + half) >> shift and a clamp, on two outputs a register. Integer
// sums are exact, so this is bit-identical to the dense form, at KH + KW
// multiply-adds an output pair instead of KH * KW an output. kFieldwise
// rounds each field on its own: for a shift above 15, or where the rounding
// add could carry from one field into the next.
template <int KH, int KW, bool kFieldwise>
struct ConvRank1 {
  static constexpr int HY = KH / 2, HX = KW / 2, kWords = kFieldWords;
  static constexpr int W = kWords;
  uint32_t u[KH], v[KW];
  int shift;
  uint32_t half;
  uint32_t limit;  // 0x00ff00ff where a field can round above 255, else ~0
  struct Row {
    uint32_t e[W], o[W];
  };
  __device__ __forceinline__ Row row(const uint32_t (&x)[W + 2]) const {
    Row r;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      uint32_t e = 0, d = 0;
#pragma unroll
      for (int kx = 0; kx < KW; ++kx) {
        e += v[kx] * field_pair<W>(x, i, kx - HX);
        d += v[kx] * field_pair<W>(x, i, kx - HX + 1);
      }
      r.e[i] = e;
      r.o[i] = d;
    }
    return r;
  }
  // Both fields of acc rounded and clamped: with one add, shift and mask
  // (the JAX package's swar_requant), or field by field.
  __device__ __forceinline__ uint32_t round(uint32_t acc) const {
    uint32_t t;
    if constexpr (kFieldwise) {
      t = ((acc & 0xffffu) + half) >> shift | ((acc >> 16) + half) >> shift
                                                  << 16;
    } else {
      t = ((acc + half * 0x00010001u) >> shift) &
          ((0xffffu >> shift) * 0x00010001u);
    }
    return __vminu2(t, limit);
  }
  __device__ __forceinline__ void out(const Row (&ring)[KH],
                                      uint32_t (&o)[W]) const {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      uint32_t e = 0, d = 0;
#pragma unroll
      for (int ky = 0; ky < KH; ++ky) {
        e += u[ky] * ring[ky].e[i];
        d += u[ky] * ring[ky].o[i];
      }
      o[i] = pack_fields(round(e), round(d));
    }
  }
};

// Dense KH x KW correlation with any runtime integer mask: one int32 sum an
// output, one round-half-up (acc + half) >> shift, clamp to [0, 255]. The
// ring holds each input row's bytes, unpacked once.
template <int KH, int KW>
struct ConvDense {
  static constexpr int HY = KH / 2, HX = KW / 2, kWords = kIntWords;
  static constexpr int W = kWords, kBytes = 4 * W + 2 * HX;
  int w[KH * KW];
  int shift, half;
  struct Row {
    int b[kBytes];
  };
  __device__ __forceinline__ Row row(const uint32_t (&x)[W + 2]) const {
    Row r;
#pragma unroll
    for (int b = 0; b < kBytes; ++b) r.b[b] = byte_at<W>(x, b - HX);
    return r;
  }
  __device__ __forceinline__ void out(const Row (&ring)[KH],
                                      uint32_t (&o)[W]) const {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      int v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int acc = 0;
#pragma unroll
        for (int ky = 0; ky < KH; ++ky)
#pragma unroll
          for (int kx = 0; kx < KW; ++kx)
            acc += w[ky * KW + kx] * ring[ky].b[4 * i + j + kx];
        v[j] = clamp_u8((acc + half) >> shift);
      }
      o[i] = pack_bytes(v);
    }
  }
};

// 1xN pass with the row mask, rounded and clamped to u8 before it enters
// the ring, then an Nx1 pass with the column mask over the ring, rounded
// and clamped again. The pass order and the rounding of the intermediate
// are part of the answer: a single rounding is not bit-exact. The baked
// mirror rows make the ring equal to the mirrored intermediate of the
// two-pass reference.
template <int N>
struct ConvSep {
  static constexpr int HY = N / 2, HX = N / 2, kWords = kIntWords;
  static constexpr int W = kWords;
  int wr[N], wc[N];
  int shift, half;
  struct Row {
    int r[4 * W];
  };
  __device__ __forceinline__ Row row(const uint32_t (&x)[W + 2]) const {
    int b[4 * W + 2 * HX];
#pragma unroll
    for (int k = 0; k < 4 * W + 2 * HX; ++k) b[k] = byte_at<W>(x, k - HX);
    Row r;
#pragma unroll
    for (int j = 0; j < 4 * W; ++j) {
      int acc = 0;
#pragma unroll
      for (int kx = 0; kx < N; ++kx) acc += wr[kx] * b[j + kx];
      r.r[j] = clamp_u8((acc + half) >> shift);
    }
    return r;
  }
  __device__ __forceinline__ void out(const Row (&ring)[N],
                                      uint32_t (&o)[W]) const {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      int v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int acc = 0;
#pragma unroll
        for (int ky = 0; ky < N; ++ky) acc += wc[ky] * ring[ky].r[4 * i + j];
        v[j] = clamp_u8((acc + half) >> shift);
      }
      o[i] = pack_bytes(v);
    }
  }
};

// -- the strip skeleton -----------------------------------------------------

// One input row as a thread loads it: its W words and the word beyond
// them, which only the warp's edge lanes use.
template <int W>
struct RowLoad {
  uint32_t own[W];
  uint32_t edge;
};

// Row y of the plane (words 32-bit words a row): the words at column at,
// and the word at column beyond. A lane past the row's end loads the last
// W words and an edge lane at the row's ends loads its own end word in
// place of the one beyond: what they load reaches only the zero ring's
// columns, and no lane branches. kChecked strips load nothing for a row
// outside [0, hp), and give zeros.
template <int W, bool kChecked>
__device__ __forceinline__ RowLoad<W> fetch_row(
    const uint32_t* __restrict__ plane, int y, int hp, int words, int at,
    int beyond) {
  RowLoad<W> r;
  if (kChecked && (y < 0 || y >= hp)) {
#pragma unroll
    for (int i = 0; i < W; ++i) r.own[i] = 0;
    r.edge = 0;
    return r;
  }
  const uint32_t* row = plane + static_cast<size_t>(y) * words;
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + at);
    r.own[0] = v.x, r.own[1] = v.y, r.own[2] = v.z, r.own[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + at);
    r.own[0] = v.x, r.own[1] = v.y;
  } else {
    r.own[0] = row[at];
  }
  r.edge = row[beyond];
  return r;
}

// The loaded row as the thread's view x (see "word helpers"): the words on
// either side from the adjacent lanes, the edge lanes' from their own
// load. Every lane of the warp calls this.
template <int W>
__device__ __forceinline__ void spread_row(const RowLoad<W>& r, int lane,
                                           uint32_t (&x)[W + 2]) {
  const uint32_t left = __shfl_up_sync(kFullWarp, r.own[W - 1], 1);
  const uint32_t right = __shfl_down_sync(kFullWarp, r.own[0], 1);
  x[0] = lane == 0 ? r.edge : left;
#pragma unroll
  for (int i = 0; i < W; ++i) x[i + 1] = r.own[i];
  x[W + 1] = lane == 31 ? r.edge : right;
}

// One strip: output rows [y0, y0 + kStripRows) of the thread's word column,
// from input rows [y0 - HY, y0 + kStripRows + HY), each loaded once and
// kPrefetchRows rows ahead of its use, so that many loads are in flight
// per thread. An interior strip (kChecked false) reads and writes only
// rows inside the plane and no row of the zero ring; the others check.
template <class Body, bool kChecked>
__device__ __forceinline__ void strip_walk(const Body& body,
                                           const uint32_t* __restrict__ src,
                                           uint32_t* __restrict__ dst, int hp,
                                           int words, int wx, int lane,
                                           int y0) {
  constexpr int W = Body::kWords, HY = Body::HY, HX = Body::HX;
  constexpr int K = 2 * HY + 1, R = kStripRows + 2 * HY;
  constexpr int D = kPrefetchRows < R ? kPrefetchRows : R;
  using Row = typename Body::Row;
  const bool live = wx < words;
  const int at = live ? wx : words - W;
  const int beyond = min(max(lane == 0 ? wx - 1 : wx + W, 0), words - 1);
  // The zero ring's columns: the first HX bytes of a row, the last HX.
  uint32_t keep[W];
#pragma unroll
  for (int i = 0; i < W; ++i) keep[i] = ~0u;
  if (wx == 0) keep[0] = ~0u << (8 * HX);
  if (wx + W == words) keep[W - 1] &= ~0u >> (8 * HX);

  RowLoad<W> q[R];
#pragma unroll
  for (int i = 0; i < D; ++i)
    q[i] = fetch_row<W, kChecked>(src, y0 - HY + i, hp, words, at, beyond);
  Row ring[K];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i + D < R)
      q[i + D] = fetch_row<W, kChecked>(src, y0 - HY + i + D, hp, words, at,
                                        beyond);
    uint32_t x[W + 2];
    spread_row<W>(q[i], lane, x);
    ring[i < K - 1 ? i : K - 1] = body.row(x);
    if (i < K - 1) continue;
    const int y = y0 + i - (K - 1);
    uint32_t o[W];
    body.out(ring, o);
    const bool ring_row = kChecked && (y < HY || y >= hp - HY);
#pragma unroll
    for (int j = 0; j < W; ++j) o[j] = ring_row ? 0u : o[j] & keep[j];
    if (live && (!kChecked || y < hp)) {
      uint32_t* p = dst + static_cast<size_t>(y) * words + wx;
      if constexpr (W == 4) {
        *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
      } else if constexpr (W == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(o[0], o[1]);
      } else {
        *p = o[0];
      }
    }
#pragma unroll
    for (int r = 0; r < K - 1; ++r) ring[r] = ring[r + 1];
  }
}

// in and out are (C, Hp, pitch), pitch a multiple of 16; the grid is
// (words / (W * kStripThreads), Hp / kStripRows, C), rounded up, in runs of
// at most 65,535 strips from row row0 (dip::launch_row_runs).
template <class Body>
__global__ void __launch_bounds__(kStripThreads)
    window_u8_strip(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int hp, int pitch, int row0, const Body body) {
  static_assert(Body::HX >= 1 && Body::HX < 4,
                "the neighbour words hold 1 to 3 bytes");
  const int words = pitch >> 2;
  const int lane = threadIdx.x & 31;
  const int wx = (blockIdx.x * kStripThreads + threadIdx.x) * Body::kWords;
  const int y0 = row0 + blockIdx.y * kStripRows;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * pitch;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(in + plane);
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + plane);
  if (y0 >= Body::HY && y0 + kStripRows + Body::HY <= hp)
    strip_walk<Body, false>(body, src, dst, hp, words, wx, lane, y0);
  else
    strip_walk<Body, true>(body, src, dst, hp, words, wx, lane, y0);
}

template <class Body>
int launch_strip(const void* in, void* out, int channels, int hp, int pitch,
                 const Body& body, void* stream) {
  if (pitch % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kStripThreads * Body::kWords;
  const unsigned int gx = (pitch / 4 + per_block - 1) / per_block;
  return dip::launch_row_runs(hp, kStripRows, [&](unsigned int gy, int row0) {
    window_u8_strip<Body><<<dim3(gx, gy, channels), kStripThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), hp,
        pitch, row0, body);
  });
}

template <int KH, int KW>
int launch_conv_dense(const void* in, void* out, int channels, int hp,
                      int pitch, const int* w, int shift, void* stream) {
  ConvDense<KH, KW> body;
  for (int i = 0; i < KH * KW; ++i) body.w[i] = w[i];
  body.shift = shift;
  body.half = half_of(shift);
  return launch_strip(in, out, channels, hp, pitch, body, stream);
}

template <int KH, int KW>
int launch_conv_rank1(const void* in, void* out, int channels, int hp,
                      int pitch, const int* u, const int* v, int shift,
                      void* stream) {
  long su = 0, sv = 0;
  for (int i = 0; i < KH; ++i) su += u[i];
  for (int i = 0; i < KW; ++i) sv += v[i];
  // The packed-16 proof: every field of every sum stays below 2^16.
  const long top = 255 * su * sv;
  const long half = half_of(shift);
  if (top >= (1 << 16) || shift < 0 || shift > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < KH; ++i)
    if (u[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < KW; ++i)
    if (v[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto body) {
    for (int i = 0; i < KH; ++i) body.u[i] = static_cast<uint32_t>(u[i]);
    for (int i = 0; i < KW; ++i) body.v[i] = static_cast<uint32_t>(v[i]);
    body.shift = shift;
    body.half = static_cast<uint32_t>(half);
    body.limit = ((top + half) >> shift) > 255 ? 0x00ff00ffu : ~0u;
    return launch_strip(in, out, channels, hp, pitch, body, stream);
  };
  if (shift > 15 || top + half >= (1 << 16))
    return run(ConvRank1<KH, KW, true>{});
  return run(ConvRank1<KH, KW, false>{});
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
  body.half = half_of(shift);
  return launch_strip(in, out, channels, hp, pitch, body, stream);
}

// -- any structuring element: the program of taps.cuh ------------------------

struct TapsMin : FieldMin {
  static constexpr uint32_t kIdentity = 0xffffffffu;
};
struct TapsMax : FieldMax {
  static constexpr uint32_t kIdentity = 0;
};

}  // namespace

DIP_API int dip_erosion_rect_u8(const void* in, void* out, int channels,
                                int hp, int pitch, void* stream) {
  return launch_strip(in, out, channels, hp, pitch, MinRect{}, stream);
}

DIP_API int dip_erosion_plus_u8(const void* in, void* out, int channels,
                                int hp, int pitch, void* stream) {
  return launch_strip(in, out, channels, hp, pitch, MinPlus{}, stream);
}

DIP_API int dip_erosion_sep_u8(const void* in, void* out, int channels,
                               int hp, int pitch, void* stream) {
  return launch_strip(in, out, channels, hp, pitch, MinSep{}, stream);
}

DIP_API int dip_blur3x3_u8(const void* in, void* out, int channels, int hp,
                           int pitch, void* stream) {
  return launch_strip(in, out, channels, hp, pitch, Blur3x3{}, stream);
}

// kh x kw is 3x3 or 5x5; w holds kh * kw weights in row-major order.
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

// The mask outer(u, v): u the kh column factors, v the kw row factors,
// kh x kw 3x3 or 5x5, both nonnegative with 255 * sum(u) * sum(v) < 2^16.
DIP_API int dip_conv_rank1_u8(const void* in, void* out, int channels, int hp,
                              int pitch, int kh, int kw, const int* u,
                              const int* v, int shift, void* stream) {
  if (kh == 3 && kw == 3)
    return launch_conv_rank1<3, 3>(in, out, channels, hp, pitch, u, v, shift,
                                   stream);
  if (kh == 5 && kw == 5)
    return launch_conv_rank1<5, 5>(in, out, channels, hp, pitch, u, v, shift,
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

DIP_API int dip_dilation_rect_u8(const void* in, void* out, int channels,
                                 int hp, int pitch, void* stream) {
  return launch_strip(in, out, channels, hp, pitch, MaxRect{}, stream);
}

DIP_API int dip_dilation_plus_u8(const void* in, void* out, int channels,
                                 int hp, int pitch, void* stream) {
  return launch_strip(in, out, channels, hp, pitch, MaxPlus{}, stream);
}

// Any structuring element: program holds the n int32 words of its program
// (ops/window.py TapsProgram.encode), parsed and checked here.
DIP_API int dip_erosion_taps_u8(const void* in, void* out, int channels,
                                int hp, int pitch, const int* program, int n,
                                void* stream) {
  return dip::taps::launch<dip::taps::U8<TapsMin>>(
      in, out, channels, hp, pitch, program, n, stream);
}

DIP_API int dip_dilation_taps_u8(const void* in, void* out, int channels,
                                 int hp, int pitch, const int* program, int n,
                                 void* stream) {
  return dip::taps::launch<dip::taps::U8<TapsMax>>(
      in, out, channels, hp, pitch, program, n, stream);
}
