// Fused op chains: any sequence of the matrix's device ops in one kernel,
// in the uint8 model (chain_u8) and the float32 model (chain_f32), over one
// planar padded image (C, Hp, pitch) or a stack of them (B, C, Hp, pitch).
//
// Replaces (dip_benchmark_tpu/models/chain.py):
//   chain_u8   <- make_fused_chain (:362): per channel, batched, and
//                 Grayscale first (_make_gray_chain, :530)
//   chain_f32  <- make_fused_chain_f32 (:473), the same three modes
//
// The chain is user input (--fuse, the batch tool's --op A,B,...) and the
// library is built once from the repository's sources, so the stages come
// at run time: an int32 descriptor in device memory (models/chain.py
// _encode), per stage the words kind, kh, kw, shift and a payload: one word
// for a point stage, the kh * kw taps of a "min", and for a "conv" the rank-1
// factors u (kh words) and v (kw words) of its mask in uint8, its kh * kw
// float weights in float32. All threads of a block read the same descriptor
// word at the same time, so those reads are broadcasts. Point stages are not
// capped in number; the windowed ones are a 3x3 min (cross or square) and
// kh x kw correlations (3x3, 5x5, 1x3, 3x1, 1x5, 5x1), whose radii sum to at
// most kMaxRadius.
//
// Bound: device-memory bandwidth. The planar buffer, baked with the chain's
// halo, is read once and written once (2 * C * Hp * pitch elements, 14.77 us
// for uint8 at 3504x2336 on an H100); a stage does at most 25 multiply-adds
// a position.
//
// Whole-buffer contract: the output has the input's shape; the outer ring
// of Ry rows and Rx columns is 0 and every other element is the stages
// composed. An output inside the ring reads, through the stages, only
// inputs inside the buffer, and none of the intermediates it needs lies in
// the zero ring that an earlier stage writes when the stages run one after
// another (models/chain.py fused_chain_plain), so the kernel equals that
// plain version on the whole buffer at tolerance 0, in both data models.
// Tile positions outside the buffer load as 0 and reach only ring outputs.
//
// chain_u8, the design (its first version did one shared-memory byte load
// a tap and an int32 multiply-add an output, and decoded the point stages
// for every output: 237 us for C1, 4x its unfused kernels). It carries over
// what window_u8_strip (window.cu) measured to work:
// - a block owns a tile of kTileRows output rows and kTileWords aligned
//   32-bit words of a row, halo included (kHaloWords a side), and loads it
//   once, with the chain's Ry rows a side, into shared memory as vectors of
//   kHaloWords words, kLoadBatch of them in flight a thread (gray first: the
//   luma of the three planes' words);
// - each windowed stage reads the tile and writes the other of two buffers,
//   each shrinking the rows it computes by its ry. A thread owns one word
//   column and walks a strip of rows down it: it reads each input row once
//   (its word and the two beside it, three conflict-free loads at fixed
//   offsets), makes a per-row partial, and keeps the last 2 ry + 1 of them
//   in a register ring that the loop, unrolled by whole turns of the ring,
//   renames rather than moves;
// - the stages work on two 16-bit fields a register (even and odd bytes,
//   words.cuh), two outputs an instruction: min is __vminu2, one
//   VIMNMX.U16x2 (__vminu4 is emulated on sm_90a); a conv stage is rank 1
//   (every chain mask is a nonnegative Gaussian that factors; the host
//   refuses one that does not), KH + KW multiply-adds an output pair, one
//   rounding (acc + half) >> shift a field. The JAX chain's packed-16 proof
//   holds at every stage, since each stage requantizes to u8
//   (chain.py:387-417): 255 * sum(u) * sum(v) + half < 2^16, checked on the
//   host copy, so no field carries into the next and integer sums are exact
//   in any order. Where no rounded field can pass 255 (every chain mask), the
//   clamp and the mask of the rounding go; a 1xN stage and the Nx1 stage
//   right after it (a separated convolution) run as one walk;
// - the point stages after a windowed stage (or before the first) are
//   folded once per stage into one byte-SIMD operation on the word it
//   writes: threshold ((w >> 7) & 0x01010101) * 0xff, then invert w ^ flip;
//   a stage with no point stage after it (most) runs a walk without it;
// - the horizontal halo is recomputed by every stage but the last words'
//   outputs are never stored: a byte's window shrinks the valid region by
//   the stage's rx, and 4 * kHaloWords >= Rx.
// What bounds it is integer issue: the stages spend 4-14 SASS instructions
// an output byte, and the H100 runs integer instructions at half the rate
// of float ones. benchmarks/h100/chain_lab.py times the tile settings (the
// defaults are its fastest) and counts the SASS of each stage's loop. It
// also times the other design, one ring for all stages and no shared
// memory (benchmarks/h100/chain_stream.cuh, the stages compiled in): 15 to
// 115 % slower on every chain, since each stage loses the words at a
// warp's ends, a strip recomputes 2 Ry rows, and its global loads and
// stores are one word a lane.
//
// chain_f32, the design (its first version loaded a window of
// scalars from a float tile for every strip of two outputs, one LDS a tap,
// and stored one float a lane: it lost to the port's unfused kernels on
// C1, C3 and C4). It carries over what window_f32_strip (f32.cu) measured
// to work, on chain_u8's tile:
// - a block owns a tile of kChainRows output rows and 4 kTileF4 floats of a
//   row, halo included (kHaloF4 float4 a side), and loads it once, with the
//   chain's Ry rows a side, as float4 (gray first: the luma of the three
//   planes' float4), through the point stages before the first windowed
//   one;
// - each windowed stage but the last reads one tile buffer and writes the
//   other; the last writes the output planes itself (its own float4, 0 in
//   the ring), so the other buffer is free while it runs. A block stays
//   resident and takes tile after tile (one block per resident slot of
//   the card), and during a tile's last stage the next tile is copied
//   into the free buffer in the background (cp.async, no registers), so
//   its load overlaps this tile's compute; a Grayscale-first chain, whose
//   load computes the luma, loads each tile directly. A warp
//   owns 32 lanes of kChainVecs float4 of a row and walks a strip of the
//   stage's rows: a lane reads each input row once, one 16-byte shared
//   load a float4, the HX <= 2 floats on either side from the adjacent
//   lanes by shuffle (the warp's edge lanes from one 8-byte load), and
//   keeps a register ring of the last 2 HY + 1 rows that the loop,
//   unrolled by whole turns of the ring, renames rather than moves;
// - the arithmetic is the JAX stage order, every multiply and add
//   __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA: a dense
//   stage (_conv_rank1_f32) sums each mask column over ky, then the column
//   sums over kx, so its ring holds raw rows (no rank-1 shortcut keeps that
//   order); a 1xN stage and the Nx1 stage right after it
//   (_conv_separated_f32) run as one walk, the row pass in kx order making
//   the ring entry and the column pass adding the entries in ky order; the
//   luma is (wr * R + wg * G) + wb * B;
// - a run of point stages is folded once per stage (RunF32) and applied to
//   the walk's outputs before they are stored; a stage with no point stage
//   after it runs a walk without it.
// What bounds it is FP32 issue: a 5x5 stage walk spends about 55 SASS an
// output, 49 of them the stage's own multiplies and adds, which no order-
// keeping rewrite removes. benchmarks/h100/chain_lab.py times the tile
// settings (the defaults are its fastest) and counts the SASS an output of
// each stage walk.
#include <cuda_pipeline.h>

#include "common.cuh"
#include "words.cuh"

namespace {

// Stage kinds, as models/chain.py KINDS numbers them.
constexpr int kCopy = 0;
constexpr int kInvert = 1;
constexpr int kThreshold = 2;
constexpr int kMin = 3;
constexpr int kConv = 4;
constexpr int kHeader = 4;     // kind, kh, kw, shift; then the payload
constexpr int kMaxRadius = 8;  // models/chain.py MAX_CHAIN_RADIUS

// spec.THRESHOLD_VALUE and spec.THRESHOLD_MAX; a test holds these lines
// equal to the spec. The byte-SIMD threshold reads bit 7 of each byte.
constexpr int kThresholdU8 = 127;
constexpr int kThresholdMaxU8 = 255;
static_assert(kThresholdU8 == 127 && kThresholdMaxU8 == 255,
              "the word threshold is bit 7 of each byte, times 0xff");

// -- chain_u8 ---------------------------------------------------------------

using dip::field_pair;
using dip::half_of;
using dip::pack_fields;

// The tile (the fastest settings on the H100; chain_lab.py times others).
constexpr int kTileWords = 64;   // words of a tile row, halo included
constexpr int kTileRows = 96;    // output rows of a tile
constexpr int kU8Block = 256;    // threads of a block
constexpr int kU8BlocksPerSM = 3;
constexpr int kLoadBatch = 8;    // global loads a thread keeps in flight
// Halo words a tile side, also the words of one global load or store
// (uint2 or uint4; the tiles then start on such a vector).
constexpr int kHaloWords = 4;
// Strips a stage's rows split into: a thread owns column
// threadIdx.x % kTileWords and strip threadIdx.x / kTileWords.
constexpr int kGroups = kU8Block / kTileWords;
constexpr int kRowVecs = kTileWords / kHaloWords;  // vectors a tile row
// A tile row in shared memory: kHaloWords words of slack a side, so that
// the edge columns read a neighbour (which reaches only halo bytes) at the
// same immediate offsets as every other column.
constexpr int kStride = kTileWords + 2 * kHaloWords;
static_assert(kU8Block % kTileWords == 0, "whole word columns a block");
static_assert((kHaloWords == 2 || kHaloWords == 4) &&
                  kTileWords % kHaloWords == 0 && 4 * kHaloWords >= kMaxRadius,
              "halo vectors of 2 or 4 words that cover the deepest chain");

// kHaloWords words as one vector of a global or shared load or store.
template <int N>
struct WordVec;
template <>
struct WordVec<2> {
  using T = uint2;
  __device__ static void split(const T& v, uint32_t (&w)[2]) {
    w[0] = v.x, w[1] = v.y;
  }
  __device__ static T join(const uint32_t (&w)[2]) {
    return make_uint2(w[0], w[1]);
  }
};
template <>
struct WordVec<4> {
  using T = uint4;
  __device__ static void split(const T& v, uint32_t (&w)[4]) {
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
  __device__ static T join(const uint32_t (&w)[4]) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
using Vec = WordVec<kHaloWords>;

// A run of point stages folded into one operation on a word of four bytes:
// threshold (if the run has one), then xor with flip (0 or ~0, an odd
// number of inversions). Any run folds so: an inversion flips, and a
// threshold of an inverted byte is the inverted threshold of the byte,
// since 255 - v > 127 exactly when v <= 127.
struct PointRun {
  bool threshold;
  uint32_t flip;
  __device__ __forceinline__ uint32_t operator()(uint32_t w) const {
    if (threshold) w = ((w >> 7) & 0x01010101u) * 0xffu;
    return w ^ flip;
  }
  __device__ __forceinline__ bool identity() const {
    return !threshold && flip == 0u;
  }
};

// Fold the point stages at *d, at most n_stages - *s of them.
__device__ PointRun fold_points(const int** d, int* s, int n_stages) {
  PointRun run{false, 0u};
  while (*s < n_stages) {
    const int kind = __ldg(*d);
    if (kind == kInvert)
      run.flip = ~run.flip;
    else if (kind == kThreshold)
      run.threshold = true;
    else if (kind != kCopy)
      break;
    *d += kHeader + 1;
    ++*s;
  }
  return run;
}

// A stage body: HY, HX; Row, the per-input-row partial of a thread's word;
// row(x), made from the word x[1] and the words beside it; out(ring, k),
// the output word from the 2 HY + 1 partials around the output row, row i
// from the top being ring[(k + i) % K]. Fields as in words.cuh: e the word's
// even output bytes (0, 2), o its odd ones (1, 3).

// 3x3 square: the min of three taps per row, then of three rows.
struct MinSquare {
  static constexpr int HY = 1, HX = 1;
  struct Row {
    uint32_t e, o;
  };
  __device__ __forceinline__ Row row(const uint32_t (&x)[3]) const {
    const uint32_t f0 = field_pair<1>(x, 0, 0), f1 = field_pair<1>(x, 0, 1);
    return {__vminu2(__vminu2(field_pair<1>(x, 0, -1), f0), f1),
            __vminu2(__vminu2(f0, f1), field_pair<1>(x, 0, 2))};
  }
  template <int K>
  __device__ __forceinline__ uint32_t out(const Row (&r)[K], int k) const {
    const Row &a = r[k % K], &b = r[(k + 1) % K], &c = r[(k + 2) % K];
    return pack_fields(__vminu2(__vminu2(a.e, b.e), c.e),
                       __vminu2(__vminu2(a.o, b.o), c.o));
  }
};

// 3x3 cross: the centre row's horizontal min against the centre column of
// the rows above and below.
struct MinCross {
  static constexpr int HY = 1, HX = 1;
  struct Row {
    uint32_t ce, co, he, ho;
  };
  __device__ __forceinline__ Row row(const uint32_t (&x)[3]) const {
    const uint32_t ce = field_pair<1>(x, 0, 0), co = field_pair<1>(x, 0, 1);
    return {ce, co, __vminu2(__vminu2(field_pair<1>(x, 0, -1), ce), co),
            __vminu2(__vminu2(ce, co), field_pair<1>(x, 0, 2))};
  }
  template <int K>
  __device__ __forceinline__ uint32_t out(const Row (&r)[K], int k) const {
    const Row &a = r[k % K], &b = r[(k + 1) % K], &c = r[(k + 2) % K];
    return pack_fields(__vminu2(__vminu2(a.ce, c.ce), b.he),
                       __vminu2(__vminu2(a.co, c.co), b.ho));
  }
};

// The even-output and odd-output fields of a word.
struct Fields {
  uint32_t e, o;
};

// The correlation with outer(u, v): an unrounded row pass with v, a column
// pass with u over the ring, then (acc + half) >> shift a field, the bits
// shifted in from the field above cleared, and a clamp to 255. The host
// checked the field bound, so no sum carries into the next field. A factor
// of one tap (u of a 1xN stage, v of an Nx1) is folded into the other
// factors (conv_body). kExact: every rounded field is at most 255 and
// shift <= 8, so the clamp never fires and the bits shifted in from the
// field above land in bits 8-15 of the field below, which pack_fields never
// reads: round is then one add and one shift.
template <int KH, int KW, bool kExact>
struct Conv {
  static constexpr int HY = KH / 2, HX = KW / 2;
  uint32_t u[KH], v[KW];
  uint32_t half;  // half_of(shift) in both fields
  uint32_t keep;  // the bits a field keeps after the shift
  int shift;
  using Row = Fields;
  __device__ __forceinline__ Row row(const uint32_t (&x)[3]) const {
    if constexpr (KW == 1) {
      return {field_pair<1>(x, 0, 0), field_pair<1>(x, 0, 1)};
    } else {
      uint32_t e = 0, o = 0;
#pragma unroll
      for (int kx = 0; kx < KW; ++kx) {
        e += v[kx] * field_pair<1>(x, 0, kx - HX);
        o += v[kx] * field_pair<1>(x, 0, kx - HX + 1);
      }
      return {e, o};
    }
  }
  // Both fields rounded, clean (each at most 255, nothing above it).
  __device__ __forceinline__ uint32_t round_clean(uint32_t acc) const {
    const uint32_t t = ((acc + half) >> shift) & keep;
    return kExact ? t : __vminu2(t, 0x00ff00ffu);
  }
  // Both fields rounded, for pack_fields only.
  __device__ __forceinline__ uint32_t round(uint32_t acc) const {
    return kExact ? (acc + half) >> shift : round_clean(acc);
  }
  template <int K>
  __device__ __forceinline__ uint32_t out(const Row (&r)[K], int k) const {
    if constexpr (KH == 1) {
      return pack_fields(round(r[k % K].e), round(r[k % K].o));
    } else {
      uint32_t e = 0, o = 0;
#pragma unroll
      for (int ky = 0; ky < KH; ++ky) {
        e += u[ky] * r[(k + ky) % K].e;
        o += u[ky] * r[(k + ky) % K].o;
      }
      return pack_fields(round(e), round(o));
    }
  }
};

// A 1xN stage and the Nx1 stage right after it with nothing between (the
// chain's separated convolutions) in one walk: the row pass rounds to u8
// in its fields, as the 1xN stage does, and enters the ring as the Nx1
// stage's row partial, with no shared-memory round trip and no packing and
// unpacking between the two.
template <int N, bool kExact>
struct SepConv {
  static constexpr int HY = N / 2, HX = N / 2;
  Conv<1, N, kExact> first;
  Conv<N, 1, kExact> second;
  using Row = Fields;
  __device__ __forceinline__ Row row(const uint32_t (&x)[3]) const {
    const Fields r = first.row(x);
    return {first.round_clean(r.e), first.round_clean(r.o)};
  }
  template <int K>
  __device__ __forceinline__ uint32_t out(const Row (&r)[K], int k) const {
    return second.template out<K>(r, k);
  }
};

// One windowed stage: rows [lo, hi) of dst from rows [lo - HY, hi + HY) of
// src, every word column of the tile, then post (kPost; none where the run
// after the stage is the identity, as after most stages). A thread walks its
// column's strip of rows, each input row read once; the loop is unrolled
// by the ring's length so that the ring stays in registers.
template <bool kPost, class Body>
__device__ __forceinline__ void stage_walk(const Body& body,
                                           const uint32_t* __restrict__ src,
                                           uint32_t* __restrict__ dst, int lo,
                                           int hi, PointRun post) {
  constexpr int HY = Body::HY, K = 2 * HY + 1, U = K > 1 ? K : 4;
  const int j = threadIdx.x % kTileWords;
  const int per = (hi - lo + kGroups - 1) / kGroups;
  const int r0 = lo + static_cast<int>(threadIdx.x / kTileWords) * per;
  const int n = min(r0 + per, hi) - r0;  // rows of this thread's strip
  if (n <= 0) return;
  src += kHaloWords + j;
  dst += kHaloWords + j;
  auto fetch = [&](int y) {
    const uint32_t* p = src + y * kStride;
    uint32_t x[3];
    x[1] = p[0];
    if constexpr (Body::HX > 0) {
      x[0] = p[-1];
      x[2] = p[1];
    } else {
      x[0] = x[2] = 0u;
    }
    return body.row(x);
  };
  typename Body::Row ring[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) ring[k] = fetch(r0 - HY + k);
  // Whole turns of the ring, then the rest: after a turn the ring is back
  // in its first order, so the rest starts at k = 0.
  int r = r0;
  for (const int turns_end = r0 + n / U * U; r < turns_end;) {
#pragma unroll
    for (int k = 0; k < U; ++k, ++r) {
      ring[(k + K - 1) % K] = fetch(r + HY);
      const uint32_t w = body.template out<K>(ring, k % K);
      dst[r * kStride] = kPost ? post(w) : w;
    }
  }
#pragma unroll
  for (int k = 0; k < U - 1; ++k, ++r) {
    if (r >= r0 + n) return;
    ring[(k + K - 1) % K] = fetch(r + HY);
    const uint32_t w = body.template out<K>(ring, k % K);
    dst[r * kStride] = kPost ? post(w) : w;
  }
}

template <class Body>
__device__ __forceinline__ void stage(const Body& body, const uint32_t* src,
                                     uint32_t* dst, int lo, int hi,
                                     PointRun post) {
  if (post.identity())
    stage_walk<false>(body, src, dst, lo, hi, post);
  else
    stage_walk<true>(body, src, dst, lo, hi, post);
}

// A conv stage's body from its descriptor words, the single factor of a
// 1xN or Nx1 mask folded into the other factors.
template <int KH, int KW, bool kExact>
__device__ __forceinline__ Conv<KH, KW, kExact> conv_body(const int* payload,
                                                          int shift) {
  Conv<KH, KW, kExact> body;
#pragma unroll
  for (int i = 0; i < KH; ++i) body.u[i] = __ldg(payload + i);
#pragma unroll
  for (int i = 0; i < KW; ++i) body.v[i] = __ldg(payload + KH + i);
  if (KH == 1) {
#pragma unroll
    for (int i = 0; i < KW; ++i) body.v[i] *= body.u[0];
  }
  if (KW == 1) {
#pragma unroll
    for (int i = 0; i < KH; ++i) body.u[i] *= body.v[0];
  }
  body.shift = shift;
  body.half = static_cast<uint32_t>(half_of(shift)) * 0x00010001u;
  body.keep = (0xffffu >> shift) * 0x00010001u;
  return body;
}

// kExact of a conv stage (see Conv): its largest rounded value, from the
// factor sums, is at most 255, and shift <= 8.
__device__ __forceinline__ bool exact(const int* payload, int kh, int kw,
                                      int shift) {
  int su = 0, sv = 0;
  for (int i = 0; i < kh; ++i) su += __ldg(payload + i);
  for (int i = 0; i < kw; ++i) sv += __ldg(payload + kh + i);
  return shift <= 8 && (255 * su * sv + half_of(shift)) >> shift <= 255;
}

template <int KH, int KW>
__device__ __forceinline__ void conv_walk(const int* payload, int shift,
                                          const uint32_t* src, uint32_t* dst,
                                          int lo, int hi, PointRun post) {
  if (exact(payload, KH, KW, shift))
    stage(conv_body<KH, KW, true>(payload, shift), src, dst, lo, hi, post);
  else
    stage(conv_body<KH, KW, false>(payload, shift), src, dst, lo, hi, post);
}

template <int N, bool kExact>
__device__ __forceinline__ void sep_walk(const int* payload, int shift,
                                         const int* payload2, int shift2,
                                         const uint32_t* src, uint32_t* dst,
                                         int lo, int hi, PointRun post) {
  SepConv<N, kExact> body;
  body.first = conv_body<1, N, kExact>(payload, shift);
  body.second = conv_body<N, 1, kExact>(payload2, shift2);
  stage(body, src, dst, lo, hi, post);
}

template <int N>
__device__ __forceinline__ void sep_walk(const int* payload, int shift,
                                         const int* payload2, int shift2,
                                         const uint32_t* src, uint32_t* dst,
                                         int lo, int hi, PointRun post) {
  if (exact(payload, 1, N, shift) && exact(payload2, N, 1, shift2))
    sep_walk<N, true>(payload, shift, payload2, shift2, src, dst, lo, hi,
                      post);
  else
    sep_walk<N, false>(payload, shift, payload2, shift2, src, dst, lo, hi,
                       post);
}

struct U8Luma {
  int r, g, b, shift;
};

// Four lumas (wr * R + wg * G + wb * B) >> shift from a word of each plane.
__device__ __forceinline__ uint32_t luma4(uint32_t r, uint32_t g, uint32_t b,
                                          const U8Luma& l) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sel = 0x4440 | i;
    const uint32_t v = (l.r * __byte_perm(r, 0, sel) +
                        l.g * __byte_perm(g, 0, sel) +
                        l.b * __byte_perm(b, 0, sel)) >> l.shift;
    y |= (v & 0xffu) << (8 * i);
  }
  return y;
}

// The bytes of word gx (of a row of `words` words) that lie outside the
// zero ring of rx columns a side.
__device__ __forceinline__ uint32_t ring_keep(int gx, int words, int rx) {
  const int lo = rx - 4 * gx;                   // ring bytes at its low end
  const int hi = 4 * gx + 4 - (4 * words - rx);  // and at its high end
  uint32_t keep = ~0u;
  if (lo > 0) keep = lo >= 4 ? 0u : keep << (8 * lo);
  if (hi > 0) keep &= hi >= 4 ? 0u : ~0u >> (8 * hi);
  return keep;
}

// in and out are (count * (kGray ? 3 : 1), hp, words) 32-bit words, words
// a multiple of 4; the grid is (ceil(words / (kTileWords - 2 kHaloWords)),
// ceil(hp / kTileRows), count) of kU8Block threads, in runs of at most
// 65,535 rows of tiles from row row0; dynamic shared memory holds two
// (kTileRows + 2 ry) x kStride word buffers.
template <bool kGray>
__global__ void __launch_bounds__(kU8Block, kU8BlocksPerSM)
    chain_u8(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
             int hp, int words, int row0, const int* __restrict__ desc,
             int n_stages, int ry, int rx, const U8Luma luma) {
  using V = Vec::T;
  extern __shared__ uint4 smem_words[];
  const int bh = kTileRows + 2 * ry;
  uint32_t* cur = reinterpret_cast<uint32_t*>(smem_words);
  uint32_t* nxt = cur + bh * kStride;

  const size_t plane = static_cast<size_t>(hp) * words;
  const size_t base = static_cast<size_t>(blockIdx.z) * (kGray ? 3 : 1) * plane;
  const uint32_t* src = in + base;
  uint32_t* dst = out + base;
  const int y0 = row0 + blockIdx.y * kTileRows;
  // The word of tile column 0, a multiple of kHaloWords; a vector of the
  // tile lies wholly inside a row or wholly outside it.
  const int x0 = blockIdx.x * (kTileWords - 2 * kHaloWords) - kHaloWords;

  // Load the tile and its halo, through the point stages before the first
  // windowed one: tile (i, c) is padded row y0 - ry + i, word x0 + c.
  const int* d = desc;
  int s = 0;
  PointRun run = fold_points(&d, &s, n_stages);
  // kLoadBatch loads of a thread are in flight before the first store.
  const int n_vecs = bh * kRowVecs;
  for (int i0 = threadIdx.x; i0 < n_vecs; i0 += kLoadBatch * kU8Block) {
    uint32_t w[kLoadBatch][kHaloWords] = {};
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int i = i0 + b * kU8Block;
      const int gy = y0 - ry + i / kRowVecs, gx = x0 + i % kRowVecs * kHaloWords;
      if (i >= n_vecs || gy < 0 || gy >= hp || gx < 0 || gx >= words) continue;
      const uint32_t* p = src + static_cast<size_t>(gy) * words + gx;
      Vec::split(*reinterpret_cast<const V*>(p), w[b]);
      if (kGray) {
        uint32_t g[kHaloWords], bl[kHaloWords];
        Vec::split(*reinterpret_cast<const V*>(p + plane), g);
        Vec::split(*reinterpret_cast<const V*>(p + 2 * plane), bl);
#pragma unroll
        for (int k = 0; k < kHaloWords; ++k)
          w[b][k] = luma4(w[b][k], g[k], bl[k], luma);
      }
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int i = i0 + b * kU8Block;
      if (i >= n_vecs) break;
#pragma unroll
      for (int k = 0; k < kHaloWords; ++k) w[b][k] = run(w[b][k]);
      *reinterpret_cast<V*>(cur + i / kRowVecs * kStride + kHaloWords +
                            i % kRowVecs * kHaloWords) = Vec::join(w[b]);
    }
  }

  int ny = 0;  // margin of the rows computed so far
  while (s < n_stages) {
    const int kind = __ldg(d), kh = __ldg(d + 1), kw = __ldg(d + 2);
    const int shift = __ldg(d + 3);
    const int* payload = d + kHeader;
    d = payload + (kind == kConv ? kh + kw : kh * kw);
    ++s;
    run = fold_points(&d, &s, n_stages);
    // A 1xN conv stage right before an Nx1 one runs with it as one stage.
    const int* payload2 = d + kHeader;
    const bool sep = kind == kConv && kh == 1 && run.identity() &&
                     s < n_stages && __ldg(d) == kConv &&
                     __ldg(d + 1) == kw && __ldg(d + 2) == 1;
    const int shift2 = sep ? __ldg(d + 3) : 0;
    if (sep) {
      d = payload2 + kw + 1;
      ++s;
      run = fold_points(&d, &s, n_stages);
    }
    __syncthreads();  // the last stage's writes are in, its reads done
    ny += sep ? kw / 2 : kh / 2;
    const int lo = ny, hi = bh - ny;
    if (sep) {
      if (kw == 3)
        sep_walk<3>(payload, shift, payload2, shift2, cur, nxt, lo, hi, run);
      else
        sep_walk<5>(payload, shift, payload2, shift2, cur, nxt, lo, hi, run);
    } else if (kind == kMin) {
      if (__ldg(payload) == 0)  // a corner tap: the cross
        stage(MinCross{}, cur, nxt, lo, hi, run);
      else
        stage(MinSquare{}, cur, nxt, lo, hi, run);
    } else {
      switch (kh * 8 + kw) {
        case 3 * 8 + 3:
          conv_walk<3, 3>(payload, shift, cur, nxt, lo, hi, run);
          break;
        case 5 * 8 + 5:
          conv_walk<5, 5>(payload, shift, cur, nxt, lo, hi, run);
          break;
        case 1 * 8 + 3:
          conv_walk<1, 3>(payload, shift, cur, nxt, lo, hi, run);
          break;
        case 3 * 8 + 1:
          conv_walk<3, 1>(payload, shift, cur, nxt, lo, hi, run);
          break;
        case 1 * 8 + 5:
          conv_walk<1, 5>(payload, shift, cur, nxt, lo, hi, run);
          break;
        default:  // 5 x 1; the host checked the descriptor
          conv_walk<5, 1>(payload, shift, cur, nxt, lo, hi, run);
          break;
      }
    }
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  __syncthreads();

  // Store the tile's own words: output (r, c) is tile (ry + r, c), 0 in the
  // ring.
  for (int i = threadIdx.x; i < kTileRows * kRowVecs; i += kU8Block) {
    const int r = i / kRowVecs, c = i % kRowVecs * kHaloWords;
    const int gy = y0 + r, gx = x0 + c;
    if (c < kHaloWords || c >= kTileWords - kHaloWords || gy >= hp ||
        gx >= words)
      continue;
    uint32_t w[kHaloWords] = {};
    if (gy >= ry && gy < hp - ry) {
      Vec::split(*reinterpret_cast<const V*>(cur + (ry + r) * kStride +
                                             kHaloWords + c),
                 w);
      if (gx < kMaxRadius / 4 || gx + kHaloWords > words - kMaxRadius / 4) {
#pragma unroll
        for (int k = 0; k < kHaloWords; ++k)
          w[k] &= ring_keep(gx + k, words, rx);
      }
    }
    V* o = reinterpret_cast<V*>(dst + static_cast<size_t>(gy) * words + gx);
    *o = Vec::join(w);
    if (kGray) {
      *reinterpret_cast<V*>(reinterpret_cast<uint32_t*>(o) + plane) =
          Vec::join(w);
      *reinterpret_cast<V*>(reinterpret_cast<uint32_t*>(o) + 2 * plane) =
          Vec::join(w);
    }
  }
}

// -- chain_f32 --------------------------------------------------------------

// The tile (the fastest settings on the H100; chain_lab.py times others).
constexpr int kChainRows = 80;        // output rows of a tile
constexpr int kChainVecs = 1;         // float4 of a row a lane owns
constexpr int kChainGroups = 1;       // warps side by side across a tile row
constexpr int kChainThreads = 256;    // threads of a block
constexpr int kChainBlocksPerSM = 2;  // resident blocks: the register cap
constexpr int kChainLoadBatch = 4;    // float4 loads a thread keeps in flight
constexpr int kHaloF4 = 2;            // float4 of halo a tile side
constexpr int kSpanF = 4 * kChainVecs;  // floats of a row a lane owns
// float4 of a tile row, halo included: the lanes of kChainGroups warps.
constexpr int kTileF4 = 32 * kChainVecs * kChainGroups;
// A tile row in shared memory: 4 floats of slack a side, which the warp's
// edge lanes read as a neighbour (they reach only halo columns).
constexpr int kStrideF = 4 * kTileF4 + 8;
constexpr int kStrips = kChainThreads / 32 / kChainGroups;
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kChainThreads % (32 * kChainGroups) == 0,
              "whole warps, kChainGroups of them across a row");
static_assert(4 * kHaloF4 >= kMaxRadius, "the halo covers the deepest chain");

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}

struct F32Luma {
  float r, g, b;
};

// The luma in the JAX stage's order, (wr * R + wg * G) + wb * B.
__device__ __forceinline__ float luma_of(float r, float g, float b,
                                         const F32Luma& l) {
  return fadd(fadd(fmul(l.r, r), fmul(l.g, g)), fmul(l.b, b));
}

// A run of point stages as it acts on floats: inv inversions 1 - v one
// after another (each rounds, so they do not cancel), then, if the run has
// a threshold, v > 0.5, xor flip. Every stage after the first threshold
// sees 0 or 1, where a threshold changes nothing and an inversion is exact,
// so the parity of the later inversions is the whole rest of the run. The
// inversion loop is kept rolled: unrolled inside a stage walk it cost the
// walk twice its instructions.
struct RunF32 {
  int inv;
  bool threshold, flip;
  template <int N>
  __device__ __forceinline__ void operator()(float (&v)[N]) const {
#pragma unroll 1
    for (int i = 0; i < inv; ++i) {
#pragma unroll
      for (int c = 0; c < N; ++c) v[c] = __fsub_rn(1.0f, v[c]);
    }
    if (threshold) {
#pragma unroll
      for (int c = 0; c < N; ++c) v[c] = (v[c] > 0.5f) != flip ? 1.0f : 0.0f;
    }
  }
  __device__ __forceinline__ bool identity() const {
    return inv == 0 && !threshold;
  }
};

// Fold the point stages at *d, at most n_stages - *s of them.
__device__ RunF32 fold_points_f32(const int** d, int* s, int n_stages) {
  RunF32 run{0, false, false};
  while (*s < n_stages) {
    const int kind = __ldg(*d);
    if (kind == kInvert) {
      if (run.threshold)
        run.flip = !run.flip;
      else
        ++run.inv;
    } else if (kind == kThreshold) {
      run.threshold = true;
    } else if (kind != kCopy) {
      break;
    }
    *d += kHeader + 1;
    ++*s;
  }
  return run;
}

// A stage body: HY, HX; Row, what a lane keeps of one input row, made by
// row(x) from its view x[0 .. kSpanF + 2 HX) of the row (its own floats at
// x[HX ..], HX on either side); out(ring, k, o), the lane's kSpanF outputs
// from the 2 HY + 1 rows around the output row, row i from the top being
// ring[(k + i) % K].

// A kh x kw correlation in the JAX stage's order (_conv_rank1_f32): for
// each mask column kx the sum over ky, then those column sums over kx. Each
// tap has its own weight, so the ring holds raw rows.
template <int KH, int KW>
struct DenseF {
  static constexpr int HY = KH / 2, HX = KW / 2;
  float w[KH * KW];
  struct Row {
    float f[kSpanF + 2 * HX];
  };
  __device__ __forceinline__ Row row(const float (&x)[kSpanF + 2 * HX]) const {
    Row r;
#pragma unroll
    for (int c = 0; c < kSpanF + 2 * HX; ++c) r.f[c] = x[c];
    return r;
  }
  template <int K>
  __device__ __forceinline__ void out(const Row (&r)[K], int k,
                                      float (&o)[kSpanF]) const {
#pragma unroll
    for (int i = 0; i < kSpanF; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int kx = 0; kx < KW; ++kx) {
        float col = fmul(r[k % K].f[i + kx], w[kx]);
#pragma unroll
        for (int ky = 1; ky < KH; ++ky)
          col = fadd(col, fmul(r[(k + ky) % K].f[i + kx], w[ky * KW + kx]));
        acc = kx == 0 ? col : fadd(acc, col);
      }
      o[i] = acc;
    }
  }
};

// A 1xN stage and the Nx1 stage right after it (the chain's separated
// convolutions) as one walk: the row pass, each product added in kx order,
// makes the ring entry, and the column pass adds the entries' products in
// ky order, the two stages' own orders with no shared-memory round trip
// between them.
template <int N>
struct SepF {
  static constexpr int HY = N / 2, HX = N / 2;
  float v[N], u[N];  // the 1xN stage's weights, the Nx1 stage's
  struct Row {
    float p[kSpanF];
  };
  __device__ __forceinline__ Row row(const float (&x)[kSpanF + 2 * HX]) const {
    Row r;
#pragma unroll
    for (int i = 0; i < kSpanF; ++i) {
      float acc = fmul(x[i], v[0]);
#pragma unroll
      for (int kx = 1; kx < N; ++kx) acc = fadd(acc, fmul(x[i + kx], v[kx]));
      r.p[i] = acc;
    }
    return r;
  }
  template <int K>
  __device__ __forceinline__ void out(const Row (&r)[K], int k,
                                      float (&o)[kSpanF]) const {
#pragma unroll
    for (int i = 0; i < kSpanF; ++i) {
      float acc = fmul(r[k % K].p[i], u[0]);
#pragma unroll
      for (int ky = 1; ky < N; ++ky)
        acc = fadd(acc, fmul(r[(k + ky) % K].p[i], u[ky]));
      o[i] = acc;
    }
  }
};

// The 3x3 square min: the min of three floats of a row, then of three rows.
struct MinSquareF {
  static constexpr int HY = 1, HX = 1;
  struct Row {
    float m[kSpanF];
  };
  __device__ __forceinline__ Row row(const float (&x)[kSpanF + 2]) const {
    Row r;
#pragma unroll
    for (int i = 0; i < kSpanF; ++i)
      r.m[i] = fminf(fminf(x[i], x[i + 1]), x[i + 2]);
    return r;
  }
  template <int K>
  __device__ __forceinline__ void out(const Row (&r)[K], int k,
                                      float (&o)[kSpanF]) const {
#pragma unroll
    for (int i = 0; i < kSpanF; ++i)
      o[i] = fminf(fminf(r[k % K].m[i], r[(k + 1) % K].m[i]),
                   r[(k + 2) % K].m[i]);
  }
};

// The 3x3 cross: the centre row's horizontal min against the centre
// column of the rows above and below.
struct MinCrossF {
  static constexpr int HY = 1, HX = 1;
  struct Row {
    float c[kSpanF], h[kSpanF];
  };
  __device__ __forceinline__ Row row(const float (&x)[kSpanF + 2]) const {
    Row r;
#pragma unroll
    for (int i = 0; i < kSpanF; ++i) {
      r.c[i] = x[i + 1];
      r.h[i] = fminf(fminf(x[i], x[i + 1]), x[i + 2]);
    }
    return r;
  }
  template <int K>
  __device__ __forceinline__ void out(const Row (&r)[K], int k,
                                      float (&o)[kSpanF]) const {
#pragma unroll
    for (int i = 0; i < kSpanF; ++i)
      o[i] = fminf(fminf(r[k % K].c[i], r[(k + 2) % K].c[i]),
                   r[(k + 1) % K].h[i]);
  }
};

// The lane's view of the tile row at p (its first float): one 16-byte
// shared load a float4, the HX floats on either side from the adjacent
// lanes by shuffle, the warp's edge lanes' from one 8-byte load each.
// Every lane of the warp calls this.
template <int HX>
__device__ __forceinline__ void view(const float* p, int lane,
                                     float (&x)[kSpanF + 2 * HX]) {
#pragma unroll
  for (int i = 0; i < kChainVecs; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    x[HX + 4 * i] = v.x;
    x[HX + 4 * i + 1] = v.y;
    x[HX + 4 * i + 2] = v.z;
    x[HX + 4 * i + 3] = v.w;
  }
  if constexpr (HX > 0) {
    float2 edge = make_float2(0.0f, 0.0f);
    if (lane == 0)
      edge = *reinterpret_cast<const float2*>(p - 2);
    else if (lane == 31)
      edge = *reinterpret_cast<const float2*>(p + kSpanF);
    const float l1 = __shfl_up_sync(kFullWarp, x[HX + kSpanF - 1], 1);
    const float r1 = __shfl_down_sync(kFullWarp, x[HX], 1);
    x[HX - 1] = lane == 0 ? edge.y : l1;
    x[HX + kSpanF] = lane == 31 ? edge.x : r1;
    if constexpr (HX == 2) {
      const float l2 = __shfl_up_sync(kFullWarp, x[kSpanF], 1);
      const float r2 = __shfl_down_sync(kFullWarp, x[HX + 1], 1);
      x[0] = lane == 0 ? edge.x : l2;
      x[kSpanF + 3] = lane == 31 ? edge.y : r2;
    }
  }
}

// One windowed stage: rows [lo, hi) of dst from rows [lo - HY, hi + HY) of
// src, every column of the tile, then post (kPost; none where the run after
// the stage is the identity). A warp owns kSpanF * 32 columns and walks a
// strip of the rows, each input row read once; the loop is unrolled by the
// ring's length so that the ring stays in registers.
template <bool kPost, class Body, class Sink>
__device__ __forceinline__ void walk_f32(const Body& body,
                                         const float* __restrict__ src,
                                         const Sink& sink, int lo, int hi,
                                         RunF32 post) {
  constexpr int HY = Body::HY, HX = Body::HX, K = 2 * HY + 1;
  constexpr int U = K > 1 ? K : 4;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (hi - lo + kStrips - 1) / kStrips;
  const int r0 = lo + warp / kChainGroups * per;
  const int n = min(r0 + per, hi) - r0;  // rows of this warp's strip
  if (n <= 0) return;
  const int col = (warp % kChainGroups) * 32 + lane;  // the lane's span
  src += 4 + col * kSpanF;
  auto fetch = [&](int y) {
    float x[kSpanF + 2 * HX];
    view<HX>(src + y * kStrideF, lane, x);
    return body.row(x);
  };
  auto put = [&](int y, float (&o)[kSpanF]) {
    if (kPost) post(o);
    sink(y, col, o);
  };
  typename Body::Row ring[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) ring[k] = fetch(r0 - HY + k);
  // Whole turns of the ring, then the rest: after a turn the ring is back
  // in its first order, so the rest starts at k = 0.
  int r = r0;
  for (const int turns_end = r0 + n / U * U; r < turns_end;) {
#pragma unroll
    for (int k = 0; k < U; ++k, ++r) {
      ring[(k + K - 1) % K] = fetch(r + HY);
      float o[kSpanF];
      body.template out<K>(ring, k % K, o);
      put(r, o);
    }
  }
#pragma unroll
  for (int k = 0; k < U - 1; ++k, ++r) {
    if (r >= r0 + n) return;
    ring[(k + K - 1) % K] = fetch(r + HY);
    float o[kSpanF];
    body.template out<K>(ring, k % K, o);
    put(r, o);
  }
}

// Where a stage walk's outputs go: the other tile buffer,
struct TileSink {
  float* dst;
  __device__ __forceinline__ void operator()(int y, int col,
                                             const float (&o)[kSpanF]) const {
    float4* q =
        reinterpret_cast<float4*>(dst + y * kStrideF + 4 + col * kSpanF);
#pragma unroll
    for (int i = 0; i < kChainVecs; ++i)
      q[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
  }
};

// or, for the chain's last windowed stage, the output planes: tile row y
// is padded row y0 - ry + y and tile column c float4 x0 + c; only the
// tile's own float4 are stored, 0 in the outer (ry, rx) ring, to all three
// planes for a Grayscale-first chain.
template <bool kGray>
struct PlaneSink {
  float4* dst;    // the image's first output plane
  size_t plane4;  // float4 of a plane
  int hp, vecs, ry, rx, y0, x0;
  __device__ __forceinline__ void operator()(int y, int col,
                                             const float (&o)[kSpanF]) const {
    const int gy = y0 - ry + y;
    if (gy >= hp) return;
    const bool ring = gy < ry || gy >= hp - ry;
#pragma unroll
    for (int i = 0; i < kChainVecs; ++i) {
      const int c = col * kChainVecs + i, gx = x0 + c;
      if (c < kHaloF4 || c >= kTileF4 - kHaloF4 || gx >= vecs) continue;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = 4 * gx + k;
        v[k] = ring || x < rx || x >= 4 * vecs - rx ? 0.0f : o[4 * i + k];
      }
      float4* q = dst + static_cast<size_t>(gy) * vecs + gx;
      const float4 w = make_float4(v[0], v[1], v[2], v[3]);
      q[0] = w;
      if (kGray) {
        q[plane4] = w;
        q[2 * plane4] = w;
      }
    }
  }
};

template <class Body, class Sink>
__device__ __forceinline__ void stage_f32(const Body& body, const float* src,
                                          const Sink& sink, int lo, int hi,
                                          RunF32 post) {
  if (post.identity())
    walk_f32<false>(body, src, sink, lo, hi, post);
  else
    walk_f32<true>(body, src, sink, lo, hi, post);
}

// The windowed stage at payload (kind, kh x kw), or with sep the 1xN stage
// there and the Nx1 stage at payload2, as one walk into sink.
template <class Sink>
__device__ __forceinline__ void windowed_f32(int kind, int kh, int kw,
                                             bool sep, const int* payload,
                                             const int* payload2,
                                             const float* src,
                                             const Sink& sink, int lo, int hi,
                                             RunF32 run) {
  auto dense = [&](auto body) {
#pragma unroll
    for (int k = 0; k < int(sizeof(body.w) / sizeof(float)); ++k)
      body.w[k] = __int_as_float(__ldg(payload + k));
    stage_f32(body, src, sink, lo, hi, run);
  };
  auto separated = [&](auto body) {
#pragma unroll
    for (int k = 0; k < int(sizeof(body.v) / sizeof(float)); ++k) {
      body.v[k] = __int_as_float(__ldg(payload + k));
      body.u[k] = __int_as_float(__ldg(payload2 + k));
    }
    stage_f32(body, src, sink, lo, hi, run);
  };
  if (sep) {
    if (kw == 3)
      separated(SepF<3>{});
    else
      separated(SepF<5>{});
  } else if (kind == kMin) {
    if (__ldg(payload) == 0)  // a corner tap: the cross
      stage_f32(MinCrossF{}, src, sink, lo, hi, run);
    else
      stage_f32(MinSquareF{}, src, sink, lo, hi, run);
  } else {
    switch (kh * 8 + kw) {
      case 3 * 8 + 3: dense(DenseF<3, 3>{}); break;
      case 5 * 8 + 5: dense(DenseF<5, 5>{}); break;
      case 1 * 8 + 3: dense(DenseF<1, 3>{}); break;
      case 3 * 8 + 1: dense(DenseF<3, 1>{}); break;
      case 1 * 8 + 5: dense(DenseF<1, 5>{}); break;
      default: dense(DenseF<5, 1>{}); break;  // 5 x 1; the host checked
    }
  }
}

// A tile of the (count, C, hp, pitch) buffer: image (or plane) z, output
// rows from y0, float4 from x0 (halo included, kHaloF4 left of its own).
struct TileF {
  int z, y0, x0;
};

__device__ __forceinline__ TileF tile_at(int t, int tiles_x, int tiles_y) {
  const int per = tiles_x * tiles_y, z = t / per, r = t - z * per;
  return {z, r / tiles_x * kChainRows,
          r % tiles_x * (kTileF4 - 2 * kHaloF4) - kHaloF4};
}

// Load a tile and its halo into buf, through the point run pre: buffer
// (i, c) is float4 x0 + c of padded row y0 - ry + i, 0 outside the
// buffer; for a Grayscale-first chain the luma of the three planes.
template <bool kGray>
__device__ __forceinline__ void load_tile(const float4* __restrict__ src,
                                          float* buf, const TileF& tile,
                                          int hp, int vecs, size_t plane4,
                                          int bh, int ry, RunF32 pre,
                                          const F32Luma& luma) {
  const int n_vecs = bh * kTileF4;
  for (int i0 = threadIdx.x; i0 < n_vecs;
       i0 += kChainLoadBatch * kChainThreads) {
    float4 v[kChainLoadBatch];
#pragma unroll
    for (int b = 0; b < kChainLoadBatch; ++b) {
      const int i = i0 + b * kChainThreads;
      const int gy = tile.y0 - ry + i / kTileF4, gx = tile.x0 + i % kTileF4;
      v[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i >= n_vecs || gy < 0 || gy >= hp || gx < 0 || gx >= vecs) continue;
      const float4* p = src + static_cast<size_t>(gy) * vecs + gx;
      v[b] = p[0];
      if (kGray) {
        const float4 g = p[plane4], bl = p[2 * plane4];
        v[b] = make_float4(luma_of(v[b].x, g.x, bl.x, luma),
                           luma_of(v[b].y, g.y, bl.y, luma),
                           luma_of(v[b].z, g.z, bl.z, luma),
                           luma_of(v[b].w, g.w, bl.w, luma));
      }
    }
#pragma unroll
    for (int b = 0; b < kChainLoadBatch; ++b) {
      const int i = i0 + b * kChainThreads;
      if (i >= n_vecs) break;
      float w[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
      pre(w);
      *reinterpret_cast<float4*>(buf + i / kTileF4 * kStrideF + 4 +
                                 4 * (i % kTileF4)) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Start copying a tile into buf without the registers (cp.async, 16 bytes
// a copy, 0 outside the buffer); the caller waits, then applies the point
// run before the first windowed stage. A thread copies the float4 that
// load_tile would give it.
__device__ __forceinline__ void prefetch_tile(const float4* __restrict__ src,
                                              float* buf, const TileF& tile,
                                              int hp, int vecs, int bh,
                                              int ry) {
  const int n_vecs = bh * kTileF4;
  for (int i = threadIdx.x; i < n_vecs; i += kChainThreads) {
    const int gy = tile.y0 - ry + i / kTileF4, gx = tile.x0 + i % kTileF4;
    const bool in = gy >= 0 && gy < hp && gx >= 0 && gx < vecs;
    __pipeline_memcpy_async(
        buf + i / kTileF4 * kStrideF + 4 + 4 * (i % kTileF4),
        in ? src + static_cast<size_t>(gy) * vecs + gx : src, 16,
        in ? 0 : 16);
  }
  __pipeline_commit();
}

// in and out are (count * (kGray ? 3 : 1), hp, pitch) floats, pitch a
// multiple of 4, cut into n_tiles tiles (tiles_x across, tiles_y down,
// then count); a block takes tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// of kChainThreads threads; dynamic shared memory holds two
// (kChainRows + 2 ry) x kStrideF float buffers. The last windowed stage
// writes the output planes itself, so the other buffer is free while it
// runs and, but for a Grayscale-first chain, takes the block's next tile,
// copied in the background.
template <bool kGray>
__global__ void __launch_bounds__(kChainThreads, kChainBlocksPerSM)
    chain_f32(const float* __restrict__ in, float* __restrict__ out, int hp,
              int pitch, const int* __restrict__ desc, int n_stages, int ry,
              int rx, const F32Luma luma, int tiles_x, int tiles_y,
              int n_tiles) {
  extern __shared__ float4 smem_f4[];
  const int bh = kChainRows + 2 * ry;
  float* cur = reinterpret_cast<float*>(smem_f4);
  float* nxt = cur + bh * kStrideF;
  const size_t plane4 = static_cast<size_t>(hp) * pitch / 4;
  const size_t image4 = (kGray ? 3 : 1) * plane4;
  const float4* src = reinterpret_cast<const float4*>(in);
  const int vecs = pitch / 4;  // float4 of a row
  // The point stages before the first windowed one.
  const int* d0 = desc;
  int s0 = 0;
  const RunF32 pre = fold_points_f32(&d0, &s0, n_stages);
  bool ready = false;  // cur holds the tile, copied in the background
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const TileF tile = tile_at(t, tiles_x, tiles_y);
    if (ready) {
      ready = false;
      __pipeline_wait_prior(0);
      if (!pre.identity()) {  // the float4 this thread copied
        for (int i = threadIdx.x; i < bh * kTileF4; i += kChainThreads) {
          float4* q = reinterpret_cast<float4*>(cur + i / kTileF4 * kStrideF +
                                                4 + 4 * (i % kTileF4));
          float w[4] = {q->x, q->y, q->z, q->w};
          pre(w);
          *q = make_float4(w[0], w[1], w[2], w[3]);
        }
      }
    } else {
      load_tile<kGray>(src + tile.z * image4, cur, tile, hp, vecs, plane4,
                       bh, ry, pre, luma);
    }
    const PlaneSink<kGray> planes{
        reinterpret_cast<float4*>(out) + tile.z * image4, plane4, hp, vecs,
        ry, rx, tile.y0, tile.x0};
    const int* d = d0;
    int s = s0;
    int ny = 0;  // margin of the rows computed so far
    bool stored = false;
    while (s < n_stages) {
      const int kind = __ldg(d), kh = __ldg(d + 1), kw = __ldg(d + 2);
      const int* payload = d + kHeader;
      d = payload + kh * kw;
      ++s;
      RunF32 run = fold_points_f32(&d, &s, n_stages);
      // A 1xN conv stage right before an Nx1 one runs with it as one stage.
      const int* payload2 = d + kHeader;
      const bool sep = kind == kConv && kh == 1 && run.identity() &&
                       s < n_stages && __ldg(d) == kConv &&
                       __ldg(d + 1) == kw && __ldg(d + 2) == 1;
      if (sep) {
        d = payload2 + kw;
        ++s;
        run = fold_points_f32(&d, &s, n_stages);
      }
      __syncthreads();  // the last stage's writes are in, its reads done
      ny += sep ? kw / 2 : kh / 2;
      if (s < n_stages) {
        windowed_f32(kind, kh, kw, sep, payload, payload2, cur,
                     TileSink{nxt}, ny, bh - ny, run);
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
        continue;
      }
      // The last windowed stage: nxt is free, so the next tile's copy runs
      // beside it.
      const int tn = t + gridDim.x;
      ready = !kGray && tn < n_tiles;
      if (ready) {
        const TileF next = tile_at(tn, tiles_x, tiles_y);
        prefetch_tile(src + next.z * image4, nxt, next, hp, vecs, bh, ry);
      }
      windowed_f32(kind, kh, kw, sep, payload, payload2, cur, planes, ny,
                   bh - ny, run);
      stored = true;
    }
    if (!stored) {  // no windowed stage: store the loaded tile
      __syncthreads();
      constexpr int kSpans = kTileF4 / kChainVecs;  // lane spans a row
      for (int i = threadIdx.x; i < kChainRows * kSpans; i += kChainThreads) {
        const int r = i / kSpans, c = i % kSpans;
        const float* p = cur + (ry + r) * kStrideF + 4 + c * kSpanF;
        float o[kSpanF];
#pragma unroll
        for (int k = 0; k < kSpanF; ++k) o[k] = p[k];
        planes(ry + r, c, o);
      }
    }
    if (ready) {
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    __syncthreads();  // this tile's reads are done before the next's writes
  }
}

// -- the host side ----------------------------------------------------------

bool conv_shape(int kh, int kw) {
  return (kh == 3 && kw == 3) || (kh == 5 && kw == 5) ||
         (kh == 1 && (kw == 3 || kw == 5)) ||
         (kw == 1 && (kh == 3 || kh == 5));
}

// A uint8 conv stage's payload: nonnegative rank-1 factors u (kh) and v
// (kw), neither all zero, whose sums keep every 16-bit field of every sum,
// rounding add included, below 2^16 (the packed-16 proof), shift <= 15.
bool factors_fit(const int* uv, int kh, int kw, int shift) {
  long su = 0, sv = 0;
  for (int i = 0; i < kh + kw; ++i) {
    if (uv[i] < 0) return false;
    (i < kh ? su : sv) += uv[i];
  }
  return su > 0 && sv > 0 && shift <= 15 &&
         255 * su * sv + half_of(shift) < (1L << 16);
}

// A min stage: the 3x3 square or cross, the two bodies each kernel has.
bool min_taps_fit(const int* t) {
  for (int k = 0; k < 9; ++k) {
    const bool corner = k % 2 == 0 && k != 4;
    if (t[k] != (corner ? t[0] : 1) || (t[0] != 0 && t[0] != 1))
      return false;
  }
  return true;
}

// Check the host copy of the descriptor: only kinds and shapes the kernel
// has, words that add up, radii within kMaxRadius, a min's taps the square
// or the cross; with factors (uint8), a conv stage's payload is its rank-1
// factors. Sets the stage count and the chain's radii. No stage at all is
// a Grayscale-only chain.
bool parse(const int* desc, int n_words, bool factors, int* n_stages, int* ry,
           int* rx) {
  int i = 0, n = 0;
  *ry = *rx = 0;
  while (i + kHeader <= n_words) {
    const int kind = desc[i], kh = desc[i + 1], kw = desc[i + 2];
    const int shift = desc[i + 3];
    const int words = kind == kConv && factors ? kh + kw : kh * kw;
    bool ok = false;
    if (kind == kCopy || kind == kInvert || kind == kThreshold)
      ok = kh == 1 && kw == 1;
    else if (kind == kMin)
      ok = kh == 3 && kw == 3 && i + kHeader + 9 <= n_words &&
           min_taps_fit(desc + i + kHeader);
    else if (kind == kConv)
      ok = conv_shape(kh, kw) && shift >= 0 && shift < 31 &&
           i + kHeader + words <= n_words &&
           (!factors || factors_fit(desc + i + kHeader, kh, kw, shift));
    if (!ok) return false;
    *ry += kh / 2;
    *rx += kw / 2;
    i += kHeader + words;
    ++n;
  }
  *n_stages = n;
  return i == n_words && *ry <= kMaxRadius && *rx <= kMaxRadius;
}

// Dynamic shared memory above 48 KB is given only after opting in.
template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

int launch_chain_u8(const void* in, void* out, int count, int hp, int pitch,
                    int gray, const void* desc, const int* desc_host,
                    int n_words, const U8Luma& luma, void* stream) {
  int n_stages, ry, rx;
  if (count < 1 || count > 65535 || hp < 1 || pitch < 16 || pitch % 16 ||
      n_words < 0 || (n_words > 0 && desc_host == nullptr) ||
      !parse(desc_host, n_words, true, &n_stages, &ry, &rx) ||
      (n_stages == 0 && !gray))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const uint32_t*, uint32_t*, int, int, int, const int*, int,
                 int, int, const U8Luma) =
      gray ? chain_u8<true> : chain_u8<false>;
  const size_t smem =
      2 * static_cast<size_t>(kTileRows + 2 * ry) * kStride * sizeof(uint32_t);
  if (const int e = allow_smem(kernel, smem)) return e;
  const int words = pitch / 4, per_tile = kTileWords - 2 * kHaloWords;
  const unsigned int gx = (words + per_tile - 1) / per_tile;
  return dip::launch_row_runs(hp, kTileRows, [&](unsigned int gy, int row0) {
    kernel<<<dim3(gx, gy, count), kU8Block, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), hp,
        words, row0, static_cast<const int*>(desc), n_stages, ry, rx, luma);
  });
}

int launch_chain_f32(const void* in, void* out, int count, int hp, int pitch,
                     int gray, const void* desc, const int* desc_host,
                     int n_words, const F32Luma& luma, void* stream) {
  int n_stages, ry, rx;
  if (count < 1 || count > 65535 || hp < 1 || pitch < 4 || pitch % 4 ||
      n_words < 0 || (n_words > 0 && desc_host == nullptr) ||
      !parse(desc_host, n_words, false, &n_stages, &ry, &rx) ||
      (n_stages == 0 && !gray))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const float*, float*, int, int, const int*, int, int, int,
                 const F32Luma, int, int, int) =
      gray ? chain_f32<true> : chain_f32<false>;
  const size_t smem =
      2 * static_cast<size_t>(kChainRows + 2 * ry) * kStrideF * sizeof(float);
  if (const int e = allow_smem(kernel, smem)) return e;
  // One block for each resident slot of the card, each taking every
  // grid-th tile.
  int device, sms, per_sm;
  if (const cudaError_t e = cudaGetDevice(&device)) return static_cast<int>(e);
  if (const cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device))
    return static_cast<int>(e);
  if (const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kChainThreads, smem))
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_tile = 4 * (kTileF4 - 2 * kHaloF4);
  const int tiles_x = (pitch + per_tile - 1) / per_tile;
  const int tiles_y = (hp + kChainRows - 1) / kChainRows;
  const int n_tiles = tiles_x * tiles_y * count;
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  kernel<<<grid, kChainThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), hp, pitch,
      static_cast<const int*>(desc), n_stages, ry, rx, luma, tiles_x, tiles_y,
      n_tiles);
  return dip::launch_status();
}

}  // namespace

// in and out are (count, C, hp, pitch) uint8 read as count * C planes, or
// with gray != 0 (count, 3, hp, pitch) with count images, pitch a multiple
// of 16 and both base addresses 16-byte aligned; desc is the descriptor on
// the card and desc_host the same n_words on the host; wr, wg, wb and shift
// are the fixed-point luma of a Grayscale first stage.
DIP_API int dip_chain_u8(const void* in, void* out, int count, int hp,
                         int pitch, int gray, const void* desc,
                         const int* desc_host, int n_words, int wr, int wg,
                         int wb, int shift, void* stream) {
  return launch_chain_u8(in, out, count, hp, pitch, gray, desc, desc_host,
                         n_words, U8Luma{wr, wg, wb, shift}, stream);
}

// The same for float32; the conv weights in desc are float bits.
DIP_API int dip_chain_f32(const void* in, void* out, int count, int hp,
                          int pitch, int gray, const void* desc,
                          const int* desc_host, int n_words, float wr,
                          float wg, float wb, void* stream) {
  return launch_chain_f32(in, out, count, hp, pitch, gray, desc, desc_host,
                          n_words, F32Luma{wr, wg, wb}, stream);
}
