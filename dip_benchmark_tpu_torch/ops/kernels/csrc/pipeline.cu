// The fused pipeline of the uint8 model: grayscale, threshold, 3x3 square
// erosion and the 1-2-1 x 1-2-1 blur in one kernel, over one planar padded
// image (3, Hp, pitch) or a stack of them (B, 3, Hp, pitch).
//
// Replaces dip_benchmark_tpu/models/pipeline.py:30
// make_fused_pipeline_pallas, and with it the fused_channels and batch modes
// of the skeleton _windowed_call (ops/pallas/window.py:57-65, 115-131,
// 203-215): a thread reads all three planes of its words, and blockIdx.z is
// the batch index.
//
// Bound: device-memory bandwidth. Each image's three planes are read once
// and written once (2 * 3 * Hp * pitch bytes, 14.75 us at 3504x2336 on an
// H100); the arithmetic is about a dozen integer instructions a pixel.
//
// Design. The first version ran three shared-memory phases split by
// __syncthreads: the luma byte by byte, the erosion with nine byte loads an
// output, the blur, one 4-byte store a plane. Its blocks each waited on a
// chain of 4-byte loads, and a launch cost about 11 us more than its pixels
// (benchmarks/h100/launch_scaling.py). Here a warp walks a strip of
// kPipeRows output rows; a lane owns kPipeWords 32-bit words of each row
// and keeps every stage in registers, carrying the JAX kernel's own trick
// (after the threshold every byte is 0 or 1, so the 3x3 min is an AND, as
// in dip_benchmark_tpu/models/pipeline.py:64-68) onto words:
//   1. each input row is loaded once a strip, 16 bytes a lane and plane,
//      a few rows ahead of its use (kPipeAhead, kPipeAheadOne); the word on either side of a
//      lane's words comes from the neighbouring lane by warp shuffle, and
//      the warp's edge lanes load the one word beyond;
//   2. luma > 127 four pixels at a time: each weight split as 256 hi + lo
//      (both below 256), the pixels' even and odd bytes as 16-bit fields
//      of one register, so that H = hi . (R, G, B) and L = lo . (R, G, B)
//      fit a field each (<= 255 * 255 and 255 * 256) and
//      luma > 127  <=>  256 H + L >= 2^23  <=>  H + (L >> 8) >= 2^15, bit
//      15 of a field: exact, with no product wider than a field;
//   3. the mask as bytes 0 or 1; the horizontal min an AND of the word
//      with its two funnel-shifted neighbours; the erosion the AND of three
//      such rows of a register ring;
//   4. the blur on the eroded bytes: the 1-2-1 horizontal sum (<= 4 a
//      byte) and the 1-2-1 vertical sum over a second ring (k <= 16 a
//      byte) never carry across bytes, and (255 k + 8) >> 4 is 16 k, less
//      1 for k >= 9;
//   5. the output word stored to all three planes, 16 bytes a lane each.
// A lane past a row's end or at its ends loads the row's words nearest to
// it, and a strip at the top or bottom the plane's nearest rows: what they
// read reaches only the zero ring (2 rows and 2 columns), which is written
// 0. The strip loop is unrolled whole, so both rings stay in registers.
// benchmarks/h100/chain_lab.py times the settings (the defaults are its
// fastest) and counts the SASS an output byte (about 29, most of it the
// luma of 12 rows for 8): short strips won, since at B = 1 they give the
// card enough warps to hide each walk's latency.
//
// Like window_u8, the output has the input's shape and every byte of it is
// written: the pipeline where every tap lies in the buffer, 0 in the outer
// ring of 2 rows and 2 columns (erosion 1 + blur 1).
#include "common.cuh"
#include "words.cuh"

namespace {

// spec.GRAYSCALE_WEIGHTS_INT_RGB, spec.GRAYSCALE_SHIFT, spec.THRESHOLD_VALUE
// and spec.THRESHOLD_MAX; a test holds these lines equal to the spec.
constexpr int kLumaR = 13933;
constexpr int kLumaG = 46871;
constexpr int kLumaB = 4732;
constexpr int kLumaShift = 16;
constexpr int kThreshold = 127;
constexpr int kThresholdMax = 255;
static_assert((kThreshold + 1) << (kLumaShift - 8) == 1 << 15,
              "the threshold is bit 15 of H + (L >> 8)");
static_assert(kThresholdMax == 255, "the blur maps k to (255 k + 8) >> 4");
static_assert(kLumaR < 1 << 16 && kLumaG < 1 << 16 && kLumaB < 1 << 16 &&
                  (kLumaR >> 8) + (kLumaG >> 8) + (kLumaB >> 8) <= 256 &&
                  (kLumaR & 255) + (kLumaG & 255) + (kLumaB & 255) <= 256,
              "255 times the summed weight halves fits a 16-bit field");

constexpr int kRing = 2;        // erosion radius 1 + blur radius 1
// The strip (the fastest settings on the H100; chain_lab.py times others).
constexpr int kPipeRows = 8;    // output rows of a strip, a warp's walk
constexpr int kPipeWords = 4;   // 32-bit words of a row a lane owns
constexpr int kTileW = 512;     // bytes of a row a warp covers
constexpr int kPipeWarps = 4;   // warps of a block, strips one below another
// Input rows loaded ahead of their use: for a stack (B > 1), and for one
// image. The shallower queue takes fewer registers, so more warps are
// resident and one image's grid fits the card in one wave; a stack fills
// the card either way, and there the deeper queue is faster.
constexpr int kPipeAhead = 4;
constexpr int kPipeAheadOne = 2;
constexpr int kBlock = 32 * kPipeWarps;
constexpr int kVecs = kPipeWords / 4;  // uint4 of a lane's row, each plane
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kPipeWords % 4 == 0 && kTileW == 128 * kPipeWords,
              "a lane owns whole uint4, a warp 32 lanes of them");

using dip::even_bytes;
using dip::odd_bytes;

// One input row as a lane loads it: its words of the three planes, and
// (the warp's edge lanes) the one word beyond them.
struct RowLoad {
  uint32_t w[3][kPipeWords];
  uint32_t edge[3];
};

// Row y of the image at src, of words 32-bit words: the lane's uint4 from
// uint4 column at4 (each clamped to the row), and the word edge_at.
__device__ __forceinline__ RowLoad fetch(const uint8_t* __restrict__ src,
                                         size_t plane, int y, int words,
                                         int at4, int edge_at) {
  RowLoad r;
  const uint8_t* row = src + static_cast<size_t>(y) * (4 * words);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const uint4* v = reinterpret_cast<const uint4*>(row + p * plane);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const uint4 q = v[min(at4 + i, words / 4 - 1)];
      r.w[p][4 * i] = q.x;
      r.w[p][4 * i + 1] = q.y;
      r.w[p][4 * i + 2] = q.z;
      r.w[p][4 * i + 3] = q.w;
    }
    r.edge[p] = reinterpret_cast<const uint32_t*>(row + p * plane)[edge_at];
  }
  return r;
}

// The threshold mask of four pixels, a byte each, 0 or 1, from a word of
// each plane (see the design note, step 2).
__device__ __forceinline__ uint32_t mask4(uint32_t r, uint32_t g,
                                          uint32_t b) {
  constexpr uint32_t hr = kLumaR >> 8, hg = kLumaG >> 8, hb = kLumaB >> 8;
  constexpr uint32_t lr = kLumaR & 255, lg = kLumaG & 255, lb = kLumaB & 255;
  const uint32_t re = even_bytes(r), ge = even_bytes(g), be = even_bytes(b);
  const uint32_t ro = odd_bytes(r), go = odd_bytes(g), bo = odd_bytes(b);
  const uint32_t te = hr * re + hg * ge + hb * be +
                      odd_bytes(lr * re + lg * ge + lb * be);
  const uint32_t to = hr * ro + hg * go + hb * bo +
                      odd_bytes(lr * ro + lg * go + lb * bo);
  // bit 15 of each field, the top bit of bytes 1 and 3, into bytes 0 - 3
  return (__byte_perm(te, to, 0x7351) >> 7) & 0x01010101u;
}

// Byte i-1 and byte i+1 of the word pair (prev, cur) and (cur, next).
__device__ __forceinline__ uint32_t left_of(uint32_t prev, uint32_t cur) {
  return __funnelshift_l(prev, cur, 8);
}
__device__ __forceinline__ uint32_t right_of(uint32_t cur, uint32_t next) {
  return __funnelshift_r(cur, next, 8);
}

// (255 k + 8) >> 4 for each byte k in [0, 16]: 16 k, less 1 for k >= 9.
__device__ __forceinline__ uint32_t blur_out(uint32_t k) {
  const uint32_t f = ((k + 0x07070707u) >> 4) & 0x01010101u;
  return ((k - f) << 4) | (f * 0x0fu);
}

// The bytes of word gx (of a row of `words` words) outside the zero ring of
// kRing columns a side.
__device__ __forceinline__ uint32_t ring_keep(int gx, int words) {
  const int lo = kRing - 4 * gx;                   // ring bytes at its low end
  const int hi = 4 * gx + 4 - (4 * words - kRing);  // and at its high end
  uint32_t keep = ~0u;
  if (lo > 0) keep = lo >= 4 ? 0u : keep << (8 * lo);
  if (hi > 0) keep &= hi >= 4 ? 0u : ~0u >> (8 * hi);
  return keep;
}

// Output rows [y0, y0 + kPipeRows) of the lane's words from input rows
// [y0 - 2, y0 + kPipeRows + 2). kChecked strips clamp the rows they load to
// the plane, write 0 in the ring rows and store no row past the plane.
template <int kAhead, bool kChecked>
__device__ __forceinline__ void walk(const uint8_t* __restrict__ src,
                                     uint8_t* __restrict__ dst, size_t plane,
                                     int hp, int words, int w0, int lane,
                                     int y0) {
  constexpr int W = kPipeWords, R = kPipeRows + 2 * kRing;
  constexpr int D = kAhead < R ? kAhead : R;
  const bool live = w0 < words;
  const int at4 = w0 / 4;
  const int edge_at = lane == 0 ? max(w0 - 1, 0)
                                : min(w0 + W, words - 1);
  uint32_t keep[W];
#pragma unroll
  for (int i = 0; i < W; ++i) keep[i] = ring_keep(w0 + i, words);
  auto row_at = [&](int y) { return kChecked ? min(max(y, 0), hp - 1) : y; };

  RowLoad q[R];
#pragma unroll
  for (int i = 0; i < D; ++i)
    q[i] = fetch(src, plane, row_at(y0 - kRing + i), words, at4, edge_at);
  uint32_t hmin[3][W + 2];  // horizontal mins, x[-1] .. x[W] of a row
  uint32_t hsum[3][W];      // horizontal blur sums of eroded rows
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i + D < R)
      q[i + D] = fetch(src, plane, row_at(y0 - kRing + i + D), words, at4,
                       edge_at);
    // The mask of the row and of the words on either side.
    uint32_t m[W + 2];
#pragma unroll
    for (int k = 0; k < W; ++k)
      m[k + 1] = mask4(q[i].w[0][k], q[i].w[1][k], q[i].w[2][k]);
    const uint32_t e = mask4(q[i].edge[0], q[i].edge[1], q[i].edge[2]);
    const uint32_t l = __shfl_up_sync(kFullWarp, m[W], 1);
    const uint32_t r = __shfl_down_sync(kFullWarp, m[1], 1);
    m[0] = lane == 0 ? e : l;
    m[W + 1] = lane == 31 ? e : r;
    // Of the outer two words only the byte next to the lane's words is
    // whole; the others reach nothing.
#pragma unroll
    for (int k = 0; k < W + 2; ++k)
      hmin[i % 3][k] = m[k] & left_of(k > 0 ? m[k - 1] : 0u, m[k]) &
                       right_of(m[k], k < W + 1 ? m[k + 1] : 0u);
    if (i < 2) continue;
    // Eroded row y0 - 3 + i, and its horizontal 1-2-1 sums.
    uint32_t ero[W + 2];
#pragma unroll
    for (int k = 0; k < W + 2; ++k)
      ero[k] = hmin[0][k] & hmin[1][k] & hmin[2][k];
#pragma unroll
    for (int k = 0; k < W; ++k)
      hsum[i % 3][k] = left_of(ero[k], ero[k + 1]) + 2 * ero[k + 1] +
                       right_of(ero[k + 1], ero[k + 2]);
    if (i < 4) continue;
    // Output row y = y0 - 4 + i from the sums of eroded rows y - 1 .. y + 1.
    const int y = y0 + i - 2 * kRing;
    uint32_t o[W];
#pragma unroll
    for (int k = 0; k < W; ++k)
      o[k] = blur_out(hsum[(i + 1) % 3][k] + 2 * hsum[(i + 2) % 3][k] +
                      hsum[i % 3][k]) & keep[k];
    if (kChecked && (y < kRing || y >= hp - kRing)) {
#pragma unroll
      for (int k = 0; k < W; ++k) o[k] = 0u;
    }
    if (live && (!kChecked || y < hp)) {
      uint8_t* out = dst + static_cast<size_t>(y) * (4 * words);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint4* v = reinterpret_cast<uint4*>(out + p * plane) + at4;
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          if (4 * (at4 + j) < words)
            v[j] = make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2],
                              o[4 * j + 3]);
      }
    }
  }
}

// in and out are (batch, 3, hp, pitch), pitch a multiple of 16; the grid is
// (ceil(pitch / kTileW), ceil(hp / (kPipeWarps * kPipeRows)), batch) of
// kBlock threads.
template <int kAhead>
__global__ void __launch_bounds__(kBlock)
    pipeline_u8(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                int hp, int pitch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int y0 = (blockIdx.y * kPipeWarps + warp) * kPipeRows;
  if (y0 >= hp) return;  // a whole warp
  const size_t plane = static_cast<size_t>(hp) * pitch;
  const size_t image = static_cast<size_t>(blockIdx.z) * 3 * plane;
  const int words = pitch / 4;
  const int w0 = (blockIdx.x * 32 + lane) * kPipeWords;
  if (y0 >= kRing && y0 + kPipeRows + kRing <= hp)
    walk<kAhead, false>(in + image, out + image, plane, hp, words, w0, lane,
                        y0);
  else
    walk<kAhead, true>(in + image, out + image, plane, hp, words, w0, lane,
                       y0);
}

}  // namespace

// in and out are (batch, 3, hp, pitch) uint8, pitch a multiple of 16 and
// both base addresses 16-byte aligned.
DIP_API int dip_pipeline_u8(const void* in, void* out, int batch, int hp,
                            int pitch, void* stream) {
  if (batch < 1 || batch > 65535 || hp < 1 || pitch < 16 || pitch % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((pitch + kTileW - 1) / kTileW,
                  (hp + kPipeWarps * kPipeRows - 1) / (kPipeWarps * kPipeRows),
                  batch);
  void (*kernel)(const uint8_t*, uint8_t*, int, int) =
      batch == 1 ? pipeline_u8<kPipeAheadOne> : pipeline_u8<kPipeAhead>;
  kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), hp, pitch);
  return dip::launch_status();
}
