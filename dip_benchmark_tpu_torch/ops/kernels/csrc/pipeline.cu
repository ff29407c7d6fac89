// The fused pipeline of the uint8 model: grayscale, threshold, 3x3 square
// erosion and the 1-2-1 x 1-2-1 blur in one kernel, over one planar padded
// image (3, Hp, pitch) or a stack of them (B, 3, Hp, pitch).
//
// Replaces dip_benchmark_tpu/models/pipeline.py:30
// make_fused_pipeline_pallas, and with it the fused_channels and batch modes
// of the skeleton _windowed_call (ops/pallas/window.py:57-65, 115-131,
// 203-215): one block reads all three planes of its tile, and blockIdx.z is
// the batch index.
//
// Bound: device-memory bandwidth. Each image's three planes are read once
// and written once (2 * 3 * Hp * pitch bytes); the arithmetic is a few
// dozen integer operations per pixel, far below the card's rate.
//
// Design: a block owns a kTileH x kTileW tile of output pixels and runs the
// four stages on it in shared memory, so no stage recomputes another's
// values and the planes are read about once (the tile's halo, 2 rows and 4
// columns a side, adds 20 % to the reads, mostly L2 hits):
//   1. luma of every pixel of the tile and its halo, from 4-byte words of
//      the three planes, thresholded to {0, kThresholdMax} (a compare with
//      the threshold, as point_u8<Threshold> does);
//   2. the 3x3 erosion of that mask with a 1-pixel halo. On two-valued
//      {0, M} data the minimum is a bitwise AND;
//   3. the blur (o + 8) >> 4, four output bytes a thread, one 4-byte store
//      into each of the three planes.
// Like window_u8, the output has the input's shape and every byte of it is
// written: the pipeline where every tap lies in the buffer, 0 in the outer
// ring of 2 rows and 2 columns (erosion 1 + blur 1). The mirror halo is
// baked into the layout, so the taps need no boundary logic. TMA tiles and
// byte-SIMD stages are later work.
#include "common.cuh"

namespace {

// spec.GRAYSCALE_WEIGHTS_INT_RGB, spec.GRAYSCALE_SHIFT, spec.THRESHOLD_VALUE
// and spec.THRESHOLD_MAX; a test holds these lines equal to the spec.
constexpr int kLumaR = 13933;
constexpr int kLumaG = 46871;
constexpr int kLumaB = 4732;
constexpr int kLumaShift = 16;
constexpr int kThreshold = 127;
constexpr int kThresholdMax = 255;

constexpr int kRing = 2;        // erosion radius 1 + blur radius 1
constexpr int kTileW = 128;     // output columns of a block, a multiple of 4
constexpr int kTileH = 32;      // output rows of a block
constexpr int kBlock = 256;     // threads of a block
// Mask tile: padded rows y0-2 .. y0+kTileH+1 and columns x0-4 ..
// x0+kTileW+3, whole 4-byte words so every load is an aligned word.
constexpr int kMaskH = kTileH + 4;
constexpr int kMaskWords = (kTileW + 8) / 4;
constexpr int kMaskW = 4 * kMaskWords;
// Eroded tile: padded rows y0-1 .. y0+kTileH, columns x0-1 .. x0+kTileW.
constexpr int kEroH = kTileH + 2;
constexpr int kEroW = kTileW + 2;

__device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store_word(uint8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// Four mask bytes from four R, G and B bytes: the spec's exact fixed-point
// luma (every product and sum < 2^24), then luma > kThreshold.
__device__ __forceinline__ uint32_t mask4(uint32_t r, uint32_t g,
                                          uint32_t b) {
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = 8 * k;
    const int luma = (kLumaR * static_cast<int>((r >> s) & 0xFFu) +
                      kLumaG * static_cast<int>((g >> s) & 0xFFu) +
                      kLumaB * static_cast<int>((b >> s) & 0xFFu)) >>
                     kLumaShift;
    if (luma > kThreshold) m |= static_cast<uint32_t>(kThresholdMax) << s;
  }
  return m;
}

// in and out are (batch, 3, hp, pitch); the grid is
// (ceil(pitch / kTileW), ceil(hp / kTileH), batch).
__global__ void __launch_bounds__(kBlock)
    pipeline_u8(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                int hp, int pitch) {
  __shared__ uint32_t mask_words[kMaskH][kMaskWords];
  __shared__ uint8_t ero[kEroH][kEroW];

  const size_t plane = static_cast<size_t>(hp) * pitch;
  const size_t image = static_cast<size_t>(blockIdx.z) * 3 * plane;
  const uint8_t* src = in + image;
  uint8_t* dst = out + image;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;

  // 1. Grayscale and threshold. A word outside the buffer gets mask 0: it
  //    only reaches outputs in the ring, which are written 0. A word that
  //    starts inside the buffer ends inside it (pitch % 4 == 0).
  for (int i = threadIdx.x; i < kMaskH * kMaskWords; i += kBlock) {
    const int r = i / kMaskWords, w = i % kMaskWords;
    const int gy = y0 - 2 + r, gx = x0 - 4 + 4 * w;
    uint32_t m = 0;
    if (gy >= 0 && gy < hp && gx >= 0 && gx < pitch) {
      const uint8_t* p = src + static_cast<size_t>(gy) * pitch + gx;
      m = mask4(load_word(p), load_word(p + plane), load_word(p + 2 * plane));
    }
    mask_words[r][w] = m;
  }
  __syncthreads();
  const uint8_t* mask = reinterpret_cast<const uint8_t*>(mask_words);

  // 2. Erosion. Eroded (r, e) is padded pixel (y0 - 1 + r, x0 - 1 + e);
  //    its taps are mask rows r .. r + 2 and mask columns e + 2 .. e + 4.
  for (int i = threadIdx.x; i < kEroH * kEroW; i += kBlock) {
    const int r = i / kEroW, e = i % kEroW;
    uint32_t v = 0xFFu;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 2; dx < 5; ++dx) v &= mask[(r + dy) * kMaskW + e + dx];
    ero[r][e] = static_cast<uint8_t>(v);
  }
  __syncthreads();

  // 3. Blur. Output (s, t .. t + 3) is padded row y0 + s, columns
  //    x0 + t .. x0 + t + 3; its taps are eroded rows s .. s + 2 and
  //    eroded columns t .. t + 5. The sum is at most 255 * 16: no clamp.
  for (int i = threadIdx.x; i < kTileH * (kTileW / 4); i += kBlock) {
    const int s = i / (kTileW / 4), t = 4 * (i % (kTileW / 4));
    const int gy = y0 + s, gx = x0 + t;
    if (gy >= hp || gx >= pitch) continue;
    int col[6];
#pragma unroll
    for (int c = 0; c < 6; ++c)
      col[c] = ero[s][t + c] + 2 * ero[s + 1][t + c] + ero[s + 2][t + c];
    const bool row_in = gy >= kRing && gy < hp - kRing;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = gx + k;
      if (row_in && x >= kRing && x < pitch - kRing) {
        const int o = col[k] + 2 * col[k + 1] + col[k + 2];
        word |= static_cast<uint32_t>((o + 8) >> 4) << (8 * k);
      }
    }
    uint8_t* q = dst + static_cast<size_t>(gy) * pitch + gx;
    store_word(q, word);
    store_word(q + plane, word);
    store_word(q + 2 * plane, word);
  }
}

}  // namespace

// in and out are (batch, 3, hp, pitch) uint8, pitch a multiple of 16 and
// both base addresses 16-byte aligned.
DIP_API int dip_pipeline_u8(const void* in, void* out, int batch, int hp,
                            int pitch, void* stream) {
  if (batch < 1 || batch > 65535 || hp < 1 || pitch < 16 || pitch % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((pitch + kTileW - 1) / kTileW, (hp + kTileH - 1) / kTileH,
                  batch);
  pipeline_u8<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), hp, pitch);
  return dip::launch_status();
}
