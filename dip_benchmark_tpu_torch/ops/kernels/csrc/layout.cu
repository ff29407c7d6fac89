// The batch tool's layout bake: a (B, H, W, 3) HWC uint8 stack on the
// card -> the (B, 3, Hp, pitch) planar, mirror-padded stack the kernels
// take (utils/image.py stack_planar_padded, byte for byte).
//
// Replaces no TPU kernel: the JAX package bakes on the host (its
// utils/image.py to_planar_padded, a NumPy gather). On the H100 that
// gather took 96 % of a batch of the batch tool, so the port uploads the
// raw stack and bakes it here.
//
// Bound: device-memory bandwidth. The kernel reads the stack once
// (B*H*W*3 bytes) and writes the planar stack once (B*3*Hp*pitch bytes);
// it does a few byte permutations a word, far below the card's compute.
//
// Design: a block owns one source row of one image (blockIdx.x the row,
// blockIdx.z the image) over a tile of up to kTileWords output words of
// 16 bytes (blockIdx.y the tile; one tile holds 4096 columns, the whole of
// a fundus row), and writes every padded row that mirrors to that source
// row, so each source row is read once:
//   A. the row's bytes go to shared memory with 16-byte loads, at their
//      offset from a 16-byte boundary, so every vector lands aligned;
//      a head or tail that shares a 16-byte word with another row is read
//      byte by byte; a thread issues all its loads (up to kVecsPerThread,
//      the whole of a fundus row for the block) before it stores any, so
//      the row costs one wait for memory, not one a vector;
//   B. each thread takes 16 pixels (48 bytes: three 16-byte shared loads
//      where the row starts on a 16-byte boundary, as a 10,512-byte
//      fundus row does; 13 words and a funnel shift otherwise) and
//      de-interleaves them with byte permutes into one 16-byte word a
//      plane, stored to the plane's shared row;
//   C. each thread writes whole 16-byte words along the pitch: a word
//      whose 16 columns are all inside the image is the plane's row read
//      at the pad's offset (two aligned 16-byte loads and a funnel shift,
//      its word offset a template argument); a word that holds a reflected
//      column (the first pad columns, the last pitch - W - pad) computes
//      the mirror index column by column (spec.mirror_index, clamped: no
//      index table) and reads those bytes from the source row in memory.
#include "common.cuh"

namespace {

constexpr int kBakeThreads = 256;
constexpr int kTileWords = 256;  // output words of 16 columns a tile
constexpr int kVecsPerThread = 4;  // 16-byte loads a thread has in flight

// The spec's mirror rule, clamped (utils/image.py mirror_cols).
__device__ __forceinline__ int mirror_clamped(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - i - 1;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// Four pixels' bytes (x: R0 G0 B0 R1, y: G1 B1 R2 G2, z: B2 R3 G3 B3) ->
// one word of four bytes a plane.
__device__ __forceinline__ void split3(uint32_t x, uint32_t y, uint32_t z,
                                       uint32_t& r, uint32_t& g,
                                       uint32_t& b) {
  r = __byte_perm(__byte_perm(x, y, 0x0630), z, 0x5210);
  g = __byte_perm(__byte_perm(x, y, 0x0741), z, 0x6210);
  b = __byte_perm(__byte_perm(x, y, 0x0052), z, 0x7410);
}

// Shared memory of a block: the source row's bytes, then three planes.
struct Smem {
  int row_bytes;    // 48 * chunks + 32
  int plane_bytes;  // 16 * chunks + 16
};

__host__ __device__ inline Smem smem_for(int chunks) {
  return {48 * chunks + 32, 16 * chunks + 16};
}

// in: (B, H, W, 3); out: (B, 3, H + 2 pad, pitch). chunks: the most 16-pixel
// chunks a tile loads (the shared size). kQ: the word part of the offset
// (-pad) mod 16 at which an inside word sits in its plane's row.
template <int kQ>
__global__ void __launch_bounds__(kBakeThreads)
bake_u8(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h,
        int w, int pad, int pitch, int chunks) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Smem size = smem_for(chunks);
  uint8_t* srow = smem;
  uint8_t* planes = smem + size.row_bytes;

  const int y = blockIdx.x;
  const int b = blockIdx.z;
  const int hp = h + 2 * pad;
  const int words = pitch / 16;
  const int u0 = blockIdx.y * kTileWords;
  const int u1 = min(words, u0 + kTileWords);
  // The pixels this tile's inside words read: [xlo, xhi), xlo on a
  // 16-pixel boundary so that 3 * xlo is one too.
  const int xlo = max(0, 16 * u0 - pad) & ~15;
  const int xhi = min(w, 16 * u1 - pad);
  const uint8_t* src =
      in + (static_cast<size_t>(b) * h + y) * static_cast<size_t>(w) * 3;

  // A. Row bytes [3 xlo, 3 xhi) to srow[a + k], a = the address mod 16.
  if (xhi > xlo) {
    const uint8_t* g0 = src + 3 * static_cast<size_t>(xlo);
    const int n = 3 * (xhi - xlo);
    const int a = static_cast<int>(reinterpret_cast<uintptr_t>(g0) & 15);
    const uint8_t* gs = g0 - a;
    const int vecs = (a + n + 15) / 16;
    // All of a thread's loads are issued before any is stored: a loop of
    // load-then-store would wait for memory once a vector.
    for (int k0 = threadIdx.x; k0 < vecs; k0 += kVecsPerThread * blockDim.x) {
      uint4 v[kVecsPerThread];
#pragma unroll
      for (int i = 0; i < kVecsPerThread; ++i) {
        const int lo = 16 * (k0 + i * blockDim.x);  // srow bytes of a vector
        if (lo >= a && lo + 16 <= a + n)
          v[i] = *reinterpret_cast<const uint4*>(gs + lo);
      }
#pragma unroll
      for (int i = 0; i < kVecsPerThread; ++i) {
        const int lo = 16 * (k0 + i * blockDim.x), hi = lo + 16;
        if (lo >= a && hi <= a + n) {
          reinterpret_cast<uint4*>(srow)[lo / 16] = v[i];
        } else {
          for (int j = max(lo, a); j < min(hi, a + n); ++j) srow[j] = gs[j];
        }
      }
    }
    __syncthreads();

    // B. 16 pixels a thread -> a 16-byte word of each plane.
    const int nchunk = (xhi - xlo + 15) / 16;
    const int plane = size.plane_bytes;
    for (int j = threadIdx.x; j < nchunk; j += blockDim.x) {
      uint32_t v[12];
      if (a == 0) {
        const uint4* p = reinterpret_cast<const uint4*>(srow + 48 * j);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const uint4 t = p[q];
          v[4 * q] = t.x;
          v[4 * q + 1] = t.y;
          v[4 * q + 2] = t.z;
          v[4 * q + 3] = t.w;
        }
      } else {
        const uint32_t* p =
            reinterpret_cast<const uint32_t*>(srow) + ((a >> 2) + 12 * j);
        const unsigned s = 8u * (a & 3);
        uint32_t lo = p[0];
#pragma unroll
        for (int i = 0; i < 12; ++i) {
          const uint32_t hi = p[i + 1];
          v[i] = __funnelshift_r(lo, hi, s);
          lo = hi;
        }
      }
      uint32_t r[4], g[4], bl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split3(v[3 * q], v[3 * q + 1], v[3 * q + 2], r[q], g[q], bl[q]);
      reinterpret_cast<uint4*>(planes)[j] = make_uint4(r[0], r[1], r[2], r[3]);
      reinterpret_cast<uint4*>(planes + plane)[j] =
          make_uint4(g[0], g[1], g[2], g[3]);
      reinterpret_cast<uint4*>(planes + 2 * plane)[j] =
          make_uint4(bl[0], bl[1], bl[2], bl[3]);
    }
  }
  __syncthreads();

  // The padded rows that mirror to source row y besides its own (y + pad):
  // the top halo's pad - y (for 1 <= y <= pad) and the bottom halo's
  // 2h - 1 - y + pad (for h - pad <= y); -1 where there is none.
  const int top = (y >= 1 && y <= pad) ? pad - y : -1;
  const int bottom = y >= h - pad ? 2 * h - 1 - y + pad : -1;
  const size_t row_words = pitch / 16;

  // C. Whole 16-byte words along the pitch, one plane after another.
  const int tile = u1 - u0;
  const int r = (16 - (pad & 15)) & 3;  // (-pad) mod 16 = 4 kQ + r
  for (int t = threadIdx.x; t < 3 * tile; t += blockDim.x) {
    const int ch = t / tile;
    const int u = u0 + t % tile;
    const int x0 = 16 * u - pad;  // the word's first column's pixel
    uint4 word;
    if (x0 >= 0 && x0 + 16 <= w) {
      const int e = x0 - xlo - 4 * kQ - r;  // a multiple of 16
      const uint4* p = reinterpret_cast<const uint4*>(
          planes + ch * size.plane_bytes + e);
      const uint4 p0 = p[0], p1 = p[1];
      const uint32_t q[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const unsigned s = 8u * r;
      word.x = __funnelshift_r(q[kQ], q[kQ + 1], s);
      word.y = __funnelshift_r(q[kQ + 1], q[kQ + 2], s);
      word.z = __funnelshift_r(q[kQ + 2], q[kQ + 3], s);
      word.w = __funnelshift_r(q[kQ + 3], q[kQ + 4], s);
    } else {
      uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int x = mirror_clamped(x0 + k, w);
        q[k >> 2] |= static_cast<uint32_t>(src[3 * x + ch]) << (8 * (k & 3));
      }
      word = make_uint4(q[0], q[1], q[2], q[3]);
    }
    uint4* column = reinterpret_cast<uint4*>(out) +
                    (static_cast<size_t>(b) * 3 + ch) * hp * row_words + u;
    column[(y + pad) * row_words] = word;
    if (top >= 0) column[top * row_words] = word;
    if (bottom >= 0) column[bottom * row_words] = word;
  }
}

template <int kQ>
int launch_bake(const void* in, void* out, int b, int h, int w, int pad,
                int pitch, cudaStream_t stream) {
  const int words = pitch / 16;
  const int tiles = (words + kTileWords - 1) / kTileWords;
  // The most chunks a tile loads: its words' pixels, from a 16-pixel
  // boundary at most 15 pixels before the first.
  const int chunks = (16 * min(words, kTileWords) + 15 + 15) / 16;
  const Smem size = smem_for(chunks);
  const size_t bytes = size.row_bytes + 3 * static_cast<size_t>(size.plane_bytes);
  bake_u8<kQ><<<dim3(h, tiles, b), kBakeThreads, bytes, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), h, w, pad,
      pitch, chunks);
  return dip::launch_status();
}

}  // namespace

// in: (b, h, w, 3) uint8 on the card; out: (b, 3, h + 2 pad, pitch), pitch a
// multiple of 16 of at least w + 2 pad, out 16-byte aligned. Needs
// 0 <= pad < min(h, w) (utils/image.py make_layout).
DIP_API int dip_bake_u8(const void* in, void* out, int b, int h, int w,
                        int pad, int pitch, void* stream) {
  if (b < 1 || pad < 0 || h < pad + 1 || w < pad + 1 || pitch % 16 ||
      pitch < w + 2 * pad || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (((16 - (pad & 15)) & 15) >> 2) {
    case 0: return launch_bake<0>(in, out, b, h, w, pad, pitch, s);
    case 1: return launch_bake<1>(in, out, b, h, w, pad, pitch, s);
    case 2: return launch_bake<2>(in, out, b, h, w, pad, pitch, s);
    default: return launch_bake<3>(in, out, b, h, w, pad, pitch, s);
  }
}
