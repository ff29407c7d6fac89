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
// _encode), per stage the words kind, kh, kw, shift and kh * kw weights.
// All threads of a block read the same descriptor word at the same time, so
// those reads are broadcasts. Point stages are not capped in number; the
// windowed ones are a 3x3 min (cross or square) and kh x kw correlations
// (3x3, 5x5, 1x3, 3x1, 1x5, 5x1), whose radii sum to at most kMaxRadius.
//
// Bound: device-memory bandwidth. The planar buffer, baked with the chain's
// halo, is read once and written once (2 * C * Hp * pitch elements); a
// stage does at most 25 multiply-adds a position.
//
// Design: a block owns a kTileH x kTileW output tile. It loads the tile and
// the chain's whole halo (Ry rows and Rx columns a side) into shared memory
// once (in gray-first mode as the luma of the three planes), then runs the
// windowed stages there, ping-ponging between two buffers, each shrinking
// the computed region by its (ry, rx). A point stage costs no pass of its
// own: it is applied where its input is made, at the load or at the write
// of the windowed stage before it. The halo's rereads hit L2, not device
// memory (24 % more reads at R = 3). Only the output tile is stored, to the
// plane it came from or, gray first, to all three. blockIdx.z walks the
// B * C planes (per channel) or the B images (gray first).
//
// What bounds this version is not bytes but the shared-memory loads and
// the instructions around them, one load a tap: a thread computes a strip
// of kRows outputs of one column from the (kRows + KH - 1) x KW window it
// loads once into registers, and the strips of a stage are dealt out in
// row-major order, so neighbouring lanes read neighbouring columns and no
// lane idles until the last strip.
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
// Arithmetic: uint8 keeps u8 values between stages, since every stage of
// the JAX chain rounds to u8 (chain.py:403-407): int32 sums in registers,
// (acc + half) >> shift clamped to [0, 255]. float32 keeps floats and does
// every multiply and add with __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA, in the JAX stage order: for each mask column kx
// the sum over ky, then the column sums over kx (_conv_rank1_f32); the luma
// (wr * R + wg * G) + wb * B. TMA tiles, byte-SIMD stages and persistent
// blocks are later work.
#include "common.cuh"

namespace {

// Stage kinds, as models/chain.py KINDS numbers them.
constexpr int kCopy = 0;
constexpr int kInvert = 1;
constexpr int kThreshold = 2;
constexpr int kMin = 3;
constexpr int kConv = 4;
constexpr int kHeader = 4;     // kind, kh, kw, shift; then kh * kw weights
constexpr int kMaxRadius = 8;  // models/chain.py MAX_CHAIN_RADIUS
constexpr int kTileW = 128;    // output columns of a block
constexpr int kTileH = 32;     // output rows of a block

// spec.THRESHOLD_VALUE and spec.THRESHOLD_MAX; a test holds these lines
// equal to the spec.
constexpr int kThresholdU8 = 127;
constexpr int kThresholdMaxU8 = 255;

struct U8 {
  using T = uint8_t;
  using W = int;
  struct Luma {
    int r, g, b, shift;
  };
  __device__ static T gray(T r, T g, T b, const Luma& l) {
    return static_cast<T>((l.r * r + l.g * g + l.b * b) >> l.shift);
  }
  __device__ static T point(int kind, T v) {
    if (kind == kInvert) return static_cast<T>(255 - v);
    if (kind == kThreshold) return v > kThresholdU8 ? kThresholdMaxU8 : 0;
    return v;
  }
  __device__ static T top() { return 255; }
  __device__ static T lesser(T a, T b) { return a < b ? a : b; }
  __device__ static W weight(int word) { return word; }
  template <int KH, int KW>
  __device__ static T conv(const T* p, int stride, const W* w, int shift) {
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < KH; ++ky)
#pragma unroll
      for (int kx = 0; kx < KW; ++kx)
        acc += w[ky * KW + kx] * p[ky * stride + kx];
    const int v = (acc + (shift > 0 ? 1 << (shift - 1) : 0)) >> shift;
    return static_cast<T>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
};

struct F32 {
  using T = float;
  using W = float;
  struct Luma {
    float r, g, b;
  };
  __device__ static T gray(T r, T g, T b, const Luma& l) {
    return __fadd_rn(__fadd_rn(__fmul_rn(l.r, r), __fmul_rn(l.g, g)),
                     __fmul_rn(l.b, b));
  }
  __device__ static T point(int kind, T v) {
    if (kind == kInvert) return __fsub_rn(1.0f, v);
    if (kind == kThreshold) return v > 0.5f ? 1.0f : 0.0f;
    return v;
  }
  __device__ static T top() { return __int_as_float(0x7f800000); }  // +inf
  __device__ static T lesser(T a, T b) { return fminf(a, b); }
  __device__ static W weight(int word) { return __int_as_float(word); }
  template <int KH, int KW>
  __device__ static T conv(const T* p, int stride, const W* w, int) {
    float acc = 0.0f;
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) {
      float col = __fmul_rn(p[kx], w[kx]);
#pragma unroll
      for (int ky = 1; ky < KH; ++ky)
        col = __fadd_rn(col, __fmul_rn(p[ky * stride + kx], w[ky * KW + kx]));
      acc = kx == 0 ? col : __fadd_rn(acc, col);
    }
    return acc;
  }
};

// Each buffer is bh x bw plus kRows - 1 rows of slack, which a thread's
// last strip may read past the region it computes; those rows only reach
// outputs that are not written.
constexpr int kRows = 2;        // output rows of a thread's strip
constexpr int kWarp = 32;
constexpr int kBlock = 256;     // threads of a block
// Blocks an SM keeps resident: the compiler holds a thread to 64 registers
// for it. Taller strips save shared-memory loads but need more registers,
// and the blocks an SM then loses cost more than the loads saved.
constexpr int kBlocksPerSM = 4;

// The run of n point stages at run (each kHeader + 1 words) applied to v.
template <class M>
__device__ typename M::T apply_run(typename M::T v, const int* run, int n) {
  for (int k = 0; k < n; ++k) v = M::point(__ldg(run + k * (kHeader + 1)), v);
  return v;
}

// A kh x kw correlation of the registers x[v .. v + KH - 1][0 .. KW - 1].
template <class M, int KH, int KW>
struct ConvOp {
  typename M::W w[KH * KW];
  int shift;
  template <int R>
  __device__ typename M::T operator()(const typename M::T (&x)[R][KW],
                                      int v) const {
    return M::template conv<KH, KW>(&x[v][0], KW, w, shift);
  }
};

// The min over the taps of a 3x3 structuring element (weights 0 or 1).
template <class M>
struct MinOp {
  int taps[9];
  template <int R>
  __device__ typename M::T operator()(const typename M::T (&x)[R][3],
                                      int v) const {
    typename M::T m = M::top();
#pragma unroll
    for (int k = 0; k < 9; ++k)
      if (taps[k]) m = M::lesser(m, x[v + k / 3][k % 3]);
    return m;
  }
};

// One windowed stage: rows [ny, bh - ny) and columns [nx, bw - nx) of dst
// from src, then the run of point stages after it. A thread computes a
// strip of kRows outputs of one column from the (kRows + KH - 1) x KW
// window it loads once into registers.
template <class M, int KH, int KW, class Op>
__device__ void window_stage(const typename M::T* src, typename M::T* dst,
                             int bh, int bw, int ny, int nx, const Op& op,
                             const int* run, int n_run) {
  using T = typename M::T;
  const int rh = bh - 2 * ny, rw = bw - 2 * nx;
  const int groups = (rh + kRows - 1) / kRows;
  // Strip (g, j) is column j of row group g, taken in row-major order:
  // neighbouring threads take neighbouring columns, and every lane has
  // work until the last strip. One division a stage, none a strip.
  const int step_g = kBlock / rw, step_j = kBlock - step_g * rw;
  int g = threadIdx.x / rw, j = threadIdx.x - g * rw;
  while (g < groups) {
    const int i0 = g * kRows;
    const T* p = src + (ny + i0 - KH / 2) * bw + nx + j - KW / 2;
    T x[kRows + KH - 1][KW];
#pragma unroll
    for (int r = 0; r < kRows + KH - 1; ++r)
#pragma unroll
      for (int kx = 0; kx < KW; ++kx) x[r][kx] = p[r * bw + kx];
    T* q = dst + (ny + i0) * bw + nx + j;
#pragma unroll
    for (int v = 0; v < kRows; ++v)
      if (i0 + v < rh) q[v * bw] = apply_run<M>(op(x, v), run, n_run);
    g += step_g;
    j += step_j;
    if (j >= rw) {
      j -= rw;
      ++g;
    }
  }
}

template <class M, int KH, int KW>
__device__ void conv_stage(const typename M::T* src, typename M::T* dst,
                           int bh, int bw, int ny, int nx, const int* wd,
                           int shift, const int* run, int n_run) {
  ConvOp<M, KH, KW> op;
#pragma unroll
  for (int k = 0; k < KH * KW; ++k) op.w[k] = M::weight(__ldg(wd + k));
  op.shift = shift;
  window_stage<M, KH, KW>(src, dst, bh, bw, ny, nx, op, run, n_run);
}

// Skip the point stages at *d, at most n_stages - *s of them; their count.
__device__ int skip_points(const int** d, int* s, int n_stages) {
  int n = 0;
  while (*s < n_stages && __ldg(*d) < kMin) {
    *d += kHeader + 1;
    ++*s;
    ++n;
  }
  return n;
}

// in and out are (count * (kGray ? 3 : 1), hp, pitch); the grid is
// (ceil(pitch / kTileW), ceil(hp / kTileH), count) of kBlock threads;
// dynamic shared memory holds two (kTileH + 2 ry + kRows - 1) x
// (kTileW + 2 rx) buffers.
template <class M, bool kGray>
__global__ void __launch_bounds__(kBlock, kBlocksPerSM)
    chain_kernel(const typename M::T* __restrict__ in,
                 typename M::T* __restrict__ out, int hp, int pitch,
                 const int* __restrict__ desc, int n_stages, int ry, int rx,
                 const typename M::Luma luma) {
  using T = typename M::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = kTileH + 2 * ry, bw = kTileW + 2 * rx;
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = cur + (bh + kRows - 1) * bw;

  const size_t plane = static_cast<size_t>(hp) * pitch;
  const size_t base = static_cast<size_t>(blockIdx.z) * (kGray ? 3 : 1) * plane;
  const T* src = in + base;
  T* dst = out + base;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  // Load the tile and its halo, through the point stages before the first
  // windowed one: buffer (i, j) is padded pixel (y0 - ry + i, x0 - rx + j).
  const int* d = desc;
  int s = 0;
  const int* run = d;
  int n_run = skip_points(&d, &s, n_stages);
  for (int i = warp; i < bh; i += kBlock / kWarp) {
    const int gy = y0 - ry + i;
    for (int j = lane; j < bw; j += kWarp) {
      const int gx = x0 - rx + j;
      T v = 0;
      if (gy >= 0 && gy < hp && gx >= 0 && gx < pitch) {
        const T* p = src + static_cast<size_t>(gy) * pitch + gx;
        v = kGray ? M::gray(p[0], p[plane], p[2 * plane], luma) : p[0];
      }
      cur[i * bw + j] = apply_run<M>(v, run, n_run);
    }
  }

  int ny = 0, nx = 0;  // margin of the region computed so far
  while (s < n_stages) {
    const int kind = __ldg(d), kh = __ldg(d + 1), kw = __ldg(d + 2);
    const int shift = __ldg(d + 3);
    const int* w = d + kHeader;
    d = w + kh * kw;
    ++s;
    run = d;
    n_run = skip_points(&d, &s, n_stages);
    __syncthreads();  // the last stage's writes are in, its reads done
    ny += kh / 2;
    nx += kw / 2;
    if (kind == kMin) {
      MinOp<M> op;
#pragma unroll
      for (int k = 0; k < 9; ++k) op.taps[k] = __ldg(w + k);
      window_stage<M, 3, 3>(cur, nxt, bh, bw, ny, nx, op, run, n_run);
    } else {
      switch (kh * 8 + kw) {
        case 3 * 8 + 3:
          conv_stage<M, 3, 3>(cur, nxt, bh, bw, ny, nx, w, shift, run, n_run);
          break;
        case 5 * 8 + 5:
          conv_stage<M, 5, 5>(cur, nxt, bh, bw, ny, nx, w, shift, run, n_run);
          break;
        case 1 * 8 + 3:
          conv_stage<M, 1, 3>(cur, nxt, bh, bw, ny, nx, w, shift, run, n_run);
          break;
        case 3 * 8 + 1:
          conv_stage<M, 3, 1>(cur, nxt, bh, bw, ny, nx, w, shift, run, n_run);
          break;
        case 1 * 8 + 5:
          conv_stage<M, 1, 5>(cur, nxt, bh, bw, ny, nx, w, shift, run, n_run);
          break;
        default:  // 5 x 1; the host checked the descriptor
          conv_stage<M, 5, 1>(cur, nxt, bh, bw, ny, nx, w, shift, run, n_run);
          break;
      }
    }
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  __syncthreads();

  // Store the tile: output (r, c) is buffer (ry + r, rx + c), 0 in the ring.
  for (int r = warp; r < kTileH; r += kBlock / kWarp) {
    const int gy = y0 + r;
    if (gy >= hp) break;
    for (int c = lane; c < kTileW; c += kWarp) {
      const int gx = x0 + c;
      if (gx >= pitch) break;
      const bool ring =
          gy < ry || gy >= hp - ry || gx < rx || gx >= pitch - rx;
      const T v = ring ? T(0) : cur[(ry + r) * bw + rx + c];
      const size_t o = static_cast<size_t>(gy) * pitch + gx;
      dst[o] = v;
      if (kGray) {
        dst[o + plane] = v;
        dst[o + 2 * plane] = v;
      }
    }
  }
}

bool conv_shape(int kh, int kw) {
  return (kh == 3 && kw == 3) || (kh == 5 && kw == 5) ||
         (kh == 1 && (kw == 3 || kw == 5)) ||
         (kw == 1 && (kh == 3 || kh == 5));
}

// Check the host copy of the descriptor: only kinds and shapes the kernel
// has, words that add up, radii within kMaxRadius. Sets the stage count and
// the chain's radii. No stage at all is a Grayscale-only chain.
bool parse(const int* desc, int n_words, int* n_stages, int* ry, int* rx) {
  int i = 0, n = 0;
  *ry = *rx = 0;
  while (i + kHeader <= n_words) {
    const int kind = desc[i], kh = desc[i + 1], kw = desc[i + 2];
    const int shift = desc[i + 3];
    bool ok = false;
    if (kind == kCopy || kind == kInvert || kind == kThreshold)
      ok = kh == 1 && kw == 1;
    else if (kind == kMin)
      ok = kh == 3 && kw == 3;
    else if (kind == kConv)
      ok = conv_shape(kh, kw) && shift >= 0 && shift < 31;
    if (!ok) return false;
    *ry += kh / 2;
    *rx += kw / 2;
    i += kHeader + kh * kw;
    ++n;
  }
  *n_stages = n;
  return i == n_words && *ry <= kMaxRadius && *rx <= kMaxRadius;
}

template <class M>
int launch_chain(const void* in, void* out, int count, int hp, int pitch,
                 int gray, const void* desc, const int* desc_host,
                 int n_words, const typename M::Luma& luma, void* stream) {
  int n_stages, ry, rx;
  if (count < 1 || count > 65535 || hp < 1 || pitch < 1 || n_words < 0 ||
      (n_words > 0 && desc_host == nullptr) ||
      !parse(desc_host, n_words, &n_stages, &ry, &rx) ||
      (n_stages == 0 && !gray))
    return static_cast<int>(cudaErrorInvalidValue);
  using T = typename M::T;
  const size_t smem = 2 * static_cast<size_t>(kTileH + 2 * ry + kRows - 1) *
                      (kTileW + 2 * rx) * sizeof(T);
  void (*kernel)(const T*, T*, int, int, const int*, int, int, int,
                 typename M::Luma) = chain_kernel<M, false>;
  if (gray) kernel = chain_kernel<M, true>;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((pitch + kTileW - 1) / kTileW, (hp + kTileH - 1) / kTileH,
                  count);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), hp, pitch,
      static_cast<const int*>(desc), n_stages, ry, rx, luma);
  return dip::launch_status();
}

}  // namespace

// in and out are (count, C, hp, pitch) uint8 read as count * C planes, or
// with gray != 0 (count, 3, hp, pitch) with count images; desc is the
// descriptor on the card and desc_host the same n_words on the host; wr,
// wg, wb and shift are the fixed-point luma of a Grayscale first stage.
DIP_API int dip_chain_u8(const void* in, void* out, int count, int hp,
                         int pitch, int gray, const void* desc,
                         const int* desc_host, int n_words, int wr, int wg,
                         int wb, int shift, void* stream) {
  return launch_chain<U8>(in, out, count, hp, pitch, gray, desc, desc_host,
                          n_words, U8::Luma{wr, wg, wb, shift}, stream);
}

// The same for float32; the conv weights in desc are float bits.
DIP_API int dip_chain_f32(const void* in, void* out, int count, int hp,
                          int pitch, int gray, const void* desc,
                          const int* desc_host, int n_words, float wr,
                          float wg, float wb, void* stream) {
  return launch_chain<F32>(in, out, count, hp, pitch, gray, desc, desc_host,
                           n_words, F32::Luma{wr, wg, wb}, stream);
}
