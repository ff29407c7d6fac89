// The alternative design that benchmarks/h100/chain_lab.py times beside
// chain_u8: one ring for all stages. Appended to a copy of csrc/chain.cu
// (it uses that file's bodies, Conv, SepConv, MinSquare, MinCross, and its
// point runs), built only by the lab, never by the port.
//
// chain_u8 keeps the intermediates between windowed stages in a
// shared-memory tile: every stage reads the rows of the stage before from
// it (three loads a word) and writes its own (one store), and the tile's
// halo is recomputed by each stage. Here all stages walk down a strip
// together instead, with no shared memory: a lane owns one 32-bit word of
// a row, each stage keeps its ring of 2 HY + 1 row partials in registers,
// and the word a stage writes goes straight into the next stage's ring,
// its neighbour words from the lanes beside it by warp shuffle. The
// price: each stage loses the words at both ends of the warp (32 - 2 S of
// a warp's 32 lanes store, S the windowed stages), and a strip recomputes
// the chain's 2 Ry rows of halo. The stage list is fixed at compile time
// (StreamC1 .. StreamC4, chip_smoke.CHAINS C1-C4), so this is the most the
// design could give; the chain kernel takes its stages at run time. It is
// slower than chain_u8 on each of the four chains (PERF.md, section 6).
namespace {

constexpr unsigned kStreamFullWarp = 0xffffffffu;
constexpr int kStreamRows = 64;   // output rows of a warp's strip
constexpr int kStreamWarps = 4;   // warps of a block, side by side

// A walk over the descriptor.
struct Cursor {
  const int* d;
  int s, n;
};

// The next windowed stage: its payload and shift, then the point run after
// it folded into *post.
__device__ const int* next_window(Cursor& c, int* shift, PointRun* post) {
  const int kind = __ldg(c.d), kh = __ldg(c.d + 1), kw = __ldg(c.d + 2);
  *shift = __ldg(c.d + 3);
  const int* payload = c.d + kHeader;
  c.d = payload + (kind == kConv ? kh + kw : kh * kw);
  ++c.s;
  *post = fold_points(&c.d, &c.s, c.n);
  return payload;
}

// One stage of the walk: its body, the point run after it, and its ring.
template <class Body>
struct Stream {
  static constexpr int K = 2 * Body::HY + 1;
  Body body;
  PointRun post;
  typename Body::Row ring[K] = {};
  // The stage's output word for input word w of this lane, whose
  // neighbours come from the lanes beside it; j counts the rows walked, in
  // a loop unrolled by a multiple of K so that the ring stays in registers.
  __device__ __forceinline__ uint32_t step(uint32_t w, int j) {
    uint32_t x[3];
    x[0] = __shfl_up_sync(kStreamFullWarp, w, 1);
    x[1] = w;
    x[2] = __shfl_down_sync(kStreamFullWarp, w, 1);
    ring[(j + K - 1) % K] = body.row(x);
    return post(body.template out<K>(ring, j % K));
  }
};

// C1: Convolution-5x5, Inversion, Convolution-3x3.
struct StreamC1 {
  static constexpr int kStages = 2, kPeriod = 15;
  Stream<Conv<5, 5, true>> a;
  Stream<Conv<3, 3, true>> b;
  __device__ void init(Cursor& c) {
    int shift;
    const int* p = next_window(c, &shift, &a.post);
    a.body = conv_body<5, 5, true>(p, shift);
    p = next_window(c, &shift, &b.post);
    b.body = conv_body<3, 3, true>(p, shift);
  }
  __device__ __forceinline__ uint32_t step(uint32_t w, int j) {
    return b.step(a.step(w, j), j);
  }
};

// C2 after its luma and threshold: Erosion-3x3-Square, Gaussian-Blur-3x3.
struct StreamC2 {
  static constexpr int kStages = 2, kPeriod = 3;
  Stream<MinSquare> a;
  Stream<Conv<3, 3, true>> b;
  __device__ void init(Cursor& c) {
    int shift;
    next_window(c, &shift, &a.post);
    const int* p = next_window(c, &shift, &b.post);
    b.body = conv_body<3, 3, true>(p, shift);
  }
  __device__ __forceinline__ uint32_t step(uint32_t w, int j) {
    return b.step(a.step(w, j), j);
  }
};

// C3: Convolution-1x5+5x1 (its two stages as one, as chain_u8 runs them),
// Erosion-3x3-Cross.
struct StreamC3 {
  static constexpr int kStages = 2, kPeriod = 15;
  Stream<SepConv<5, true>> a;
  Stream<MinCross> b;
  __device__ void init(Cursor& c) {
    int s1, s2;
    PointRun none;
    const int* p1 = next_window(c, &s1, &none);
    const int* p2 = next_window(c, &s2, &a.post);
    a.body.first = conv_body<1, 5, true>(p1, s1);
    a.body.second = conv_body<5, 1, true>(p2, s2);
    next_window(c, &s1, &b.post);
  }
  __device__ __forceinline__ uint32_t step(uint32_t w, int j) {
    return b.step(a.step(w, j), j);
  }
};

// C4: Convolution-5x5 four times.
struct StreamC4 {
  static constexpr int kStages = 4, kPeriod = 5;
  Stream<Conv<5, 5, true>> s[4];
  __device__ void init(Cursor& c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int shift;
      const int* p = next_window(c, &shift, &s[i].post);
      s[i].body = conv_body<5, 5, true>(p, shift);
    }
  }
  __device__ __forceinline__ uint32_t step(uint32_t w, int j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w = s[i].step(w, j);
    return w;
  }
};

// The arguments and whole-buffer contract of chain_u8. The grid is
// (ceil(ceil(words / (32 - 2 S)) / kStreamWarps), ceil(hp / kStreamRows),
// count) of 32 kStreamWarps threads; warp g of the row of warps owns words
// [g (32 - 2 S), (g + 1) (32 - 2 S)), its lane l loading word
// g (32 - 2 S) - S + l.
template <class Chain, bool kGray>
__global__ void __launch_bounds__(32 * kStreamWarps)
    chain_u8_stream(const uint32_t* __restrict__ in,
                    uint32_t* __restrict__ out, int hp, int words,
                    const int* __restrict__ desc, int n_stages, int ry,
                    int rx, const U8Luma luma) {
  constexpr int S = Chain::kStages, P = Chain::kPeriod;
  const int lane = threadIdx.x & 31;
  const int group = blockIdx.x * kStreamWarps + (threadIdx.x >> 5);
  const int gx = group * (32 - 2 * S) - S + lane;
  const int y0 = blockIdx.y * kStreamRows;
  const size_t plane = static_cast<size_t>(hp) * words;
  const size_t base =
      static_cast<size_t>(blockIdx.z) * (kGray ? 3 : 1) * plane;
  const uint32_t* src = in + base;
  uint32_t* dst = out + base;

  Cursor c{desc, 0, n_stages};
  const PointRun pre = fold_points(&c.d, &c.s, c.n);
  Chain chain;
  chain.init(c);

  const bool in_x = gx >= 0 && gx < words;
  const bool owns = in_x && lane >= S && lane < 32 - S;
  const uint32_t keep = ring_keep(gx, words, rx);
  // Row gy of this lane's word column through the point stages before the
  // first windowed one; 0 outside the buffer.
  auto load = [&](int gy) {
    uint32_t w = 0u;
    if (in_x && gy >= 0 && gy < hp) {
      const uint32_t* p = src + static_cast<size_t>(gy) * words + gx;
      w = __ldg(p);
      if (kGray) w = luma4(w, __ldg(p + plane), __ldg(p + 2 * plane), luma);
    }
    return pre(w);
  };

  // Step i reads input row y0 - ry + i (loaded two steps ahead); the last
  // stage then gives output row y0 + i - 2 ry, once every ring is full.
  const int n_steps = kStreamRows + 2 * ry;
  uint32_t q0 = load(y0 - ry), q1 = load(y0 - ry + 1);
  for (int i0 = 0; i0 < n_steps; i0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = i0 + j;
      if (i >= n_steps) break;
      const uint32_t w = q0;
      q0 = q1;
      q1 = load(y0 - ry + i + 2);
      const uint32_t o = chain.step(w, j);
      const int y = y0 + i - 2 * ry;
      if (i >= 2 * ry && owns && y < hp) {
        const uint32_t v = y >= ry && y < hp - ry ? o & keep : 0u;
        uint32_t* q = dst + static_cast<size_t>(y) * words + gx;
        q[0] = v;
        if (kGray) {
          q[plane] = v;
          q[2 * plane] = v;
        }
      }
    }
  }
}

template <class Chain, bool kGray>
int launch_stream(const void* in, void* out, int count, int hp, int pitch,
                  int gray, const void* desc, const int* desc_host,
                  int n_words, const U8Luma& luma, void* stream) {
  int n_stages, ry, rx;
  if (gray != kGray || count < 1 || count > 65535 || hp < 1 || pitch < 16 ||
      pitch % 16 || n_words < 1 ||
      !parse(desc_host, n_words, true, &n_stages, &ry, &rx))
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = pitch / 4, per = 32 - 2 * Chain::kStages;
  const int groups = (words + per - 1) / per;
  const dim3 grid((groups + kStreamWarps - 1) / kStreamWarps,
                  (hp + kStreamRows - 1) / kStreamRows, count);
  const auto kernel = chain_u8_stream<Chain, kGray>;
  kernel<<<grid, 32 * kStreamWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), hp,
      words, static_cast<const int*>(desc), n_stages, ry, rx, luma);
  return dip::launch_status();
}

}  // namespace

// dip_chain_u8's arguments after which, the chain the descriptor holds:
// 1 to 4 for chip_smoke.CHAINS C1 to C4.
DIP_API int dip_chain_u8_stream(int which, const void* in, void* out,
                                int count, int hp, int pitch, int gray,
                                const void* desc, const int* desc_host,
                                int n_words, int wr, int wg, int wb, int shift,
                                void* stream) {
  const U8Luma l{wr, wg, wb, shift};
  switch (which) {
    case 1:
      return launch_stream<StreamC1, false>(in, out, count, hp, pitch, gray,
                                            desc, desc_host, n_words, l,
                                            stream);
    case 2:
      return launch_stream<StreamC2, true>(in, out, count, hp, pitch, gray,
                                           desc, desc_host, n_words, l,
                                           stream);
    case 3:
      return launch_stream<StreamC3, false>(in, out, count, hp, pitch, gray,
                                            desc, desc_host, n_words, l,
                                            stream);
    case 4:
      return launch_stream<StreamC4, false>(in, out, count, hp, pitch, gray,
                                            desc, desc_host, n_words, l,
                                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
