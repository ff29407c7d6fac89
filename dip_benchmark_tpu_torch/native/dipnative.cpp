// Native runtime components for dip_benchmark_tpu_torch.
//
// Role parity with the reference's C++ backends (sycl/benchmark.cpp,
// visiongl/benchmark.cpp): the host-side native layer around the accelerator
// compute path. On the GPU the kernels themselves are hand-written CUDA
// (ops/kernels/csrc); this library provides the host runtime pieces that the
// reference implements in C++:
//   - a steady-clock nanosecond timer (chrono::steady_clock — the same role
//     as measure_time's chrono::high_resolution_clock at sycl/benchmark.cpp:25)
//   - the full 14-op oracle on uint8 HWC images, used to verify device
//     outputs bit-exactly at full production image sizes (8.2 Mpx) where
//     the NumPy oracle is too slow for per-run verification.
//
// Semantics are the spec of dip_benchmark_tpu_torch/spec.py exactly:
//   mirror borders (low: -i, high: 2n-i-1), Rec.709 grayscale in the
//   spec's EXACT 16-bit integer fixed point (see dip_grayscale below —
//   NOT the reference's f32 accumulate, which drifts under FMA
//   contraction), >127 threshold, min-erosion, integer-exact convolution
//   with round-half-up.
//
// Plain C ABI for ctypes binding; OpenMP row-parallel when available.

#include <chrono>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

inline int mirror(int i, int n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - i - 1;
    return i;
}

}  // namespace

extern "C" {

uint64_t dip_monotonic_ns() {
    return static_cast<uint64_t>(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now().time_since_epoch())
            .count());
}

void dip_copy(const uint8_t* in, uint8_t* out, int h, int w, int c) {
    std::memcpy(out, in, static_cast<size_t>(h) * w * c);
}

void dip_inversion(const uint8_t* in, uint8_t* out, int h, int w, int c) {
    const size_t n = static_cast<size_t>(h) * w * c;
#pragma omp parallel for
    for (long long i = 0; i < static_cast<long long>(n); ++i)
        out[i] = static_cast<uint8_t>(255 - in[i]);
}

void dip_threshold(const uint8_t* in, uint8_t* out, int h, int w, int c) {
    const size_t n = static_cast<size_t>(h) * w * c;
#pragma omp parallel for
    for (long long i = 0; i < static_cast<long long>(n); ++i)
        out[i] = in[i] > 127 ? 255 : 0;
}

// Rec.709 luma in the spec's EXACT 16-bit fixed point
// (y = (13933*R + 46871*G + 4732*B) >> 16, dip_benchmark_tpu_torch/spec.py):
// bit-identical on every backend regardless of FMA contraction, unlike the
// reference's float32 path [sycl/benchmark.cpp:71-91]. RGB HWC in/out.
void dip_grayscale(const uint8_t* in, uint8_t* out, int h, int w, int c) {
    if (c < 3) return;  // luma reads px[0..2]; fewer channels would be
                        // a heap over-read (binding enforces c == 3 too)
    const long long npx = static_cast<long long>(h) * w;
#pragma omp parallel for
    for (long long p = 0; p < npx; ++p) {
        const uint8_t* px = in + p * c;
        const int32_t g = (13933 * px[0] + 46871 * px[1] + 4732 * px[2]) >> 16;
        const uint8_t v = static_cast<uint8_t>(g);
        uint8_t* q = out + p * c;
        for (int k = 0; k < c; ++k) q[k] = v;
    }
}

// Min-erosion over a bool mask, mirror borders. [sycl/benchmark.cpp:116-157]
void dip_erosion(const uint8_t* in, uint8_t* out, int h, int w, int c,
                 const uint8_t* mask, int mh, int mw) {
#pragma omp parallel for
    for (long long y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            for (int k = 0; k < c; ++k) {
                uint8_t result = 255;
                for (int my = 0; my < mh; ++my) {
                    const int iy = mirror(static_cast<int>(y) + my - mh / 2, h);
                    for (int mx = 0; mx < mw; ++mx) {
                        if (!mask[my * mw + mx]) continue;
                        const int ix = mirror(x + mx - mw / 2, w);
                        result = std::min(
                            result, in[(static_cast<size_t>(iy) * w + ix) * c + k]);
                    }
                }
                out[(static_cast<size_t>(y) * w + x) * c + k] = result;
            }
        }
    }
}

// Integer-exact convolution: acc = sum(w_int * px); (acc + half) >> shift,
// clamp [0,255]. Bit-identical to the reference's f32 path because the
// binomial weights are exact binary fractions. [sycl/benchmark.cpp:159-202]
void dip_convolution(const uint8_t* in, uint8_t* out, int h, int w, int c,
                     const int32_t* mask, int mh, int mw, int shift) {
    // shift == 0 (unit weights, no normalization): half would be
    // 1 << -1, undefined behavior — round-half-up of /1 is a no-op.
    const int32_t half = shift > 0 ? (1 << (shift - 1)) : 0;
#pragma omp parallel for
    for (long long y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            for (int k = 0; k < c; ++k) {
                int32_t acc = 0;
                for (int my = 0; my < mh; ++my) {
                    const int iy = mirror(static_cast<int>(y) + my - mh / 2, h);
                    for (int mx = 0; mx < mw; ++mx) {
                        const int ix = mirror(x + mx - mw / 2, w);
                        acc += mask[my * mw + mx] *
                               in[(static_cast<size_t>(iy) * w + ix) * c + k];
                    }
                }
                int32_t r = (acc + half) >> shift;
                r = std::min(std::max(r, 0), 255);
                out[(static_cast<size_t>(y) * w + x) * c + k] =
                    static_cast<uint8_t>(r);
            }
        }
    }
}

}  // extern "C"
